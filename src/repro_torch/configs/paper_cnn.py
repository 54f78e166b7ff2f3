"""Paper-faithful CNN path (the paper's own experimental setting, reduced).

A small conv backbone (``F.conv2d``) + classifier used to validate the
paper's figure/table-level claims (MMSE granularity, CLE, QFT recovery) in
the exact layer type the paper studies.  See models/cnn.py.
"""
from ..models.cnn import CNNConfig

CONFIG = CNNConfig(name="paper-cnn", channels=(16, 32, 64), n_classes=10,
                   img_hw=16, kernel=3)
SMOKE = CONFIG
