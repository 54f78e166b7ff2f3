"""Mamba2-1.3B [arXiv:2405.21060]: 48L d=2048 attn-free V=50280, ssm_state=128.

SSD (state-space duality): chunked scan for train/prefill, O(1) recurrent
decode. Tied embeddings (as published).
"""
import dataclasses
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280, head_dim=0, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=128))

# padded fields reset to 0 so __post_init__ re-derives them at SMOKE
# scale (dataclasses.replace would otherwise inherit the full-size
# vocab/head padding -- a 150k-row embedding under a 512 vocab)
SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, vocab=512,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                  chunk=16),
    n_heads_padded=0, n_kv_heads_padded=0, vocab_padded=0)
