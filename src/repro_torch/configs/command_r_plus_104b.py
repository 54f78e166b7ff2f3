"""Command-R+ 104B [hf:CohereForAI/c4ai-command-r-v01]: 64L d=12288 96H (kv=8) ff=33792 V=256000, no-bias."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense", n_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=33792, vocab=256000, head_dim=128,
    rope_theta=1e4, bias=False)

# padded fields reset to 0 so __post_init__ re-derives them at SMOKE
# scale (dataclasses.replace would otherwise inherit the full-size
# vocab/head padding -- a 150k-row embedding under a 512 vocab)
SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
    vocab=512, head_dim=16,
    n_heads_padded=0, n_kv_heads_padded=0, vocab_padded=0)
