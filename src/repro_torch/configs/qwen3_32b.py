"""Qwen3-32B [hf:Qwen/Qwen3-8B family]: 64L d=5120 64H (GQA kv=8) ff=25600 V=151936, qk_norm."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120, n_heads=64,
    n_kv_heads=8, d_ff=25600, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6)

# padded fields reset to 0 so __post_init__ re-derives them at SMOKE
# scale (dataclasses.replace would otherwise inherit the full-size
# vocab/head padding -- a 150k-row embedding under a 512 vocab)
SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab=512, head_dim=16,
    n_heads_padded=0, n_kv_heads_padded=0, vocab_padded=0)
