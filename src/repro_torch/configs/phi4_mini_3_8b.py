"""Phi-4-mini-3.8B [arXiv:2412.08905]: 32L d=3072 24H (GQA kv=8) ff=8192 V=200064."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab=200064, head_dim=128,
    rope_theta=1e4, tie_embeddings=True)

# padded fields reset to 0 so __post_init__ re-derives them at SMOKE
# scale (dataclasses.replace would otherwise inherit the full-size
# vocab/head padding -- a 150k-row embedding under a 512 vocab)
SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_ff=128,
    vocab=512, head_dim=16,
    n_heads_padded=0, n_kv_heads_padded=0, vocab_padded=0)
