"""Qwen2-VL-7B [arXiv:2409.12191]: 28L d=3584 28H (GQA kv=4) ff=18944 V=152064.

M-RoPE (sections 16/24/24 on the half head dim) and biased q/k/v; the
dynamic-resolution vision frontend is stubbed: a batch carries precomputed
patch embeddings ``[B, S_img, d]`` and ``positions [B, 3, S]``.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584, n_heads=28,
    n_kv_heads=4, d_ff=18944, vocab=152064, head_dim=128,
    mrope_sections=(16, 24, 24), rope_theta=1e6, bias=True)

# padded fields reset to 0 so __post_init__ re-derives them at SMOKE
# scale (dataclasses.replace would otherwise inherit the full-size
# vocab/head padding -- a 150k-row embedding under a 512 vocab)
SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16, mrope_sections=(4, 2, 2),
    n_heads_padded=0, n_kv_heads_padded=0, vocab_padded=0)
