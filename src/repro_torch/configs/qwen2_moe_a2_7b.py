"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d=2048 16H ff(expert)=1408 V=151936.

60 routed top-4 + 4 shared experts (padded to 64 routed for EP16, router-masked).
"""
import dataclasses
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=0, vocab=151936, head_dim=128,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_ff_expert=1408))

# padded fields reset to 0 so __post_init__ re-derives them at SMOKE
# scale (dataclasses.replace would otherwise inherit the full-size
# vocab/head padding -- a 150k-row embedding under a 512 vocab)
SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, vocab=512,
    head_dim=16, moe=MoEConfig(n_experts=6, top_k=2, n_shared=2,
                               d_ff_expert=32),
    n_heads_padded=0, n_kv_heads_padded=0, vocab_padded=0)
