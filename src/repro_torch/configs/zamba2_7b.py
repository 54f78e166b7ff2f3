"""Zamba2-7B [arXiv:2411.15242]: 81L d=3584 32H ff=14336 V=32000, ssm_state=64.

Mamba2 backbone + ONE shared attention+MLP block invoked every 6 layers
(Zamba weight sharing; per-invocation LoRA omitted, as in the JAX package).
81 = 13 groups of 6 + 3 tail mamba layers.
"""
import dataclasses
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584, n_heads=32,
    n_kv_heads=32, d_ff=14336, vocab=32000, head_dim=112, attn_every=6,
    rope_theta=1e4,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=2,
                  chunk=128))

# padded fields reset to 0 so __post_init__ re-derives them at SMOKE
# scale (dataclasses.replace would otherwise inherit the full-size
# vocab/head padding -- a 150k-row embedding under a 512 vocab)
SMOKE = dataclasses.replace(
    CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, head_dim=16, attn_every=2,
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16, n_groups=1,
                  chunk=16),
    n_heads_padded=0, n_kv_heads_padded=0, vocab_padded=0)
