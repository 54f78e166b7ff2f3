"""DeepSeek-V2 236B [arXiv:2405.04434]: 60L d=5120 128H ff(expert)=1536 V=102400.

MLA (kv_lora=512, q_lora=1536, nope 128 + rope 64, v 128); MoE: 160 routed
top-6 + 2 shared experts per the assigned pool spec.
"""
import dataclasses
from ..models.config import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="mla_moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=0, vocab=102400, head_dim=192,
    rope_theta=1e4,
    mla=MLAConfig(kv_lora=512, q_lora=1536, d_nope=128, d_rope=64, d_v=128),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536))

# padded fields reset to 0 so __post_init__ re-derives them at SMOKE
# scale (dataclasses.replace would otherwise inherit the full-size
# vocab/head padding -- a 150k-row embedding under a 512 vocab)
SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, vocab=512,
    head_dim=24,
    mla=MLAConfig(kv_lora=16, q_lora=32, d_nope=16, d_rope=8, d_v=16),
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=2, d_ff_expert=32),
    n_heads_padded=0, n_kv_heads_padded=0, vocab_padded=0)
