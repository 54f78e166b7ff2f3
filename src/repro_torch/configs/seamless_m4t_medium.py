"""SeamlessM4T-medium [arXiv:2308.11596]: enc-dec 12L+12L d=1024 16H ff=4096 V=256206.

The audio frontend is stubbed: a batch carries precomputed frame
embeddings ``[B, S_enc, d]``.  GELU MLP (the conformer encoder approximated
as a standard transformer).  The decoder: 12 causal layers, each with
cross attention over the encoder output.  ``vocab_padded`` is 256206, the
vocabulary itself: ``__post_init__`` copies it, and no tensor-parallel
padding (``ModelConfig.with_padding``) is applied.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=12, enc_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206,
    head_dim=64, mlp="gelu", rope_theta=1e4)

# padded fields reset to 0 so __post_init__ re-derives them at SMOKE
# scale (dataclasses.replace would otherwise inherit the full-size
# vocab/head padding -- a 150k-row embedding under a 512 vocab)
SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, head_dim=16,
    n_heads_padded=0, n_kv_heads_padded=0, vocab_padded=0)
