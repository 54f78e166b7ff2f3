"""Plain PyTorch versions of the kernels: the CPU path of each wrapper and
the oracle the kernels are held against on the card."""
from __future__ import annotations

import torch

from ..core.fakequant import expand_group_scale, unpack_int4

_NEG = -1e30


def quant_matmul_ref(x: torch.Tensor, qw: torch.Tensor, s_wl: torch.Tensor,
                     s_wr: torch.Tensor) -> torch.Tensor:
    """``x @ (s_wl ⊙ unpack(qw) ⊙ s_wr)`` in f32; s_wr: [N] or [K/g, N]."""
    w = unpack_int4(qw, axis=0).to(torch.float32)
    s_wr = s_wr[None, :] if s_wr.ndim == 1 else expand_group_scale(
        s_wr, w.shape[0], axis=0)
    w = w * s_wl[:, None] * s_wr
    return (x.to(torch.float32) @ w).to(x.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor,
                         k_scale: torch.Tensor | None = None,
                         v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The masked decode attention ``_sdpa``/``_paged_sdpa`` compute, in f32.

    q: [S, Hkv, G, hd]; k, v: [S, T, Hkv, hd] (int8 with [S, Hkv] scales, or
    float); lengths: [S] → [S, Hkv, G, hd] in q's type.  The K scale and
    1/sqrt(hd) fold into q before the dot, the V scale multiplies the
    context after it.
    """
    hd = q.shape[-1]
    T = k.shape[1]
    scale = hd ** -0.5
    if k_scale is not None:
        scale = scale * k_scale.to(torch.float32)[:, :, None, None]
    qs = q.to(torch.float32) * scale
    logits = torch.einsum("skgh,stkh->skgt", qs, k.to(torch.float32))
    mask = (torch.arange(T, device=k.device)[None, :]
            < lengths.to(k.device)[:, None])
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, _NEG))
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("skgt,stkh->skgh", probs, v.to(torch.float32))
    if v_scale is not None:
        ctx = ctx * v_scale.to(torch.float32)[:, :, None, None]
    return ctx.to(q.dtype)
