"""Plain PyTorch versions of the kernels: the CPU path of each wrapper and
the oracle the kernels are held against on the card."""
from __future__ import annotations

import torch

from ..core.fakequant import expand_group_scale, unpack_int4

_NEG = -1e30
_RULES = ("kernel", "ste")


def quant_matmul_ref(x: torch.Tensor, qw: torch.Tensor, s_wl: torch.Tensor,
                     s_wr: torch.Tensor) -> torch.Tensor:
    """``x @ (s_wl ⊙ unpack(qw) ⊙ s_wr)`` in f32; s_wr: [N] or [K/g, N]."""
    w = unpack_int4(qw, axis=0).to(torch.float32)
    s_wr = s_wr[None, :] if s_wr.ndim == 1 else expand_group_scale(
        s_wr, w.shape[0], axis=0)
    w = w * s_wl[:, None] * s_wr
    return (x.to(torch.float32) @ w).to(x.dtype)


def quant_matmul_int8_ref(x: torch.Tensor, q: torch.Tensor,
                          s_wl: torch.Tensor,
                          s_wr: torch.Tensor) -> torch.Tensor:
    """``Σ_g s_wr[g] · ((x·s_wl)[:, g] @ q[g])`` in f32 for an int8
    ``q [K, N]`` (the JAX package's int8 branch of ``qlinear_deployed``);
    s_wr ``[N]`` or ``[K/g, N]``; output in x's type."""
    xs = x.to(torch.float32) * s_wl[None, :]
    qf = q.to(torch.float32)
    K, N = q.shape
    if s_wr.ndim == 2:
        n_groups = s_wr.shape[0]
        g = K // n_groups
        p = torch.einsum("bgk,gkn->gbn", xs.reshape(-1, n_groups, g),
                         qf.reshape(n_groups, g, N))
        return torch.sum(p * s_wr[:, None, :], dim=0).to(x.dtype)
    return (xs @ qf * s_wr[None, :]).to(x.dtype)


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


def decode_attention_paged_ref(q: torch.Tensor, pool_k: torch.Tensor,
                               pool_v: torch.Tensor, pt: torch.Tensor,
                               lengths: torch.Tensor,
                               k_scale: torch.Tensor | None = None,
                               v_scale: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """:func:`decode_attention_ref` over the paged pools: each slot's pages
    gathered into the ``[S, max_pages * P, Hkv, hd]`` view, rows past the
    slot's length (trash-page padding included) masked.

    pool_k, pool_v: [n_pages + 1, P, Hkv, hd]; pt: [S, max_pages] page ids."""
    S, n_pg = pt.shape
    P, Hkv, hd = pool_k.shape[1:]
    k = pool_k[pt].reshape(S, n_pg * P, Hkv, hd)
    v = pool_v[pt].reshape(S, n_pg * P, Hkv, hd)
    return decode_attention_ref(q, k, v, lengths, k_scale, v_scale)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Softmax attention in f32 over ``[BH, S, hd]``, in q's type; the
    causal mask is ``query index >= key index`` (aligned at 0)."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    s = torch.einsum("bqh,bkh->bqk", qf, kf) * (q.shape[-1] ** -0.5)
    if causal:
        Sq, Sk = s.shape[1], s.shape[2]
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, vf).to(q.dtype)


def attention_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """:func:`flash_attention_ref` in the ``[B, S, H, hd]`` layout, k/v
    ``[B, Sk, Hkv, hd]`` with each kv head repeated for its ``H / Hkv``
    query heads (the JAX shim's input)."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    qt = q.transpose(1, 2).reshape(B * H, S, hd)
    kt = k.transpose(1, 2).reshape(B * H, -1, hd)
    vt = v.transpose(1, 2).reshape(B * H, -1, hd)
    o = flash_attention_ref(qt, kt, vt, causal=causal)
    return o.reshape(B, H, S, hd).transpose(1, 2)


def fake_quant_ref(x: torch.Tensor, scale: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """``clip(round(x/s), ±qmax)·s`` in f32, returned in x's type; ``scale``
    broadcasts against ``x``."""
    qmax = float(2 ** (bits - 1) - 1)
    s = scale.to(torch.float32)
    q = torch.clamp(torch.round(x.to(torch.float32) / s), -qmax, qmax)
    return (q * s).to(x.dtype)


def fake_quant_grad_ref(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                        bits: int, rule: str = "kernel"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two backwards of :func:`fake_quant_ref` → ``(gx, gs)``, with
    ``gs`` summed to the scale's (broadcast) shape.  With ``ratio = x/s``,
    ``r = round(ratio)`` and ``q = clip(r, ±qmax)``:

    - ``"kernel"``: the Pallas kernel's custom VJP (``_fq_bwd``) — the hard
      indicator ``inside = |ratio| <= qmax``; ``gx = g·inside``,
      ``gs = g·(q − ratio)`` inside and ``g·q`` outside.
    - ``"ste"``: the gradient of ``s·clip(ste_round(x/s), ±qmax)`` as autograd
      takes it through ``minimum(maximum(·))`` (½ where ``|r| == qmax``):
      ``c = 1, ½, 0`` for ``|r| <, ==, > qmax``; ``gx = (g·s·c)/s`` in that
      order (the composition's chain rule) and ``gs = g·(q − c·ratio)``.

    The CUDA kernel computes these expressions in the same order, so ``gx``
    and a full-shape ``gs`` agree bit for bit; a reduced ``gs`` differs in
    summation order only.
    """
    if rule not in _RULES:
        raise ValueError(f"rule must be one of {_RULES}, got {rule!r}")
    qmax = float(2 ** (bits - 1) - 1)
    gf = g.to(torch.float32)
    s = scale.to(torch.float32)
    ratio = x.to(torch.float32) / s
    r = torch.round(ratio)
    q = torch.clamp(r, -qmax, qmax)
    if rule == "kernel":
        inside = (torch.abs(ratio) <= qmax).to(torch.float32)
        gx = gf * inside
        gs = gf * torch.where(inside > 0, q - ratio, q)
    else:
        a = torch.abs(r)
        c = torch.where(a < qmax, 1.0, torch.where(a == qmax, 0.5, 0.0))
        gx = gf * s * c / s
        gs = gf * (q - c * ratio)
    return gx.to(x.dtype), gs.sum_to_size(scale.shape).to(scale.dtype)
