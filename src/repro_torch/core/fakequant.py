"""STE fake-quantization primitives (paper §3.4, Appendix A).

The only non-differentiable elements are ``clip(round(.))``; each carries a
Straight-Through Estimator and gradients flow natively through the offline
subgraph that computes scales and quantized weights.  ``torch.round`` rounds
half to even, as ``jnp.round`` does, so integer grids agree bit for bit with
the JAX package.
"""
from __future__ import annotations

import torch


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round-to-nearest-even with identity gradient."""
    return x + (torch.round(x) - x).detach()


def qrange(bits: int, signed: bool = True) -> tuple[float, float]:
    """Integer grid range.  Symmetric signed uses ±(2^{b-1}-1) (paper Eq. 1)."""
    if signed:
        qmax = float(2 ** (bits - 1) - 1)
        return -qmax, qmax
    return 0.0, float(2**bits - 1)


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int,
             signed: bool = True,
             zero_point: torch.Tensor | None = None) -> torch.Tensor:
    """Lossy encode ``clip(round(x/scale) + zp)`` with STE; ``scale``
    broadcasts against ``x``.

    The clip is ``minimum(maximum(q, lo), hi)`` on tensor bounds, as
    ``jnp.clip`` is: where ``q`` lands exactly on a bound both split the
    gradient ½/½ (``torch.clamp`` would pass all of it)."""
    lo, hi = qrange(bits, signed)
    q = ste_round(x / scale)
    if zero_point is not None:
        q = q + zero_point
    # filled on the device: a tensor made from a host value is a copy the
    # host waits for
    lo_t = torch.full((), lo, dtype=q.dtype, device=q.device)
    hi_t = torch.full((), hi, dtype=q.dtype, device=q.device)
    return torch.minimum(torch.maximum(q, lo_t), hi_t)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               zero_point: torch.Tensor | None = None) -> torch.Tensor:
    if zero_point is not None:
        q = q - zero_point
    return q * scale


def fake_quant(x: torch.Tensor, scale: torch.Tensor, bits: int,
               signed: bool = True,
               zero_point: torch.Tensor | None = None) -> torch.Tensor:
    """quantize → dequantize; differentiable end to end (STE for ``x``,
    the LSQ gradient emerges for ``scale``)."""
    return dequantize(quantize(x, scale, bits, signed, zero_point), scale,
                      zero_point)


def fake_quant_act(x: torch.Tensor, scale: torch.Tensor, bits: int = 8,
                   zero_point: torch.Tensor | None = None) -> torch.Tensor:
    """Unsigned asymmetric activation fake-quant (paper W4A8 setting); the
    zero-point is rounded with STE to stay on the grid."""
    zp = None if zero_point is None else ste_round(zero_point)
    return fake_quant(x, scale, bits, signed=False, zero_point=zp)


def expand_group_scale(scale: torch.Tensor, dim: int,
                       axis: int = -2) -> torch.Tensor:
    """Block-broadcast per-group scales ``[..., n_g, ...]`` to ``[..., dim,
    ...]`` along ``axis``, each group repeated over ``dim // n_g`` rows."""
    axis = axis % scale.ndim
    n_g = scale.shape[axis]
    if n_g == dim:
        return scale
    if dim % n_g:
        raise ValueError(f"{n_g} groups do not divide dim {dim}")
    return torch.repeat_interleave(scale, dim // n_g, dim=axis)


def _every_other(t: torch.Tensor, axis: int, start: int) -> torch.Tensor:
    idx = (slice(None),) * axis + (slice(start, None, 2),)
    return t[idx]


def pack_int4(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack signed int4 values (int8 in [-8, 7]) into uint8 pairs along
    ``axis``: the even row in the low nibble, the odd row in the high one."""
    axis = axis % q.ndim
    if q.shape[axis] % 2:
        raise ValueError("pack axis must be even")
    u = (q.to(torch.int8) & 0x0F).to(torch.uint8)
    return _every_other(u, axis, 0) | (_every_other(u, axis, 1) << 4)


def unpack_int4(p: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`pack_int4` → int8 values, nibbles above 7
    sign-extended."""
    axis = axis % p.ndim
    lo = (p & 0x0F).to(torch.int8)
    hi = ((p >> 4) & 0x0F).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    st = torch.stack([lo, hi], dim=axis + 1)      # [..., n/2, 2, ...]
    out_shape = p.shape[:axis] + (p.shape[axis] * 2,) + p.shape[axis + 1:]
    return st.reshape(out_shape)
