"""MMSE-optimal quantization ranges (paper Eq. 5, Appendix C).

PPQ (Algorithm 1) solves ``min_s ||W - s*clip(round(W/s))||`` by iterated
linear projection; APQ (Algorithm 2) alternates row and column projections
for the doubly-channelwise problem.  The JAX package's ``lax.fori_loop``
bodies are plain loops here.
"""
from __future__ import annotations

import torch

from .fakequant import expand_group_scale, qrange

_EPS = 1e-12


def _dims(w: torch.Tensor, axes) -> tuple[int, ...]:
    return tuple(range(w.ndim)) if axes is None else tuple(axes)


def _proj_scale(w: torch.Tensor, q: torch.Tensor, axes) -> torch.Tensor:
    """Optimal linear-projection scale  s = <q, w> / <q, q>  (Eq. 14)."""
    num = torch.sum(q * w, dim=axes, keepdim=True)
    den = torch.sum(q * q, dim=axes, keepdim=True)
    return num / torch.clamp(den, min=_EPS)


def ppq_scale(w: torch.Tensor, bits: int, axes=None,
              iters: int = 10) -> torch.Tensor:
    """Algorithm 1 over the slice spanned by ``axes`` (None → the whole
    tensor); the result keeps the reduced dims for broadcasting."""
    axes = _dims(w, axes)
    lo, hi = qrange(bits, signed=True)
    s = torch.amax(torch.abs(w), dim=axes, keepdim=True) / hi
    s = torch.clamp(s, min=_EPS)
    for _ in range(iters):
        q = torch.clamp(torch.round(w / s), lo, hi)
        s_new = _proj_scale(w, q, axes)
        s = torch.where(s_new > _EPS, s_new, s)   # guard all-zero slices
    return s


def ppq_scale_grouped(w: torch.Tensor, bits: int, n_groups: int,
                      iters: int = 10) -> torch.Tensor:
    """Group-wise PPQ along the in-dim of ``W[in, out]`` → ``[n_groups, out]``."""
    K, N = w.shape
    if K % n_groups:
        raise ValueError(f"{n_groups} groups do not divide in-dim {K}")
    wg = w.reshape(n_groups, K // n_groups, N)
    return ppq_scale(wg, bits, axes=(1,), iters=iters)[:, 0, :]


def mmse_error(w: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """||W - s*clip(round(W/s))||_2 for a broadcastable scale."""
    lo, hi = qrange(bits, signed=True)
    deq = scale * torch.clamp(torch.round(w / scale), lo, hi)
    return torch.linalg.vector_norm((w - deq).reshape(-1))


def apq_scales(w: torch.Tensor, bits: int,
               iters: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 2 (APQ) for ``W[m, n]`` → ``(S_wL[m, 1], S_wR[1, n])``."""
    lo, hi = qrange(bits, signed=True)
    t = torch.clamp(torch.amax(torch.abs(w), dim=0, keepdim=True) / hi,
                    min=_EPS)
    s = torch.clamp(torch.amax(torch.abs(w / t), dim=1, keepdim=True) / hi,
                    min=_EPS)
    for _ in range(iters):
        q = torch.clamp(torch.round(w / (s * t)), lo, hi)
        t_new = _proj_scale(w / s, q, (0,))
        t = torch.where(t_new > _EPS, t_new, t)
        q = torch.clamp(torch.round(w / (s * t)), lo, hi)
        s_new = _proj_scale(w / t, q, (1,))
        s = torch.where(s_new > _EPS, s_new, s)
    return s, t


def mmse_lw(w: torch.Tensor, bits: int, iters: int = 10) -> torch.Tensor:
    """Layerwise (scalar) MMSE error — Eq. 5a."""
    return mmse_error(w, ppq_scale(w, bits, axes=None, iters=iters), bits)


def mmse_ch(w: torch.Tensor, bits: int, iters: int = 10) -> torch.Tensor:
    """Channelwise (per-out-channel) MMSE error — Eq. 5b (W as [in, out])."""
    return mmse_error(w, ppq_scale(w, bits, axes=(0,), iters=iters), bits)


def mmse_dch(w: torch.Tensor, bits: int, iters: int = 10) -> torch.Tensor:
    """Doubly-channelwise MMSE error — Eq. 5c via APQ."""
    s, t = apq_scales(w, bits, iters=iters)
    return mmse_error(w, s * t, bits)


def mmse_grp(w: torch.Tensor, bits: int, group: int,
             iters: int = 10) -> torch.Tensor:
    """Group-wise MMSE error."""
    K = w.shape[0]
    n_g = K // group if K % group == 0 else 1
    s = ppq_scale_grouped(w, bits, n_g, iters=iters)
    return mmse_error(w, expand_group_scale(s, K, axis=0), bits)
