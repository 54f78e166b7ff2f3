"""4b-adapted Cross-Layer Equalization (paper Appendix D, Eqs. 19-21).

CLE pre-conditions weight pairs W^{l-1} (out-slices) / W^l (in-slices) by
inverse factors C_m.  In the paper's reframing the C_m are ratios of the
activation vector-scale DoF to its uniform init (Eq. 18), so CLE is an
initializer of the S_a / S_wL DoF, after which QFT trains it.  The 4-bit
adaptation uses MMSE(PPQ)-optimal per-slice scales:

    2 log C_m = (1+β) log(Ŝ_wR^{l-1}[m]/ŝ_w^{l-1}) + (1−β) log(ŝ_w^l/Ŝ_wL^l[m])

β = 0 for equal bitwidths, ±0.5 toward the lower-bitwidth layer, β = 1 when
the consumer is a lossless elementwise add.  Fan-out consumers contribute a
weighted mean to the second term and share C_m.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .mmse import ppq_scale
from .qconfig import QuantConfig


def _log_slice_scales(w: torch.Tensor, bits: int, axis: int,
                      iters: int) -> torch.Tensor:
    """log MMSE-optimal scale per slice along ``axis`` of W[in, out]."""
    red = tuple(i for i in range(w.ndim) if i != axis)
    s = ppq_scale(w, bits, axes=red, iters=iters)
    return torch.log(torch.clamp(s.reshape(-1), min=1e-12))


def _log_tensor_scale(w: torch.Tensor, bits: int, iters: int) -> torch.Tensor:
    s = ppq_scale(w, bits, axes=None, iters=iters).reshape(())
    return torch.log(torch.clamp(s, min=1e-12))


def cle_factors(w_prev: torch.Tensor, w_next_list: Sequence[torch.Tensor],
                bits_prev: int, bits_next_list: Sequence[int],
                cfg: QuantConfig,
                fanout_weights: Sequence[float] | None = None,
                beta_override: float | None = None) -> torch.Tensor:
    """log C_m for a producer kernel W^{l-1}[in, m] and fan-out consumers
    W^l[m, out]; to be added to the producer-output stream's log_sa
    (Eq. 18)."""
    it = cfg.mmse_iters
    t1 = (_log_slice_scales(w_prev, bits_prev, w_prev.ndim - 1, it)
          - _log_tensor_scale(w_prev, bits_prev, it))
    if fanout_weights is None:
        fanout_weights = [1.0 / len(w_next_list)] * len(w_next_list)
    t2 = torch.zeros_like(t1)
    for w_next, bits_next, fw in zip(w_next_list, bits_next_list,
                                     fanout_weights):
        t2 = t2 + fw * (_log_tensor_scale(w_next, bits_next, it)
                        - _log_slice_scales(w_next, bits_next, 0, it))
    if beta_override is not None:
        beta = beta_override
    else:
        b_next = bits_next_list[0]
        if bits_prev == b_next:
            beta = 0.0
        else:
            beta = 0.5 if bits_prev < b_next else -0.5
    return 0.5 * ((1.0 + beta) * t1 + (1.0 - beta) * t2)


def apply_cle_to_stream(stream_log_sa: torch.Tensor,
                        log_c: torch.Tensor) -> torch.Tensor:
    """Fold CLE factors into the stream scale DoF (Eq. 18): S_a ← C · S_a."""
    return stream_log_sa + log_c
