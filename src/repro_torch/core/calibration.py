"""Activation-range calibration (paper §4: naive max-min for activations,
MMSE for weights — 'a sole pre-QFT step').

The model forward exposes stream taps; a few calibration batches set each
stream's ``(log_sa, zp)`` from the observed ranges.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from .qconfig import QuantConfig


def ranges_from_batch(taps: dict[str, torch.Tensor]
                      ) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Per-channel (min, max) of each tapped activation ``[..., C]``."""
    out = {}
    for name, x in taps.items():
        x = x.to(torch.float32).reshape(-1, x.shape[-1])
        out[name] = (torch.amin(x, 0), torch.amax(x, 0))
    return out


def merge_ranges(a, b):
    return {k: (torch.minimum(a[k][0], b[k][0]),
                torch.maximum(a[k][1], b[k][1])) for k in a}


def stream_params_from_range(lo: torch.Tensor, hi: torch.Tensor,
                             cfg: QuantConfig,
                             per_channel: bool | None = None) -> dict:
    """(lo, hi) per channel → ``{log_sa, zp}`` for unsigned a_bits encoding.

    ``per_channel=False`` is the paper's scalar (per-tensor) range; the
    vector structure of S_a then enters only via CLE or QFT training
    (per-channel calibration pushes dead-channel spread into the tied
    weight grids of Eq. 2)."""
    bits = cfg.a_bits or 8
    qmax = 2 ** bits - 1
    if per_channel is False:
        lo = torch.broadcast_to(torch.amin(lo), lo.shape)
        hi = torch.broadcast_to(torch.amax(hi), hi.shape)
    lo = torch.clamp(lo, max=0.0)
    hi = torch.maximum(hi, lo + 1e-6)
    scale = (hi - lo) / qmax
    # dead/near-dead channels would otherwise get ~0 scale and explode any
    # tied weight grid (Eq. 2): floor at 1e-3 of the layer max
    scale = torch.maximum(scale, torch.amax(scale) * 1e-3 + 1e-12)
    zp = torch.round(-lo / scale)
    return {"log_sa": torch.log(scale).to(torch.float32),
            "zp": zp.to(torch.float32)}


def calibrate_streams(forward_with_taps: Callable, params,
                      batches: Iterable, cfg: QuantConfig) -> dict[str, dict]:
    """Run calibration batches; return ``{stream_name: {log_sa, zp}}``."""
    acc = None
    for batch in batches:
        _, taps = forward_with_taps(params, batch)
        r = ranges_from_batch(taps)
        acc = r if acc is None else merge_ranges(acc, r)
    if acc is None:
        raise ValueError("need at least one calibration batch")
    return {k: stream_params_from_range(lo, hi, cfg)
            for k, (lo, hi) in acc.items()}
