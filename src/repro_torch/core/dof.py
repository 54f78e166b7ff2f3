"""The offline subgraph: deployment parameters inferred from the DoF set.

Paper §3.3–3.4: the kernel scale matrix collapses to an outer product
``S_w[m, n] = S_wL[m] · S_wR[n]`` with ``S_wL = 1/S_a`` of the input stream
(Eq. 2).  Trainable DoF per quantized linear: the FP master ``w``, the bias,
the input stream's ``log_sa`` (shared by fan-out siblings) and ``log_swr``,
whose shape IS the weight-scale layout (scalar → layerwise, ``[out]`` →
channel, ``[in/g, out]`` → group).  Scales live in the log domain.

Parameters are plain dicts of tensors in the JAX package's layout, so a
converted JAX tree and a tree built here are interchangeable; ``lead``
prepends stacked axes (the JAX package's ``vmap`` over layers).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..kernels._library import on_card
from ..kernels.fake_quant import fake_quant_kernel
from .fakequant import (expand_group_scale, fake_quant, fake_quant_act,
                        pack_int4, quantize, unpack_int4)
from .mmse import apq_scales, ppq_scale, ppq_scale_grouped
from .qconfig import QuantConfig

Params = dict[str, Any]


def swr_layout_kind(w: torch.Tensor, log_swr: torch.Tensor) -> str:
    """Layout kind from the shapes: ``w.ndim - log_swr.ndim`` is 2 for
    layerwise, 1 for channel, 0 for group (stacked axes shift both)."""
    diff = w.ndim - log_swr.ndim
    if not 0 <= diff <= 2:
        raise ValueError(f"log_swr {tuple(log_swr.shape)} does not fit "
                         f"w {tuple(w.shape)}")
    return ("group", "channel", "layerwise")[diff]


# ---------------------------------------------------------------------------
# Stream (activation quant point) — owns the S_a vector DoF.
# ---------------------------------------------------------------------------

def init_stream(dim: int, a_scale: float = 1.0 / 16.0, lead: tuple = (),
                device=None) -> Params:
    """A quantization point on an activation stream of width ``dim``."""
    shape = tuple(lead) + (dim,)
    return {"log_sa": torch.full(shape, math.log(a_scale),
                                 dtype=torch.float32, device=device),
            "zp": torch.zeros(shape, dtype=torch.float32, device=device)}


def stream_fake_quant(x: torch.Tensor, stream: Params,
                      cfg: QuantConfig) -> torch.Tensor:
    """A-bit fake quantization at a stream point (no-op in permissive mode)."""
    if not cfg.act_quant:
        return x
    scale = torch.exp(stream["log_sa"]).to(x.dtype)
    return fake_quant_act(x, scale, cfg.a_bits,
                          zero_point=stream["zp"].to(x.dtype))


# ---------------------------------------------------------------------------
# Quantized linear — offline subgraph for the kernel.
# ---------------------------------------------------------------------------

def randn(shape: tuple, gen) -> torch.Tensor:
    """Standard normal f32 draws from ``gen`` on its device; on the meta
    device (a shape-only skeleton) nothing is drawn."""
    dev = gen.device
    return torch.randn(shape, generator=None if dev.type == "meta" else gen,
                       device=dev, dtype=torch.float32)


def init_qlinear(gen: torch.Generator, d_in: int, d_out: int,
                 cfg: QuantConfig | None, bias: bool = False,
                 w_bits: int | None = None, name: str | None = None,
                 lead: tuple = ()) -> Params:
    """Master weights + scale DoF on ``gen``'s device.  ``w_bits``
    overrides ``cfg.w_bits`` (exempt layers, the head); ``name`` keys the
    bare-name layout overrides of ``cfg``; the layout fixes the
    ``log_swr`` shape."""
    lead = tuple(lead)
    dev = gen.device
    std = d_in ** -0.5
    p: Params = {"w": randn(lead + (d_in, d_out), gen) * std}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=torch.float32, device=dev)
    if cfg is not None:
        bits = w_bits or cfg.w_bits
        layout = cfg.layout_for(name)
        p["log_swr"] = torch.full(
            lead + layout.swr_shape(d_in, d_out),
            math.log(std / (2 ** (bits - 1) - 1)), dtype=torch.float32,
            device=dev)
    return p


def _swr_dense(p: Params) -> torch.Tensor:
    """exp(log_swr) broadcastable against ``w`` under any layout."""
    w, log_swr = p["w"], p["log_swr"]
    kind = swr_layout_kind(w, log_swr)
    if kind == "layerwise":
        s = torch.exp(log_swr)
        return s[..., None, None] if log_swr.ndim else s
    if kind == "channel":
        return torch.exp(log_swr)[..., None, :]
    return expand_group_scale(torch.exp(log_swr), w.shape[-2], axis=-2)


def weight_scale(p: Params, log_sa_in: torch.Tensor | None) -> torch.Tensor:
    """S_w = S_wL ⊗ S_wR with S_wL = 1/S_a_in (Eq. 2)."""
    s_wr = _swr_dense(p)
    if log_sa_in is None:
        return (torch.broadcast_to(s_wr, p["w"].shape) if p["w"].ndim >= 3
                else s_wr)
    s_wl = torch.exp(-log_sa_in)[..., :, None]
    while s_wl.ndim < p["w"].ndim:
        s_wl = s_wl.unsqueeze(-3)
    return s_wl * s_wr


def weight_fake_quant(w: torch.Tensor, s: torch.Tensor, bits: int,
                      use_kernels: bool = False) -> torch.Tensor:
    """Signed fake-quant of a weight: a CUDA weight with ``use_kernels``
    goes through the ``fake_quant`` kernel under the ``"ste"`` rule (the
    gradient of the plain composition) — a stacked ``[..., in, out]`` one
    in one launch, as the ``[prod(...)·in, out]`` view with its scale
    broadcast to the weight's shape; anything else through the plain
    composition.  The forward is the same bits either way."""
    if not (use_kernels and on_card(w)):
        return fake_quant(w, s, bits, signed=True)
    if w.ndim == 2:
        return fake_quant_kernel(w, s, bits, rule="ste")
    if w.ndim < 2:
        raise ValueError(f"a weight has at least 2 dims, got {tuple(w.shape)}")
    C = w.shape[-1]
    y = fake_quant_kernel(w.reshape(-1, C),
                          torch.broadcast_to(s, w.shape).reshape(-1, C),
                          bits, rule="ste")
    return y.reshape(w.shape)


def effective_weight(p: Params, cfg: QuantConfig | None,
                     log_sa_in: torch.Tensor | None = None,
                     compute_dtype=torch.bfloat16,
                     bits: int | None = None,
                     use_kernels: bool = False) -> torch.Tensor:
    """The fake-quantized (deploy-equivalent) weight; ``cfg=None`` is the FP
    path (teacher, deploy view)."""
    w = p["w"]
    if cfg is None:
        return w.to(compute_dtype)
    s = weight_scale(p, log_sa_in)
    return weight_fake_quant(w, s, bits or cfg.w_bits,
                             use_kernels).to(compute_dtype)


def qlinear(x: torch.Tensor, p: Params, cfg: QuantConfig | None,
            stream: Params | None = None,
            bits: int | None = None,
            use_kernels: bool = False) -> torch.Tensor:
    """``y = x̂ @ W_eff + b``; ``stream`` supplies both the activation
    fake-quant and S_wL (paper Appendix D)."""
    log_sa = None
    if stream is not None and cfg is not None:
        x = stream_fake_quant(x, stream, cfg)
        log_sa = stream["log_sa"]
    w_eff = effective_weight(p, cfg, log_sa, compute_dtype=x.dtype, bits=bits,
                             use_kernels=use_kernels)
    y = torch.matmul(x, w_eff)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# MMSE initialization (the paper's sole pre-QFT step, §4)
# ---------------------------------------------------------------------------

def _log_scale(s: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(s, min=1e-12))


def mmse_init_qlinear(p: Params, cfg: QuantConfig, bits: int | None = None,
                      log_sa_in: torch.Tensor | None = None) -> Params:
    """``log_swr`` from MMSE, inverting Eq. 2: the fit runs on the
    pre-scaled kernel ``W ⊙ S_a[:, None]`` because the total scale is
    ``S_wL ⊗ S_wR`` with ``S_wL = 1/S_a``.  The fit granularity is read off
    the existing ``log_swr`` shape (layerwise → scalar PPQ, channel →
    per-out-channel PPQ, group → per-(in-group, out) PPQ); a stacked
    (``[E, in, out]``) weight is fitted per leading index."""
    w = p["w"]
    bits = bits or cfg.w_bits
    kind = swr_layout_kind(w, p["log_swr"])
    if log_sa_in is not None:
        w = w * torch.exp(log_sa_in)[..., :, None]

    def one(wm):
        if kind == "group":
            s = ppq_scale_grouped(wm, bits, p["log_swr"].shape[-2],
                                  iters=cfg.mmse_iters)
        elif kind == "channel":
            s = ppq_scale(wm, bits, axes=(0,), iters=cfg.mmse_iters)[0]
        else:
            s = ppq_scale(wm, bits, axes=None,
                          iters=cfg.mmse_iters).reshape(())
        return _log_scale(s)

    log_swr = (torch.stack([one(wm) for wm in w]) if w.ndim == 3
               else one(w))
    return {**p, "log_swr": log_swr.to(torch.float32)}


def apq_init_qlinear(p: Params, cfg: QuantConfig, bits: int | None = None
                     ) -> tuple[Params, torch.Tensor]:
    """Doubly-channelwise init via APQ (Alg. 2) → ``(params, log_swl)``; the
    caller folds ``log_swl`` into the input stream (``log_sa = -log_swl``).

    Non-channel layouts keep APQ's rows × columns alternation for the left
    scale, then refit the right factor at the layer's layout resolution
    (PPQ over ``W / S_wL``), so the ``log_swr`` shape is preserved.  A
    stacked (``[E, in, out]``) weight shares one left scale, the geometric
    mean over the leading index."""
    w = p["w"]
    bits = bits or cfg.w_bits
    kind = swr_layout_kind(w, p["log_swr"])

    def refit(wm, log_swl):
        wn = wm / torch.exp(log_swl)[:, None]
        if kind == "group":
            s = ppq_scale_grouped(wn, bits, p["log_swr"].shape[-2],
                                  iters=cfg.mmse_iters)
        else:
            s = ppq_scale(wn, bits, axes=None,
                          iters=cfg.mmse_iters).reshape(())
        return _log_scale(s)

    if w.ndim == 3:
        st = [apq_scales(we, bits, cfg.mmse_iters) for we in w]
        s = torch.stack([a for a, _ in st])
        t = torch.stack([b for _, b in st])
        log_swl = torch.mean(torch.log(s[..., 0]), dim=0)
        log_swr = (torch.log(t[:, 0, :]) if kind == "channel"
                   else torch.stack([refit(we, log_swl) for we in w]))
    else:
        s, t = apq_scales(w, bits, iters=cfg.mmse_iters)
        log_swl = torch.log(s[:, 0])
        log_swr = (torch.log(t[0, :]) if kind == "channel"
                   else refit(w, log_swl))
    return ({**p, "log_swr": log_swr.to(torch.float32)},
            log_swl.to(torch.float32))


# ---------------------------------------------------------------------------
# Deployment export — the offline computation run once.
# ---------------------------------------------------------------------------

#: elements of a weight quantized at once in the export (its row blocks
#: bound the f32 temporaries: command-r-plus's [12288, 256000] head would
#: otherwise take several 11.7 GiB copies beside the f32 masters)
_EXPORT_BLOCK = 1 << 26


def export_qlinear(p: Params, cfg: QuantConfig,
                   log_sa_in: torch.Tensor | None = None,
                   pack: bool = True, bits: int | None = None) -> Params:
    """Freeze the offline subgraph: ``{q (nibble-packed uint8 | int8),
    s_wl?, s_wr, b?}``; ``s_wr`` carries the layout in its shape.  The
    integer grid is computed in blocks of rows (elementwise, so the bits
    are the whole weight's)."""
    bits = bits or cfg.w_bits
    w = p["w"]
    s = torch.broadcast_to(weight_scale(p, log_sa_in), w.shape)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    rows = max(_EXPORT_BLOCK // max(w[..., :1, :].numel(), 1), 1)
    for a in range(0, w.shape[-2], rows):
        q[..., a:a + rows, :] = quantize(w[..., a:a + rows, :],
                                         s[..., a:a + rows, :], bits,
                                         signed=True).to(torch.int8)
    out: Params = {}
    if bits == 4 and pack and p["w"].shape[-2] % 2 == 0:
        out["q"] = pack_int4(q, axis=-2)
    else:
        out["q"] = q
    if log_sa_in is not None:
        out["s_wl"] = torch.exp(-log_sa_in).to(torch.float32)
    out["s_wr"] = torch.exp(p["log_swr"]).to(torch.float32)
    if "b" in p:
        out["b"] = p["b"].to(torch.float32)
    return out


def dequantize_export(ex: Params, compute_dtype=torch.bfloat16,
                      packed: bool = True) -> torch.Tensor:
    """Reference decode of an exported linear.  The total scale S_wL ⊗ S_wR
    is assembled in f32 before touching q — the grouping of
    weight_scale/fake_quant — so it is bit-exact against effective_weight."""
    q = ex["q"]
    if packed and q.dtype == torch.uint8:
        q = unpack_int4(q, axis=-2)
    w = q.to(torch.float32)
    s_wr = ex["s_wr"]
    if s_wr.ndim == w.ndim - 2:          # scalar per (stacked) linear
        s = s_wr[..., None, None]
    elif s_wr.ndim == w.ndim:            # group: [..., in/g, out]
        s = expand_group_scale(s_wr, w.shape[-2], axis=-2)
    else:                                # per-out-channel
        s = s_wr[..., None, :]
    if ex.get("s_wl") is not None:
        s_wl = ex["s_wl"][..., :, None]
        while s_wl.ndim < w.ndim:
            s_wl = s_wl.unsqueeze(-3)
        s = s_wl * s
    return (w * s).to(compute_dtype)
