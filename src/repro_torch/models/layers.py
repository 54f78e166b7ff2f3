"""Shared layer primitives, quantization-aware through ``core.dof``.

Every linear goes through ``core.dof.qlinear``; ``qcfg=None`` is the FP path
(teacher, deploy view) through the same code.  Parameter dicts keep the JAX
package's layout; ``lead`` prepends stacked axes.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..core import dof
from ..core.plan import plan_view
from ..core.qconfig import QuantConfig

Params = dict[str, Any]


def tap(taps: dict | None, name: str, x: torch.Tensor) -> None:
    """Record per-channel ``{min, max, mean}`` (f32) of ``x`` under ``name``
    when ``taps`` is a dict (calibration; no graph is kept)."""
    if taps is None:
        return
    xf = x.detach().to(torch.float32).reshape(-1, x.shape[-1])
    taps[name] = {"min": torch.amin(xf, 0), "max": torch.amax(xf, 0),
                  "mean": torch.mean(xf, 0)}


def init_rmsnorm(dim: int, lead: tuple = (), device=None) -> Params:
    return {"g": torch.ones(tuple(lead) + (dim,), dtype=torch.float32,
                            device=device)}


def rmsnorm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["g"]).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (int)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * freqs      # [B, S, hd/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xf1 = x[..., : hd // 2].to(torch.float32)
    xf2 = x[..., hd // 2:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen: torch.Generator, d: int, ff: int,
             qcfg: QuantConfig | None, bias: bool, lead: tuple = ()) -> Params:
    """SwiGLU MLP: up, down, gate and (student) the two stream DoF."""
    p: Params = {
        "up": dof.init_qlinear(gen, d, ff, qcfg, bias=bias, name="up",
                               lead=lead),
        "down": dof.init_qlinear(gen, ff, d, qcfg, bias=bias, name="down",
                                 lead=lead),
        "gate": dof.init_qlinear(gen, d, ff, qcfg, bias=bias, name="gate",
                                 lead=lead),
    }
    if qcfg is not None:
        p["in_stream"] = dof.init_stream(d, lead=lead, device=gen.device)
        p["act_stream"] = dof.init_stream(ff, lead=lead, device=gen.device)
    return p


def mlp(x: torch.Tensor, p: Params, qcfg: QuantConfig | None,
        plan=None, taps: dict | None = None, prefix: str = "",
        use_kernels: bool = False) -> torch.Tensor:
    """SwiGLU forward; ``plan`` (scoped to e.g. ``layers.mlp``) supplies
    per-path fake-quant bits; ``taps`` records ``{prefix}.act``;
    ``use_kernels`` routes the weights' fake-quant through the kernel."""
    pv = plan_view(plan)
    ins = p.get("in_stream")
    up = dof.qlinear(x, p["up"], qcfg, stream=ins, bits=pv.bits("up"),
                     use_kernels=use_kernels)
    gate = dof.qlinear(x, p["gate"], qcfg, stream=ins, bits=pv.bits("gate"),
                       use_kernels=use_kernels)
    h = torch.nn.functional.silu(gate) * up
    tap(taps, prefix + ".act", h)
    return dof.qlinear(h, p["down"], qcfg, stream=p.get("act_stream"),
                       bits=pv.bits("down"), use_kernels=use_kernels)


def init_embed(gen: torch.Generator, vocab: int, d: int,
               qcfg: QuantConfig | None) -> Params:
    p: Params = {"w": dof.randn((vocab, d), gen) * 0.02}
    if qcfg is not None:
        # per-row (token) scale: embedding tables quantize at embed_bits
        p["log_s"] = torch.full((vocab, 1), math.log(0.02 / 127.0),
                                dtype=torch.float32, device=gen.device)
    return p


def embed_lookup(tokens: torch.Tensor, p: Params, qcfg: QuantConfig | None,
                 dtype=torch.bfloat16, use_kernels: bool = False) -> torch.Tensor:
    """Rows of the (student: per-row fake-quantized) table; the
    fake-quant takes the weights' route (``core.dof.weight_fake_quant``)."""
    w = p["w"]
    if qcfg is not None:
        w = dof.weight_fake_quant(w, torch.exp(p["log_s"]), qcfg.embed_bits,
                                  use_kernels)
    return w[tokens].to(dtype)
