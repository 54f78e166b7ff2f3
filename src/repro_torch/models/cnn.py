"""Paper-faithful CNN path: quantized convolutions exactly as analyzed in the
paper (Fig. 2): kernel scale = S_wL[c_in] ⊗ S_wR[c_out], spatially invariant
(footnote 1), streams on every conv input, backbone features = pre-pooling
activations (the paper's distillation point).  BatchNorm is assumed folded.

The layouts are the JAX package's at every API: NHWC activations and HWIO
``[kh, kw, cin, cout]`` weights, so plans, checkpoints and converted trees
carry over unchanged; only the convolution itself (``F.conv2d``) sees NCHW.
With ``use_kernels``, a CUDA conv weight's fake-quant runs through the
``fake_quant`` kernel as one ``[kh·kw, cin·cout]`` view with a per-column
scale: one launch per conv forward and one per backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..core import dof
from ..core.fakequant import fake_quant, pack_int4, quantize
from ..core.mmse import apq_scales, ppq_scale
from ..core.plan import PLAN_KEY, plan_to_array
from ..core.qconfig import QuantConfig
from ..device import resolve_device
from ..kernels._library import on_card
from ..kernels.fake_quant import fake_quant_kernel
from .layers import tap
from .transformer import _ShapeOnly

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    channels: tuple[int, ...] = (16, 32, 64)
    n_classes: int = 10
    img_hw: int = 16
    in_ch: int = 3
    kernel: int = 3
    family: str = "cnn"


def init_qconv(gen, kh: int, kw: int, cin: int, cout: int,
               cfg: QuantConfig | None) -> Params:
    """An HWIO kernel drawn from ``gen`` on its device, zero bias, and (a
    student) the recode factor F̂ of Eq. 2: scalar for layerwise, ``[cout]``
    for channelwise right scales."""
    dev = gen.device
    std = (kh * kw * cin) ** -0.5
    p: Params = {"w": dof.randn((kh, kw, cin, cout), gen) * std,
                 "b": torch.zeros((cout,), dtype=torch.float32, device=dev)}
    if cfg is not None:
        p["log_f"] = torch.zeros((cout,) if cfg.swr_per_channel else (),
                                 dtype=torch.float32, device=dev)
    return p


def conv_weight_scale(p: Params, log_sa_in: torch.Tensor | None,
                      log_sa_out: torch.Tensor | None) -> torch.Tensor:
    """Full Eq. 2 coupling: S_w = (1/S_a_in)[c_in] ⊗ (S_a_out·F̂)[c_out], as
    ``[1, 1, cin or 1, cout or 1]``.  Both stream scales are DoF shared with
    the neighbouring convs (the CLE coupling, Corollary 1)."""
    log_f = p["log_f"]
    log_f = log_f if log_f.ndim else log_f[None]
    log_swr = log_f + (log_sa_out if log_sa_out is not None else 0.0)
    s = torch.exp(log_swr)[None, None, None, :]
    if log_sa_in is not None:
        s = s * torch.exp(-log_sa_in)[None, None, :, None]
    return s


def conv_fake_quant_kernel(w: torch.Tensor, s: torch.Tensor,
                           bits: int) -> torch.Tensor:
    """Signed fake-quant of an HWIO kernel through ``fake_quant_kernel``:
    ``w`` viewed as ``[kh·kw, cin·cout]``, the scale broadcast to
    ``[cin, cout]`` and viewed as one row ``[1, cin·cout]`` (the spatial
    taps share it), under the ``"ste"`` rule — the gradient of the plain
    composition.  The kernel on the card for CUDA tensors, its plain
    version on the CPU."""
    kh, kw, cin, cout = w.shape
    s2 = torch.broadcast_to(s.reshape(s.shape[-2:]), (cin, cout))
    y = fake_quant_kernel(w.reshape(kh * kw, cin * cout),
                          s2.reshape(1, cin * cout), bits, rule="ste")
    return y.reshape(kh, kw, cin, cout)


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: the output has
    ``ceil(size / stride)`` positions, the extra row (if any) after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor,
                stride: int = 1) -> torch.Tensor:
    """``jax.lax.conv_general_dilated(x, w, (s, s), "SAME", ("NHWC",
    "HWIO", "NHWC"))``: NHWC in and out, HWIO kernel."""
    kh, kw = w.shape[:2]
    ph, pw = _same_pad(x.shape[1], kh, stride), _same_pad(x.shape[2], kw,
                                                           stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def qconv(x: torch.Tensor, p: Params, cfg: QuantConfig | None,
          stream: Params | None = None, stream_out: Params | None = None,
          stride: int = 1, bits: int | None = None,
          use_kernels: bool = False) -> torch.Tensor:
    log_sa = None
    if stream is not None and cfg is not None:
        x = dof.stream_fake_quant(x, stream, cfg)
        log_sa = stream["log_sa"]
    log_sa_out = (None if (stream_out is None or cfg is None)
                  else stream_out["log_sa"])
    w = p["w"]
    if cfg is not None:
        s = conv_weight_scale(p, log_sa, log_sa_out)
        w = (conv_fake_quant_kernel(w, s, bits or cfg.w_bits)
             if use_kernels and on_card(w)
             else fake_quant(w, s, bits or cfg.w_bits))
    y = conv2d_same(x, w.to(x.dtype), stride)
    return y + p["b"].to(y.dtype)


def mmse_init_qconv(p: Params, cfg: QuantConfig,
                    log_sa_in: torch.Tensor | None = None,
                    log_sa_out: torch.Tensor | None = None,
                    bits: int | None = None) -> Params:
    """Fit F̂ by inverting Eq. 2 (paper §4): the total grid is
    S_wL ⊗ (S_a_out·F̂); PPQ runs on W' = W·S_a_in[c_in]/S_a_out[c_out].
    ``bits``: static per-conv override from the quant plan."""
    w = p["w"]
    bits = bits or cfg.w_bits
    if log_sa_in is not None:
        w = w * torch.exp(log_sa_in)[None, None, :, None]
    if log_sa_out is not None:
        w = w / torch.exp(log_sa_out)[None, None, None, :]
    w2 = w.reshape(-1, w.shape[-1])
    if cfg.swr_per_channel:
        f = ppq_scale(w2, bits, axes=(0,), iters=cfg.mmse_iters)[0]
    else:
        f = ppq_scale(w2, bits, axes=None, iters=cfg.mmse_iters).reshape(())
    return {**p, "log_f": torch.log(torch.clamp(f, min=1e-12))}


def apq_init_qconv(p: Params, cfg: QuantConfig, bits: int | None = None
                   ) -> tuple[Params, torch.Tensor]:
    """Doubly-channelwise init: APQ over the ``[kh·kw·cin, cout]`` view; the
    per-(spatial, cin) row scale is averaged over the spatial taps (in the
    log domain), which share the c_in scale (HW invariance)."""
    kh, kw, cin, cout = p["w"].shape
    s, t = apq_scales(p["w"].reshape(-1, cout), bits or cfg.w_bits,
                      iters=cfg.mmse_iters)
    log_swl_full = torch.log(s[:, 0]).reshape(kh, kw, cin)
    log_swl = torch.mean(log_swl_full, dim=(0, 1))
    return ({**p, "log_f": torch.log(t[0, :])}, log_swl)


def conv_effective_weight(p: Params, cfg: QuantConfig,
                          log_sa_in: torch.Tensor | None = None,
                          log_sa_out: torch.Tensor | None = None,
                          compute_dtype=torch.float32,
                          bits: int | None = None) -> torch.Tensor:
    """The fake-quantized (deploy-equivalent) conv kernel — the export
    oracle, through the plain composition."""
    s = conv_weight_scale(p, log_sa_in, log_sa_out)
    return fake_quant(p["w"], s, bits or cfg.w_bits).to(compute_dtype)


def export_qconv(p: Params, cfg: QuantConfig,
                 log_sa_in: torch.Tensor | None = None,
                 log_sa_out: torch.Tensor | None = None,
                 pack: bool = True, bits: int | None = None) -> Params:
    """Freeze a conv's offline subgraph into ``{q, s_wl?, s_wr, b}``: the
    artifact schema of ``dof.export_qlinear`` (q ``[kh, kw, cin(/2),
    cout]``), so ``dof.dequantize_export`` decodes it unchanged."""
    bits = bits or cfg.w_bits
    s = conv_weight_scale(p, log_sa_in, log_sa_out)
    q = quantize(p["w"], s, bits, signed=True).to(torch.int8)
    out: Params = {}
    if bits == 4 and pack and p["w"].shape[-2] % 2 == 0:
        out["q"] = pack_int4(q, axis=-2)
    else:
        out["q"] = q
    if log_sa_in is not None:
        out["s_wl"] = torch.exp(-log_sa_in).to(torch.float32)
    log_f = p["log_f"]
    log_f = log_f if log_f.ndim else log_f[None]
    log_swr = log_f + (log_sa_out if log_sa_out is not None else 0.0)
    out["s_wr"] = torch.exp(torch.broadcast_to(
        log_swr, (p["w"].shape[-1],))).to(torch.float32)
    out["b"] = p["b"].to(torch.float32)
    return out


def _conv_stream_scales(params: Params, i: int):
    """(log_sa_in, log_sa_out) for conv i under the Eq. 2 stream chaining."""
    n = len(params["convs"])
    st_out = (params["streams"][i + 1] if i + 1 < n
              else params.get("fc_stream"))
    log_in = params["streams"][i].get("log_sa")
    log_out = None if st_out is None else st_out.get("log_sa")
    return log_in, log_out


@torch.no_grad()
def export_cnn(params: Params, plan) -> Params:
    """Whole-model CNN export under a ``serve.deploy.DeployPlan``, on the
    student's device: per-conv bits and packing from the resolved QuantPlan
    (paths ``convs.<i>``, ``fc``); the serialized plan rides inside the
    artifact."""
    qcfg = plan.qcfg
    out: Params = {"convs": []}
    for i, conv in enumerate(params["convs"]):
        log_in, log_out = _conv_stream_scales(params, i)
        out["convs"].append(export_qconv(conv, qcfg, log_in, log_out,
                                         pack=plan.is_packed(f"convs.{i}"),
                                         bits=plan.bits_for(f"convs.{i}")))
    out["fc"] = dof.export_qlinear(
        params["fc"], qcfg, log_sa_in=params["fc_stream"]["log_sa"],
        pack=plan.is_packed("fc"), bits=plan.bits_for("fc"))
    if getattr(plan, "quant_plan", None) is not None:
        out[PLAN_KEY] = plan_to_array(plan.quant_plan,
                                      device=params["fc"]["w"].device)
    return out


def cnn_deploy_view(exported: Params, plan,
                    dtype=torch.float32) -> Params:
    """Exported CNN artifact → forward_cnn()-compatible tree (qcfg=None).
    Packing is read off each q leaf's dtype (uint8 ⇔ nibble-packed), the
    artifact's own ground truth."""
    def deq(ex):
        return dof.dequantize_export(ex, dtype,
                                     packed=ex["q"].dtype == torch.uint8)
    convs = [{"w": deq(ex), "b": ex["b"]} for ex in exported["convs"]]
    fc_ex = exported["fc"]
    return {"convs": convs, "streams": [{} for _ in convs],
            "fc": {"w": deq(fc_ex), "b": fc_ex["b"]}}


@torch.no_grad()
def cnn_effective_view(params: Params, plan,
                       dtype=torch.float32) -> Params:
    """Fake-quant weights in cnn_deploy_view's structure (the export parity
    oracle)."""
    qcfg = plan.qcfg
    convs = []
    for i, conv in enumerate(params["convs"]):
        log_in, log_out = _conv_stream_scales(params, i)
        convs.append({"w": conv_effective_weight(
            conv, qcfg, log_in, log_out, dtype,
            bits=plan.bits_for(f"convs.{i}")), "b": conv["b"]})
    return {"convs": convs, "streams": [{} for _ in convs],
            "fc": {"w": dof.effective_weight(
                params["fc"], qcfg, params["fc_stream"]["log_sa"],
                compute_dtype=dtype, bits=plan.bits_for("fc")),
                   "b": params["fc"]["b"]}}


def init_cnn(gen: torch.Generator | int, ccfg: CNNConfig,
             qcfg: QuantConfig | None, device=None) -> Params:
    """Random parameters from ``gen`` (or a seed) on ``device`` (``None`` →
    the card; ``"meta"`` → a skeleton of shapes, nothing drawn)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = _ShapeOnly()
    elif isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    elif gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device} but device {dev}")
    cin = ccfg.in_ch
    convs, streams = [], []
    for cout in ccfg.channels:
        convs.append(init_qconv(gen, ccfg.kernel, ccfg.kernel, cin, cout,
                                qcfg))
        streams.append({} if qcfg is None
                       else dof.init_stream(cin, device=dev))
        cin = cout
    params: Params = {"convs": convs, "streams": streams}
    params["fc"] = dof.init_qlinear(
        gen, cin, ccfg.n_classes, qcfg, bias=True, name="fc",
        w_bits=None if qcfg is None else qcfg.exempt_bits)
    if qcfg is not None:
        params["fc_stream"] = dof.init_stream(cin, device=dev)
    return params


def forward_cnn(params: Params, ccfg: CNNConfig, qcfg: QuantConfig | None,
                x: torch.Tensor, collect_taps: bool = False, plan=None,
                use_kernels: bool = False,
                logits: bool = True) -> dict[str, Any]:
    """x: ``[B, H, W, C]``.  Returns ``{features (pre-pool), pooled, logits,
    taps}``.

    ``plan`` (a ``core.plan.QuantPlan``) supplies per-tensor fake-quant bits
    (paths ``convs.<i>``, ``fc``) so training matches what exports; without
    it the role defaults apply (convs at w_bits, fc exempt).
    ``use_kernels`` routes the weights' fake-quant through the kernel.
    ``logits=False`` skips the fc (``logits`` is then None), as XLA drops
    it from a step whose loss reads only the features."""
    taps: dict | None = {} if collect_taps else None
    n_convs = len(params["convs"])

    def _bits(path: str, default: int) -> int | None:
        if qcfg is None:
            return None
        return plan.bits_for(path) if plan is not None else default

    for i, (cp, st) in enumerate(zip(params["convs"], params["streams"])):
        tap(taps, f"conv{i}.in", x)
        if qcfg is None:
            st_out = None
        elif i + 1 < n_convs:
            st_out = params["streams"][i + 1]      # chained (Eq. 2)
        else:
            st_out = params.get("fc_stream")
        x = qconv(x, cp, qcfg, stream=st if qcfg is not None else None,
                  stream_out=st_out, stride=2 if i else 1,
                  bits=_bits(f"convs.{i}", None if qcfg is None
                             else qcfg.w_bits),
                  use_kernels=use_kernels)
        x = torch.relu(x)
        tap(taps, f"conv{i}.out", x)
    feats = x                                # backbone output (KD point)
    pooled = torch.mean(x, dim=(1, 2))       # global average pool
    out = None
    if logits:
        out = dof.qlinear(pooled, params["fc"], qcfg,
                          stream=params.get("fc_stream"),
                          bits=_bits("fc", None if qcfg is None
                                     else qcfg.exempt_bits),
                          use_kernels=use_kernels)
    return {"features": feats, "pooled": pooled, "logits": out,
            "taps": taps}
