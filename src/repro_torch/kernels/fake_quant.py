"""Fused fake-quantization: the wrapper of ``csrc/fake_quant.cu``.

Replaces the Pallas kernel ``_fq_kernel`` of the JAX package and its custom
VJP (``fake_quant_kernel``): ``clip(round(x/s), ±qmax)·s`` over a 2-D
``x [R, C]`` (f32/bf16) with a scale of shape ``[R, C]``, ``[R, 1]``,
``[1, C]``, ``[C]`` or ``[]``, read at its own shape (the reference
broadcast it to ``[R, C]`` first).  The backward is a kernel too, under one
of two rules (``kernels.ref.fake_quant_grad_ref``): ``"kernel"`` is the
reference kernel's VJP, ``"ste"`` the gradient of the plain composition
``core.fakequant.fake_quant`` — the one the QFT trainer differentiates.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import _RULES, fake_quant_grad_ref, fake_quant_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# scale shapes, as csrc/fake_quant.cu numbers them
_FULL, _ROW, _COL, _SCALAR = 0, 1, 2, 3
ROW_CHUNK = 64          # rows per column-partial block (kRowChunk)


def _fwd_signature(lib: ctypes.CDLL):
    fn = lib.qft_fake_quant_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bwd_signature(lib: ctypes.CDLL):
    fn = lib.qft_fake_quant_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scale_layout(s: torch.Tensor) -> tuple[int, int, int]:
    """(mode, row stride, column stride) of a 2-D scale; a broadcast axis
    (size 1) gets stride 0."""
    rs = 0 if s.shape[0] == 1 else s.stride(0)
    cs = 0 if s.shape[1] == 1 else s.stride(1)
    mode = {(False, False): _FULL, (False, True): _ROW, (True, False): _COL,
            (True, True): _SCALAR}[(s.shape[0] == 1, s.shape[1] == 1)]
    return mode, rs, cs


def fake_quant_fwd(x: torch.Tensor, s: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """Launch the forward kernel: CUDA ``x [R, C]``, 2-D f32 scale ``s``
    (``[R|1, C|1]``)."""
    R, C = x.shape
    _, rs, cs = _scale_layout(s)
    y = torch.empty_like(x)
    fn = _fwd_signature(_build.load("fake_quant"))
    rc = fn(x.data_ptr(), s.data_ptr(), y.data_ptr(), R, C, rs, cs, bits,
            _DTYPES[x.dtype], _build.stream_ptr(x))
    _build.check(rc, "fake_quant forward")
    fake_quant_kernel.launches_fwd += 1
    return y


def fake_quant_bwd(g: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
                   bits: int, rule: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel → ``(gx, gs)``, ``gs`` at ``s``'s 2-D
    shape in f32."""
    R, C = x.shape
    mode, rs, cs = _scale_layout(s)
    g = g.to(x.dtype).contiguous()
    gx = torch.empty_like(x)
    gs = torch.empty(s.shape, dtype=torch.float32, device=x.device)
    partial = None
    if mode in (_COL, _SCALAR):
        partial = torch.empty((-(-R // ROW_CHUNK), C), dtype=torch.float32,
                              device=x.device)
    fn = _bwd_signature(_build.load("fake_quant"))
    rc = fn(g.data_ptr(), x.data_ptr(), s.data_ptr(), gx.data_ptr(),
            gs.data_ptr(), None if partial is None else partial.data_ptr(),
            R, C, rs, cs, bits, _DTYPES[x.dtype], _RULES.index(rule), mode,
            _build.stream_ptr(x))
    _build.check(rc, "fake_quant backward")
    fake_quant_kernel.launches_bwd += 1
    return gx, gs


class _FakeQuant(torch.autograd.Function):
    """Forward and backward on the card; the plain versions for CPU
    tensors.  Saves ``x`` itself (no copy) and the scale."""

    @staticmethod
    def forward(ctx, x, s, bits: int, rule: str):
        ctx.save_for_backward(x, s)
        ctx.bits, ctx.rule = bits, rule
        if x.device.type == "cpu":
            return fake_quant_ref(x, s, bits)
        return fake_quant_fwd(x, s, bits)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        if x.device.type == "cpu":
            gx, gs = fake_quant_grad_ref(g, x, s, ctx.bits, ctx.rule)
        else:
            gx, gs = fake_quant_bwd(g, x, s, ctx.bits, ctx.rule)
        return gx, gs, None, None


def fake_quant_kernel(x: torch.Tensor, scale: torch.Tensor, bits: int = 4,
                      rule: str = "kernel") -> torch.Tensor:
    """Fake-quantize ``x [R, C]`` on the card (CUDA tensors) or through the
    plain versions (CPU tensors); differentiable in ``x`` and ``scale``
    under ``rule``.  Output in x's type; the scale's gradient in its type
    and shape."""
    if x.ndim != 2 or x.dtype not in _DTYPES:
        raise ValueError(f"fake_quant_kernel takes a 2-D f32/bf16 x, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if rule not in _RULES:
        raise ValueError(f"rule must be one of {_RULES}, got {rule!r}")
    if scale.ndim > 2:
        raise ValueError(f"scale {tuple(scale.shape)} has more than 2 dims")
    s = scale.reshape((1,) * (2 - scale.ndim) + tuple(scale.shape))
    if s.shape[0] not in (1, x.shape[0]) or s.shape[1] not in (1, x.shape[1]):
        raise ValueError(f"scale {tuple(scale.shape)} does not broadcast to "
                         f"x {tuple(x.shape)}")
    devices = {x.device, s.device}
    if devices != {torch.device("cpu")}:
        if len(devices) != 1 or x.device.type != "cuda":
            raise RuntimeError(
                f"fake_quant_kernel runs on one CUDA device or on the CPU; "
                f"got tensors on {sorted(map(str, devices))}")
        if not x.is_contiguous():
            raise ValueError("fake_quant_kernel needs a contiguous x")
    return _FakeQuant.apply(x, s.to(torch.float32), bits, rule)


fake_quant_kernel.launches_fwd = 0
fake_quant_kernel.launches_bwd = 0
