"""Fused fake-quantization: the wrappers of ``csrc/fake_quant.cu``.

Replaces the Pallas kernel ``_fq_kernel`` of the JAX package and its custom
VJP (``fake_quant_kernel``): ``clip(round(x/s), ±qmax)·s``.  Two entries:

- :func:`fake_quant_factored`, the weights' route
  (``core.dof.effective_weight``): the f32 master ``w [..., in, out]`` with
  the two factors of its scale, ``S_wL`` (``[in]``, or one a stacked
  weight, or None) and ``S_wR`` in ``log_swr``'s shape, formed into
  ``S_wL ⊗ S_wR`` inside the kernel; the output in the compute type; the
  backward writes ``gx`` and both factors' gradients under the ``"ste"``
  rule.  A shape outside its index form (:func:`factored_geometry` says
  which) takes the broadcast entry, chosen before the launch.
- :func:`fake_quant_kernel`, the broadcast entry: a 2-D ``x [R, C]``
  (f32/bf16) with a materialised scale of shape ``[R, C]``, ``[R, 1]``,
  ``[1, C]``, ``[C]`` or ``[]``, read at its own shape (the reference
  broadcast it to ``[R, C]`` first); the backward under one of two rules
  (``kernels.ref.fake_quant_grad_ref``): ``"kernel"`` is the reference
  kernel's VJP, ``"ste"`` the gradient of the plain composition
  ``core.fakequant.fake_quant`` — the one the QFT trainer differentiates.

Every kernel is a ``torch.library`` operator
(``repro_torch::fake_quant_fwd``, ``::fake_quant_bwd``,
``::fake_quant_factored_fwd``, ``::fake_quant_factored_bwd``), so a trace
over fake tensors records each as one node.  Both entries count on
``fake_quant_kernel.launches_fwd`` / ``launches_bwd``, once per weight a
pass; the factored entry also on ``launches_factored_fwd`` /
``launches_factored_bwd``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._library import define, on_card
from .ref import (_RULES, fake_quant_factored_ref, fake_quant_grad_ref,
                  fake_quant_ref)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CODES = {v: k for k, v in _DTYPES.items()}
# scale shapes, as csrc/fake_quant.cu numbers them
_FULL, _ROW, _COL, _SCALAR = 0, 1, 2, 3
ROW_CHUNK = 64          # rows per column-partial block (kRowChunk)
# the factored entry's tile (kTileRows x kTileCols)
TILE_ROWS, TILE_COLS = 64, 256


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
    (``[R|1, C|1]``) (the forward operator's CUDA implementation)."""
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
    shape in f32 (the backward operator's CUDA implementation, which
    takes the rule as its index in ``_RULES``)."""
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


_FWD = define("fake_quant_fwd", "(Tensor x, Tensor s, int bits) -> Tensor",
              fake_quant_fwd, lambda x, s, bits: torch.empty_like(x),
              "fake_quant")
_BWD = define("fake_quant_bwd",
              "(Tensor g, Tensor x, Tensor s, int bits, int rule) -> "
              "(Tensor, Tensor)",
              lambda g, x, s, bits, rule: fake_quant_bwd(g, x, s, bits,
                                                         _RULES[rule]),
              lambda g, x, s, bits, rule: (
                  torch.empty_like(x),
                  x.new_empty(s.shape, dtype=torch.float32)),
              "fake_quant")


class _FakeQuant(torch.autograd.Function):
    """Forward and backward on the card; the plain versions for CPU
    tensors.  Saves ``x`` itself (no copy) and the scale."""

    @staticmethod
    def forward(ctx, x, s, bits: int, rule: str):
        ctx.save_for_backward(x, s)
        ctx.bits, ctx.rule = bits, rule
        if x.device.type == "cpu":
            return fake_quant_ref(x, s, bits)
        return _FWD(x, s, bits)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        if x.device.type == "cpu":
            gx, gs = fake_quant_grad_ref(g, x, s, ctx.bits, ctx.rule)
        else:
            gx, gs = _BWD(g, x, s, ctx.bits, _RULES.index(ctx.rule))
        return gx, gs, None, None


# ---------------------------------------------------------------------------
# the factored entry
# ---------------------------------------------------------------------------

def factored_geometry(w: torch.Tensor, s_wl: torch.Tensor | None,
                      s_wr: torch.Tensor) -> tuple[int, int, int] | None:
    """``(P, g, cs)`` of the factored entry's index form for an f32 weight
    ``w [..., K, N]`` viewed as ``[R, N]``, ``R = prod(...)·K``: row ``r``
    reads ``s_wl[r mod P]`` and row ``r // g`` of ``s_wr`` viewed as
    ``[R/g, N]`` (``cs`` 1) or ``[R/g, 1]`` (``cs`` 0, layerwise) — or None
    where the form does not hold.  ``s_wl`` is ``[K]`` (shared by the
    stacked axes: ``P = K``) or ``[..., K]`` with ``w``'s stacked axes
    (``P = R``) or None; ``s_wr`` has ``log_swr``'s shape: the stacked axes,
    then nothing (layerwise), ``[N]`` (channel) or ``[K/g, N]`` (group).
    Only shapes and ``w``'s type are read."""
    if w.ndim < 2 or w.dtype != torch.float32:
        return None
    lead, (K, N) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
    kind = w.ndim - s_wr.ndim
    if kind not in (0, 1, 2) or tuple(s_wr.shape[:len(lead)]) != lead:
        return None
    rest = tuple(s_wr.shape[len(lead):])
    if (kind == 1 and rest != (N,)) or (kind == 0 and (
            len(rest) != 2 or rest[1] != N or rest[0] < 1
            or K % rest[0])):
        return None
    R = math.prod(lead) * K
    if s_wl is None:
        P = R
    elif s_wl.shape[-1:] == (K,) and tuple(s_wl.shape[:-1]) in ((), lead):
        P = K if s_wl.ndim == 1 else R
    else:
        return None
    g = K // rest[0] if kind == 0 else K
    return P, g, int(kind != 2)


def _factored_signatures(lib: ctypes.CDLL):
    fwd = lib.qft_fake_quant_factored_fwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.qft_fake_quant_factored_bwd
    bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _view_geometry(w: torch.Tensor, s_wl: torch.Tensor | None,
                   s_wr: torch.Tensor) -> tuple[int, int, int, int, int]:
    """``(R, C, P, g, cs)`` of the operators' 2-D arguments: ``w [R, C]``,
    ``s_wl [P]`` or None, ``s_wr [R/g, C|1]``."""
    R, C = w.shape
    cs = int(s_wr.shape[1] == C)
    return R, C, R if s_wl is None else s_wl.shape[0], \
        R // s_wr.shape[0], cs


def fake_quant_factored_fwd(w: torch.Tensor, s_wl: torch.Tensor | None,
                            s_wr: torch.Tensor, bits: int,
                            out_dtype: int) -> torch.Tensor:
    """Launch the factored forward on the 2-D views (the forward
    operator's CUDA implementation): ``w [R, C]`` f32, ``s_wl [P]`` f32 or
    None, ``s_wr [R/g, C|1]`` f32 → ``y [R, C]`` in ``out_dtype``'s type
    (``_DTYPES`` code)."""
    R, C, P, g, cs = _view_geometry(w, s_wl, s_wr)
    y = torch.empty((R, C), dtype=_CODES[out_dtype], device=w.device)
    fwd, _ = _factored_signatures(_build.load("fake_quant"))
    rc = fwd(w.data_ptr(), None if s_wl is None else s_wl.data_ptr(),
             s_wr.data_ptr(), y.data_ptr(), R, C, P, g, cs, bits, out_dtype,
             _build.stream_ptr(w))
    _build.check(rc, "fake_quant factored forward")
    fake_quant_kernel.launches_fwd += 1
    fake_quant_kernel.launches_factored_fwd += 1
    return y


def fake_quant_factored_bwd(gy: torch.Tensor, w: torch.Tensor,
                            s_wl: torch.Tensor | None, s_wr: torch.Tensor,
                            bits: int) -> tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Launch the factored backward (the backward operator's CUDA
    implementation) → ``(gx [R, C] f32, gs_wl [P] (empty [0] without
    s_wl), gs_wr at s_wr's shape)``; ``gy`` in the forward's output
    type."""
    R, C, P, g, cs = _view_geometry(w, s_wl, s_wr)
    dev = w.device
    gx = torch.empty((R, C), dtype=torch.float32, device=dev)
    gs_wl = torch.empty((0 if s_wl is None else P,), dtype=torch.float32,
                        device=dev)
    gs_wr = torch.empty(s_wr.shape, dtype=torch.float32, device=dev)
    n_ct = -(-C // TILE_COLS)
    chunks = (R // g) * -(-g // TILE_ROWS)
    row_part = None if s_wl is None else torch.empty(
        (n_ct, R), dtype=torch.float32, device=dev)
    col_part = torch.empty((chunks, C if cs else n_ct), dtype=torch.float32,
                           device=dev)
    _, bwd = _factored_signatures(_build.load("fake_quant"))
    rc = bwd(gy.data_ptr(), w.data_ptr(),
             None if s_wl is None else s_wl.data_ptr(), s_wr.data_ptr(),
             gx.data_ptr(), None if s_wl is None else gs_wl.data_ptr(),
             gs_wr.data_ptr(),
             None if row_part is None else row_part.data_ptr(),
             col_part.data_ptr(), R, C, P, g, cs, bits,
             _DTYPES[gy.dtype], _build.stream_ptr(w))
    _build.check(rc, "fake_quant factored backward")
    fake_quant_kernel.launches_bwd += 1
    fake_quant_kernel.launches_factored_bwd += 1
    return gx, gs_wl, gs_wr


_FFWD = define("fake_quant_factored_fwd",
               "(Tensor w, Tensor? s_wl, Tensor s_wr, int bits, "
               "int out_dtype) -> Tensor",
               fake_quant_factored_fwd,
               lambda w, s_wl, s_wr, bits, out_dtype: w.new_empty(
                   w.shape, dtype=_CODES[out_dtype]),
               "fake_quant")
_FBWD = define("fake_quant_factored_bwd",
               "(Tensor gy, Tensor w, Tensor? s_wl, Tensor s_wr, int bits) "
               "-> (Tensor, Tensor, Tensor)",
               fake_quant_factored_bwd,
               lambda gy, w, s_wl, s_wr, bits: (
                   w.new_empty(w.shape, dtype=torch.float32),
                   w.new_empty((0,) if s_wl is None else s_wl.shape,
                               dtype=torch.float32),
                   w.new_empty(s_wr.shape, dtype=torch.float32)),
               "fake_quant")


class _FactoredFakeQuant(torch.autograd.Function):
    """Forward and backward on the card.  Saves ``w`` itself (no copy) and
    the two factors' 2-D views, never a full scale."""

    @staticmethod
    def forward(ctx, w, s_wl, s_wr, bits: int, out_dtype):
        P, g, cs = factored_geometry(w, s_wl, s_wr)
        C = w.shape[-1]
        R = w.numel() // C
        w2 = w.reshape(R, C)
        wl = None if s_wl is None else s_wl.reshape(-1).contiguous()
        wr = s_wr.reshape(R // g, C if cs else 1).contiguous()
        ctx.save_for_backward(w2, wl, wr)
        ctx.bits = bits
        ctx.shapes = (w.shape, None if s_wl is None else s_wl.shape,
                      s_wr.shape)
        return _FFWD(w2, wl, wr, bits, _DTYPES[out_dtype]).reshape(w.shape)

    @staticmethod
    def backward(ctx, gy):
        w2, wl, wr = ctx.saved_tensors
        w_shape, wl_shape, wr_shape = ctx.shapes
        gx, gs_wl, gs_wr = _FBWD(gy.reshape(w2.shape).contiguous(), w2, wl,
                                 wr, ctx.bits)
        return (gx.reshape(w_shape),
                None if wl_shape is None else gs_wl.reshape(wl_shape),
                gs_wr.reshape(wr_shape), None, None)


def fake_quant_factored(w: torch.Tensor, s_wl: torch.Tensor | None,
                        s_wr: torch.Tensor, bits: int = 4,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Fake-quantize the f32 master ``w [..., K, N]`` by ``S_wL ⊗ S_wR``
    (the factors' shapes: :func:`factored_geometry`), the result in
    ``out_dtype`` (bf16 or f32): on the card (CUDA tensors; fake meta ones
    in a trace) through the factored kernel, differentiable in ``w``,
    ``s_wl`` and ``s_wr`` under the ``"ste"`` rule; for CPU tensors through
    the plain version, ``kernels.ref.fake_quant_factored_ref``, and its
    autograd gradient.  Raises on what the factored entry cannot take."""
    if out_dtype not in _DTYPES:
        raise ValueError(f"fake_quant_factored writes f32 or bf16, got "
                         f"{out_dtype}")
    if factored_geometry(w, s_wl, s_wr) is None:
        raise ValueError(
            f"fake_quant_factored takes an f32 w [..., K, N] with s_wl "
            f"[K] or [..., K] and s_wr in log_swr's shape; got w "
            f"{tuple(w.shape)} {w.dtype}, s_wl "
            f"{None if s_wl is None else tuple(s_wl.shape)}, s_wr "
            f"{tuple(s_wr.shape)}")
    ts = [t for t in (w, s_wl, s_wr) if t is not None]
    devices = {t.device for t in ts}
    if devices == {torch.device("cpu")}:
        return fake_quant_factored_ref(w, s_wl, s_wr, bits, out_dtype)
    if len(devices) != 1 or not on_card(w):
        raise RuntimeError(
            f"fake_quant_factored runs on one CUDA device or on the CPU; "
            f"got tensors on {sorted(map(str, devices))}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("fake_quant_factored takes f32 scale factors")
    if not w.is_contiguous():
        raise ValueError("fake_quant_factored needs a contiguous w")
    return _FactoredFakeQuant.apply(w, s_wl, s_wr, bits, out_dtype)


# ---------------------------------------------------------------------------
# the broadcast entry
# ---------------------------------------------------------------------------

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
        if len(devices) != 1 or not on_card(x):
            raise RuntimeError(
                f"fake_quant_kernel runs on one CUDA device or on the CPU; "
                f"got tensors on {sorted(map(str, devices))}")
        if not x.is_contiguous():
            raise ValueError("fake_quant_kernel needs a contiguous x")
    return _FakeQuant.apply(x, s.to(torch.float32), bits, rule)


fake_quant_kernel.launches_fwd = 0
fake_quant_kernel.launches_bwd = 0
# the factored entry's share of the two counts above
fake_quant_kernel.launches_factored_fwd = 0
fake_quant_kernel.launches_factored_bwd = 0
