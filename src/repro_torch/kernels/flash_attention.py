"""Blocked attention, forward only: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``_fa_kernel`` of the JAX package (wrapper
``flash_attention`` over ``[BH, S, hd]``, layout shim
``ops.attention_prefill`` over ``[B, S, H, hd]``): online softmax with f32
state, causal key tiles above the diagonal skipped.  The CUDA kernel reads
each tensor through its strides (hd contiguous) and a query head ``h``
reads kv head ``h // (H / Hkv)``, so the ``[B, S, H, hd]`` form needs
neither a transpose nor a repeated copy of k and v.  Any S is taken (the
ragged last tile is masked); hd ≤ 256; f32 or bf16, output in q's type.

Two bodies, a dispatch on dtype and shape (:func:`body_for`), not a
fallback: the ``[B, S, H, hd]`` form in bf16 with hd 64 or 128 runs the
tensor-core body (``qft_flash_attention_wgmma``: TMA loads, wgmma
products); f32, other head dims and the ``[BH, S, hd]`` signature run the
FMA body (``qft_flash_attention``).  The tensor-core body's TMA loads need
16-byte-aligned bases and strides (:func:`tma_misalignment`); a view that
fails raises.  ``flash_attention.launches`` counts every launch,
``launches_wgmma`` and ``launches_fma`` each body's.  The launch is a
``torch.library`` operator (``repro_torch::flash_attention``), so a trace
over fake tensors records it as one node.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._library import define, on_card
from .ref import attention_prefill_ref, flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: head dims the tensor-core body is instantiated for
WGMMA_HEAD_DIMS = (64, 128)

_ENTRIES: dict[str, object] = {}


def _entry(body: str):
    """The C entry point of ``body``, its signature set once."""
    fn = _ENTRIES.get(body)
    if fn is None:
        lib = _build.load("flash_attention")
        if body == "wgmma":
            fn = lib.qft_flash_attention_wgmma
            tail = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        else:
            fn = lib.qft_flash_attention
            tail = [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + tail)
        fn.restype = ctypes.c_int
        _ENTRIES[body] = fn
    return fn


def body_for(dtype: torch.dtype, hd: int, layout: str) -> str:
    """The body that runs a call: ``"wgmma"`` for the ``[B, S, H, hd]``
    layout (``layout="bshd"``) in bf16 with hd in
    :data:`WGMMA_HEAD_DIMS`, else ``"fma"`` (f32, other head dims, and the
    ``[BH, S, hd]`` signature, ``layout="bsd"``)."""
    return ("wgmma" if layout == "bshd" and dtype == torch.bfloat16
            and hd in WGMMA_HEAD_DIMS else "fma")


def tma_misalignment(ptr: int, shape, strides, itemsize: int) -> str | None:
    """Why a ``[B, S, H, hd]`` view cannot be a TMA source, or None: its
    base must be 16-byte aligned, its last dim contiguous and the byte
    stride of every other dimension longer than 1 a multiple of 16."""
    if ptr % 16:
        return f"base address {ptr:#x} is not 16-byte aligned"
    if strides[-1] != 1:
        return "the head dim is not contiguous"
    for n, st in zip(shape[:-1], strides[:-1]):
        if n > 1 and (st * itemsize) % 16:
            return (f"stride {st} (x {itemsize} bytes) is not a multiple "
                    f"of 16 bytes")
    return None


def _on_cpu(*ts: torch.Tensor) -> bool:
    devices = {t.device for t in ts}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or not on_card(ts[0]):
        raise RuntimeError(f"flash_attention runs on one CUDA device or on "
                           f"the CPU; got tensors on {sorted(map(str, devices))}")
    return False


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    hd = q.shape[-1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the CUDA kernel takes f32 or bf16 q, k and v of "
                         f"one type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes hd <= {MAX_HEAD_DIM}, got "
                         f"{hd}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("flash_attention needs the head dim contiguous")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, layout: str) -> torch.Tensor:
    """The kernel over ``q [B, S, H, hd]``, ``k, v [B, Sk, Hkv, hd]`` views
    → a contiguous ``[B, S, H, hd]`` output, through the body
    :func:`body_for` names (the operator's CUDA implementation)."""
    B, S, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    body = body_for(q.dtype, hd, layout)
    if body == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            why = tma_misalignment(t.data_ptr(), t.shape, t.stride(),
                                   t.element_size())
            if why is not None:
                raise ValueError(f"flash_attention's tensor-core body loads "
                                 f"{name} with TMA: {why}")
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    tail = (() if body == "wgmma" else (_DTYPES[q.dtype],))
    rc = _entry(body)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), B, S, Sk, H, Hkv, hd, *strides,
                      hd ** -0.5, int(causal), *tail, _build.stream_ptr(q))
    _build.check(rc, f"flash_attention ({body} body)")
    flash_attention.launches += 1
    if body == "wgmma":
        flash_attention.launches_wgmma += 1
    else:
        flash_attention.launches_fma += 1
    return o


_OP = define("flash_attention",
             "(Tensor q, Tensor k, Tensor v, bool causal, str layout) -> "
             "Tensor", _launch,
             lambda q, k, v, causal, layout: q.new_empty(q.shape),
             "flash_attention")


def _run(q, k, v, causal: bool, layout: str) -> torch.Tensor:
    _check(q, k, v)
    return _OP(q, k, v, causal, layout)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v ``[BH, S, hd]`` (k, v ``[BH, Sk, hd]``) → ``[BH, S, hd]``:
    the kernel on the card, the plain version for CPU tensors."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention takes q [BH, S, hd] and k, v "
                         f"[BH, Sk, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if _on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal)
    return _run(q[:, :, None], k[:, :, None], v[:, :, None], causal,
                "bsd")[:, :, 0]


def attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """The ``[B, S, H, hd]`` layout (``ops.attention_prefill``): q
    ``[B, S, H, hd]``, k, v ``[B, Sk, Hkv, hd]`` (``H % Hkv == 0``) →
    ``[B, S, H, hd]``; the kernel on the card, the plain version (each kv
    head repeated) for CPU tensors."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"attention_prefill takes q [B, S, H, hd] and "
                         f"k, v [B, Sk, Hkv, hd] with H % Hkv == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if _on_cpu(q, k, v):
        return attention_prefill_ref(q, k, v, causal=causal)
    return _run(q, k, v, causal, "bshd")


flash_attention.launches = 0
flash_attention.launches_wgmma = 0
flash_attention.launches_fma = 0
