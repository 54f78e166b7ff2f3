"""Blocked attention, forward only: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``_fa_kernel`` of the JAX package (wrapper
``flash_attention`` over ``[BH, S, hd]``, layout shim
``ops.attention_prefill`` over ``[B, S, H, hd]``): online softmax with f32
state, causal key tiles above the diagonal skipped.  The CUDA kernel reads
each tensor through its strides (hd contiguous) and a query head ``h``
reads kv head ``h // (H / Hkv)``, so the ``[B, S, H, hd]`` form needs
neither a transpose nor a repeated copy of k and v.  Any S is taken (the
ragged last tile is masked); hd ≤ 256; f32 or bf16, output in q's type.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import attention_prefill_ref, flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _signature(lib: ctypes.CDLL):
    fn = lib.qft_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _on_cpu(*ts: torch.Tensor) -> bool:
    devices = {t.device for t in ts}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or ts[0].device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on one CUDA device or on "
                           f"the CPU; got tensors on {sorted(map(str, devices))}")
    return False


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """The kernel over ``q [B, S, H, hd]``, ``k, v [B, Sk, Hkv, hd]`` views
    → a contiguous ``[B, S, H, hd]`` output."""
    B, S, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the CUDA kernel takes f32 or bf16 q, k and v of "
                         f"one type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes hd <= {MAX_HEAD_DIM}, got "
                         f"{hd}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("flash_attention needs the head dim contiguous")
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    fn = _signature(_build.load("flash_attention"))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, Sk,
            H, Hkv, hd, *strides, hd ** -0.5, int(causal), _DTYPES[q.dtype],
            _build.stream_ptr(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o


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
    return _launch(q[:, :, None], k[:, :, None], v[:, :, None],
                   causal)[:, :, 0]


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
    return _launch(q, k, v, causal)


flash_attention.launches = 0
