"""Slot-masked flash-decode: the wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas kernel ``_fd_kernel`` of the JAX package.  One query
token per slot against the slot-indexed KV view: q ``[S, Hkv, G, hd]``
(head ``h == kv*G + g``), k/v ``[S, T, Hkv, hd]`` bf16/f32 or int8 with
per-slot per-kv-head ``k_scale``/``v_scale`` ``[S, Hkv]``, ``lengths [S]``
int32, each ``>= 1`` → ``[S, Hkv, G, hd]``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 8


def kernel_takes(G: int, hd: int) -> bool:
    """The CUDA kernel's shape gate: query heads per kv-head and head dim.
    Any cache depth is taken (a ragged last block is masked)."""
    return 1 <= G <= _MAX_GROUP and hd in _HEAD_DIMS


def _signature(lib: ctypes.CDLL):
    fn = lib.qft_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, lengths, k_scale, v_scale) -> None:
    S, Hkv, G, hd = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != S \
            or k.shape[2:] != (Hkv, hd):
        raise ValueError(f"k/v must be [S, T, Hkv, hd] matching q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if lengths.shape != (S,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be an int32 [S] tensor")
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("int8 k/v need k_scale and v_scale; float k/v take "
                         "neither")
    if quantized:
        for sc in (k_scale, v_scale):
            if sc.shape != (S, Hkv) or sc.dtype != torch.float32:
                raise ValueError("k_scale/v_scale must be f32 [S, Hkv]")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Flash-decode on the card; the plain version for CPU tensors."""
    _check(q, k, v, lengths, k_scale, v_scale)
    args = [q, k, v, lengths] + ([k_scale, v_scale]
                                 if k_scale is not None else [])
    devices = {t.device for t in args}
    if devices == {torch.device("cpu")}:
        return decode_attention_ref(q, k, v, lengths, k_scale, v_scale)
    if len(devices) != 1 or q.device.type != "cuda":
        raise RuntimeError(f"decode_attention runs on one CUDA device or on "
                           f"the CPU; got tensors on {sorted(map(str, devices))}")
    S, Hkv, G, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or not kernel_takes(G, hd):
        raise ValueError(f"the CUDA kernel takes f32/bf16 q, hd in "
                         f"{_HEAD_DIMS} and G <= {_MAX_GROUP}; got {q.dtype}, "
                         f"hd={hd}, G={G}")
    if k.dtype != torch.int8 and (k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError("the CUDA kernel takes float k/v in q's dtype")
    for t in args:
        if not t.is_contiguous():
            raise ValueError("decode_attention needs contiguous tensors")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k/v must be 16-byte aligned")
    out = torch.empty_like(q)
    fn = _signature(_build.load("decode_attention"))
    quantized = k_scale is not None
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None, out.data_ptr(),
            S, k.shape[1], Hkv, G, hd, _DTYPES[q.dtype], _DTYPES[k.dtype],
            hd ** -0.5, _build.stream_ptr(q))
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
