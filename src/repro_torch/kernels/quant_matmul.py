"""W4 nibble-packed matmul: the wrapper of ``csrc/quant_matmul.cu``.

Replaces the Pallas kernel ``_qmm_int8_kernel`` of the JAX package:
``y = (x * s_wl) @ unpack(qw)`` with ``s_wr`` on one partial sum per
K-group.  x ``[M, K]`` f32/bf16; qw ``[K/2, N]`` uint8; s_wl ``[K]`` f32;
s_wr ``[N]`` (layerwise, channel) or ``[K/g, N]`` (group) f32 → ``[M, N]``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import quant_matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_N = 64
TILE_K = 64


def tiles_ok(M: int, N: int, K: int, n_groups: int | None = None) -> bool:
    """The CUDA kernel's tiling: N and K by 64; a K-group a multiple of 16
    that divides or is divided by the 64-row K step.  M is masked."""
    if M < 1 or N % TILE_N or K % TILE_K:
        return False
    if n_groups is None:
        return True
    if K % n_groups:
        return False
    g = K // n_groups
    return g % 16 == 0 and (g % TILE_K == 0 or TILE_K % g == 0)


def _signature(lib: ctypes.CDLL):
    fn = lib.qft_quant_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quant_matmul(x: torch.Tensor, qw: torch.Tensor, s_wl: torch.Tensor,
                 s_wr: torch.Tensor) -> torch.Tensor:
    """The W4 matmul on the card; the plain version for CPU tensors."""
    if x.ndim != 2 or qw.ndim != 2 or qw.dtype != torch.uint8:
        raise ValueError("quant_matmul takes x [M, K] and uint8 qw [K/2, N]")
    M, K = x.shape
    N = qw.shape[1]
    if qw.shape[0] * 2 != K or s_wl.shape != (K,):
        raise ValueError(f"qw {tuple(qw.shape)} / s_wl {tuple(s_wl.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if s_wr.shape != (N,) and not (s_wr.ndim == 2 and s_wr.shape[1] == N):
        raise ValueError(f"s_wr must be [N] or [K/g, N], got "
                         f"{tuple(s_wr.shape)}")
    devices = {t.device for t in (x, qw, s_wl, s_wr)}
    if devices == {torch.device("cpu")}:
        return quant_matmul_ref(x, qw, s_wl, s_wr)
    if len(devices) != 1 or x.device.type != "cuda":
        raise RuntimeError(f"quant_matmul runs on one CUDA device or on the "
                           f"CPU; got tensors on {sorted(map(str, devices))}")
    n_groups = s_wr.shape[0] if s_wr.ndim == 2 else None
    if x.dtype not in _DTYPES or not tiles_ok(M, N, K, n_groups):
        raise ValueError(f"the CUDA kernel takes f32/bf16 x and shapes that "
                         f"pass tiles_ok; got {x.dtype}, M={M} N={N} K={K} "
                         f"groups={n_groups}")
    if s_wl.dtype != torch.float32 or s_wr.dtype != torch.float32:
        raise ValueError("s_wl/s_wr must be f32")
    for t in (x, qw, s_wl, s_wr):
        if not t.is_contiguous():
            raise ValueError("quant_matmul needs contiguous tensors")
    if s_wr.data_ptr() % 16:
        raise ValueError("s_wr must be 16-byte aligned")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    group = K if n_groups is None else K // n_groups
    fn = _signature(_build.load("quant_matmul"))
    rc = fn(x.data_ptr(), qw.data_ptr(), s_wl.data_ptr(), s_wr.data_ptr(),
            y.data_ptr(), M, N, K, group, _DTYPES[x.dtype],
            _build.stream_ptr(x))
    _build.check(rc, "quant_matmul")
    quant_matmul.launches += 1
    return y


quant_matmul.launches = 0
