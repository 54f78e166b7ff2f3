"""Split-KV flash-decode: the wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas kernel ``_fd_kernel`` of the JAX package.  One query
token per slot: q ``[S, Hkv, G, hd]`` (head ``h == kv*G + g``), per-slot
valid lengths ``[S]`` int32, each ``>= 1`` → ``[S, Hkv, G, hd]``.  Two
entries share one kernel body:

- :func:`decode_attention` reads the slot-indexed view k/v
  ``[S, T, Hkv, hd]``, bf16/f32 or int8 with per-slot per-kv-head
  ``k_scale``/``v_scale`` ``[S, Hkv]``;
- :func:`decode_attention_paged` reads the int8 page pools
  ``[n_pages + 1, P, Hkv, hd]`` through the page table ``pt [S, max_pages]``
  itself (the serving engine's paged cache), with the same scales.

Both count into ``decode_attention.launches``; the paged entry also into
``decode_attention.launches_paged``.  Each entry is a ``torch.library``
operator (``repro_torch::decode_attention``, ``::decode_attention_paged``),
so a trace over fake tensors records it as one node.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._library import define, on_card
from .ref import decode_attention_paged_ref, decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (16, 32, 64, 112, 128)
_MAX_GROUP = 16
#: query heads one block of the split pass holds; a larger group is split
#: into query chunks of this many, each a block that reads the K/V rows again
_BLOCK_GROUP = 8
_ELT = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
_WARPS = 4
_MAX_TILE = 128
#: a grid of fewer blocks than two waves of the H100's 132 SMs takes
#: smaller splits
_MIN_BLOCKS = 2 * 132


def kernel_takes(G: int, hd: int) -> bool:
    """The CUDA kernel's shape gate: query heads per kv-head (up to 16) and
    head dim.  Any cache depth and page size is taken (a ragged last split
    is masked)."""
    return 1 <= G <= _MAX_GROUP and hd in _HEAD_DIMS


def query_chunks(G: int) -> int:
    """Blocks of the split pass per (split, kv head): one, or for a group
    above 8 one per chunk of 8 query heads (G 12 and 16: 2), each reading
    the split's K and V rows."""
    return -(-G // _BLOCK_GROUP)


def tile_rows(kv_dtype: torch.dtype, hd: int, G: int) -> int:
    """Rows one block of the kernel reads in a single round of loads (its
    ``Tile::ROWS``): a lane takes one 16-byte vector of a row (a row's
    lanes padded to a power of two: 14 → 16 for bf16 at hd 112) and 8 rows
    of K and of V, 4 where its slice of the G queries is 128 floats (int8,
    G > 4; a block holds at most 8 queries, so G 12 and 16 tile as G 8);
    at most 128.  128 for the int8 cache at hd 128 and G <= 4, 64 for
    bf16."""
    vn = 16 // _ELT[kv_dtype]
    lanes = 1 << (hd // vn - 1).bit_length()
    rows_per_step = _WARPS * (32 // lanes)
    u = 4 if (4 if G <= 4 else 8) * vn >= 128 else 8
    return min(u, _MAX_TILE // rows_per_step) * rows_per_step


def split_rows(T: int, slot_heads: int, tile: int) -> int:
    """Rows per KV split for a view of ``T`` rows (``max_pages * P`` for the
    paged entry), ``slot_heads = S * Hkv * query_chunks(G)`` (the blocks of
    one split) and the kernel's ``tile``: the
    whole tile unless fewer than two waves of blocks would result, then
    half of it, then a quarter."""
    for rows in (tile, tile // 2):
        if -(-T // rows) * slot_heads >= _MIN_BLOCKS:
            return rows
    return max(tile // 4, 1)


def _signature(lib: ctypes.CDLL, paged: bool):
    fn = lib.qft_decode_attention_paged if paged else lib.qft_decode_attention
    fn.argtypes = [ctypes.c_void_p] * (9 if paged else 8) \
        + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_scales(S, Hkv, quantized, k_scale, v_scale) -> None:
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("int8 k/v need k_scale and v_scale; float k/v take "
                         "neither")
    if quantized:
        for sc in (k_scale, v_scale):
            if sc.shape != (S, Hkv) or sc.dtype != torch.float32:
                raise ValueError("k_scale/v_scale must be f32 [S, Hkv]")


def _check(q, k, v, lengths, k_scale, v_scale) -> None:
    S, Hkv, G, hd = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != S \
            or k.shape[2:] != (Hkv, hd):
        raise ValueError(f"k/v must be [S, T, Hkv, hd] matching q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if lengths.shape != (S,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be an int32 [S] tensor")
    _check_scales(S, Hkv, k.dtype == torch.int8, k_scale, v_scale)


def _check_paged(q, pool_k, pool_v, pt, lengths, k_scale, v_scale) -> None:
    S, Hkv, G, hd = q.shape
    if pool_k.ndim != 4 or pool_k.shape != pool_v.shape \
            or pool_k.shape[2:] != (Hkv, hd):
        raise ValueError(f"pool_k/pool_v must be [n_pages + 1, P, Hkv, hd] "
                         f"matching q {tuple(q.shape)}, got "
                         f"{tuple(pool_k.shape)} / {tuple(pool_v.shape)}")
    if pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8:
        raise ValueError("the page pools must be int8")
    if pt.ndim != 2 or pt.shape[0] != S or pt.dtype != torch.int32:
        raise ValueError("pt must be an int32 [S, max_pages] tensor")
    if lengths.shape != (S,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be an int32 [S] tensor")
    _check_scales(S, Hkv, True, k_scale, v_scale)


def _on_cpu(what: str, q: torch.Tensor, tensors) -> bool:
    """True for all-CPU tensors (the plain version); raises unless they all
    lie on q's one CUDA device."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or not on_card(q):
        raise RuntimeError(f"{what} runs on one CUDA device or on the CPU; "
                           f"got tensors on {sorted(map(str, devices))}")
    return False


def _check_kernel(what: str, q, tensors, kv) -> None:
    """What the CUDA kernel takes: f32/bf16 q, the head shapes it was built
    for, contiguous tensors and 16-byte aligned KV rows."""
    S, Hkv, G, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or not kernel_takes(G, hd):
        raise ValueError(f"the CUDA kernel takes f32/bf16 q, hd in "
                         f"{_HEAD_DIMS} and G <= {_MAX_GROUP}; got {q.dtype}, "
                         f"hd={hd}, G={G}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous tensors")


def _aligned(what: str, *kv: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in kv):
        raise ValueError(f"{what}: k/v must be 16-byte aligned")


def _scratch(q: torch.Tensor, T: int, rows: int) -> torch.Tensor:
    """The split pass's f32 partials: acc [S, Hkv, n_splits, G, hd], then
    (m, l) [S, Hkv, n_splits, G, 2]."""
    S, Hkv, G, hd = q.shape
    return torch.empty(S * Hkv * -(-T // rows) * G * (hd + 2),
                       dtype=torch.float32, device=q.device)


def _run(q, k, v, lengths, k_scale, v_scale) -> torch.Tensor:
    """Both passes on the slot-indexed view, on q's current stream (the
    operator's CUDA implementation)."""
    _aligned("decode_attention", k, v)
    S, Hkv, G, hd = q.shape
    T = k.shape[1]
    rows = split_rows(T, S * Hkv * query_chunks(G),
                      tile_rows(k.dtype, hd, G))
    out = torch.empty_like(q)
    scratch = _scratch(q, T, rows)
    quantized = k_scale is not None
    rc = _signature(_build.load("decode_attention"), paged=False)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None, out.data_ptr(),
        scratch.data_ptr(), S, T, Hkv, G, hd, _DTYPES[q.dtype],
        _DTYPES[k.dtype], rows, hd ** -0.5, _build.stream_ptr(q))
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


def _run_paged(q, pool_k, pool_v, pt, lengths, k_scale, v_scale
               ) -> torch.Tensor:
    """Both passes on the page pools, on q's current stream (the
    operator's CUDA implementation)."""
    _aligned("decode_attention_paged", pool_k, pool_v)
    S, Hkv, G, hd = q.shape
    P, max_pages = pool_k.shape[1], pt.shape[1]
    rows = split_rows(max_pages * P, S * Hkv * query_chunks(G),
                      tile_rows(torch.int8, hd, G))
    out = torch.empty_like(q)
    scratch = _scratch(q, max_pages * P, rows)
    rc = _signature(_build.load("decode_attention"), paged=True)(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), pt.data_ptr(),
        lengths.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), S, P, max_pages, Hkv, G, hd,
        _DTYPES[q.dtype], rows, hd ** -0.5, _build.stream_ptr(q))
    _build.check(rc, "decode_attention_paged")
    decode_attention.launches += 1
    decode_attention.launches_paged += 1
    return out


_OP = define("decode_attention",
             "(Tensor q, Tensor k, Tensor v, Tensor lengths, Tensor? k_scale,"
             " Tensor? v_scale) -> Tensor", _run,
             lambda q, *_: torch.empty_like(q), "decode_attention")
_OP_PAGED = define("decode_attention_paged",
                   "(Tensor q, Tensor pool_k, Tensor pool_v, Tensor pt, "
                   "Tensor lengths, Tensor k_scale, Tensor v_scale) -> Tensor",
                   _run_paged, lambda q, *_: torch.empty_like(q),
                   "decode_attention")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Flash-decode over the slot-indexed view on the card; the plain
    version for CPU tensors."""
    _check(q, k, v, lengths, k_scale, v_scale)
    args = [q, k, v, lengths] + ([k_scale, v_scale]
                                 if k_scale is not None else [])
    if _on_cpu("decode_attention", q, args):
        return decode_attention_ref(q, k, v, lengths, k_scale, v_scale)
    _check_kernel("decode_attention", q, args, (k, v))
    if k.dtype != torch.int8 and (k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError("the CUDA kernel takes float k/v in q's dtype")
    return _OP(q, k, v, lengths, k_scale, v_scale)


def decode_attention_paged(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, pt: torch.Tensor,
                           lengths: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor) -> torch.Tensor:
    """Flash-decode over the int8 page pools through the page table on the
    card; the plain version (gather, then :func:`decode_attention_ref`) for
    CPU tensors.  ``pt`` entries must be page ids of the pools."""
    _check_paged(q, pool_k, pool_v, pt, lengths, k_scale, v_scale)
    args = [q, pool_k, pool_v, pt, lengths, k_scale, v_scale]
    if _on_cpu("decode_attention_paged", q, args):
        return decode_attention_paged_ref(q, pool_k, pool_v, pt, lengths,
                                          k_scale, v_scale)
    _check_kernel("decode_attention_paged", q, args, (pool_k, pool_v))
    return _OP_PAGED(q, pool_k, pool_v, pt, lengths, k_scale, v_scale)


decode_attention.launches = 0
decode_attention.launches_paged = 0
