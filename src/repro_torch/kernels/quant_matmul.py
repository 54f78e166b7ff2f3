"""W4 nibble-packed matmul: the wrapper of ``csrc/quant_matmul.cu``.

Replaces the Pallas kernels of the JAX package's ``quant_matmul``:
``variant="int8dot"`` (``_qmm_int8_kernel``) computes
``y = (x * s_wl) @ unpack(qw)`` with ``s_wr`` on one partial sum per
K-group; ``variant="dequant"`` (``_qmm_dequant_kernel`` and its group
body, the baseline the first is measured against) dequantizes the weight
with ``s_wl ⊙ s_wr`` before the product.  x ``[M, K]`` f32/bf16; qw
``[K/2, N]`` uint8; s_wl ``[K]`` f32; s_wr ``[N]`` (layerwise, channel) or
``[K/g, N]`` (group) f32 → ``[M, N]``.

:func:`plan` picks one of three bodies from the shape and type before the
launch, and the K-split that fills the card:

- ``mma`` (bf16, M ≤ 16): split-K on ``mma.sync`` tensor cores, the weight
  the A operand, unpacked to bf16 in registers.  Bound by the packed
  weight read at large N·K, by latency (one DRAM round trip, the split
  combine) on a 2 MB linear.
- ``mma_wide`` (bf16, M > 16): 64 × 128 tiles of four ``mma.sync`` warps
  on fp16 operands, after a pre-pass that scales each row of x (times
  ``s_wl`` for int8dot) by a power of two into fp16's range; bound by the
  tensor cores' operations at prefill M.
- ``fma`` (f32): CUDA-core FMAs with the same split-K streaming; f32 stays
  f32 because the f32 tolerances do not survive TF32 or bf16 operands.

Every split lies in one K-group or is a union of whole groups, the splits'
f32 partials go to a workspace and the last block of each output tile sums
them in split order: no float atomics, two launches give identical bits.

:func:`quant_matmul_int8` is the entry for the unpacked int8 weights the
plan keeps at 8 bits (``q [K, N]`` int8, the reference's integer
``dot_general`` operand), counted on ``quant_matmul.launches_int8`` alone.
:func:`plan_int8` gives bf16 x at M ≤ 16 on a shape that passes
:func:`tiles_ok` the ``mma`` body, the weight's bytes widened to bf16 in
registers (exact); f32 x and every other shape take the ``fma`` body's
pipeline with a byte load in place of the nibble unpack.  The ``fma``
body also reads the int4 entry's nibble-packed ``qw [K/2, N]`` in place,
for the int4 shapes that :func:`tiles_ok` refuses.

Each entry is a ``torch.library`` operator (``repro_torch::quant_matmul``,
``::quant_matmul_dequant``, ``::quant_matmul_i8``; ``_library.py``), so a
trace over fake tensors records it as one node.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ..core.fakequant import unpack_int4
from . import _build
from ._library import define, on_card
from .ref import quant_matmul_int8_ref, quant_matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ENTRY = {"int8dot": "qft_quant_matmul", "dequant": "qft_quant_matmul_dequant",
          "int8": "qft_quant_matmul_i8"}
BODIES = ("fma", "mma", "mma_wide")
TILE_N = 64
TILE_K = 64
#: the H100's streaming multiprocessors
SMS = 132
MAX_SPLITS = 64
#: the wide body's split tiles are 32 KB, and the last block of a tile reads
#: them all, so its splits stay few
MAX_WIDE_SPLITS = 8
#: per body: block rows, block columns, the longest split (the mma and fma
#: bodies keep their split of x in shared memory) and the blocks a plan
#: aims at: at least two 4-warp blocks per SM for the latency-bound decode
#: bodies; for mma_wide at most one wave of the three blocks an SM holds
_BLOCK = {"fma": (8, 64, 1024, 2 * SMS), "mma": (8, 64, 1024, 2 * SMS),
          "mma_wide": (64, 128, None, 3 * SMS)}


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


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: the body, its block tile, the K-split and the scratch.

    The grid is (``tiles``, ``splits``): the output tiles (M-tiles ×
    N-tiles, one split counter each) by the K-splits.  ``workspace`` is
    the f32 partials ``[splits, M, N]`` when there is more than one split;
    ``staged_x`` whether the ``mma_wide`` pre-pass needs its scratch (x,
    times s_wl for int8dot, as row-scaled fp16 ``[M, K]`` and the f32 row
    scales ``[M]``)."""
    body: str
    block_m: int
    block_n: int
    ksplit: int
    splits: int
    tiles: int
    workspace: tuple[int, int, int] | None
    staged_x: bool

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits


def nests(ksplit: int, group: int, K: int) -> bool:
    """A split lies inside one K-group or is a union of whole groups, so
    ``s_wr`` multiplies one partial per group."""
    return group >= K or ksplit % group == 0 or group % ksplit == 0


@functools.lru_cache(maxsize=None)
def plan(M: int, N: int, K: int, group: int, dtype: torch.dtype) -> Plan:
    """The launch plan for a shape that passes :func:`tiles_ok` (``group``
    is K for the channel and layerwise layouts).

    The body follows the type and M.  The K-split is a multiple of 64 rows
    that nests with the group, the shortest such length for its count of
    splits, so that they are as even as the group allows.  The count is,
    at most ``MAX_SPLITS``, the fewest that launch the body's target of
    blocks (mma, fma) or the most that stay within it (mma_wide)."""
    if dtype == torch.float32:
        body = "fma"
    elif dtype == torch.bfloat16:
        body = "mma" if M <= 16 else "mma_wide"
    else:
        raise ValueError(f"no quant_matmul body for {dtype}")
    bm, bn, cap, target = _BLOCK[body]
    if body == "mma" and M > 8:
        bm, cap = 16, cap // 2
    tiles = math.ceil(M / bm) * math.ceil(N / bn)
    longest = K if cap is None else min(cap, K)
    nesting = [ks for ks in range(TILE_K, longest + 1, TILE_K)
               if nests(ks, group, K)]

    def even(n):                         # the most even split in <= n parts
        fit = [ks for ks in nesting if math.ceil(K / ks) <= n]
        return fit[0] if fit else None

    if body == "mma_wide":
        ksplit = (even(max(1, min(MAX_WIDE_SPLITS, target // tiles)))
                  or nesting[-1])
    else:
        ksplit = nesting[-1]
        for n in range(1, MAX_SPLITS + 1):
            ksplit = even(n) or ksplit
            if tiles * math.ceil(K / ksplit) >= target:
                break
    splits = math.ceil(K / ksplit)
    return Plan(body=body, block_m=bm, block_n=bn, ksplit=ksplit,
                splits=splits, tiles=tiles,
                workspace=(splits, M, N) if splits > 1 else None,
                staged_x=body == "mma_wide")


@functools.lru_cache(maxsize=None)
def plan_int8(M: int, N: int, K: int, group: int | None = None,
              dtype: torch.dtype = torch.float32,
              packed: bool = False) -> Plan:
    """The launch plan of the int8 entry (``group`` rows a K-group, None
    or K for the channel layout; ``packed``: nibble-packed weights).  bf16
    x at M ≤ 16 on a shape that passes :func:`tiles_ok`, unpacked:
    :func:`plan`'s ``mma`` plan.  Otherwise the ``fma``
    body's 8 x 64 blocks for both x types, the K-split a multiple of 64
    rows (at most 1024, x of a split is kept in shared memory) and the
    fewest splits, at most ``MAX_SPLITS``, that launch two blocks an SM; a
    split need not nest with the groups there: a row that opens a group
    flushes the partial."""
    group = K if group is None else group
    if (not packed and dtype == torch.bfloat16 and M <= 16
            and tiles_ok(M, N, K, None if group >= K else K // group)):
        return plan(M, N, K, group, dtype)
    bm, bn, cap, target = _BLOCK["fma"]
    tiles = math.ceil(M / bm) * math.ceil(N / bn)
    ksplit = min(cap, math.ceil(K / TILE_K) * TILE_K)
    for n in range(1, MAX_SPLITS + 1):
        ks = math.ceil(math.ceil(K / n) / TILE_K) * TILE_K
        if ks > cap:
            continue
        ksplit = ks
        if tiles * math.ceil(K / ks) >= target:
            break
    splits = math.ceil(K / ksplit)
    return Plan(body="fma", block_m=bm, block_n=bn, ksplit=ksplit,
                splits=splits, tiles=tiles,
                workspace=(splits, M, N) if splits > 1 else None,
                staged_x=False)


@functools.lru_cache(maxsize=None)
def _signature(lib: ctypes.CDLL, variant: str):
    fn = getattr(lib, _ENTRY[variant])
    if variant == "int8":
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 3)
    else:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


#: split counters per (device, stream): zero between launches (the last
#: block of each output tile resets its own), grown on demand
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _aligned(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("x, q, s_wl and s_wr must be 16-byte aligned")


def _launch(x: torch.Tensor, qw: torch.Tensor, s_wl: torch.Tensor,
            s_wr: torch.Tensor, variant: str) -> torch.Tensor:
    """The packed entries' launch (the operators' CUDA implementation)."""
    _aligned(x, qw, s_wl, s_wr)
    M, K = x.shape
    N = qw.shape[1]
    group = K if s_wr.ndim == 1 else K // s_wr.shape[0]
    p = plan(M, N, K, group, x.dtype)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = (torch.empty(p.workspace, dtype=torch.float32, device=x.device)
          if p.workspace else None)
    xs = (torch.empty(M * K * 2 + M * 4, dtype=torch.uint8, device=x.device)
          if p.staged_x else None)
    stream = _build.stream_ptr(x)
    counters = (_counters(x.device, stream, p.tiles) if p.splits > 1
                else None)
    fn = _signature(_build.load("quant_matmul"), variant)
    rc = fn(x.data_ptr(), qw.data_ptr(), s_wl.data_ptr(), s_wr.data_ptr(),
            y.data_ptr(), M, N, K, group, _DTYPES[x.dtype],
            BODIES.index(p.body), p.ksplit,
            None if ws is None else ws.data_ptr(),
            None if xs is None else xs.data_ptr(),
            None if counters is None else counters.data_ptr(), stream)
    _build.check(rc, f"quant_matmul ({variant}, {p.body})")
    if variant == "int8dot":
        quant_matmul.launches += 1
    else:
        quant_matmul.launches_dequant += 1
    setattr(quant_matmul, f"launches_{p.body}",
            getattr(quant_matmul, f"launches_{p.body}") + 1)
    return y


def _launch_int8(x: torch.Tensor, q: torch.Tensor, s_wl: torch.Tensor,
                 s_wr: torch.Tensor) -> torch.Tensor:
    """The int8 entry's launch (its operator's CUDA implementation)."""
    _aligned(x, s_wl, s_wr)
    M, K = x.shape
    N = q.shape[1]
    group = K if s_wr.ndim == 1 else K // s_wr.shape[0]
    packed = q.dtype == torch.uint8
    p = plan_int8(M, N, K, group, x.dtype, packed)
    if p.body == "mma":                 # cp.async copies of q
        _aligned(q)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = (torch.empty(p.workspace, dtype=torch.float32, device=x.device)
          if p.workspace else None)
    stream = _build.stream_ptr(x)
    counters = (_counters(x.device, stream, p.tiles) if p.splits > 1
                else None)
    fn = _signature(_build.load("quant_matmul"), "int8")
    rc = fn(x.data_ptr(), q.data_ptr(), s_wl.data_ptr(), s_wr.data_ptr(),
            y.data_ptr(), M, N, K, group, _DTYPES[x.dtype],
            BODIES.index(p.body), int(packed), p.ksplit,
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), stream)
    _build.check(rc, f"quant_matmul (int8, {p.body})")
    quant_matmul.launches_int8 += 1
    return y


def _fake_out(x, qw, s_wl, s_wr):
    return x.new_empty((x.shape[0], qw.shape[1]))


_SCHEMA = "(Tensor x, Tensor q, Tensor s_wl, Tensor s_wr) -> Tensor"
_OPS = {
    "int8dot": define("quant_matmul", _SCHEMA,
                      lambda x, q, a, b: _launch(x, q, a, b, "int8dot"),
                      _fake_out, "quant_matmul"),
    "dequant": define("quant_matmul_dequant", _SCHEMA,
                      lambda x, q, a, b: _launch(x, q, a, b, "dequant"),
                      _fake_out, "quant_matmul"),
    "int8": define("quant_matmul_i8", _SCHEMA, _launch_int8, _fake_out,
                   "quant_matmul"),
}


def _check_devices(what: str, ts) -> bool:
    """True for all-CPU tensors (the plain version); raises unless they all
    lie on one CUDA device."""
    devices = {t.device for t in ts}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or not on_card(ts[0]):
        raise RuntimeError(f"{what} runs on one CUDA device or on the CPU; "
                           f"got tensors on {sorted(map(str, devices))}")
    return False


def _check_scales(what: str, K: int, N: int, s_wl, s_wr) -> None:
    if s_wl.shape != (K,):
        raise ValueError(f"{what}: s_wl {tuple(s_wl.shape)} does not fit "
                         f"K={K}")
    if s_wr.shape != (N,) and not (s_wr.ndim == 2 and s_wr.shape[1] == N):
        raise ValueError(f"s_wr must be [N] or [K/g, N], got "
                         f"{tuple(s_wr.shape)}")


def quant_matmul(x: torch.Tensor, qw: torch.Tensor, s_wl: torch.Tensor,
                 s_wr: torch.Tensor, variant: str = "int8dot") -> torch.Tensor:
    """The W4 matmul on the card; the plain version for CPU tensors (both
    variants compute ``quant_matmul_ref``'s function).  Launches count on
    ``quant_matmul.launches`` (int8dot) and ``.launches_dequant``, and per
    body on ``.launches_mma``, ``.launches_mma_wide`` and
    ``.launches_fma`` (both variants)."""
    if variant not in ("int8dot", "dequant"):
        raise ValueError(f"unknown quant_matmul variant {variant!r}")
    if x.ndim != 2 or qw.ndim != 2 or qw.dtype != torch.uint8:
        raise ValueError("quant_matmul takes x [M, K] and uint8 qw [K/2, N]")
    M, K = x.shape
    N = qw.shape[1]
    if qw.shape[0] * 2 != K:
        raise ValueError(f"qw {tuple(qw.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    _check_scales("quant_matmul", K, N, s_wl, s_wr)
    if _check_devices("quant_matmul", (x, qw, s_wl, s_wr)):
        return quant_matmul_ref(x, qw, s_wl, s_wr)
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
    return _OPS[variant](x, qw, s_wl, s_wr)


def quant_matmul_int8(x: torch.Tensor, q: torch.Tensor, s_wl: torch.Tensor,
                      s_wr: torch.Tensor) -> torch.Tensor:
    """``Σ_g s_wr[g] · ((x·s_wl)[:, g] @ q[g])`` for an unpacked int8
    weight ``q [K, N]``, or the int4 entry's nibble-packed uint8 ``q [K/2,
    N]`` (row 2i in the low nibble): the kernel on the card, the plain
    version (``ref.quant_matmul_int8_ref`` on the unpacked weight) for CPU
    tensors.  x ``[M, K]`` f32 or bf16; s_wr ``[N]`` or ``[K/g, N]``.  Any
    M, N, K (K even when packed).  Launches count on
    ``quant_matmul.launches_int8``."""
    if x.ndim != 2 or q.ndim != 2 or q.dtype not in (torch.int8,
                                                      torch.uint8):
        raise ValueError("quant_matmul_int8 takes x [M, K] and int8 q "
                         "[K, N] or packed uint8 q [K/2, N]")
    M, K = x.shape
    N = q.shape[1]
    packed = q.dtype == torch.uint8
    if q.shape[0] * (2 if packed else 1) != K:
        raise ValueError(f"q {tuple(q.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    _check_scales("quant_matmul_int8", K, N, s_wl, s_wr)
    if s_wr.ndim == 2 and K % s_wr.shape[0]:
        raise ValueError(f"{s_wr.shape[0]} groups do not divide K={K}")
    if _check_devices("quant_matmul_int8", (x, q, s_wl, s_wr)):
        return quant_matmul_int8_ref(
            x, unpack_int4(q, axis=0) if packed else q, s_wl, s_wr)
    if x.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernel takes f32/bf16 x, got {x.dtype}")
    if s_wl.dtype != torch.float32 or s_wr.dtype != torch.float32:
        raise ValueError("s_wl/s_wr must be f32")
    for t in (x, q, s_wl, s_wr):
        if not t.is_contiguous():
            raise ValueError("quant_matmul_int8 needs contiguous tensors")
    return _OPS["int8"](x, q, s_wl, s_wr)


quant_matmul.launches = 0
quant_matmul.launches_dequant = 0
quant_matmul.launches_int8 = 0
quant_matmul.launches_mma = 0
quant_matmul.launches_mma_wide = 0
quant_matmul.launches_fma = 0
