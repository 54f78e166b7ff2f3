"""The CUDA kernels on the card, each against its plain PyTorch version.

No jax here: this file runs on the GPU machine, which has none
(``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``).
Elsewhere every test skips, deciding inside the ``cuda`` fixture.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fakequant import pack_int4, unpack_int4  # noqa: E402
from repro_torch.kernels import decode_attention as fd  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_paged)
from repro_torch.kernels.fake_quant import fake_quant_kernel  # noqa: E402
from repro_torch.kernels.ops import qlinear_deployed  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_prefill, flash_attention)
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.kernels.quant_matmul import (  # noqa: E402
    quant_matmul, quant_matmul_int8)
from repro_torch.kernels.ref import (attention_prefill_ref,  # noqa: E402
                                     decode_attention_paged_ref,
                                     decode_attention_ref,
                                     fake_quant_grad_ref, fake_quant_ref,
                                     flash_attention_ref,
                                     quant_matmul_int8_ref, quant_matmul_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("hd", [16, 128])
def test_decode_attention_kernel(cuda, kv, hd):
    """Ragged last block (T=200), lengths 1 .. T, past T (a dead slot)."""
    S, T, Hkv, G = 6, 200, 2, 4
    q = _rand((S, Hkv, G, hd), 0, cuda)
    k = _rand((S, T, Hkv, hd), 1, cuda)
    v = _rand((S, T, Hkv, hd), 2, cuda)
    lengths = torch.tensor([1, 31, 32, 33, 200, 260], dtype=torch.int32,
                           device=cuda)
    args = _fd_args(kv, q, k, v, lengths, S, Hkv)
    before = decode_attention.launches
    out = decode_attention(*args)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_ref(*args)
    tol = 2e-5 if kv == "float32" else 2e-2    # bf16: one output rounding
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def _fd_args(kv, q, k, v, lengths, S, Hkv):
    if kv == "int8":
        k8 = (k * 40).clamp(-127, 127).round().to(torch.int8)
        v8 = (v * 40).clamp(-127, 127).round().to(torch.int8)
        ks = torch.rand((S, Hkv), device=q.device) * 0.02 + 0.005
        vs = torch.rand((S, Hkv), device=q.device) * 0.02 + 0.005
        return (q.bfloat16(), k8, v8, lengths, ks, vs)
    if kv == "bfloat16":
        return (q.bfloat16(), k.bfloat16(), v.bfloat16(), lengths)
    return (q, k, v, lengths)


def _fd_close(out, ref):
    """f32 to 2e-5; a bf16 output to one rounding of an f32 result of
    magnitude up to max|ref| (2e-2 of it)."""
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    else:
        tol = 2e-2 * max(1.0, float(ref.float().abs().max()))
        torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("part", [1, 2, 4])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
@pytest.mark.parametrize("kv", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("hd", [16, 128])
def test_split_body_against_plain(cuda, monkeypatch, part, G, kv, hd):
    """The split body at splits of the whole tile, a half and a quarter:
    lengths 1, rows - 1, rows, rows + 1 and T (T = 300, a ragged last
    split); two launches bit-identical (a fixed merge order, no atomics)."""
    rows = max(fd.tile_rows(getattr(torch, kv), hd, G) // part, 2)
    monkeypatch.setattr(fd, "split_rows", lambda T, slot_heads, tile: rows)
    S, T, Hkv = 5, 300, 2
    q = _rand((S, Hkv, G, hd), 3, cuda)
    k = _rand((S, T, Hkv, hd), 4, cuda)
    v = _rand((S, T, Hkv, hd), 5, cuda)
    lengths = torch.tensor([1, rows - 1, rows, rows + 1, T],
                           dtype=torch.int32, device=cuda)
    args = _fd_args(kv, q, k, v, lengths, S, Hkv)
    out = decode_attention(*args)
    again = decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _fd_close(out, decode_attention_ref(*args))


def test_split_larger_than_the_tile_is_refused(cuda, monkeypatch):
    """The C entry refuses a split the kernel's tile cannot hold."""
    monkeypatch.setattr(fd, "split_rows", lambda T, slot_heads, tile: 128)
    q = _rand((2, 2, 4, 128), 0, cuda).bfloat16()
    k = _rand((2, 256, 2, 128), 1, cuda).bfloat16()
    with pytest.raises(RuntimeError, match="cudaError"):
        decode_attention(q, k, k, torch.full((2,), 256, dtype=torch.int32,
                                             device=cuda))


@pytest.mark.parametrize("T", [2048, 4096])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_split_body_one_long_slot(cuda, T, kv):
    """S 1: the long slot is split across blocks (32 or 64 rows each)."""
    S, Hkv, G, hd = 1, 8, 4, 128
    q = _rand((S, Hkv, G, hd), 6, cuda)
    k = _rand((S, T, Hkv, hd), 7, cuda)
    v = _rand((S, T, Hkv, hd), 8, cuda)
    lengths = torch.tensor([T], dtype=torch.int32, device=cuda)
    args = _fd_args(kv, q, k, v, lengths, S, Hkv)
    _fd_close(decode_attention(*args), decode_attention_ref(*args))


def _paged(cuda, P, n_pg, G, seed, S=4, Hkv=2, hd=128):
    """Int8 pools with a trash page of 127s, shuffled non-monotonic page
    ids, entries past each slot's pages on the trash page, a retired last
    slot (every entry on the trash page, length 1)."""
    g = torch.Generator().manual_seed(seed)
    n_pages = S * n_pg
    pool_k, pool_v = (torch.randint(-127, 128, (n_pages + 1, P, Hkv, hd),
                                    generator=g, dtype=torch.int8)
                      for _ in range(2))
    pool_k[n_pages] = 127
    pool_v[n_pages] = 127
    T = n_pg * P
    lengths = torch.tensor([T, T // 2 + 1, 1, 1][:S], dtype=torch.int32)
    pt = torch.randperm(n_pages, generator=g).to(torch.int32).reshape(S, n_pg)
    for s in range(S):
        pt[s, -(-int(lengths[s]) // P):] = n_pages
    pt[S - 1] = n_pages
    q = torch.randn((S, Hkv, G, hd), generator=g)
    ks, vs = (torch.rand((S, Hkv), generator=g) * 0.02 + 0.005
              for _ in range(2))
    return [t.to(cuda) for t in (q, pool_k, pool_v, pt, lengths, ks, vs)]


@pytest.mark.parametrize("P,n_pg", [(16, 20), (48, 7), (5, 61), (1, 300)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
def test_paged_entry_against_plain(cuda, P, n_pg, dtype, G):
    """The paged entry at the engine's page size (16), at sizes that do not
    divide the split (48, 5) and at 1, against the gather + plain version;
    both counts move, two launches are bit-identical."""
    args = _paged(cuda, P, n_pg, G, P + n_pg + G)
    args[0] = args[0].to(getattr(torch, dtype))
    before = (decode_attention.launches, decode_attention.launches_paged)
    out = decode_attention_paged(*args)
    again = decode_attention_paged(*args)
    torch.cuda.synchronize()
    assert (decode_attention.launches - before[0],
            decode_attention.launches_paged - before[1]) == (2, 2)
    assert torch.equal(out, again)
    _fd_close(out, decode_attention_paged_ref(*args))


def test_paged_entry_refuses_what_it_cannot_take(cuda):
    q, pool_k, pool_v, pt, lengths, ks, vs = _paged(cuda, 16, 4, 4, 0)
    with pytest.raises(ValueError, match="int32"):
        decode_attention_paged(q, pool_k, pool_v, pt.long(), lengths, ks, vs)
    strided = pool_k.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention_paged(q, strided, pool_v, pt, lengths, ks, vs)
    flat = torch.zeros(pool_k.numel() + 16, dtype=torch.int8, device=cuda)
    shifted = flat[8:8 + pool_k.numel()].view(pool_k.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention_paged(q, shifted, pool_v, pt, lengths, ks, vs)
    with pytest.raises(ValueError, match="CUDA kernel"):
        decode_attention_paged(q[..., :48].contiguous(),
                               pool_k[..., :48].contiguous(),
                               pool_v[..., :48].contiguous(), pt, lengths,
                               ks, vs)
    with pytest.raises(RuntimeError, match="CUDA device or on"):
        decode_attention_paged(q, pool_k.cpu(), pool_v, pt, lengths, ks, vs)


def test_slot_entry_refuses_misaligned_kv(cuda):
    S, T, Hkv, G, hd = 2, 64, 2, 4, 16
    q = _rand((S, Hkv, G, hd), 0, cuda).bfloat16()
    n = S * T * Hkv * hd
    flat = torch.zeros(n + 8, dtype=torch.bfloat16, device=cuda)
    k = flat[4:4 + n].view(S, T, Hkv, hd)
    v = torch.zeros((S, T, Hkv, hd), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention(q, k, v, torch.ones(S, dtype=torch.int32,
                                             device=cuda))


@pytest.mark.parametrize("layout", ["channel", "group:128", "group:32"])
@pytest.mark.parametrize("M", [1, 8, 130])
def test_quant_matmul_kernel(cuda, layout, M):
    K, N = 256, 128
    rng = np.random.default_rng(M)
    x = _rand((M, K), 3, cuda)
    q4 = torch.from_numpy(rng.integers(-8, 8, size=(K, N)).astype(np.int8))
    qw = pack_int4(q4, axis=0).to(cuda)
    s_wl = torch.from_numpy(np.exp(rng.normal(size=K) * 0.2).astype(
        np.float32) * 0.05).to(cuda)
    shape = (N,) if layout == "channel" else (K // int(layout[6:]), N)
    s_wr = torch.from_numpy(np.exp(rng.normal(size=shape) * 0.2).astype(
        np.float32)).to(cuda)
    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        args = (x.to(dt), qw, s_wl, s_wr)
        before = quant_matmul.launches
        y = quant_matmul(*args)
        torch.cuda.synchronize()
        assert quant_matmul.launches == before + 1
        torch.testing.assert_close(y.float(), quant_matmul_ref(*args).float(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", ["channel", "group:128", "group:32"])
@pytest.mark.parametrize("M", [1, 8, 130])
def test_quant_matmul_dequant_kernel(cuda, layout, M):
    """The dequant body (the baseline variant) against the plain version:
    f32 2e-5, bf16 2e-2; it counts on its own counter."""
    K, N = 256, 128
    rng = np.random.default_rng(M + 7)
    x = _rand((M, K), 4, cuda)
    q4 = torch.from_numpy(rng.integers(-8, 8, size=(K, N)).astype(np.int8))
    qw = pack_int4(q4, axis=0).to(cuda)
    s_wl = torch.from_numpy(np.exp(rng.normal(size=K) * 0.2).astype(
        np.float32) * 0.05).to(cuda)
    shape = (N,) if layout == "channel" else (K // int(layout[6:]), N)
    s_wr = torch.from_numpy(np.exp(rng.normal(size=shape) * 0.2).astype(
        np.float32)).to(cuda)
    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        args = (x.to(dt), qw, s_wl, s_wr)
        before = (quant_matmul.launches, quant_matmul.launches_dequant)
        y = quant_matmul(*args, variant="dequant")
        torch.cuda.synchronize()
        assert (quant_matmul.launches, quant_matmul.launches_dequant) == (
            before[0], before[1] + 1)
        torch.testing.assert_close(y.float(), quant_matmul_ref(*args).float(),
                                   rtol=tol, atol=tol)


#: the int8 (exempt) leaves the plan keeps at 8 bits, as [K, N]:
#: deepseek-v2-236b's MLA k_up, kv_down and q_down, the paper CNN's fc, a
#: router (qwen2-moe-a2.7b: N 60) and ragged edges
_INT8_SHAPES = {"k_up": (512, 16384), "kv_down": (5120, 576),
                "q_down": (5120, 1536), "cnn_fc": (64, 10),
                "router": (2048, 60), "ragged": (200, 70)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 8, 33])
@pytest.mark.parametrize("layout", ["channel", "group"])
@pytest.mark.parametrize("name", sorted(_INT8_SHAPES))
def test_quant_matmul_int8_kernel(cuda, name, layout, M, dtype):
    """K1's int8 entry against its plain version at the int8 leaves'
    shapes, channel and grouped (group 128 where it divides K, else 8):
    f32 within 1e-5 of max|ref|, bf16 within one bf16 rounding (2^-7 of
    max|ref|); two launches bit-identical; counted on launches_int8 only."""
    K, N = _INT8_SHAPES[name]
    group = 128 if K % 128 == 0 else 8
    rng = np.random.default_rng(K + N + M)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(
        dt).to(cuda)
    q = torch.from_numpy(rng.integers(-128, 128, size=(K, N)).astype(
        np.int8)).to(cuda)
    s_wl = torch.from_numpy(np.exp(rng.normal(size=K) * 0.2).astype(
        np.float32) * 0.05).to(cuda)
    shape = (N,) if layout == "channel" else (K // group, N)
    s_wr = torch.from_numpy(np.exp(rng.normal(size=shape) * 0.2).astype(
        np.float32) * 0.01).to(cuda)
    counts = (quant_matmul.launches, quant_matmul.launches_dequant,
              quant_matmul.launches_int8, quant_matmul.launches_fma)
    y = quant_matmul_int8(x, q, s_wl, s_wr)
    again = quant_matmul_int8(x, q, s_wl, s_wr)
    torch.cuda.synchronize()
    assert (quant_matmul.launches, quant_matmul.launches_dequant,
            quant_matmul.launches_int8, quant_matmul.launches_fma) == (
        counts[0], counts[1], counts[2] + 2, counts[3])
    assert y.dtype == dt and y.shape == (M, N)
    assert torch.equal(y, again)
    ref = quant_matmul_int8_ref(x, q, s_wl, s_wr).float()
    err = (y.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= (1e-5 if dtype == "float32" else 2 ** -7) * scale, (
        err, scale)


@pytest.mark.parametrize("group", [None, 16, 32, 64, 128])
@pytest.mark.parametrize("M", [1, 8, 9, 16])
@pytest.mark.parametrize("K,N", [(4096, 1024), (1024, 64), (640, 320)])
def test_quant_matmul_int8_mma_body(cuda, K, N, M, group):
    """K1's int8 entry on its ``mma`` body (bf16 x, M ≤ 16): every group
    size the packed bodies take (one per split, whole groups per split, a
    group past the 64-row step), one and two token tiles, against the
    plain version within one bf16 rounding (2^-7 of max|ref|), with the
    extreme weights -128 and 127 among the draws; two launches
    bit-identical; counted on launches_int8 alone."""
    assert qmm.plan_int8(M, N, K, group, torch.bfloat16).body == "mma"
    rng = np.random.default_rng(K + N + M + (group or 0))
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(
        torch.bfloat16).to(cuda)
    qn = rng.integers(-128, 128, size=(K, N)).astype(np.int8)
    qn[0, :2], qn[-1, -2:] = (-128, 127), (127, -128)
    q = torch.from_numpy(qn).to(cuda)
    s_wl = torch.from_numpy(np.exp(rng.normal(size=K) * 0.2).astype(
        np.float32) * 0.05).to(cuda)
    shape = (N,) if group is None else (K // group, N)
    s_wr = torch.from_numpy(np.exp(rng.normal(size=shape) * 0.2).astype(
        np.float32) * 0.01).to(cuda)
    counts = (_qmm_counts(), quant_matmul.launches, quant_matmul.launches_int8)
    y = quant_matmul_int8(x, q, s_wl, s_wr)
    again = quant_matmul_int8(x, q, s_wl, s_wr)
    torch.cuda.synchronize()
    assert (_qmm_counts(), quant_matmul.launches,
            quant_matmul.launches_int8) == (counts[0], counts[1],
                                            counts[2] + 2)
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    assert torch.equal(y, again)
    ref = quant_matmul_int8_ref(x, q, s_wl, s_wr).float()
    err = (y.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= 2 ** -7 * scale, (err, scale)


#: int4 shapes the int4 entry does not tile (N under or off 64): SMOKE
#: width's N 32, a router's N 60, ragged, N 96
_INT4_UNTILED = {"smoke_n32": (64, 32), "router_n60": (2048, 60),
                 "ragged": (200, 70), "n96": (1024, 96)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 8, 33])
@pytest.mark.parametrize("layout", ["channel", "group"])
@pytest.mark.parametrize("name", sorted(_INT4_UNTILED))
def test_quant_matmul_int8_packed(cuda, name, layout, M, dtype):
    """An int4 leaf the int4 entry does not tile: ``qlinear_deployed``
    sends its packed weight to K1's int8 entry, which reads the nibbles in
    place (launches_int8 + 1 a call; the int4 entry's counts unchanged),
    against the plain version on the unpacked weight: f32 within 1e-5 of
    max|ref|, bf16 within one bf16 rounding; -8 and 7 among the draws; two
    calls bit-identical."""
    K, N = _INT4_UNTILED[name]
    group = 32 if K % 32 == 0 else 8
    rng = np.random.default_rng(K + N + M + 7)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(
        dt).to(cuda)
    q4 = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    q4[0, :2], q4[-1, -2:] = (-8, 7), (7, -8)
    q = torch.from_numpy(q4)
    s_wl = torch.from_numpy(np.exp(rng.normal(size=K) * 0.2).astype(
        np.float32) * 0.05).to(cuda)
    shape = (N,) if layout == "channel" else (K // group, N)
    s_wr = torch.from_numpy(np.exp(rng.normal(size=shape) * 0.2).astype(
        np.float32)).to(cuda)
    ex = {"q": pack_int4(q, axis=0).to(cuda), "s_wl": s_wl, "s_wr": s_wr}
    counts = (_qmm_counts(), quant_matmul.launches, quant_matmul.launches_int8)
    y = qlinear_deployed(x, ex)
    again = qlinear_deployed(x, ex)
    torch.cuda.synchronize()
    assert (_qmm_counts(), quant_matmul.launches,
            quant_matmul.launches_int8) == (counts[0], counts[1],
                                            counts[2] + 2)
    assert y.dtype == dt and y.shape == (M, N)
    assert torch.equal(y, again)
    ref = quant_matmul_int8_ref(x, q.to(cuda), s_wl, s_wr).float()
    err = (y.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= (1e-5 if dtype == "float32" else 2 ** -7) * scale, (
        err, scale)


def _qmm_args(M, K, N, group, seed, dt, device):
    """x, qw, s_wl, s_wr for one quant_matmul call; group None = channel."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    q4 = torch.from_numpy(rng.integers(-8, 8, size=(K, N)).astype(np.int8))
    s_wl = np.exp(rng.normal(size=K) * 0.2).astype(np.float32) * 0.05
    shape = (N,) if group is None else (K // group, N)
    s_wr = np.exp(rng.normal(size=shape) * 0.2).astype(np.float32)
    return (x.to(dt).to(device), pack_int4(q4, axis=0).to(device),
            torch.from_numpy(s_wl).to(device),
            torch.from_numpy(s_wr).to(device))


_QMM_BODY_COUNTS = ("launches_mma", "launches_mma_wide", "launches_fma")


def _qmm_counts():
    return tuple(getattr(quant_matmul, c) for c in _QMM_BODY_COUNTS)


@pytest.mark.parametrize("variant", ["int8dot", "dequant"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [None, 16, 32, 64, 128])
@pytest.mark.parametrize("M", [1, 4, 8, 16, 17, 64, 130])
@pytest.mark.parametrize("K,N", [(4096, 1024), (1024, 64), (640, 320)])
def test_quant_matmul_split_k_edges(cuda, variant, dtype, group, M, K, N):
    """Each body at its edges: M from 1 to past one wide tile, K-splits
    that do not divide K evenly (4096 in 192-row splits), one 64-column
    tile, a last 256-column tile with dead warps (N 320), groups 16 … K;
    within f32 2e-5 / bf16 2e-2 of max|ref|, two launches bit-identical,
    and the body the plan names is the one counted."""
    dt = getattr(torch, dtype)
    args = _qmm_args(M, K, N, group, M * 7 + K + N, dt, cuda)
    p = qmm.plan(M, N, K, K if group is None else group, dt)
    assert qmm.nests(p.ksplit, K if group is None else group, K)
    before = (_qmm_counts(), quant_matmul.launches,
              quant_matmul.launches_dequant)
    y = quant_matmul(*args, variant=variant)
    again = quant_matmul(*args, variant=variant)
    torch.cuda.synchronize()
    body = _QMM_BODY_COUNTS.index(f"launches_{p.body}")
    want = [c + (2 if i == body else 0) for i, c in enumerate(before[0])]
    assert list(_qmm_counts()) == want
    dint8, ddeq = (quant_matmul.launches - before[1],
                   quant_matmul.launches_dequant - before[2])
    assert (dint8, ddeq) == ((2, 0) if variant == "int8dot" else (0, 2))
    assert torch.equal(y, again)
    ref = quant_matmul_ref(*args).float()
    tol = (2e-5 if dtype == "float32" else 2e-2) * float(ref.abs().max())
    assert float((y.float() - ref).abs().max()) <= tol


def test_quant_matmul_route_check_shape(cuda):
    """kernel_route_check's probe (M 4 rows of f32 on a 4096 x 1024 channel
    linear) against x @ the f32 dequantized weight: within 1e-4 absolute,
    the bound chip_smoke and the pipeline hold it to, on the fma body."""
    x, qw, s_wl, s_wr = _qmm_args(4, 4096, 1024, None, 11, torch.float32,
                                  cuda)
    s_wr = s_wr * 0.01
    w = unpack_int4(qw, axis=0).float() * s_wl[:, None] * s_wr[None, :]
    before = quant_matmul.launches_fma
    y = quant_matmul(x, qw, s_wl, s_wr)
    torch.cuda.synchronize()
    assert quant_matmul.launches_fma == before + 1
    assert float((y - x @ w).abs().max()) <= 1e-4


def test_quant_matmul_refuses_what_the_gate_refuses(cuda):
    """N or K off the 64 grid, a group of 96 or 8, f16 x: ValueError, and
    no launch is counted."""
    before = (quant_matmul.launches, _qmm_counts())
    for M, K, N, group, dt in ((4, 64, 96, None, torch.bfloat16),
                               (4, 96, 64, None, torch.bfloat16),
                               (4, 192, 64, 96, torch.float32),
                               (4, 128, 64, 8, torch.bfloat16),
                               (4, 64, 64, None, torch.float16)):
        args = _qmm_args(M, K, N, group, 0, dt, cuda)
        with pytest.raises(ValueError):
            quant_matmul(*args)
    assert (quant_matmul.launches, _qmm_counts()) == before


FA_TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
          "bfloat16": dict(rtol=3e-2, atol=3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,hd", [(128, 64), (200, 128), (64, 256), (70, 16)])
def test_flash_attention_kernel(cuda, dtype, causal, S, hd):
    """[BH, S, hd] against the plain version within the reference's
    tolerances; a ragged last tile (S = 200, 70); two runs bit-equal."""
    dt = getattr(torch, dtype)
    q, k, v = (_rand((3, S, hd), i, cuda).to(dt) for i in (5, 6, 7))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert out.shape == q.shape and out.dtype == dt
    assert torch.equal(out, again)
    ref = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), **FA_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_prefill_gqa_kernel(cuda, dtype):
    """The [B, S, H, hd] layout with 4 query heads per kv head, read
    through strides (a non-contiguous q as the model hands it)."""
    dt = getattr(torch, dtype)
    B, S, H, Hkv, hd = 2, 130, 8, 2, 128
    q = _rand((B, H, S, hd), 8, cuda).to(dt).transpose(1, 2)
    k, v = (_rand((B, S, Hkv, hd), i, cuda).to(dt) for i in (9, 10))
    out = attention_prefill(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert out.shape == (B, S, H, hd)
    ref = attention_prefill_ref(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), **FA_TOL[dtype])


def _fused_qkv(B, S, H, Hkv, hd, seed, device):
    """bf16 q [B, S, H, hd] and k, v [B, S, Hkv, hd] as views of one fused
    [B, S, (H + 2 Hkv) hd] projection: strided in S, as a fused qkv
    matmul hands them over."""
    qkv = _rand((B, S, (H + 2 * Hkv) * hd), seed, device).bfloat16()
    q = qkv[..., :H * hd].view(B, S, H, hd)
    k = qkv[..., H * hd:(H + Hkv) * hd].view(B, S, Hkv, hd)
    v = qkv[..., (H + Hkv) * hd:].view(B, S, Hkv, hd)
    return q, k, v


def _fa_counts():
    return (flash_attention.launches, flash_attention.launches_wgmma,
            flash_attention.launches_fma)


@pytest.mark.parametrize("heads", [(32, 8), (4, 1)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 17, 64, 300, 512])
def test_attention_prefill_tensor_core_body(cuda, S, causal, hd, heads):
    """The tensor-core body (bf16, hd 64/128) on strided views of a fused
    qkv projection, against the plain version at the reference's bf16
    tolerance; two runs bit-equal; both launches counted on that body."""
    H, Hkv = heads
    q, k, v = _fused_qkv(2, S, H, Hkv, hd, S + hd + H, cuda)
    before = _fa_counts()
    out = attention_prefill(q, k, v, causal=causal)
    again = attention_prefill(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _fa_counts() == (before[0] + 2, before[1] + 2, before[2])
    assert out.shape == (2, S, H, hd) and out.dtype == torch.bfloat16
    assert torch.equal(out, again)
    ref = attention_prefill_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), **FA_TOL["bfloat16"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,Sk", [(100, 300), (300, 100), (64, 1)])
def test_tensor_core_body_with_sk_other_than_s(cuda, S, Sk, causal):
    """[B, S, H, hd] with Sk != S through the tensor-core body (causal mask
    aligned at 0, as the reference's), and the [BH, S, hd] form through the
    FMA body, each against its plain version."""
    q = _rand((2, S, 8, 128), 11, cuda).bfloat16()
    k, v = (_rand((2, Sk, 2, 128), i, cuda).bfloat16() for i in (12, 13))
    before = _fa_counts()
    out = attention_prefill(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _fa_counts() == (before[0] + 1, before[1] + 1, before[2])
    torch.testing.assert_close(
        out.float(), attention_prefill_ref(q, k, v, causal=causal).float(),
        **FA_TOL["bfloat16"])
    q3 = _rand((3, S, 128), 14, cuda).bfloat16()
    k3, v3 = (_rand((3, Sk, 128), i, cuda).bfloat16() for i in (15, 16))
    before = _fa_counts()
    out3 = flash_attention(q3, k3, v3, causal=causal)
    again = flash_attention(q3, k3, v3, causal=causal)
    torch.cuda.synchronize()
    assert _fa_counts() == (before[0] + 2, before[1], before[2] + 2)
    assert torch.equal(out3, again)
    torch.testing.assert_close(
        out3.float(), flash_attention_ref(q3, k3, v3, causal=causal).float(),
        **FA_TOL["bfloat16"])


def test_tensor_core_body_takes_heads_major_views_and_refuses_misaligned(
        cuda):
    """A q transposed from [B, H, S, hd] goes through the tensor-core body;
    a view whose base is not 16-byte aligned raises instead of launching."""
    B, S, H, Hkv, hd = 2, 130, 8, 2, 64
    q = _rand((B, H, S, hd), 17, cuda).bfloat16().transpose(1, 2)
    k, v = (_rand((B, S, Hkv, hd), i, cuda).bfloat16() for i in (18, 19))
    before = _fa_counts()
    out = attention_prefill(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _fa_counts() == (before[0] + 1, before[1] + 1, before[2])
    torch.testing.assert_close(
        out.float(), attention_prefill_ref(q, k, v, causal=True).float(),
        **FA_TOL["bfloat16"])
    flat = _rand((B * S * H * hd + 1,), 20, cuda).bfloat16()
    shifted = flat[1:].view(B, S, H, hd)               # base off by 2 bytes
    with pytest.raises(ValueError, match="16-byte"):
        attention_prefill(shifted, k, v)
    assert _fa_counts() == (before[0] + 1, before[1] + 1, before[2])


def test_teacher_forward_goes_through_flash_attention(cuda):
    """A no-gradient forward with use_kernels runs the kernel once a layer
    and stays within f32 summation order of the plain route; a forward
    that needs a gradient keeps _sdpa (the kernel has no backward)."""
    from repro_torch.configs.qwen3_8b import SMOKE
    from repro_torch.models import forward, init_model
    teacher = init_model(0, SMOKE, None, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, SMOKE.vocab, (2, 100))).to(cuda)
    out = {}
    for use in (True, False):
        before = flash_attention.launches
        with torch.no_grad():
            out[use] = forward(teacher, SMOKE, None, {"tokens": tokens},
                               compute_dtype=torch.float32,
                               use_kernels=use)["hidden"]
        torch.cuda.synchronize()
        assert flash_attention.launches - before == (
            SMOKE.n_layers if use else 0)
    torch.testing.assert_close(out[True], out[False], rtol=1e-4, atol=1e-4)
    for leaf in teacher["layers"]["attn"]["wq"].values():
        leaf.requires_grad_()
    before = flash_attention.launches
    forward(teacher, SMOKE, None, {"tokens": tokens}, use_kernels=True)
    assert flash_attention.launches == before


def test_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    q = torch.zeros((2, 1, 2, 48), device=cuda)       # hd 48: not built
    kv = torch.zeros((2, 8, 1, 48), device=cuda)
    with pytest.raises(ValueError, match="CUDA kernel"):
        decode_attention(q, kv, kv, torch.ones(2, dtype=torch.int32,
                                               device=cuda))
    x = torch.zeros((4, 96), device=cuda)               # K % 64
    with pytest.raises(ValueError, match="tiles_ok"):
        quant_matmul(x, torch.zeros((48, 64), dtype=torch.uint8, device=cuda),
                     torch.ones(96, device=cuda), torch.ones(64, device=cuda))
    big = torch.zeros((1, 8, 300), device=cuda)         # hd > 256
    with pytest.raises(ValueError, match="hd <= 256"):
        flash_attention(big, big, big)
    q16 = torch.zeros((1, 8, 64), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_attention(q16, q16, q16)


#: (logits, k): F8's two subnormal cases (6.3e-40 is a float32 subnormal)
#: and a boundary tie
TOP_K_CASES = [([0.0, 6.3e-40], 1), ([6.3e-40, 0.0, -1.0], 1),
               ([1e-45, -1e-45, 0.0, 2.0], 2), ([1.0, 2.0, 2.0, 0.5], 2)]


@pytest.mark.parametrize("case", range(len(TOP_K_CASES)))
def test_top_k_mask_on_the_card_keeps_subnormals(cuda, case):
    """F8 on the card: top_k_mask compares subnormals exactly, as the numpy
    reference (everything >= the k-th largest value) does."""
    from repro_torch.core.sampling import top_k_mask
    row, k = TOP_K_CASES[case]
    logits = np.asarray(row, np.float32)
    want = logits >= np.sort(logits)[::-1][k - 1]
    got = torch.isfinite(top_k_mask(torch.from_numpy(logits).to(cuda), k))
    np.testing.assert_array_equal(got.cpu().numpy(), want)


FQ_SCALES = {"full": lambda R, C: (R, C), "row": lambda R, C: (R, 1),
             "col": lambda R, C: (1, C), "scalar": lambda R, C: ()}


def _fq_case(R, C, shape, bits, device, seed=0):
    """x with a quarter of its elements on and around the clip bounds."""
    rng = np.random.default_rng(seed)
    qmax = 2 ** (bits - 1) - 1
    s = np.asarray(np.exp(rng.normal(size=shape) * 0.3) * 0.05, np.float32)
    ratio = rng.normal(size=(R, C)) * qmax * 0.6
    special = rng.choice([qmax - 0.5, qmax, qmax + 0.5, qmax + 2.0],
                         size=(R, C)) * rng.choice([-1, 1], size=(R, C))
    ratio = np.where(rng.random((R, C)) < 0.25, special, ratio)
    x = (ratio * np.broadcast_to(s, (R, C))).astype(np.float32)
    g = rng.normal(size=(R, C)).astype(np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(s).to(device),
            torch.from_numpy(g).to(device))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", list(FQ_SCALES))
@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_kernel_forward(cuda, dtype, scale, bits):
    """Bit-equal to the plain version; a ragged column edge (C = 1000)."""
    R, C = 70, 1000
    x, s, _ = _fq_case(R, C, FQ_SCALES[scale](R, C), bits, cuda)
    x = x.to(getattr(torch, dtype))
    before = fake_quant_kernel.launches_fwd
    y = fake_quant_kernel(x, s, bits)
    torch.cuda.synchronize()
    assert fake_quant_kernel.launches_fwd == before + 1
    assert y.dtype == x.dtype
    assert torch.equal(y, fake_quant_ref(x, s, bits))


@pytest.mark.parametrize("rule", ["kernel", "ste"])
@pytest.mark.parametrize("scale", list(FQ_SCALES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_kernel_backward(cuda, rule, scale, dtype):
    """gx bit-equal to the plain backward, gs bit-equal for a full scale
    and within 1e-5 x max|ref| where it is a sum (the order differs); two
    runs give the same bits (no atomics)."""
    R, C, bits = 200, 300, 4          # 200 rows: four 64-row chunks
    x, s, g = _fq_case(R, C, FQ_SCALES[scale](R, C), bits, cuda, seed=1)
    x, g = x.to(getattr(torch, dtype)), g.to(getattr(torch, dtype))
    runs = []
    for _ in range(2):
        xt = x.clone().requires_grad_()
        st = s.clone().requires_grad_()
        before = fake_quant_kernel.launches_bwd
        fake_quant_kernel(xt, st, bits, rule=rule).backward(g)
        torch.cuda.synchronize()
        assert fake_quant_kernel.launches_bwd == before + 1
        runs.append((xt.grad, st.grad))
    gx_ref, gs_ref = fake_quant_grad_ref(g, x, s, bits, rule)
    for gx, gs in runs:
        assert gs.shape == s.shape and gx.dtype == x.dtype
        assert torch.equal(gx, gx_ref)
        if scale == "full":
            assert torch.equal(gs, gs_ref)
        else:
            err = float((gs - gs_ref).abs().max())
            assert err <= 1e-5 * float(gs_ref.abs().max()), err
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


#: paper-cnn's conv weights as the fake_quant kernel sees them, [kh·kw,
#: cin·cout], and the fc [64, 10]: (R, C, scale shape)
CNN_VIEWS = {"conv0": (9, 3 * 16, (1, 48)), "conv1": (9, 16 * 32, (1, 512)),
             "conv2": (9, 32 * 64, (1, 2048)), "fc": (64, 10, (64, 1))}


@pytest.mark.parametrize("rule", ["kernel", "ste"])
@pytest.mark.parametrize("view", list(CNN_VIEWS))
def test_fake_quant_kernel_at_the_cnn_views(cuda, view, rule):
    """K3 at the four paper-cnn weight views: forward bit for bit, gx bit
    for bit, the summed gs within 1e-5 x max|ref|."""
    R, C, shape = CNN_VIEWS[view]
    x, s, g = _fq_case(R, C, shape, 4, cuda, seed=R + C)
    xt, st = x.clone().requires_grad_(), s.clone().requires_grad_()
    y = fake_quant_kernel(xt, st, 4, rule=rule)
    y.backward(g)
    torch.cuda.synchronize()
    assert torch.equal(y.detach(), fake_quant_ref(x, s, 4))
    gx_ref, gs_ref = fake_quant_grad_ref(g, x, s, 4, rule)
    assert torch.equal(xt.grad, gx_ref)
    err = float((st.grad - gs_ref).abs().max())
    assert err <= 1e-5 * float(gs_ref.abs().max()), err


def test_cnn_finetune_launches_fake_quant_per_weight(cuda, tmp_path):
    """The paper-cnn pipeline on the card: each finetune step launches the
    fake_quant kernel once forward and once backward for each of the 3
    convs (the loss reads the pre-pool features: the fc is not run); the
    plain route agrees with it on one step's loss (1e-6) and gradients
    (1e-4 relative L2 per leaf)."""
    from repro_torch.pipeline import PipelineConfig, run_pipeline
    from repro_torch.pipeline.adapters import get_adapter
    from repro_torch.tree import tree_items
    pcfg = PipelineConfig(arch="paper-cnn", steps=3, calib_samples=256,
                          workdir=str(tmp_path))
    seen = {}

    def log(msg):
        if msg.startswith("stage "):
            seen[msg.split()[1]] = (fake_quant_kernel.launches_fwd,
                                    fake_quant_kernel.launches_bwd)
    before = (fake_quant_kernel.launches_fwd, fake_quant_kernel.launches_bwd)
    result = run_pipeline(pcfg, log=log)
    assert seen["init"] == before
    ft = (seen["finetune"][0] - before[0], seen["finetune"][1] - before[1])
    assert ft == (3 * pcfg.steps, 3 * pcfg.steps), ft
    assert result.metrics["evaluate"]["export_parity_max_err"] < 1e-4
    ad = get_adapter(pcfg)
    x = ad.x_calib[:64]
    out = {}
    for use in (True, False):
        ad.pcfg = dataclasses.replace(pcfg, use_kernels=use)
        student = {k: v for k, v in result.student.items()}
        out[use] = ad.loss_and_grads(student, result.teacher, x)
    (lk, gk), (lp, gp) = out[True], out[False]
    assert abs(float(lk) - float(lp)) <= 1e-6 * abs(float(lp))
    plain = dict(tree_items(gp))
    for path, g in tree_items(gk):
        ref = plain[path]
        if g is None or ref is None:            # the fc: not in the loss
            assert g is None and ref is None and path[0].startswith("fc")
            continue
        assert float((g - ref).norm()) <= 1e-4 * max(float(ref.norm()),
                                                     1e-30), path


def _route_step_gap(qcfg, device):
    """One SMOKE student step's loss and gradients through the kernels and
    through the plain route, both on the same teacher targets (computed
    once, through flash_attention), so the gap measures fake_quant alone;
    asserts one forward and one backward launch per quantized weight and
    microbatch.  Returns (loss pair, gradient pair)."""
    from repro_torch.configs.qwen3_8b import SMOKE
    from repro_torch.models import forward, init_model
    from repro_torch.train.steps import make_value_and_grad
    teacher = init_model(0, SMOKE, None, device=device)
    student = init_model(1, SMOKE, qcfg, device=device)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, SMOKE.vocab, (4, 16))).to(device)
    with torch.no_grad():
        targets = forward(teacher, SMOKE, None, {"tokens": tokens},
                          compute_dtype=torch.float32, use_kernels=True,
                          logits=False)
    out = {}
    for use in (True, False):
        fwd, bwd = fake_quant_kernel.launches_fwd, fake_quant_kernel.launches_bwd
        fa = flash_attention.launches
        vg = make_value_and_grad(SMOKE, qcfg, microbatches=2,
                                 compute_dtype=torch.float32,
                                 use_kernels=use)
        out[use] = vg(student, teacher, {"tokens": tokens}, targets=targets)
        assert flash_attention.launches == fa     # the teacher is not run
        torch.cuda.synchronize()
        n = (1 + 7 * SMOKE.n_layers) * 2 if use else 0
        assert fake_quant_kernel.launches_fwd - fwd == n
        assert fake_quant_kernel.launches_bwd - bwd == n
    return out[True], out[False]


def _assert_same_step(kernel, plain):
    from repro_torch.tree import tree_items
    (lk, gk), (lp, gp) = kernel, plain
    assert abs(float(lk) - float(lp)) <= 1e-6 * abs(float(lp))
    plain = dict(tree_items(gp))
    for path, g in tree_items(gk):
        if g is None:
            assert plain[path] is None, path
            continue
        ref = plain[path]
        assert float((g - ref).norm()) <= 1e-4 * float(ref.norm()) + 1e-12, \
            path


def test_training_step_kernel_route_matches_plain_route(cuda):
    """One SMOKE student step on the card (W4A8 DCHW: full weight scales):
    the weights' fake-quant through the kernel (the "ste" rule) and through
    the plain composition give the same loss and gradients (1e-6 / 1e-4
    relative L2 per leaf), on the same teacher targets."""
    from repro_torch.core.qconfig import QuantConfig
    _assert_same_step(*_route_step_gap(QuantConfig(), cuda))


def test_training_step_routes_match_for_the_pipeline_mode(cuda):
    """The same for the pipeline's default mode, w4a8 (deployment-oriented:
    layerwise right scales, so the weight scale reaches the kernel as one
    value per row and its gradient is a reduced sum)."""
    from repro_torch.core.qconfig import deployment_oriented
    _assert_same_step(*_route_step_gap(deployment_oriented(), cuda))


@pytest.mark.parametrize("scale", ["full", "col", "shared"])
def test_stacked_weight_fake_quant_goes_through_kernel(cuda, scale):
    """A stacked ``[E, in, out]`` weight with ``use_kernels`` runs through
    the kernel in one forward and one backward launch (the ``[E·in, out]``
    view, its scale broadcast to the weight's shape), never through the
    plain composition: forward bit-equal to it, gradients within 1e-5 x
    max|ref| of its autograd gradients."""
    from repro_torch.core.dof import weight_fake_quant
    from repro_torch.core.fakequant import fake_quant
    E, R, C, bits = 3, 64, 96, 4
    shape = {"full": (E, R, C), "col": (E, 1, C), "shared": (R, C)}[scale]
    rng = np.random.default_rng(3)
    s = torch.from_numpy(np.asarray(
        np.exp(rng.normal(size=shape) * 0.3) * 0.05, np.float32)).to(cuda)
    w = (_rand((E, R, C), 4, cuda) * 0.3).contiguous()
    g = _rand((E, R, C), 5, cuda)
    grads = {}
    for use in (True, False):
        fwd, bwd = fake_quant_kernel.launches_fwd, fake_quant_kernel.launches_bwd
        wt, st = w.clone().requires_grad_(), s.clone().requires_grad_()
        y = (weight_fake_quant(wt, st, bits, use_kernels=True) if use
             else fake_quant(wt, st, bits, signed=True))
        y.backward(g)
        torch.cuda.synchronize()
        assert fake_quant_kernel.launches_fwd - fwd == (1 if use else 0)
        assert fake_quant_kernel.launches_bwd - bwd == (1 if use else 0)
        grads[use] = (y.detach(), wt.grad, st.grad)
    (yk, gwk, gsk), (yp, gwp, gsp) = grads[True], grads[False]
    assert torch.equal(yk, yp)
    for got, ref in ((gwk, gwp), (gsk, gsp)):
        assert got.shape == ref.shape
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), err


def test_cli_quantize_on_the_card(cuda, tmp_path, capsys):
    """``python -m repro_torch quantize`` on the SMOKE model on the card:
    every stage, through the kernels, export parity below 1e-4; a rerun on
    the workdir resumes after finetune."""
    from repro_torch.pipeline.cli import main
    args = ["quantize", "--config", "qwen3_8b", "--steps", "2",
            "--calib-samples", "32", "--calib-seq-len", "64",
            "--calib-batch-size", "4", "--serve-smoke",
            "--workdir", str(tmp_path)]
    before = flash_attention.launches
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "stage evaluate" in out and "pipeline complete" in out
    assert "'kernel': True" in out
    assert flash_attention.launches > before
    assert main(args) == 0
    assert "skipped (resume): calibrate, init, finetune" in \
        capsys.readouterr().out


def test_pipeline_plain_route_launches_no_kernel(cuda):
    """``PipelineConfig(use_kernels=False)`` reaches every stage: a whole
    run on the card launches none of the five kernels, and evaluate has no
    kernel-route record."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.pipeline import PipelineConfig, run_pipeline
    counts = lambda: (fake_quant_kernel.launches_fwd,  # noqa: E731
                      fake_quant_kernel.launches_bwd,
                      flash_attention.launches, quant_matmul.launches,
                      quant_matmul.launches_dequant, decode_attention.launches)
    before = counts()
    result = run_pipeline(PipelineConfig(
        arch="qwen3-8b", steps=1, calib_samples=32, calib_seq_len=64, calib_batch_size=4,
        serve_smoke=True, use_kernels=False))
    torch.cuda.synchronize()
    assert counts() == before
    ev = result.metrics["evaluate"]
    assert "kernel_route" not in ev and ev["export_parity_max_err"] < 1e-4


# ---------------------------------------------------------------------------
# The MoE family (qwen2-moe-a2.7b): K3 on the expert stacks, K2 at a GQA
# group of 1, the sort-based dispatch on the card
# ---------------------------------------------------------------------------

def test_expert_stack_fake_quant_in_one_launch(cuda):
    """An ``[E, in, out]`` expert stack with its S_wL ⊗ S_wR scale (the
    input stream's ``[in]`` shared by every expert): one forward and one
    backward launch, forward and ``gx`` bit-equal to the per-expert loop of
    launches and to the plain composition, ``gs`` within 1e-5 x max|ref|."""
    from repro_torch.core.dof import weight_fake_quant
    from repro_torch.core.fakequant import fake_quant
    E, R, C, bits = 6, 64, 96, 4
    rng = np.random.default_rng(12)
    s_wl = np.exp(rng.normal(size=(R, 1)) * 0.3)
    s_wr = np.exp(rng.normal(size=(E, 1, C)) * 0.3) * 0.05
    s = torch.from_numpy((s_wl * s_wr).astype(np.float32)).to(cuda)
    w = (_rand((E, R, C), 13, cuda) * 0.3).contiguous()
    g = _rand((E, R, C), 14, cuda)
    outs = {}
    for how in ("stack", "loop", "plain"):
        fwd, bwd = fake_quant_kernel.launches_fwd, fake_quant_kernel.launches_bwd
        wt, st = w.clone().requires_grad_(), s.clone().requires_grad_()
        if how == "stack":
            y = weight_fake_quant(wt, st, bits, use_kernels=True)
        elif how == "loop":
            y = torch.stack([fake_quant_kernel(wt[e], st[e], bits, "ste")
                             for e in range(E)])
        else:
            y = fake_quant(wt, st, bits, signed=True)
        y.backward(g)
        torch.cuda.synchronize()
        n = {"stack": 1, "loop": E, "plain": 0}[how]
        assert (fake_quant_kernel.launches_fwd - fwd,
                fake_quant_kernel.launches_bwd - bwd) == (n, n), how
        outs[how] = (y.detach(), wt.grad, st.grad)
    y, gx, gs = outs["stack"]
    for ref in ("loop", "plain"):
        ry, rgx, rgs = outs[ref]
        assert torch.equal(y, ry) and torch.equal(gx, rgx), ref
        assert float((gs - rgs).abs().max()) <= 1e-5 * float(
            rgs.abs().max()), ref


def test_paged_entry_at_qwen2_moe_heads(cuda):
    """The paged entry at qwen2-moe-a2.7b's slot pool: 8 slots, 16 kv
    heads, a GQA group of 1, hd 128, pages of 16, 128 pages a slot, bf16
    queries; against the gather + plain version, two launches
    bit-identical."""
    S, Hkv, G, hd, P, n_pg = 8, 16, 1, 128, 16, 128
    g = torch.Generator().manual_seed(21)
    n_pages = S * n_pg
    pool_k, pool_v = (torch.randint(-127, 128, (n_pages + 1, P, Hkv, hd),
                                    generator=g, dtype=torch.int8)
                      for _ in range(2))
    pool_k[n_pages] = 127
    pool_v[n_pages] = 127
    lengths = torch.tensor([1, 25, 138, 308, 1008, 33, 2047, 2048],
                           dtype=torch.int32)
    pt = torch.randperm(n_pages, generator=g).to(torch.int32).reshape(S, n_pg)
    for s in range(S):
        pt[s, -(-int(lengths[s]) // P):] = n_pages
    q = torch.randn((S, Hkv, G, hd), generator=g).bfloat16()
    ks, vs = (torch.rand((S, Hkv), generator=g) * 0.02 + 0.005
              for _ in range(2))
    args = [t.to(cuda) for t in (q, pool_k, pool_v, pt, lengths, ks, vs)]
    out = decode_attention_paged(*args)
    again = decode_attention_paged(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _fd_close(out, decode_attention_paged_ref(*args))


def _moe_smoke(cf=3.0):
    from repro_torch.configs.qwen2_moe_a2_7b import SMOKE
    return dataclasses.replace(SMOKE, moe=dataclasses.replace(
        SMOKE.moe, capacity_factor=cf))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_sorted_on_the_card(cuda, dtype):
    """The sort-based dispatch on the card, W4A8 experts through K3: equal
    to the dense oracle (nothing drops at capacity_factor 3; f32 to 1e-5,
    bf16 to 2e-2 of max|ref|, the oracle's einsum rounding once), and two
    runs bit-identical (the combine sums in a fixed order)."""
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import moe
    cfg, qcfg = _moe_smoke(), QuantConfig()
    p = moe.init_moe(torch.Generator(device=cuda).manual_seed(0), cfg, qcfg)
    x = _rand((64, cfg.d_model), 22, cuda).to(getattr(torch, dtype))
    with torch.no_grad():
        runs = [moe.moe_sorted(x, p, cfg, qcfg, use_kernels=True)
                for _ in range(2)]
        dense = moe.moe_dense(x, p, cfg, qcfg, use_kernels=True)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    tol = 1e-5 if dtype == "float32" else 2e-2
    err = float((runs[0].float() - dense.float()).abs().max())
    assert err <= tol * float(dense.float().abs().max()), err


def test_moe_decode_step_makes_no_host_sync(cuda):
    """One decode step of a MoE engine on the card (routing, the sorted
    dispatch, K2's paged entry, sampling) under
    ``torch.cuda.set_sync_debug_mode("error")``: no operation reads the
    device back to the host."""
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import init_model
    from repro_torch.serve.deploy import export_for_layers, make_deploy_plan
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    cfg, qcfg = _moe_smoke(), QuantConfig()
    params = init_model(0, cfg, qcfg, device=cuda)
    plan = make_deploy_plan(qcfg, arch=cfg.name, family=cfg.family,
                            params=params, model_cfg=cfg)
    eng = Engine.from_artifact(cfg, plan, export_for_layers(params, plan),
                               ServeConfig(max_slots=2, max_len=64,
                                           prefill_chunk=16))
    eng.submit(Request(prompt=[1, 2, 3, 4, 5], max_new_tokens=8))
    eng.step()                            # admit, prefill, install, decode
    before = decode_attention.launches_paged
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.cache, eng.state, _, _ = eng._decode(eng.params, eng.cache,
                                                 eng.state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert decode_attention.launches_paged - before == cfg.n_layers


# ---------------------------------------------------------------------------
# deepseek-v2-236b's MLA: K3 at an MLA weight, the latent-cache decode step,
# the absorbed decode form
# ---------------------------------------------------------------------------

def _mla_smoke(cf=4.0, absorb=False):
    from repro_torch.configs.deepseek_v2_236b import SMOKE
    return dataclasses.replace(SMOKE, mla_absorb=absorb,
                               moe=dataclasses.replace(SMOKE.moe,
                                                       capacity_factor=cf))


@pytest.mark.parametrize("rule", ["kernel", "ste"])
def test_fake_quant_kernel_at_an_mla_view(cuda, rule):
    """K3 at deepseek-v2-236b's k_up/v_up weight ``[512, 16384]`` with its
    full S_wL ⊗ S_wR scale (``kv_stream``'s ``[512]`` times ``[16384]``):
    forward, gx and gs bit for bit against the plain version."""
    R, C = 512, 16384
    x, s, g = _fq_case(R, C, (R, C), 4, cuda, seed=23)
    xt, st = x.clone().requires_grad_(), s.clone().requires_grad_()
    before = fake_quant_kernel.launches_fwd
    y = fake_quant_kernel(xt, st, 4, rule=rule)
    y.backward(g)
    torch.cuda.synchronize()
    assert fake_quant_kernel.launches_fwd == before + 1
    assert torch.equal(y.detach(), fake_quant_ref(x, s, 4))
    gx_ref, gs_ref = fake_quant_grad_ref(g, x, s, 4, rule)
    assert torch.equal(xt.grad, gx_ref)
    assert torch.equal(st.grad, gs_ref)


def _mla_engine(cuda, absorb=False):
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import init_model
    from repro_torch.serve.deploy import export_for_layers, make_deploy_plan
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg, qcfg = _mla_smoke(absorb=absorb), QuantConfig()
    params = init_model(0, cfg, qcfg, device=cuda)
    plan = make_deploy_plan(qcfg, arch=cfg.name, family=cfg.family,
                            params=params, model_cfg=cfg)
    return Engine.from_artifact(cfg, plan, export_for_layers(params, plan),
                                ServeConfig(max_slots=2, max_len=64,
                                            prefill_chunk=16))


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_decode_step_makes_no_host_sync(cuda, absorb):
    """One decode step of an MLA engine on the card (the latent cache's
    per-slot write, the einsum attention in either decode form, the MoE
    dispatch, sampling) under ``torch.cuda.set_sync_debug_mode("error")``:
    no operation reads the device back to the host; no decode_attention
    or flash_attention launch."""
    from repro_torch.serve.engine import Request
    eng = _mla_engine(cuda, absorb)
    assert sorted(eng.cache) == ["ckv", "kr", "pos"]
    eng.submit(Request(prompt=[1, 2, 3, 4, 5], max_new_tokens=8))
    eng.step()                            # admit, prefill, install, decode
    before = (decode_attention.launches, flash_attention.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.cache, eng.state, _, _ = eng._decode(eng.params, eng.cache,
                                                 eng.state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (decode_attention.launches, flash_attention.launches) == before


@pytest.mark.parametrize("cached", [False, True])
def test_mla_absorbed_form_matches_default_form_on_the_card(cuda, cached):
    """``mla_attention`` in f32 on the card, a weights-only W4 student
    (no activation fake-quant, so the two forms are the same function):
    the absorbed form within 1e-5 x max|default| of the default one,
    cache-free and on a per-slot latent cache."""
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import attention
    cfg, qcfg = _mla_smoke(), QuantConfig(a_bits=None)
    p = attention.init_mla(torch.Generator(device=cuda).manual_seed(1), cfg,
                           qcfg)
    B, Sq = (3, 1) if cached else (2, 9)
    x = _rand((B, Sq, cfg.d_model), 24, cuda)
    pos = torch.tensor([4, 0, 12], dtype=torch.int32, device=cuda)
    positions = (pos[:, None] if cached else
                 torch.arange(Sq, device=cuda)[None].expand(B, Sq))
    outs = []
    for absorb in (False, True):
        cache = None
        if cached:
            m = cfg.mla
            cache = {"ckv": _rand((B, 16, m.kv_lora), 25, cuda),
                     "kr": _rand((B, 16, m.d_rope), 26, cuda), "pos": pos}
        with torch.no_grad():
            outs.append(attention.mla_attention(
                x, p, dataclasses.replace(cfg, mla_absorb=absorb), qcfg,
                positions, cache, use_kernels=True))
    torch.cuda.synchronize()
    err = float((outs[1] - outs[0]).abs().max())
    assert err <= 1e-5 * float(outs[0].abs().max()), err


# ---------------------------------------------------------------------------
# zamba2-7b's head dim 112 in K2; the Mamba2 block and the SSM/hybrid
# engines on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part", [1, 2, 4])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("kv", ["bfloat16", "int8", "float32"])
def test_split_body_hd112_against_plain(cuda, monkeypatch, part, G, kv):
    """hd 112, a row of 14 (bf16), 7 (int8) or 28 (f32) 16-byte vectors
    whose padding lanes read nothing: the split body at the whole tile, a
    half and a quarter, lengths 1, rows - 1, rows, rows + 1 and T (300, a
    ragged last split), against the plain version; two launches
    bit-identical."""
    rows = max(fd.tile_rows(getattr(torch, kv), 112, G) // part, 2)
    monkeypatch.setattr(fd, "split_rows", lambda T, slot_heads, tile: rows)
    S, T, Hkv, hd = 5, 300, 2, 112
    q = _rand((S, Hkv, G, hd), 31, cuda)
    k = _rand((S, T, Hkv, hd), 32, cuda)
    v = _rand((S, T, Hkv, hd), 33, cuda)
    lengths = torch.tensor([1, rows - 1, rows, rows + 1, T],
                           dtype=torch.int32, device=cuda)
    args = _fd_args(kv, q, k, v, lengths, S, Hkv)
    before = decode_attention.launches
    out = decode_attention(*args)
    again = decode_attention(*args)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert torch.equal(out, again)
    _fd_close(out, decode_attention_ref(*args))


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_decode_attention_hd112_at_zamba2_slot_pool(cuda, kv):
    """zamba2-7b's shared attention at its serving slot pool: 8 slots x
    T 2048, 32 kv heads, a GQA group of 1, hd 112, the engine's split, the
    main path's lengths; against the plain version."""
    S, T, Hkv, G, hd = 8, 2048, 32, 1, 112
    q = _rand((S, Hkv, G, hd), 34, cuda)
    k = _rand((S, T, Hkv, hd), 35, cuda)
    v = _rand((S, T, Hkv, hd), 36, cuda)
    lengths = torch.tensor([1, 25, 138, 308, 1008, 33, 2047, 2048],
                           dtype=torch.int32, device=cuda)
    args = _fd_args(kv, q, k, v, lengths, S, Hkv)
    _fd_close(decode_attention(*args), decode_attention_ref(*args))


@pytest.mark.parametrize("P,n_pg", [(16, 20), (5, 61)])
@pytest.mark.parametrize("G", [1, 4])
def test_paged_entry_hd112_against_plain(cuda, P, n_pg, G):
    """The paged entry at hd 112 (int8 pools, shuffled page ids, a trash
    page of 127s, a retired slot), against the gather + plain version;
    two launches bit-identical."""
    args = _paged(cuda, P, n_pg, G, 40 + P + G, hd=112)
    args[0] = args[0].bfloat16()
    out = decode_attention_paged(*args)
    again = decode_attention_paged(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _fd_close(out, decode_attention_paged_ref(*args))


def _ssm_smoke(name):
    from repro_torch.configs.registry import get_config
    return get_config(name, smoke=True)


@pytest.mark.parametrize("mode", ["none", "prefill", "decode"])
def test_ssm_block_on_the_card_matches_the_cpu(cuda, mode):
    """mamba2-1.3b's SMOKE Mamba2 block in f32, a weights-only W4 student
    (an A8 grid would turn a last-bit difference of the two devices'
    matmuls into a whole grid step) with its weights' fake-quant through
    K3 on the card and the plain route on the CPU: cache-free (S 37, a
    ragged last chunk), a cached prefill (S 20) and a decode step; outputs
    and the written cache 1e-4 of max|CPU|."""
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import ssm
    cfg, qcfg = _ssm_smoke("mamba2-1.3b"), QuantConfig(a_bits=None)
    p = ssm.init_ssm(torch.Generator().manual_seed(2), cfg, qcfg)
    B, S = 2, {"none": 37, "prefill": 20, "decode": 1}[mode]
    x = _rand((B, S, cfg.d_model), 41, "cpu")
    cache = None
    if mode != "none":
        cache = ssm.init_ssm_cache(cfg, B, 1)
        cache = {k: _rand(v.shape[1:], 42 + i, "cpu") * 0.3
                 for i, (k, v) in enumerate(sorted(cache.items()))}
    outs = []
    for dev in ("cpu", cuda):
        c = None if cache is None else {k: v.to(dev).clone()
                                        for k, v in cache.items()}
        with torch.no_grad():
            y = ssm.ssm_block(x.to(dev), {k: (v.to(dev) if torch.is_tensor(v)
                                              else {kk: vv.to(dev)
                                                    for kk, vv in v.items()})
                                          for k, v in p.items()},
                              cfg, qcfg, c, use_kernels=True)
        outs.append((y.cpu(), None if c is None else
                     {k: v.cpu() for k, v in c.items()}))
    torch.cuda.synchronize()
    (y0, c0), (y1, c1) = outs
    assert float((y1 - y0).abs().max()) <= 1e-4 * float(y0.abs().max())
    for k in (c0 or {}):
        assert float((c1[k] - c0[k]).abs().max()) <= 1e-4 * float(
            c0[k].abs().max()), k


def _serving_engine(cuda, name):
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import init_model
    from repro_torch.serve.deploy import export_for_layers, make_deploy_plan
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg, qcfg = _ssm_smoke(name), QuantConfig()
    params = init_model(0, cfg, qcfg, device=cuda)
    plan = make_deploy_plan(qcfg, arch=cfg.name, family=cfg.family,
                            params=params, model_cfg=cfg)
    return Engine.from_artifact(cfg, plan, export_for_layers(params, plan),
                                ServeConfig(max_slots=2, max_len=64,
                                            prefill_chunk=16))


def test_ssm_decode_step_makes_no_host_sync(cuda):
    """One decode step of a mamba2 SMOKE engine on the card (the
    recurrent state update written into the slot cache in place,
    sampling) under ``torch.cuda.set_sync_debug_mode("error")``: no
    operation reads the device back to the host; no attention kernel
    launches."""
    from repro_torch.serve.engine import Request
    eng = _serving_engine(cuda, "mamba2-1.3b")
    assert sorted(eng.cache) == ["conv_state", "ssm_state"]
    eng.submit(Request(prompt=list(range(1, 21)), max_new_tokens=8))
    eng.step()                            # admit, prefill, install, decode
    state = eng.cache["ssm_state"].clone()
    before = (decode_attention.launches, flash_attention.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.cache, eng.state, _, _ = eng._decode(eng.params, eng.cache,
                                                 eng.state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (decode_attention.launches, flash_attention.launches) == before
    assert not torch.equal(eng.cache["ssm_state"], state)


def test_hybrid_engine_routes_every_shared_attention_through_k2(cuda):
    """A zamba2 SMOKE engine on the card: ``stats()`` reports every
    shared-attention invocation of a decode step on the kernel route
    (n_layers // attn_every of them), and each decode step launches K2
    that many times; a decode step makes no host sync."""
    from repro_torch.serve.engine import Request
    eng = _serving_engine(cuda, "zamba2-7b")
    cfg = eng.cfg
    n_attn = cfg.n_layers // cfg.attn_every
    s = eng.stats()
    assert s["decode_attn_kernel_layers"] == n_attn
    assert s["decode_attn_ref_layers"] == 0
    eng.submit(Request(prompt=list(range(3, 40)), max_new_tokens=6))
    eng.step()
    before = decode_attention.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.cache, eng.state, _, _ = eng._decode(eng.params, eng.cache,
                                                 eng.state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert decode_attention.launches - before == n_attn
    out = eng.generate([Request(prompt=[5, 6, 7], max_new_tokens=4)])
    assert len(out[0]) == 4 and all(0 <= t < cfg.vocab for t in out[0])


# ---------------------------------------------------------------------------
# the VLM (qwen2-vl-7b: GQA group 7) and encoder-decoder (seamless-m4t-medium:
# the teacher's non-causal cross attention) shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_decode_attention_g7_at_qwen2_vl_slot_pool(cuda, kv):
    """The slot view at qwen2-vl-7b's 4 kv heads x a group of 7, hd 128,
    over the engine's 8 slots of 2048 rows (the int8 cache takes the
    4-row tiles of G > 4, a group slot of the 8 idle); lengths from 1 to
    T, against the plain version; two launches bit-identical."""
    S, T, Hkv, G, hd = 8, 2048, 4, 7, 128
    q = _rand((S, Hkv, G, hd), 30, cuda)
    k = _rand((S, T, Hkv, hd), 31, cuda)
    v = _rand((S, T, Hkv, hd), 32, cuda)
    lengths = torch.tensor([1, 17, 130, 300, 1000, 1016, 2047, 2048],
                           dtype=torch.int32, device=cuda)
    args = _fd_args(kv, q, k, v, lengths, S, Hkv)
    out = decode_attention(*args)
    again = decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _fd_close(out, decode_attention_ref(*args))


@pytest.mark.parametrize("P,n_pg", [(16, 128), (48, 7)])
def test_paged_entry_g7_against_plain(cuda, P, n_pg):
    """The paged entry at 4 kv heads x a group of 7, hd 128: the engine's
    page size over 2048 rows and a page size that does not divide the
    split, against the gather + plain version."""
    args = _paged(cuda, P, n_pg, 7, 40 + P, Hkv=4)
    args[0] = args[0].bfloat16()
    before = decode_attention.launches_paged
    out = decode_attention_paged(*args)
    torch.cuda.synchronize()
    assert decode_attention.launches_paged == before + 1
    _fd_close(out, decode_attention_paged_ref(*args))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [17, 512])
def test_tensor_core_body_at_qwen2_vl_heads(cuda, S, causal):
    """The tensor-core body at qwen2-vl-7b's 28 query heads over 4 kv heads
    (a group of 7), hd 128, on strided views of a fused qkv projection,
    against the plain version."""
    q, k, v = _fused_qkv(2, S, 28, 4, 128, 40 + S, cuda)
    before = _fa_counts()
    out = attention_prefill(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _fa_counts() == (before[0] + 1, before[1] + 1, before[2])
    torch.testing.assert_close(
        out.float(), attention_prefill_ref(q, k, v, causal=causal).float(),
        **FA_TOL["bfloat16"])


@pytest.mark.parametrize("Sq,Sk", [(64, 512), (1, 512), (300, 77)])
def test_tensor_core_body_cross_attention(cuda, Sq, Sk):
    """seamless-m4t-medium's cross attention: 16/16 heads, hd 64, non-causal,
    decoder queries over encoder keys of another length (the q a view of a
    projection, k and v views of one fused kv projection), through the
    tensor-core body, against the plain version; two runs bit-equal."""
    B, H, hd = 2, 16, 64
    q = _rand((B, Sq, H * hd), 41, cuda).bfloat16().view(B, Sq, H, hd)
    kv = _rand((B, Sk, 2 * H * hd), 42, cuda).bfloat16()
    k = kv[..., :H * hd].view(B, Sk, H, hd)
    v = kv[..., H * hd:].view(B, Sk, H, hd)
    before = _fa_counts()
    out = attention_prefill(q, k, v, causal=False)
    again = attention_prefill(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert _fa_counts() == (before[0] + 2, before[1] + 2, before[2])
    assert torch.equal(out, again)
    torch.testing.assert_close(
        out.float(), attention_prefill_ref(q, k, v, causal=False).float(),
        **FA_TOL["bfloat16"])


def test_encdec_teacher_forward_goes_through_flash_attention(cuda):
    """A seamless SMOKE teacher's no-gradient forward with use_kernels runs
    the kernel three times a layer pair — the encoder's and the decoder's
    causal self-attention and the decoder's non-causal cross attention —
    and stays within f32 summation order of the plain route; a cache-mode
    prefill launches it for the encoder and the cross attention only; a
    forward that needs a gradient launches nothing."""
    from repro_torch.configs.seamless_m4t_medium import SMOKE
    from repro_torch.models import forward, init_cache, init_model
    from repro_torch.tree import tree_items
    teacher = init_model(0, SMOKE, None, device=cuda)
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, SMOKE.vocab, (2, 40))).to(cuda),
             "frames": _rand((2, 96, SMOKE.d_model), 43, cuda)}
    out = {}
    for use in (True, False):
        before = flash_attention.launches
        with torch.no_grad():
            out[use] = forward(teacher, SMOKE, None, batch,
                               compute_dtype=torch.float32,
                               use_kernels=use)["hidden"]
        torch.cuda.synchronize()
        assert flash_attention.launches - before == (
            SMOKE.enc_layers + 2 * SMOKE.n_layers if use else 0)
    torch.testing.assert_close(out[True], out[False], rtol=1e-4, atol=1e-4)
    before = flash_attention.launches
    with torch.no_grad():
        forward(teacher, SMOKE, None, batch, init_cache(
            SMOKE, 2, 64, torch.float32, device=cuda),
            compute_dtype=torch.float32, use_kernels=True)
    # the prefill's encoder is a cache-free forward, and the cross
    # attention reads no cache of its own; the decoder's self-attention
    # over the cache takes _sdpa
    assert flash_attention.launches - before == (SMOKE.enc_layers
                                                 + SMOKE.n_layers)
    for _, leaf in tree_items(teacher):
        leaf.requires_grad_()
    before = flash_attention.launches
    forward(teacher, SMOKE, None, batch, use_kernels=True)
    assert flash_attention.launches == before


def test_vlm_engine_decodes_through_k2_at_group_7(cuda):
    """A qwen2-vl SMOKE engine narrowed to 7 query heads over one kv head:
    ``stats()`` puts every layer on the kernel route and each decode step
    launches the paged entry once a layer, with no host sync."""
    from repro_torch.configs.qwen2_vl_7b import SMOKE
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import init_model
    from repro_torch.serve.deploy import export_for_layers, make_deploy_plan
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    cfg = dataclasses.replace(SMOKE, n_heads=7, n_kv_heads=1,
                              n_heads_padded=7, n_kv_heads_padded=1)
    qcfg = QuantConfig()
    params = init_model(0, cfg, qcfg, device=cuda)
    plan = make_deploy_plan(qcfg, arch=cfg.name, family=cfg.family,
                            params=params, model_cfg=cfg)
    eng = Engine.from_artifact(cfg, plan, export_for_layers(params, plan),
                               ServeConfig(max_slots=2, max_len=64,
                                           prefill_chunk=16))
    assert eng._kv is not None
    assert eng.stats()["decode_attn_kernel_layers"] == cfg.n_layers
    eng.submit(Request(prompt=list(range(3, 40)), max_new_tokens=6))
    eng.step()
    before = decode_attention.launches_paged
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.cache, eng.state, _, _ = eng._decode(eng.params, eng.cache,
                                                 eng.state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert decode_attention.launches_paged - before == cfg.n_layers
    out = eng.generate([Request(prompt=[5, 6, 7], max_new_tokens=4)])
    assert len(out[0]) == 4 and all(0 <= t < cfg.vocab for t in out[0])


# ---------------------------------------------------------------------------
# GQA groups above 8 (command-r-plus-104b: 96/8 heads, G 12): the split pass
# takes the group in query chunks of 8, each a block re-reading the K/V rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [12, 16])
@pytest.mark.parametrize("kv", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("hd", [16, 128])
def test_decode_attention_g12_g16_slot_view(cuda, G, kv, hd):
    """The slot view at 8 kv heads x a group of 12 and of 16 over the
    engine's 8 slots of 2048 rows (lengths 1 .. T, one past T), against
    the plain version; two launches bit-identical."""
    S, T, Hkv = 8, 2048, 8
    q = _rand((S, Hkv, G, hd), 50 + G, cuda)
    k = _rand((S, T, Hkv, hd), 51, cuda)
    v = _rand((S, T, Hkv, hd), 52, cuda)
    lengths = torch.tensor([1, 17, 130, 300, 1000, 1016, 2047, 2100],
                           dtype=torch.int32, device=cuda)
    args = _fd_args(kv, q, k, v, lengths, S, Hkv)
    before = decode_attention.launches
    out = decode_attention(*args)
    again = decode_attention(*args)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert torch.equal(out, again)
    _fd_close(out, decode_attention_ref(*args))


@pytest.mark.parametrize("G", [12, 16])
@pytest.mark.parametrize("part", [1, 4])
def test_split_body_g12_g16_at_split_edges(cuda, monkeypatch, G, part):
    """Splits of the whole tile and a quarter at G 12 and 16 (int8, hd 128):
    lengths 1, rows - 1, rows, rows + 1 and T = 300."""
    rows = max(fd.tile_rows(torch.int8, 128, G) // part, 2)
    monkeypatch.setattr(fd, "split_rows", lambda T, slot_heads, tile: rows)
    S, T, Hkv = 5, 300, 2
    q = _rand((S, Hkv, G, 128), 60, cuda)
    k = _rand((S, T, Hkv, 128), 61, cuda)
    v = _rand((S, T, Hkv, 128), 62, cuda)
    lengths = torch.tensor([1, rows - 1, rows, rows + 1, T],
                           dtype=torch.int32, device=cuda)
    args = _fd_args("int8", q, k, v, lengths, S, Hkv)
    _fd_close(decode_attention(*args), decode_attention_ref(*args))


@pytest.mark.parametrize("G", [12, 16])
@pytest.mark.parametrize("P,n_pg", [(16, 128), (48, 7)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_paged_entry_g12_g16_against_plain(cuda, G, P, n_pg, dtype):
    """The paged entry at 8 kv heads x a group of 12 and of 16, hd 128: the
    engine's page size over 2048 rows and a page size that does not divide
    the split, against the gather + plain version; both counts move."""
    args = _paged(cuda, P, n_pg, G, 70 + P + G, Hkv=8)
    args[0] = args[0].to(getattr(torch, dtype))
    before = (decode_attention.launches, decode_attention.launches_paged)
    out = decode_attention_paged(*args)
    again = decode_attention_paged(*args)
    torch.cuda.synchronize()
    assert (decode_attention.launches - before[0],
            decode_attention.launches_paged - before[1]) == (2, 2)
    assert torch.equal(out, again)
    _fd_close(out, decode_attention_paged_ref(*args))


def test_decode_attention_refuses_g_above_16(cuda):
    q = torch.zeros((2, 1, 17, 128), device=cuda)
    kv = torch.zeros((2, 8, 1, 128), device=cuda)
    with pytest.raises(ValueError, match="CUDA kernel"):
        decode_attention(q, kv, kv, torch.ones(2, dtype=torch.int32,
                                               device=cuda))
