"""repro_torch kernel wrappers and the deployed linear vs the JAX package.

On the CPU each wrapper runs its plain PyTorch version; that is what is held
against the JAX Pallas kernels here (in interpret mode, as
tests/test_kernels.py runs them).  The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda.py and by
chip_smoke.py.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import dof as j_dof  # noqa: E402
from repro.core import permissive as j_permissive  # noqa: E402
from repro.kernels import decode_attention as j_decode_attention  # noqa: E402
from repro.kernels import quant_matmul as j_quant_matmul  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.ops import qlinear_deployed as j_qlinear_deployed  # noqa: E402
from repro.serve.deploy import kernel_route_check as j_route_check  # noqa: E402
from repro.serve.deploy import make_deploy_plan as j_make_plan  # noqa: E402
from repro.serve.deploy import export_for_layers as j_export  # noqa: E402
from repro.configs.qwen3_8b import SMOKE as J_SMOKE  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro_torch.core.fakequant import pack_int4  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_paged, split_rows, tile_rows)
from repro_torch.kernels.ops import kernel_tiles_ok, qlinear_deployed  # noqa: E402
from repro_torch.kernels import quant_matmul as t_qmm  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.serve.deploy import DeployPlan, kernel_route_check  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _qmm_case(M, K, N, layout, g, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    q4 = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    swl = (np.exp(rng.normal(size=(K,)) * 0.2) * 0.05).astype(np.float32)
    shape = (K // g, N) if layout == "group" else (N,)
    swr = np.exp(rng.normal(size=shape) * 0.2).astype(np.float32)
    return x, q4, swl, swr


@pytest.mark.parametrize("M,K,N,bk", [
    (64, 128, 64, 64), (128, 256, 128, 128), (32, 64, 256, 64),
    (128, 512, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["channel", "group"])
def test_quant_matmul_matches_jax(M, K, N, bk, dtype, layout):
    """test_quant_matmul_sweep's shapes and layouts: the port's quant_matmul
    (plain on the CPU) vs the JAX Pallas int8dot kernel in interpret mode;
    2e-5 in f32, 2e-2 in bf16 (outputs round to bf16 in both)."""
    g = min(bk, 64)
    x, q4, swl, swr = _qmm_case(M, K, N, layout, g, M + K + N)
    jdt = getattr(jnp, dtype)
    qw = pack_int4(_t(q4), axis=0).numpy()
    yj = j_quant_matmul(jnp.asarray(x, jdt), jnp.asarray(qw), jnp.asarray(swl),
                        jnp.asarray(swr), bk=bk, interpret=True)  # qft: noqa[QFT004] parity oracle
    xt = _t(x).to(getattr(torch, dtype))
    before = quant_matmul.launches
    yt = quant_matmul(xt, _t(qw), _t(swl), _t(swr))
    assert quant_matmul.launches == before     # no kernel launch on the CPU
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj, np.float32), rtol=tol, atol=tol)


def _fd_case(S, T, Hkv, G, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, Hkv, G, hd)).astype(np.float32)
    k = rng.normal(size=(S, T, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(S, T, Hkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("S,T,Hkv,G,hd,bk", [
    (3, 64, 2, 2, 16, 64), (5, 128, 2, 2, 8, 32), (4, 256, 1, 4, 32, 128),
    (2, 64, 4, 1, 16, 64)])
def test_decode_attention_matches_jax(S, T, Hkv, G, hd, bk):
    """test_decode_attention_parity's shapes and odd per-slot lengths
    (including length 1 and T), f32, 2e-5."""
    q, k, v = _fd_case(S, T, Hkv, G, hd, S * T + hd)
    lengths = (np.asarray([1, T // 3 + 1, bk, T, T // 2 + 3], np.int32)[:S]
               % (T + 1)).clip(1)
    oj = j_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lengths), bk=bk, interpret=True)  # qft: noqa[QFT004] parity oracle
    ot = decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=2e-5,
                               atol=2e-5)


def test_decode_attention_int8_matches_jax():
    """The int8 + per-slot per-kv-head scales path, f32, 2e-5."""
    S, T, Hkv, G, hd = 4, 96, 2, 4, 16
    q, _, _ = _fd_case(S, T, Hkv, G, hd, 11)
    rng = np.random.default_rng(12)
    k8 = rng.integers(-127, 128, size=(S, T, Hkv, hd)).astype(np.int8)
    v8 = rng.integers(-127, 128, size=(S, T, Hkv, hd)).astype(np.int8)
    ks = rng.uniform(0.005, 0.03, size=(S, Hkv)).astype(np.float32)
    vs = rng.uniform(0.005, 0.03, size=(S, Hkv)).astype(np.float32)
    lengths = np.asarray([1, 33, 64, 96], np.int32)
    oj = j_decode_attention(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                            jnp.asarray(lengths), k_scale=jnp.asarray(ks),
                            v_scale=jnp.asarray(vs), bk=32, interpret=True)  # qft: noqa[QFT004] parity oracle
    ot = decode_attention(_t(q), _t(k8), _t(v8), _t(lengths), _t(ks), _t(vs))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=2e-5,
                               atol=2e-5)


def _paged_case(S, P, n_pg, Hkv, G, hd, seed):
    """Int8 pools with a trash page of 127s, lengths 1 and T among them, a
    page table of shuffled, non-monotonic page ids padded with the trash
    page past each slot's length, and a retired last slot whose entries
    all point at the trash page (length 1, as the engine leaves it)."""
    rng = np.random.default_rng(seed)
    T, n_pages = n_pg * P, S * n_pg
    pools = [rng.integers(-127, 128, size=(n_pages + 1, P, Hkv, hd)
                          ).astype(np.int8) for _ in range(2)]
    for pool in pools:
        pool[n_pages] = 127
    lengths = np.asarray([1, T, T // 2 + 3, 1], np.int32)[:S]
    pt = rng.permutation(n_pages).astype(np.int32).reshape(S, n_pg)
    for s in range(S):
        pt[s, -(-int(lengths[s]) // P):] = n_pages
    pt[S - 1] = n_pages
    q = rng.normal(size=(S, Hkv, G, hd)).astype(np.float32)
    ks, vs = (rng.uniform(0.005, 0.03, size=(S, Hkv)).astype(np.float32)
              for _ in range(2))
    return q, pools[0], pools[1], pt, lengths, ks, vs


@pytest.mark.parametrize("P,n_pg,G", [(16, 6, 4), (3, 32, 2), (8, 12, 8)])
def test_decode_attention_paged_matches_jax(P, n_pg, G):
    """The paged entry (on the CPU: the gather, then the plain version) vs
    the JAX kernel in interpret mode on the view gathered in numpy; the
    view (96 rows) tiles by bk=32.  f32, 2e-5, the tolerance of
    test_decode_attention_int8_matches_jax."""
    S, Hkv, hd = 4, 2, 16
    q, pool_k, pool_v, pt, lengths, ks, vs = _paged_case(S, P, n_pg, Hkv, G,
                                                         hd, P * n_pg + G)
    k8 = pool_k[pt].reshape(S, n_pg * P, Hkv, hd)
    v8 = pool_v[pt].reshape(S, n_pg * P, Hkv, hd)
    oj = j_decode_attention(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                            jnp.asarray(lengths), k_scale=jnp.asarray(ks),
                            v_scale=jnp.asarray(vs), bk=32, interpret=True)  # qft: noqa[QFT004] parity oracle
    before = (decode_attention.launches, decode_attention.launches_paged)
    ot = decode_attention_paged(_t(q), _t(pool_k), _t(pool_v), _t(pt),
                                _t(lengths), _t(ks), _t(vs))
    assert (decode_attention.launches,
            decode_attention.launches_paged) == before   # no launch on CPU
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=2e-5,
                               atol=2e-5)


def test_paged_wrapper_rejects_inputs_it_cannot_take():
    q, pool_k, pool_v, pt, lengths, ks, vs = (
        _t(a) for a in _paged_case(4, 16, 2, 2, 2, 16, 0))
    with pytest.raises(ValueError, match="int32"):
        decode_attention_paged(q, pool_k, pool_v, pt.long(), lengths, ks, vs)
    with pytest.raises(ValueError, match="int8"):
        decode_attention_paged(q, pool_k.float(), pool_v.float(), pt,
                               lengths, ks, vs)
    with pytest.raises(ValueError, match="Hkv, hd"):
        decode_attention_paged(q, pool_k[..., :8], pool_v[..., :8], pt,
                               lengths, ks, vs)
    with pytest.raises(ValueError, match="k_scale"):
        decode_attention_paged(q, pool_k, pool_v, pt, lengths, None, None)
    meta = [t.to("meta") for t in (q, pool_k, pool_v, pt, lengths, ks, vs)]
    with pytest.raises(RuntimeError, match="CUDA device or on"):
        decode_attention_paged(*meta)


def test_split_rows_fills_two_waves():
    """A split is the kernel's whole tile (128 rows for the int8 cache at
    qwen3-8b's hd 128 and G 4, 64 for bf16) unless a full cache would give
    fewer than two waves of 132 SMs: phase 3's paged shape (S 8 x Hkv 8,
    T 2048) keeps 128 (48 live splits x 8 heads at its lengths); one bf16
    slot of 2048 rows takes a quarter tile, 512 blocks."""
    assert tile_rows(torch.int8, 128, 4) == 128
    assert tile_rows(torch.bfloat16, 128, 4) == 64
    assert tile_rows(torch.int8, 128, 8) == 64
    assert tile_rows(torch.float32, 128, 1) == 32
    assert all(tile_rows(dt, 16, 8) == 128 for dt in
               (torch.int8, torch.bfloat16, torch.float32))
    assert split_rows(2048, 8 * 8, 128) == 128
    lengths = [1, 25, 138, 308, 1008, 33, 2047, 2048]
    assert sum(-(-n // 128) for n in lengths) * 8 == 384 >= 2 * 132
    assert split_rows(2048, 1 * 8, 64) == 32 and 2048 // 32 * 8 >= 264
    assert split_rows(4096, 1 * 8, 64) == 64
    assert split_rows(1, 1, 32) == 8


def test_wrappers_reject_inputs_they_cannot_take():
    q, k, v = (_t(a) for a in _fd_case(2, 32, 2, 2, 16, 0))
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q, k, v, torch.ones(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="k_scale"):
        decode_attention(q, k.to(torch.int8), v.to(torch.int8),
                         torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="qw"):
        quant_matmul(torch.zeros(4, 64), torch.zeros(16, 8, dtype=torch.uint8),
                     torch.ones(64), torch.ones(8))


def test_wrappers_raise_off_cpu_instead_of_falling_back():
    """Only a CPU tensor takes the plain version: any other device launches
    the kernel or raises."""
    q, k, v = (_t(a).to("meta") for a in _fd_case(2, 32, 2, 2, 16, 0))
    lengths = torch.ones(2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA device or on"):
        decode_attention(q, k, v, lengths)
    x, q4, swl, swr = _qmm_case(4, 64, 64, "channel", 64, 0)
    args = [_t(x), pack_int4(_t(q4), axis=0), _t(swl), _t(swr)]
    args[1] = args[1].to("meta")
    with pytest.raises(RuntimeError, match="CUDA device or on"):
        quant_matmul(*args)


def test_kernel_tiles_ok_gate():
    assert kernel_tiles_ok(8, 4096, 4096) and kernel_tiles_ok(1, 64, 64)
    assert kernel_tiles_ok(128, 12288, 4096, n_groups=4096 // 128)
    assert kernel_tiles_ok(4, 64, 128, n_groups=128 // 32)
    assert not kernel_tiles_ok(4, 96, 64)                   # N % 64
    assert not kernel_tiles_ok(4, 64, 96)                   # K % 64
    assert not kernel_tiles_ok(4, 64, 192, n_groups=2)      # g = 96
    assert not kernel_tiles_ok(4, 64, 128, n_groups=16)     # g = 8
    assert not kernel_tiles_ok(0, 64, 64)


#: qwen3-8b's linears (K, N), as chip_smoke.py's phase 3 drives them
_QWEN3_LINEARS = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
                  "wo": (4096, 4096), "gate": (4096, 12288),
                  "up": (4096, 12288), "down": (12288, 4096)}


@pytest.mark.parametrize("case", [
    (name, M, "bfloat16", layout) for name in _QWEN3_LINEARS
    for M in (8, 128) for layout in ("channel", "group:128")]
    + [("wk", 4, "float32", "channel")])
def test_quant_matmul_plan_fills_the_card(case):
    """Every phase-3 shape and the route check's: at least 2 x 132 blocks
    at decode M; for the wide body at most one wave of 3 x 132 and at
    least one block an SM where MAX_WIDE_SPLITS splits allow it; splits
    that nest with the groups and cover K once, the body the type and M
    call for, the scratch it needs, the same plan for the same inputs."""
    name, M, dtype, layout = case
    K, N = _QWEN3_LINEARS[name]
    group = K if layout == "channel" else 128
    dt = getattr(torch, dtype)
    p = t_qmm.plan(M, N, K, group, dt)
    assert p == t_qmm.plan(M, N, K, group, dt)
    assert p.body == ("fma" if dtype == "float32"
                      else "mma" if M <= 16 else "mma_wide")
    if p.body == "mma_wide":
        assert p.splits == 1 or p.blocks <= 3 * t_qmm.SMS
        assert p.splits <= t_qmm.MAX_WIDE_SPLITS
        assert p.blocks >= min(t_qmm.SMS, p.tiles * t_qmm.MAX_WIDE_SPLITS)
    else:
        assert p.blocks >= 2 * t_qmm.SMS
    assert p.ksplit % 64 == 0 and t_qmm.nests(p.ksplit, group, K)
    assert (p.splits - 1) * p.ksplit < K <= p.splits * p.ksplit
    assert p.splits <= t_qmm.MAX_SPLITS
    assert p.tiles == -(-M // p.block_m) * -(-N // p.block_n)
    assert p.workspace == ((p.splits, M, N) if p.splits > 1 else None)
    assert p.staged_x == (p.body == "mma_wide")


@pytest.mark.parametrize("M", [1, 4, 8, 33])
@pytest.mark.parametrize("K,N", [(512, 16384), (5120, 576), (5120, 1536),
                                 (64, 10), (2048, 60), (200, 70), (16, 8),
                                 (102400, 64)])
def test_quant_matmul_int8_plan_covers_k_once(M, K, N):
    """K1's int8 entry (deepseek-v2's k_up/kv_down/q_down, the CNN fc, a
    router, ragged and tiny shapes, a K past 64 splits of 1024 rows): the
    fma body's 8 x 64 tiles, splits of whole 64-row chunks within the
    1024-row cap that cover K once, the fewest that reach two blocks an SM
    where the splits allow it."""
    p = t_qmm.plan_int8(M, N, K)
    assert (p.body, p.block_m, p.block_n, p.staged_x) == ("fma", 8, 64,
                                                         False)
    assert p.ksplit % 64 == 0 and p.ksplit <= 1024
    assert (p.splits - 1) * p.ksplit < K <= p.splits * p.ksplit
    assert p.tiles == -(-M // 8) * -(-N // 64)
    assert p.workspace == ((p.splits, M, N) if p.splits > 1 else None)
    if p.blocks < 2 * t_qmm.SMS:          # the split count could not grow
        assert p.ksplit == 64 or p.splits >= t_qmm.MAX_SPLITS
    elif p.splits > 1:                    # one split fewer would not do
        fewer = -(-(-(-K // (p.splits - 1))) // 64) * 64
        assert fewer > 1024 or p.tiles * -(-K // fewer) < 2 * t_qmm.SMS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 8, 9, 16, 17])
@pytest.mark.parametrize("K,N,group", [
    (512, 16384, None), (5120, 576, None), (5120, 1536, 128), (5120, 576, 8),
    (64, 10, None), (2048, 60, None), (640, 320, 32)])
def test_quant_matmul_int8_plan_takes_mma_for_bf16_decode(dtype, M, K, N,
                                                          group):
    """K1's int8 entry: bf16 x at M ≤ 16 on a shape the packed bodies tile
    gets the int4 entry's own ``mma`` plan (its split nests with the
    group); f32 x, M > 16 and untiled shapes (the CNN fc, a router, group
    8) keep the ``fma`` plan of :func:`plan_int8`."""
    dt = getattr(torch, dtype)
    p = t_qmm.plan_int8(M, N, K, group, dt)
    n_groups = None if group is None else K // group
    if dt == torch.bfloat16 and M <= 16 and kernel_tiles_ok(M, N, K,
                                                            n_groups):
        assert p == t_qmm.plan(M, N, K, group or K, dt)
        assert p.body == "mma" and t_qmm.nests(p.ksplit, group or K, K)
    else:
        assert p == t_qmm.plan_int8(M, N, K) and p.body == "fma"
    # packed nibbles (an untiled int4 shape) stay on the fma body
    assert t_qmm.plan_int8(M, N, K, group, dt, True) == t_qmm.plan_int8(
        M, N, K)


@pytest.mark.parametrize("group", [None, 8])
@pytest.mark.parametrize("K,N", [(64, 32), (200, 70)])
def test_quant_matmul_int8_reads_packed_nibbles(K, N, group):
    """K1's int8 entry on the int4 entry's nibble-packed weight (the route
    of an int4 shape the int4 kernel does not tile): on the CPU its plain
    version equals the entry on the unpacked int8 weight bit for bit, and
    the JAX package's f32 reference within 1e-5 of max|ref| (the two sum
    in different orders)."""
    rng = np.random.default_rng(K + N)
    x = rng.normal(size=(4, K)).astype(np.float32)
    q4 = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    s_wl = np.exp(rng.normal(size=K) * 0.2).astype(np.float32)
    s_wr = np.exp(rng.normal(size=(N,) if group is None
                             else (K // group, N)) * 0.2).astype(np.float32)
    args = [_t(x), pack_int4(_t(q4), axis=0), _t(s_wl), _t(s_wr)]
    y = t_qmm.quant_matmul_int8(*args)
    assert torch.equal(y, t_qmm.quant_matmul_int8(_t(x), _t(q4), *args[2:]))
    ref = j_ref.quant_matmul_ref(
        jnp.asarray(x), jnp.asarray(args[1].numpy()), jnp.asarray(s_wl),
        jnp.asarray(s_wr))
    ref = np.asarray(ref)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 8, 9, 16, 17, 64, 130])
@pytest.mark.parametrize("K,N,group", [
    (64, 64, 64), (64, 64, 16), (640, 320, 32), (640, 320, 128),
    (4096, 1024, 4096), (4096, 1024, 16), (12288, 4096, 192),
    (12288, 64, 12288), (65536, 64, 65536)])
def test_quant_matmul_plan_nests_for_every_gated_shape(dtype, M, K, N,
                                                       group):
    """Any shape the gate takes gets a plan the C entry takes: a split of
    whole 64-row chunks that nests with the group (one group per split, or
    whole groups), within the body's shared-memory cap, at most
    MAX_SPLITS splits where the cap allows; the mma body holds 8 or 16
    rows."""
    assert kernel_tiles_ok(M, N, K, K // group)
    dt = getattr(torch, dtype)
    p = t_qmm.plan(M, N, K, group, dt)
    assert p.ksplit % 64 == 0 and t_qmm.nests(p.ksplit, group, K)
    cap = {"fma": 1024, "mma": 1024 if M <= 8 else 512,
           "mma_wide": K}[p.body]
    assert p.ksplit <= cap
    assert p.splits <= max(t_qmm.MAX_SPLITS, -(-K // cap))
    if p.body == "mma":
        assert p.block_m == (8 if M <= 8 else 16)


@pytest.mark.parametrize("bits,layout", [(4, "channel"), (4, "group:32"),
                                         (4, "layerwise"), (8, "channel"),
                                         (8, "group:32")])
def test_qlinear_deployed_matches_jax(bits, layout):
    """Packed int4 (kernel route, plain on the CPU) and int8-exempt exports
    with per-group partials, vs the JAX package's qlinear_deployed."""
    cfg = j_permissive(w_layout=layout)
    p = j_dof.init_qlinear(jax.random.PRNGKey(bits), 128, 64, cfg, bias=True)
    p = j_dof.mmse_init_qlinear(p, cfg, bits=bits)
    ex = jax.device_get(j_dof.export_qlinear(p, cfg, bits=bits))
    x = np.random.default_rng(2).normal(size=(2, 3, 128)).astype(np.float32)
    yj = j_qlinear_deployed(jnp.asarray(x), ex, use_pallas=True,
                            interpret=True)  # qft: noqa[QFT004] parity oracle
    yt = qlinear_deployed(_t(x), from_numpy_tree(ex, "cpu"))
    assert yt.shape == (2, 3, 64)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-5,
                               atol=2e-5)


def test_kernel_route_check_matches_jax_on_cpu():
    """Same linear chosen, same layout; on the CPU the kernel does not
    launch (``kernel`` False) and the plain route agrees with the f32
    dequantized product.  Widths are multiples of 64 so both packages' tile
    gates accept the same linears (SMOKE's 32-wide wk passes only the
    Pallas gate)."""
    jq = JQ()
    cfg = dataclasses.replace(J_SMOKE, d_model=128, head_dim=32, d_ff=256)
    params = j_init_model(jax.random.PRNGKey(0), cfg, jq)
    plan = j_make_plan(jq, params=params, model_cfg=cfg, use_pallas=True,
                       interpret=True)  # qft: noqa[QFT004] parity oracle
    ex = jax.jit(lambda p: j_export(p, plan))(params)
    want = j_route_check(ex, plan)
    got = kernel_route_check(from_numpy_tree(jax.device_get(ex), "cpu"),
                             DeployPlan(qcfg=TQ()))
    assert (got["path"], got["layout"]) == (want["path"], want["layout"])
    assert want["pallas"] and not got["kernel"]
    assert got["max_err"] < 1e-5
