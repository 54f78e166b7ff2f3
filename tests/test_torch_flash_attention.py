"""repro_torch's flash_attention (K4) and the dequant body of quant_matmul
(K5) against the JAX package, on the CPU: the port's plain versions — what
each wrapper runs for CPU tensors, and what the CUDA kernels are held to on
the card — against the Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and go through both packages.
Tolerances are the reference's own (``tests/test_kernels.py``): attention
f32 ``rtol 2e-4, atol 2e-5``, bf16 ``3e-2``; quant_matmul f32 ``2e-5``,
bf16 ``2e-2``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.fakequant import pack_int4 as j_pack_int4  # noqa: E402
from repro.kernels import flash_attention as j_flash_attention  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import quant_matmul as j_quant_matmul  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.configs.qwen3_8b import SMOKE  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import forward, init_model  # noqa: E402
from repro_torch.models.attention import prefill_route  # noqa: E402

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, copy=True)).to(dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("S,hd,bq,bk", [(128, 64, 64, 64), (256, 32, 64, 128),
                                        (64, 128, 32, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sweep_matches_pallas(S, hd, bq, bk, causal):
    """The reference sweep: the port's ``flash_attention`` (CPU: the plain
    version) and ``flash_attention_ref`` against the Pallas kernel."""
    q, k, v = (_normal((2, S, hd), S + hd + i) for i in range(3))
    want = j_flash_attention(_j(q), _j(k), _j(v), causal=causal, bq=bq,  # qft: noqa[QFT004] parity oracle
                             bk=bk, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    np.testing.assert_allclose(
        _f32(flash_attention_ref(_t(q), _t(k), _t(v), causal=causal)),
        _f32(j_ref.flash_attention_ref(_j(q), _j(k), _j(v), causal=causal)),
        **F32_TOL)


def test_flash_attention_bf16_matches_pallas():
    q, k, v = (_normal((2, 128, 64), 7 + i) for i in range(3))
    want = j_flash_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),  # qft: noqa[QFT004] parity oracle
                             _j(v, jnp.bfloat16), causal=True, bq=64, bk=64,
                             interpret=True)
    got = flash_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                          causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_prefill_gqa_matches_jax_shim(dtype, causal):
    """``ops.attention_prefill`` takes k/v at their kv-head count (4 query
    heads per kv head here); the JAX shim, fed each kv head repeated, runs
    the Pallas kernel over the flattened [B·H, S, hd]."""
    B, S, H, Hkv, hd = 2, 64, 8, 2, 32
    q = _normal((B, S, H, hd), 1)
    k, v = (_normal((B, S, Hkv, hd), s) for s in (2, 3))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    kr, vr = (np.repeat(a, H // Hkv, axis=2) for a in (k, v))
    want = j_ops.attention_prefill(_j(q, jd), _j(kr, jd), _j(vr, jd),
                                   causal=causal, use_pallas=True,
                                   interpret=True)
    got = ops.attention_prefill(_t(q, td), _t(k, td), _t(v, td),
                                causal=causal)
    assert got.shape == (B, S, H, hd) and got.dtype == td
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_attention_prefill_ragged_length():
    """An S no 64-row tile divides (the CUDA kernel masks the last tile;
    the Pallas wrapper asserts ``S % bq == 0``): the plain version against
    the JAX reference."""
    B, S, H, Hkv, hd = 1, 75, 4, 2, 16
    q = _normal((B, S, H, hd), 4)
    k, v = (_normal((B, S, Hkv, hd), s) for s in (5, 6))
    kr, vr = (np.repeat(a, H // Hkv, axis=2) for a in (k, v))
    want = j_ops.attention_prefill(_j(q), _j(kr), _j(vr), causal=True)
    got = ops.attention_prefill(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


def test_flash_attention_wrappers_refuse_bad_shapes():
    x = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="BH, Sk, hd"):
        flash_attention(x, x[:, :, :8], x[:, :, :8])
    q = torch.zeros((1, 8, 6, 16))
    kv = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="H % Hkv"):
        ops.attention_prefill(q, kv, kv)


def test_prefill_route_keeps_cpu_and_gradients_on_sdpa():
    """The route takes the kernel only for CUDA tensors that need no
    gradient: on the CPU the model's forward is the plain one, bit for
    bit, with or without ``use_kernels``."""
    q = torch.zeros((1, 4, 2, 8))
    assert not prefill_route(q, q, q, use_kernels=True)
    teacher = init_model(0, SMOKE, None, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, SMOKE.vocab, (2, 24)))
    with torch.no_grad():
        a = forward(teacher, SMOKE, None, {"tokens": tokens},
                    use_kernels=True)["hidden"]
        b = forward(teacher, SMOKE, None, {"tokens": tokens},
                    use_kernels=False)["hidden"]
    assert torch.equal(a, b)


def test_teacher_hidden_gap_of_the_kernel_route(monkeypatch):
    """The gap ``chip_smoke.py`` phase 6 bounds on the card
    (``TEACHER_HIDDEN_BOUND``, 3e-2), emulated on the CPU: the kernel's
    plain version (f32 probabilities) put on the route, against ``_sdpa``
    (probabilities rounded to bf16), bf16 compute, a 4-layer teacher of
    qwen3-8b's head shape at width 512, batch 2 x 512: relative L2 of the
    hidden states (measured 1.25e-2)."""
    import dataclasses
    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.models import attention as attn
    cfg = dataclasses.replace(
        CONFIG, n_layers=4, d_model=512, n_heads=4, n_kv_heads=1, d_ff=1536,
        vocab=4096, n_heads_padded=0, n_kv_heads_padded=0, vocab_padded=0)
    teacher = init_model(0, cfg, None, device="cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 512)))}
    with torch.no_grad():
        plain = forward(teacher, cfg, None, batch, logits=False)["hidden"]
        monkeypatch.setattr(attn, "prefill_route", lambda q, k, v, use: use)
        kernel = forward(teacher, cfg, None, batch, use_kernels=True,
                         logits=False)["hidden"]
    rel = float((kernel.float() - plain.float()).norm()
                / plain.float().norm())
    assert 0 < rel < 3e-2, rel


@pytest.mark.parametrize("dtype,hd,layout,want", [
    ("bfloat16", 128, "bshd", "wgmma"), ("bfloat16", 64, "bshd", "wgmma"),
    ("bfloat16", 128, "bsd", "fma"), ("bfloat16", 96, "bshd", "fma"),
    ("bfloat16", 256, "bshd", "fma"), ("bfloat16", 16, "bshd", "fma"),
    ("float32", 128, "bshd", "fma"), ("float32", 64, "bsd", "fma")])
def test_flash_attention_body_dispatch(dtype, hd, layout, want):
    """Which body runs a call: the tensor-core body for the [B, S, H, hd]
    layout in bf16 at hd 64 or 128, the FMA body for everything else."""
    from repro_torch.kernels.flash_attention import body_for
    assert body_for(getattr(torch, dtype), hd, layout) == want


def _views():
    """(name, view, reason the tensor-core body's TMA loads refuse it)."""
    fused = torch.zeros((2, 17, 48 * 128), dtype=torch.bfloat16)
    padded = torch.zeros((2, 17, 4, 68), dtype=torch.bfloat16)
    flat = torch.zeros((2 * 17 * 4 * 64 + 8,), dtype=torch.bfloat16)
    heads = torch.zeros((2, 4, 17, 64), dtype=torch.bfloat16)
    return [
        ("contiguous", torch.zeros((2, 17, 4, 64), dtype=torch.bfloat16),
         None),
        ("fused qkv slice", fused[..., 32 * 128:40 * 128].view(2, 17, 8, 128),
         None),
        ("heads-major transpose", heads.transpose(1, 2), None),
        ("one head of three", torch.zeros((2, 17, 3, 64),
                                          dtype=torch.bfloat16)[:, :, 1:2],
         None),
        ("base 2 bytes off", flat[1:1 + 2 * 17 * 4 * 64].view(2, 17, 4, 64),
         "16-byte"),
        ("base 16 bytes off", flat[8:8 + 2 * 17 * 4 * 64].view(2, 17, 4, 64),
         None),
        ("head stride 136 bytes", padded[..., :64], "multiple of 16"),
        ("head dim strided", padded[..., ::2][..., :32], "contiguous"),
        ("f32 head stride 66 elements", torch.zeros(
            (2, 17, 4, 66))[..., :64], "multiple of 16"),
    ]


@pytest.mark.parametrize("case", range(9))
def test_tma_misalignment(case):
    """The tensor-core body's TMA rule on the CPU: a 16-byte-aligned base,
    the head dim contiguous, and every other dimension longer than 1 a
    byte stride that is a multiple of 16; a dimension of size 1 is free."""
    from repro_torch.kernels.flash_attention import tma_misalignment
    name, t, want = _views()[case]
    got = tma_misalignment(t.data_ptr(), t.shape, t.stride(),
                           t.element_size())
    if want is None:
        assert got is None, (name, got)
    else:
        assert got is not None and want in got, (name, got)


def test_evaluate_keeps_the_student_on_its_training_route(monkeypatch):
    """F9: with the kernel route open to CPU tensors and the kernel's plain
    version put on it (as the gap test above does), evaluate's
    ``degradation`` sends the teacher's attention through
    ``attention_prefill`` — once a layer per eval batch — and the
    student's never: the student keeps ``_sdpa``, the route it trained
    on."""
    from repro_torch.kernels.ref import attention_prefill_ref
    from repro_torch.models import attention as attn
    from repro_torch.pipeline import PipelineConfig
    from repro_torch.pipeline.adapters import get_adapter
    pcfg = PipelineConfig(arch="qwen3-8b", device="cpu", calib_samples=16,
                          calib_seq_len=16,
                          calib_batch_size=4, calib_batches=2,
                          eval_batches=2)
    adapter = get_adapter(pcfg)
    teacher = adapter.init_teacher()
    student = adapter.build_student(teacher)
    calls = []

    def kernel_route(q, k, v, causal=True):
        calls.append(q.shape)
        return attention_prefill_ref(q, k, v, causal=causal)

    monkeypatch.setattr(attn, "prefill_route", lambda q, k, v, use: use)
    monkeypatch.setattr(attn, "attention_prefill", kernel_route)
    metrics = adapter.degradation(student, teacher)
    assert len(calls) == pcfg.eval_batches * adapter.cfg.n_layers
    assert np.isfinite(metrics["distill_loss"])


@pytest.mark.parametrize("M,K,N,bm,bn,bk", [(64, 128, 64, 64, 64, 64),
                                            (128, 256, 128, 64, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["channel", "group"])
def test_quant_matmul_dequant_matches_pallas(M, K, N, bm, bn, bk, dtype,
                                             layout):
    """K5: ``variant="dequant"`` (CPU: the plain version) against the
    Pallas baseline body, both scale layouts."""
    rng = np.random.default_rng(M + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    q4 = rng.integers(-7, 8, size=(K, N)).astype(np.int8)
    swl = (np.exp(rng.normal(size=K) * 0.2) * 0.05).astype(np.float32)
    g = min(bk, 64)
    shape = (K // g, N) if layout == "group" else (N,)
    swr = np.exp(rng.normal(size=shape) * 0.2).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    qw = np.asarray(j_pack_int4(jnp.asarray(q4), axis=0))
    want = j_quant_matmul(_j(x, jd), jnp.asarray(qw), _j(swl), _j(swr),  # qft: noqa[QFT004] parity oracle
                          bm=bm, bn=bn, bk=bk, interpret=True,
                          variant="dequant")
    got = quant_matmul(_t(x, getattr(torch, dtype)), _t(qw, torch.uint8),
                       _t(swl), _t(swr), variant="dequant")
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_quant_matmul_refuses_unknown_variant():
    x = torch.zeros((4, 64))
    qw = torch.zeros((32, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="variant"):
        quant_matmul(x, qw, torch.ones(64), torch.ones(64), variant="fp8")
