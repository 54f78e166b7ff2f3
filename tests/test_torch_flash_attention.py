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
