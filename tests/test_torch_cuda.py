"""The CUDA kernels on the card, each against its plain PyTorch version.

No jax here: this file runs on the GPU machine, which has none
(``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``).
Elsewhere every test skips, deciding inside the ``cuda`` fixture.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fakequant import pack_int4  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: E402
                                     quant_matmul_ref)

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
    if kv == "int8":
        k8 = (k * 40).clamp(-127, 127).round().to(torch.int8)
        v8 = (v * 40).clamp(-127, 127).round().to(torch.int8)
        sc = torch.full((S, Hkv), 0.025, device=cuda)
        args = (q.bfloat16(), k8, v8, lengths, sc, sc)
    elif kv == "bfloat16":
        args = (q.bfloat16(), k.bfloat16(), v.bfloat16(), lengths)
    else:
        args = (q, k, v, lengths)
    before = decode_attention.launches
    out = decode_attention(*args)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_ref(*args)
    tol = 2e-5 if kv == "float32" else 2e-2    # bf16: one output rounding
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


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
