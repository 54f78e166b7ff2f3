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
from repro_torch.kernels.fake_quant import fake_quant_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_prefill, flash_attention)
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.kernels.ref import (attention_prefill_ref,  # noqa: E402
                                     decode_attention_ref,
                                     fake_quant_grad_ref, fake_quant_ref,
                                     flash_attention_ref, quant_matmul_ref)

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
    the kernel slice by slice (one forward and one backward launch per
    slice), never through the plain composition: forward bit-equal to it,
    gradients within 1e-5 x max|ref| of its autograd gradients."""
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
        assert fake_quant_kernel.launches_fwd - fwd == (E if use else 0)
        assert fake_quant_kernel.launches_bwd - bwd == (E if use else 0)
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
        steps=1, calib_samples=32, calib_seq_len=64, calib_batch_size=4,
        serve_smoke=True, use_kernels=False))
    torch.cuda.synchronize()
    assert counts() == before
    ev = result.metrics["evaluate"]
    assert "kernel_route" not in ev and ev["export_parity_max_err"] < 1e-4
