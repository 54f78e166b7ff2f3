"""The serving launcher (``repro_torch.launch.serve``), the registry's cell
helpers, ``train.steps.make_decode_step`` and K1's int8 plain version,
each held against the JAX package on the CPU.

- ``configs.registry``: ``skip_reason``, ``cell_list`` and ``input_specs``
  (shapes and dtypes) equal the JAX registry's on every (arch × shape);
- ``make_decode_step`` at SMOKE on converted JAX weights, both at f32
  compute (each module's ``forward`` given ``compute_dtype=float32``):
  logits rel L2 ≤ 1e-5 step by step, integer cache leaves bit for bit;
- the launcher at SMOKE against ``repro.launch.serve.main`` (argv patched)
  on one JAX pipeline workdir, both restoring its trained student: greedy
  ``reqN:`` tokens equal, or first split where the plain route's top-2
  margin is within 4 bf16 ulps (phase 5's rule); the ``--show-plan`` table
  equal; paper-cnn refused with exit 2; a mismatched checkpoint raises
  ``RuntimeError``;
- ``ref.quant_matmul_int8_ref`` (K1's int8 plain version) against the
  JAX package's int8 branch of ``qlinear_deployed``, 1e-6 relative.
"""
import functools
import math
import re
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.launch.serve as j_serve  # noqa: E402
import repro.train.steps as j_steps  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.kernels.ops import qlinear_deployed as j_qlinear_deployed  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.pipeline import PipelineConfig as JPipelineConfig  # noqa: E402
from repro.pipeline import run_pipeline as j_run_pipeline  # noqa: E402
import repro_torch.train.steps as t_steps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.kernels.ops import qlinear_deployed  # noqa: E402
from repro_torch.kernels.ref import quant_matmul_int8_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import forward, init_cache, init_model  # noqa: E402
from repro_torch.pipeline import PipelineConfig, run_pipeline  # noqa: E402
from repro_torch.serve.deploy import deploy_view, export_for_layers  # noqa: E402

MARGIN_ULPS = 4
TOKENS = re.compile(r"^req(\d+): \[([\d, ]*)\]$", re.M)


# ---------------------------------------------------------------------------
# configs.registry: the cell helpers
# ---------------------------------------------------------------------------

def test_cells_and_skips_match_jax():
    assert list(registry.SHAPES) == list(j_registry.SHAPES)
    for name, sp in registry.SHAPES.items():
        j = j_registry.SHAPES[name]
        assert (sp.name, sp.seq_len, sp.global_batch, sp.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)
    for arch in registry.ARCH_IDS:
        for shape in registry.SHAPES:
            assert registry.skip_reason(arch, shape) == \
                j_registry.skip_reason(arch, shape)
    for skips in (False, True):
        assert registry.cell_list(skips) == j_registry.cell_list(skips)
    assert registry.get_module("qwen3-8b").__name__ == \
        "repro_torch.configs.qwen3_8b"


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_input_specs_match_jax(arch):
    """Shapes and dtypes of every cell's inputs, meta tensors against the
    JAX package's ShapeDtypeStructs (through ``jax.eval_shape``)."""
    for shape in registry.SHAPES:
        got = registry.input_specs(arch, shape)
        want = jax.eval_shape(lambda: j_registry.input_specs(arch, shape))
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (arch, shape, k)
            assert str(v.dtype).removeprefix("torch.") == \
                jnp.dtype(want[k].dtype).name


# ---------------------------------------------------------------------------
# train.steps.make_decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-1.3b"])
def test_decode_step_matches_jax(arch, monkeypatch):
    monkeypatch.setattr(j_steps, "forward", functools.partial(
        j_forward, compute_dtype=jnp.float32))
    monkeypatch.setattr(t_steps, "forward", functools.partial(
        forward, compute_dtype=torch.float32))
    jcfg = j_registry.get_config(arch, smoke=True)
    cfg = registry.get_config(arch, smoke=True)
    jp = j_init_model(jax.random.PRNGKey(3), jcfg, None)
    tp = from_numpy_tree(jax.device_get(jp), "cpu")
    B, T = 2, 16
    jc = j_init_cache(jcfg, B, T, jnp.float32)
    tc = init_cache(cfg, B, T, torch.float32, device="cpu")
    jstep = j_steps.make_decode_step(jcfg, None)
    tstep = t_steps.make_decode_step(cfg, None)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, 5))
    for i in range(toks.shape[1]):
        jl, jc = jstep(jp, jc, {"tokens": jnp.asarray(toks[:, i:i + 1],
                                                      jnp.int32)})
        with torch.no_grad():
            tl, tc = tstep(tp, tc, {"tokens": torch.from_numpy(
                toks[:, i:i + 1])})
        want = np.asarray(jl, np.float32)
        assert tl.shape == want.shape
        rel = np.linalg.norm(tl.numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-5, (i, rel)
    n_int = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jc):
        node = tc
        for k in path:
            node = node[k.key]
        if jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.integer):
            n_int += 1
            np.testing.assert_array_equal(np.asarray(node), np.asarray(leaf))
    assert n_int == (arch != "mamba2-1.3b")    # the attention cache's pos


# ---------------------------------------------------------------------------
# K1's int8 plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [None, 4])
def test_int8_plain_version_matches_jax(groups):
    rng = np.random.default_rng(7)
    K, N, M = 64, 10, 4
    x = rng.normal(size=(M, K)).astype(np.float32)
    q = rng.integers(-128, 128, size=(K, N)).astype(np.int8)
    s_wl = np.exp(rng.normal(size=K) * 0.2).astype(np.float32)
    s_wr = np.exp(rng.normal(size=(N,) if groups is None else (groups, N))
                  * 0.2).astype(np.float32) * 0.01
    want = np.asarray(j_qlinear_deployed(
        jnp.asarray(x), {"q": jnp.asarray(q), "s_wl": jnp.asarray(s_wl),
                         "s_wr": jnp.asarray(s_wr)}))
    args = [torch.from_numpy(a) for a in (x, q, s_wl, s_wr)]
    for got in (quant_matmul_int8_ref(*args),
                qlinear_deployed(args[0], {"q": args[1], "s_wl": args[2],
                                           "s_wr": args[3]})):
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert rel <= 1e-6, rel


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A JAX pipeline run on SMOKE qwen3-8b through finetune: its stage
    checkpoints are what both launchers restore."""
    wd = tmp_path_factory.mktemp("jax_workdir")
    j_run_pipeline(JPipelineConfig(
        arch="qwen3_8b", smoke=True, steps=1, calib_samples=64,
        calib_seq_len=16, calib_batch_size=8, calib_batches=2,
        eval_batches=1, stop_after="finetune", workdir=str(wd)))
    return wd


def _run_jax(argv, monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *argv])
    j_serve.main()
    return capsys.readouterr().out


def _tokens(out: str) -> list[list[int]]:
    return [[int(t) for t in m.group(2).split(",") if t.strip()]
            for m in TOKENS.finditer(out)]


def _plan_table(out: str) -> str:
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("tensor "))
    end = next(i for i, ln in enumerate(lines) if ln.startswith("# "))
    return "\n".join(lines[start:end + 1])


def _margin_ok(wd, context: list[int]) -> bool:
    """Phase 5's rule on the port's plain route: the top-2 margin of the
    next-token logits after ``context`` within MARGIN_ULPS bf16 ulps."""
    res = run_pipeline(PipelineConfig(
        arch="qwen3_8b", smoke=True, steps=0, stop_after="export",
        device="cpu", calib_samples=128, calib_seq_len=32,
        calib_batch_size=8))
    student, _ = serve.restore_student(str(wd), res.student)
    with torch.no_grad():
        view = deploy_view(export_for_layers(student, res.plan,
                                             device="cpu"), res.plan)
        out = forward(view, res.model_cfg, None,
                      {"tokens": torch.tensor([context])})
    z = np.sort(out["logits"][0, -1].float().numpy())[::-1]
    ulp = 2.0 ** (math.floor(math.log2(abs(z[0]))) - 7)
    return z[0] - z[1] <= MARGIN_ULPS * ulp


def test_launcher_matches_jax(workdir, monkeypatch, capsys):
    want_out = _run_jax(["--arch", "qwen3-8b", "--ckpt-dir", str(workdir),
                         "--show-plan"], monkeypatch, capsys)
    assert serve.main(["--arch", "qwen3-8b", "--ckpt-dir", str(workdir),
                       "--show-plan", "--device", "cpu"]) == 0
    got_out = capsys.readouterr().out
    assert "restored trained student from" in got_out
    assert _plan_table(got_out) == _plan_table(want_out)
    want, got = _tokens(want_out), _tokens(got_out)
    prompts = [[1, 2, 3], [4, 5]]
    assert len(want) == len(got) == 2
    for prompt, w, g in zip(prompts, want, got):
        assert len(g) == len(w) == 8
        i = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if i is not None:
            assert _margin_ok(workdir, prompt + w[:i]), (prompt, i, w, g)


def test_launcher_kernel_flag_and_paper_cnn(monkeypatch, capsys):
    """``--use-kernels`` runs the route check (the plain version on the
    CPU: no launch) and serves; paper-cnn is refused with exit 2, as the
    JAX launcher refuses it."""
    assert serve.main(["--arch", "qwen3-8b", "--use-kernels",
                       "--device", "cpu", "--stream"]) == 0
    out = capsys.readouterr().out
    assert "kernel route: {'path':" in out and "'kernel': False" in out
    assert len(re.findall(r"^req\d: \d+( \d+){7}$", out, re.M)) == 2
    assert serve.main(["--arch", "paper-cnn"]) == 2
    monkeypatch.setattr(sys, "argv", ["x", "--arch", "paper-cnn"])
    with pytest.raises(SystemExit) as e:
        j_serve.main()
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.count("paper-cnn is a classifier") == 2


def test_mismatched_checkpoint_raises(workdir):
    cfg = registry.get_config("mamba2-1.3b", smoke=True)
    student = init_model(0, cfg, QuantConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="does not match this config"):
        serve.restore_student(str(workdir), student)
    assert serve.restore_student(str(workdir / "nothing"), student) is None
