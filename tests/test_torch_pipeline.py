"""repro_torch's pipeline (calibrate → init → finetune → export → evaluate
with stage checkpoint/resume, and the ``python -m repro_torch`` CLI)
against the JAX package's, on the CPU at the JAX test's tiny transformer
(``tests/test_pipeline.py: TINY_LM``).

One JAX pipeline run with a workdir leaves its stage checkpoints behind
(the student after calibrate, init and finetune); the port restores them —
the on-disk format is shared — and runs each stage from the JAX input of
that stage.  Tolerances: weights and integer leaves bit-equal; log-scale
leaves 1e-6 relative or absolute (exp/log ulps), but the calibrated ``log_sa``
within one bf16 ulp and its zero-point within 1 (the teacher's taps are
bf16, rounded in other places by the two packages); the bf16 finetune losses 1e-2 relative, as the shipped bf16
step in ``test_torch_train.py``; the export parity below 1e-4, the JAX
pipeline's own acceptance bound.
"""
import dataclasses
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.pipeline import PipelineConfig as JPipelineConfig  # noqa: E402
from repro.pipeline import run_pipeline as j_run_pipeline  # noqa: E402
from repro.pipeline.adapters import get_adapter as j_get_adapter  # noqa: E402
from repro.pipeline.cli import main as j_cli_main  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.pipeline import (MODES, STAGES, PipelineConfig,  # noqa: E402
                                  run_pipeline)
from repro_torch.pipeline.adapters import get_adapter  # noqa: E402
from repro_torch.pipeline.cli import main as cli_main  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

TINY_LM = dict(arch="qwen3_8b", smoke=True, steps=2, calib_samples=64,
               calib_seq_len=16, calib_batch_size=8, calib_batches=2,
               eval_batches=1, log_every=1)
SCALE_LEAVES = ("log_swr", "log_sa", "log_s", "log_f")


def _torch_tree(tree):
    return from_numpy_tree(jax.device_get(tree), "cpu")


def _like(tree):
    return {"student": tree, "steps": np.asarray(0)}


def _assert_students_match(got, want, zp_within=0.0, log_sa_atol=1e-6):
    want = dict(tree_items(want))
    assert sorted(p for p, _ in tree_items(got)) == sorted(want)
    for path, leaf in tree_items(got):
        ref = want[path]
        if path[-1] == "zp" and zp_within:
            assert float((leaf - ref).abs().max()) <= zp_within, path
        elif path[-1] in SCALE_LEAVES:
            atol = log_sa_atol if path[-1] == "log_sa" else 1e-6
            np.testing.assert_allclose(leaf.numpy(), ref.numpy(), rtol=1e-6,
                                       atol=atol, err_msg=str(path))
        else:
            assert torch.equal(leaf, ref), path


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX pipeline on TINY_LM with a workdir, its stage checkpoints
    restored through the port (steps 1-3: after calibrate, init,
    finetune) and the JAX student before calibration."""
    workdir = tmp_path_factory.mktemp("jax_pipeline")
    jpcfg = JPipelineConfig(mode="w4a8", workdir=str(workdir), **TINY_LM)
    result = j_run_pipeline(jpcfg)
    student0 = j_get_adapter(jpcfg).build_student(result.teacher)
    like = _like(_torch_tree(student0))
    ckpt = CheckpointManager(str(workdir / "stages"))
    stages = {s: ckpt.restore(s, like)["student"] for s in (1, 2, 3)}
    return dict(workdir=workdir, result=result, student0=student0,
                teacher=_torch_tree(result.teacher), stages=stages)


@pytest.fixture(scope="module")
def port_adapter():
    return get_adapter(PipelineConfig(mode="w4a8", device="cpu", **TINY_LM))


def test_pipeline_config_fields_match_jax():
    """Field for field the JAX PipelineConfig, except: ``use_pallas`` is
    ``use_kernels`` (default on) and ``device`` is added.  The default arch
    is the reference's, paper-cnn, and resolves to the same config."""
    jf = [(f.name, f.default) for f in dataclasses.fields(JPipelineConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(PipelineConfig)]
    renamed = {"use_pallas": "use_kernels"}
    want = [(renamed.get(n, n), d) for n, d in jf]
    want = [(n, True if n == "use_kernels" else d) for n, d in want]
    i = [n for n, _ in want].index("use_kernels") + 1
    want.insert(i, ("device", "cuda"))
    assert tf == want
    assert STAGES == ("calibrate", "init", "finetune", "export", "evaluate")
    assert MODES == ("w4a8", "w4chw")
    pcfg = PipelineConfig(arch="qwen3_8b", w_layout="group:16",
                          bits_overrides=(("layers.mlp.down", "8"),))
    jpcfg = JPipelineConfig(arch="qwen3_8b", w_layout="group:16",
                            bits_overrides=(("layers.mlp.down", "8"),))
    assert pcfg.arch == jpcfg.arch == "qwen3-8b"
    assert str(pcfg.quant_config().layout) == str(jpcfg.quant_config().layout)
    assert pcfg.quant_config().bits_overrides == \
        jpcfg.quant_config().bits_overrides
    cnn, jcnn = PipelineConfig(arch="paper_cnn"), JPipelineConfig(
        arch="paper_cnn")
    assert cnn.arch == jcnn.arch == PipelineConfig().arch == "paper-cnn"
    assert dataclasses.asdict(cnn.model_config()) == \
        dataclasses.asdict(jcnn.model_config())


def test_build_student_applies_path_glob_layouts_like_jax():
    """A path-glob layout override that init's bare names cannot see:
    ``apply_plan`` re-shapes those ``log_swr`` leaves to the plan's layout
    (a constant fill the init stage refits), as the JAX package does."""
    kw = dict(TINY_LM, layout_overrides=(("layers.mlp.*", "group:16"),))
    jad = j_get_adapter(JPipelineConfig(**kw))
    want = dict(tree_items(_torch_tree(jad.build_student(
        jad.init_teacher()))))
    tad = get_adapter(PipelineConfig(device="cpu", **kw))
    got = tad.build_student(tad.init_teacher())
    assert got["layers"]["mlp"]["up"]["log_swr"].shape == (2, 4, 128)
    assert sorted(p for p, _ in tree_items(got)) == sorted(want)
    for path, leaf in tree_items(got):
        assert leaf.shape == want[path].shape, path
        if path[-1] == "log_swr":
            np.testing.assert_allclose(leaf.numpy(), want[path].numpy(),
                                       rtol=1e-6, err_msg=str(path))
    assert tad.qplan.describe() == jad.qplan.describe()


def test_calibrate_stage_matches_jax(jax_run, port_adapter):
    """The calibrated range is the max/min of the teacher's bf16 taps, which
    the two packages round in different places: ``log_sa`` within one bf16
    ulp of the range (log(1 + 2^-7); measured 4.1e-3 on one of the two
    layers here), a zero-point within 1; every other leaf as set."""
    got = port_adapter.calibrate(_torch_tree(jax_run["student0"]),
                                 jax_run["teacher"])
    _assert_students_match(got, jax_run["stages"][1], zp_within=1.0,
                           log_sa_atol=float(np.log1p(2.0 ** -7)))


def test_init_stage_matches_jax(jax_run, port_adapter):
    got = port_adapter.init_scales(jax_run["stages"][1])
    _assert_students_match(got, jax_run["stages"][2])


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def test_finetune_stage_matches_jax(jax_run, port_adapter):
    """Two bf16 steps from the JAX-initialised student: the logged losses
    against the JAX pipeline's."""
    _, history = port_adapter.finetune(_clone(jax_run["stages"][2]),
                                       jax_run["teacher"])
    want = jax_run["result"].history
    assert [h["step"] for h in history] == [h["step"] for h in want] == [0, 1]
    for h, w in zip(history, want):
        assert abs(h["loss"] - w["loss"]) <= 1e-2 * abs(w["loss"]), (h, w)


def test_trainer_resumes_from_step_checkpoints(jax_run, tmp_path):
    """QFTTrainer.run with ``checkpoint_every=1`` into
    ``QFTConfig.checkpoint_dir``, stopped after 3 steps and resumed to 4,
    ends bit for bit where 4 uninterrupted steps end (Adam state and step
    count restored, the data stream replayed to step 3)."""
    from repro_torch.train.qft_trainer import QFTConfig, QFTTrainer

    def run(steps, qft, **kw):
        ad = get_adapter(PipelineConfig(device="cpu", **TINY_LM))
        tr = QFTTrainer(ad.cfg, ad.qcfg, jax_run["teacher"], qft,
                        steps_per_epoch=ad.data.steps_per_epoch,
                        plan=ad.qplan)
        return tr.run(_clone(jax_run["stages"][2]), ad.batches(),
                      steps=steps, log_every=1, **kw)

    straight, _ = run(4, QFTConfig())
    run(3, QFTConfig(checkpoint_every=1, checkpoint_dir=str(tmp_path)))
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.all_steps() == [1, 2, 3]
    resumed, history = run(4, QFTConfig(), ckpt=ckpt, resume=True)
    assert [h["step"] for h in history] == [3]
    assert ckpt.latest_step() == 4
    want = dict(tree_items(straight))
    for path, leaf in tree_items(resumed):
        assert torch.equal(leaf, want[path]), path


def test_export_matches_jax_at_steps_0(jax_run, port_adapter):
    """The initialised student (no training: steps=0) exported by both
    packages: integer leaves bit-equal, scale leaves to 1e-6 relative, the
    embedded plan identical."""
    jad = j_get_adapter(JPipelineConfig(mode="w4a8", **{**TINY_LM,
                                                        "steps": 0}))
    student_j = _numpy_tree(jax_run["stages"][2])
    want = dict(tree_items(_torch_tree(jad.export(student_j,
                                                  jad.make_plan()))))
    got = port_adapter.export(jax_run["stages"][2],
                              port_adapter.make_plan())
    assert sorted(p for p, _ in tree_items(got)) == sorted(want)
    for path, leaf in tree_items(got):
        ref = want[path]
        if leaf.is_floating_point():
            np.testing.assert_allclose(leaf.numpy(), ref.numpy(), rtol=1e-6,
                                       atol=0, err_msg=str(path))
        else:
            assert torch.equal(leaf, ref), path


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def test_evaluate_matches_jax(jax_run, port_adapter):
    """evaluate on the student the JAX pipeline trained (restored bit for
    bit): export parity below 1e-4 in both packages, equal artifact bytes,
    the distillation loss to 2e-2 relative (bf16 forwards)."""
    student = jax_run["stages"][3]
    plan = port_adapter.make_plan()
    artifact = port_adapter.export(student, plan)
    got = port_adapter.evaluate(student, jax_run["teacher"], artifact, plan)
    want = jax_run["result"].metrics["evaluate"]
    assert got["export_parity_max_err"] < 1e-4, got
    assert want["export_parity_max_err"] < 1e-4, want
    assert got["artifact_bytes"] == want["artifact_bytes"]
    assert got["w_layout"] == want["w_layout"]
    assert got["exempt"] == want["exempt"]
    assert abs(got["distill_loss"] - want["distill_loss"]) \
        <= 2e-2 * want["distill_loss"], (got, want)
    assert 0.0 <= got["top1_agree"] <= 1.0
    assert got["kernel_route"]["kernel"] is False      # CPU: plain version
    assert got["kernel_route"]["max_err"] < 1e-4


def test_jax_stage_checkpoint_resumes_in_the_port(jax_run):
    """The port's run_pipeline on the JAX run's workdir skips every student
    stage and carries on with the JAX-trained student, bit for bit."""
    pcfg = PipelineConfig(mode="w4a8", device="cpu",
                          workdir=str(jax_run["workdir"]), **TINY_LM)
    result = run_pipeline(pcfg)
    assert result.stages_skipped == ["calibrate", "init", "finetune"]
    assert result.stages_run == ["export", "evaluate"]
    _assert_students_match(result.student, jax_run["stages"][3])
    assert result.metrics["evaluate"]["export_parity_max_err"] < 1e-4


def test_port_checkpoint_restores_in_jax(jax_run, tmp_path):
    """The reverse: a stage checkpoint the port writes restores in the JAX
    package, leaves bit-equal."""
    student = jax_run["stages"][2]
    CheckpointManager(str(tmp_path)).save(2, {"student": student,
                                              "steps": np.asarray(2)})
    like = {"student": jax_run["student0"], "steps": np.asarray(0)}
    back = JCkpt(str(tmp_path)).restore(2, like)
    assert int(back["steps"]) == 2
    _assert_students_match(_torch_tree(back["student"]), student)


def test_checkpoint_manager_keep_atomic_and_async(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for step in (1, 2, 3):
        ckpt.save(step, {"a": {"x": x}, "n": np.asarray(step)},
                  blocking=step != 3)
        x.add_(1.0)                   # in place, right after the save
    ckpt.wait()
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    assert not list(tmp_path.glob("tmp.*"))
    back = ckpt.restore(3, {"a": {"x": torch.zeros(2, 3)},
                            "n": np.asarray(0)}, device="cpu")
    assert torch.equal(back["a"]["x"],
                       torch.arange(6, dtype=torch.float32).reshape(2, 3) + 2)
    assert int(back["n"]) == 3
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(3, {"a": {"x": torch.zeros(3, 2)}, "n": np.asarray(0)})
    with pytest.raises(KeyError):
        ckpt.restore(3, {"a": {"y": torch.zeros(2, 3)}, "n": np.asarray(0)})


@pytest.fixture(scope="module")
def port_workdir(tmp_path_factory):
    """A finished port run (steps=2) on its own workdir."""
    workdir = tmp_path_factory.mktemp("port_pipeline")
    pcfg = PipelineConfig(mode="w4a8", device="cpu", workdir=str(workdir),
                          serve_smoke=True, **TINY_LM)
    return pcfg, run_pipeline(pcfg)


def test_pipeline_runs_every_stage(port_workdir):
    _, result = port_workdir
    assert result.stages_run == list(STAGES) and not result.stages_skipped
    ev = result.metrics["evaluate"]
    assert ev["export_parity_max_err"] < 1e-4, ev
    assert np.isfinite(ev["distill_loss"])
    assert ev["serve"]["tokens"] == 12
    assert result.metrics["finetune"]["steps"] == 2


def test_resume_skips_student_stages(port_workdir):
    """A rerun on the same workdir skips calibrate, init and finetune and
    re-derives export and evaluate: the same metrics, bit for bit."""
    pcfg, first = port_workdir
    second = run_pipeline(pcfg)
    assert second.stages_skipped == ["calibrate", "init", "finetune"]
    assert second.stages_run == ["export", "evaluate"]
    _assert_students_match(second.student, first.student)
    assert second.metrics["evaluate"] == first.metrics["evaluate"]


def test_changed_steps_reenters_finetune(port_workdir, tmp_path):
    """Raising --steps on a finished workdir trains the extra step,
    continuing from the within-finetune checkpoint (only step 2 is logged);
    a checkpoint of another layout raises the error that suggests
    --no-resume.  (On a copy of the workdir: the resume test reads it.)"""
    pcfg, _ = port_workdir
    workdir = tmp_path / "copy"
    shutil.copytree(pcfg.workdir, workdir)
    third = run_pipeline(dataclasses.replace(pcfg, steps=3,
                                             workdir=str(workdir)))
    assert third.stages_skipped == ["calibrate", "init"]
    assert "finetune" in third.stages_run
    assert third.metrics["finetune"]["steps"] == 3
    assert [h["step"] for h in third.history] == [2]
    with pytest.raises(RuntimeError, match="--no-resume"):
        run_pipeline(dataclasses.replace(pcfg, w_layout="group:16",
                                         workdir=str(workdir)))


def test_cli_quantize_cpu_and_exit_codes(capsys):
    rc = cli_main(["quantize", "--config", "qwen3_8b", "--device", "cpu",
                   "--steps", "0", "--stop-after", "export",
                   "--calib-samples", "32", "--calib-seq-len", "16",
                   "--calib-batch-size", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "stage export" in out and "pipeline complete" in out
    assert cli_main(["quantize", "--config", "nonexistent_model"]) == 2
    err = capsys.readouterr().err
    assert "unknown config" in err and "qwen3-8b" in err
    assert cli_main(["quantize", "--config", "qwen3_8b", "--bits-override",
                     "nope"]) == 2
    assert cli_main(["check", "--config", "nonexistent_model"]) == 2
    assert "unknown config" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [[], ["--full"],
                                   ["--w-layout", "group:16"]])
def test_cli_plan_table_matches_jax(capsys, extra):
    assert j_cli_main(["plan", "--config", "qwen3-8b", *extra]) == 0
    want = capsys.readouterr().out
    assert cli_main(["plan", "--config", "qwen3-8b", *extra]) == 0
    assert capsys.readouterr().out == want


def test_python_m_repro_torch_lists_configs():
    out = subprocess.run([sys.executable, "-m", "repro_torch",
                          "list-configs"], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[::2] == ["command-r-plus-104b",
                                       "deepseek-v2-236b", "mamba2-1.3b",
                                       "paper-cnn", "phi4-mini-3.8b",
                                       "qwen2-moe-a2.7b", "qwen2-vl-7b",
                                       "qwen3-32b", "qwen3-8b",
                                       "seamless-m4t-medium", "zamba2-7b"]
    assert out.stdout.split()[1::2] == [
        f"repro_torch.configs.{m}" for m in (
            "command_r_plus_104b", "deepseek_v2_236b", "mamba2_1_3b",
            "paper_cnn", "phi4_mini_3_8b", "qwen2_moe_a2_7b", "qwen2_vl_7b",
            "qwen3_32b", "qwen3_8b", "seamless_m4t_medium", "zamba2_7b")]


# ---------------------------------------------------------------------------
# The paper CNN: tests/test_pipeline.py's CNN cases, each stage held against
# the JAX stage on the JAX stage's own input.  The CNN runs in f32, so the
# tolerances are f32's: scale leaves 1e-6, weights and integer leaves bit
# for bit before finetune; the finetune losses 1e-5 relative and the trained
# leaves within two Adam steps' reach of JAX's (an update of ±lr where a
# gradient is noise); accuracies to one eval image in 512.
# ---------------------------------------------------------------------------

CNN_RUN = dict(arch="paper_cnn", mode="w4a8", steps=2, calib_samples=256,
               log_every=1)


def _cnn_data(jad):
    """The JAX adapter's synthetic task (drawn with jax.random), as
    tensors."""
    return {k: torch.from_numpy(np.array(getattr(jad, k)))
            for k in ("x_calib", "y_calib", "x_eval", "y_eval")}


@pytest.fixture(scope="module")
def jax_cnn_run(tmp_path_factory):
    """The JAX pipeline on paper-cnn with a workdir; its stage checkpoints
    restored through the port, its teacher and data converted."""
    workdir = tmp_path_factory.mktemp("jax_cnn_pipeline")
    jpcfg = JPipelineConfig(workdir=str(workdir), **CNN_RUN)
    result = j_run_pipeline(jpcfg)
    jad = j_get_adapter(jpcfg)
    student0 = _torch_tree(jad.build_student(result.teacher))
    like = _like(student0)
    ckpt = CheckpointManager(str(workdir / "stages"))
    stages = {s: ckpt.restore(s, like)["student"] for s in (1, 2, 3)}
    return dict(workdir=workdir, result=result, student0=student0,
                teacher=_torch_tree(result.teacher), stages=stages,
                data=_cnn_data(jad))


def _cnn_adapter(run, **kw):
    """A port CNN adapter on the CPU that takes the JAX run's data and
    teacher (the student's constant init is the same in both)."""
    ad = get_adapter(PipelineConfig(device="cpu", **{**CNN_RUN, **kw}))
    for k, v in run["data"].items():
        setattr(ad, k, v)
    ad.init_teacher = lambda: _clone_tree(run["teacher"])
    return ad


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()


def _assert_trained_close(got, want, lr):
    """Trained leaves: within two Adam steps (2·lr) of JAX's, the rest
    bit for bit where untouched by training is not asked."""
    want = dict(tree_items(want))
    assert sorted(map(str, (p for p, _ in tree_items(got)))) == \
        sorted(map(str, want))
    for path, leaf in tree_items(got):
        err = float((leaf - want[path]).abs().max())
        assert err <= 2 * lr * 1.01, (path, err)


def test_cnn_build_student_matches_jax(jax_cnn_run):
    ad = _cnn_adapter(jax_cnn_run)
    got = ad.build_student(ad.init_teacher())
    _assert_students_match(got, jax_cnn_run["student0"])
    assert ad.qplan.describe() == j_get_adapter(
        JPipelineConfig(**CNN_RUN)).qplan.describe()


def test_cnn_calibrate_stage_matches_jax(jax_cnn_run):
    """Max-min ranges of the f32 teacher's taps: log_sa 1e-6, zero-points
    equal."""
    ad = _cnn_adapter(jax_cnn_run)
    got = ad.calibrate(_clone_tree(jax_cnn_run["student0"]),
                       jax_cnn_run["teacher"])
    _assert_students_match(got, jax_cnn_run["stages"][1])


@pytest.mark.parametrize("cle", [False, True])
def test_cnn_init_stage_matches_jax(jax_cnn_run, cle):
    """The MMSE init of every conv's F̂ and the fc (with the CLE chain and
    its refit when asked), from the JAX calibrated student."""
    ad = _cnn_adapter(jax_cnn_run, cle=cle)
    got = ad.init_scales(_clone_tree(jax_cnn_run["stages"][1]))
    if not cle:
        _assert_students_match(got, jax_cnn_run["stages"][2])
        return
    jad = j_get_adapter(JPipelineConfig(**{**CNN_RUN, "cle": True}))
    want = _torch_tree(jad.init_scales(jax.tree.map(
        np.asarray, _numpy_cnn(jax_cnn_run["stages"][1]))))
    _assert_students_match(got, want)


def _numpy_cnn(tree):
    if isinstance(tree, dict):
        return {k: _numpy_cnn(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_cnn(v) for v in tree]
    return tree.numpy()


def test_cnn_finetune_stage_matches_jax(jax_cnn_run):
    """Two steps of the paper recipe from the JAX-initialised student: the
    first loss (same inputs) 1e-6 relative, the second 1e-4 (Adam's first
    update moves a leaf by ±lr whatever its gradient's size, so a gradient
    at rounding noise can leave the packages 2·lr apart), every trained
    leaf within 2·lr."""
    ad = _cnn_adapter(jax_cnn_run)
    student, history = ad.finetune(_clone_tree(jax_cnn_run["stages"][2]),
                                   jax_cnn_run["teacher"])
    want = jax_cnn_run["result"].history
    assert [h["step"] for h in history] == [h["step"] for h in want] == [0, 1]
    for h, w, rtol in zip(history, want, (1e-6, 1e-4)):
        assert abs(h["loss"] - w["loss"]) <= rtol * abs(w["loss"]), (h, w)
    _assert_trained_close(student, jax_cnn_run["stages"][3],
                          PipelineConfig().base_lr)


def test_cnn_pipeline_e2e_matches_jax(jax_cnn_run, tmp_path):
    """tests/test_pipeline.py::test_pipeline_e2e_paper_cnn on the port, on
    the JAX run's data and teacher: every stage runs, the evaluate metrics
    agree with JAX's, the export round-trips on the packed conv1."""
    from repro_torch.core import dof
    from repro_torch.models import cnn
    ad = _cnn_adapter(jax_cnn_run)
    pcfg = ad.pcfg
    result = run_pipeline(dataclasses.replace(pcfg, workdir=str(tmp_path)),
                          adapter=ad)
    assert result.stages_run == list(STAGES)
    ev, want = (result.metrics["evaluate"],
                jax_cnn_run["result"].metrics["evaluate"])
    assert ev["export_parity_max_err"] < 1e-4, ev
    for key in ("w_layout", "exempt", "artifact_bytes"):
        assert ev[key] == want[key], key
    for key in ("acc_teacher", "acc_student", "acc_deployed"):
        assert abs(ev[key] - want[key]) <= 1 / 512, (key, ev, want)
    assert ev["kernel_route"]["kernel"] is False          # int8 fc
    assert ev["kernel_route"]["path"] == "fc"
    _assert_trained_close(result.student, jax_cnn_run["stages"][3],
                          pcfg.base_lr)
    student, art = result.student, result.artifact
    log_in, log_out = cnn._conv_stream_scales(student, 1)
    assert art["convs"][1]["q"].dtype == torch.uint8     # int4-packed
    deq = dof.dequantize_export(art["convs"][1], torch.float32, packed=True)
    w_eff = cnn.conv_effective_weight(student["convs"][1], result.qcfg,
                                      log_in, log_out)
    np.testing.assert_allclose(deq.numpy(), w_eff.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_cnn_stage_resume_on_the_jax_workdir(jax_cnn_run):
    """tests/test_pipeline.py::test_pipeline_stage_resume: the port on the
    JAX run's workdir (steps 0) skips every student stage and carries on
    with the JAX-trained student, bit for bit."""
    ad = _cnn_adapter(jax_cnn_run, steps=0,
                      workdir=str(jax_cnn_run["workdir"]))
    second = run_pipeline(ad.pcfg, adapter=ad)
    assert second.stages_skipped == ["calibrate", "init", "finetune"]
    assert second.stages_run == ["export", "evaluate"]
    _assert_students_match(second.student, jax_cnn_run["stages"][3])
    assert second.metrics["evaluate"]["export_parity_max_err"] < 1e-4


def test_cnn_steps_change_reenters_finetune(jax_cnn_run, tmp_path):
    """tests/test_pipeline.py::test_pipeline_steps_change_reenters_finetune:
    steps 3 on a copy of the finished steps-2 workdir, in both packages,
    continues from the within-finetune checkpoint: only step 2 is trained
    and logged, its loss 1e-5 relative to JAX's."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, tdir):
        shutil.copytree(jax_cnn_run["workdir"], d)
    jthird = j_run_pipeline(JPipelineConfig(**{**CNN_RUN, "steps": 3,
                                               "workdir": str(jdir)}))
    ad = _cnn_adapter(jax_cnn_run, steps=3, workdir=str(tdir))
    third = run_pipeline(ad.pcfg, adapter=ad)
    assert third.stages_skipped == jthird.stages_skipped == ["calibrate",
                                                             "init"]
    assert "finetune" in third.stages_run
    assert third.metrics["finetune"]["steps"] == 3
    assert [h["step"] for h in third.history] == \
        [h["step"] for h in jthird.history] == [2]
    got, want = third.history[0]["loss"], jthird.history[0]["loss"]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_cnn_w4chw_mode_matches_jax(jax_cnn_run):
    """tests/test_pipeline.py::test_pipeline_w4chw_mode_cnn: the permissive
    (doubly-channelwise, APQ) setup through export and evaluate with no
    training; the initialised student against JAX's."""
    kw = {**CNN_RUN, "mode": "w4chw", "steps": 0}
    want = j_run_pipeline(JPipelineConfig(**kw))
    ad = _cnn_adapter(jax_cnn_run, mode="w4chw", steps=0)
    got = run_pipeline(ad.pcfg, adapter=ad)
    assert "finetune" not in got.metrics
    _assert_students_match(got.student, _torch_tree(want.student))
    ev, jev = got.metrics["evaluate"], want.metrics["evaluate"]
    assert ev["export_parity_max_err"] < 1e-4, ev
    for key in ("acc_student", "acc_deployed"):
        assert abs(ev[key] - jev[key]) <= 1 / 512, (key, ev, jev)


def test_cnn_cli_quantize_and_resume(capsys, tmp_path):
    """``python -m repro_torch quantize --config paper_cnn --device cpu``:
    the JAX CLI smoke (steps 0, stop after export), then two runs of 2
    steps on one workdir: the second skips calibrate, init and finetune and
    prints the same evaluate metrics."""
    rc = cli_main(["quantize", "--config", "paper_cnn", "--device", "cpu",
                   "--steps", "0", "--stop-after", "export"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "stage export" in out and "pipeline complete" in out
    argv = ["quantize", "--config", "paper_cnn", "--device", "cpu",
            "--steps", "2", "--workdir", str(tmp_path)]
    outs = []
    for _ in range(2):
        assert cli_main(argv) == 0
        outs.append(capsys.readouterr().out)
    assert "skipped (resume): calibrate, init, finetune" in outs[1]

    def metrics(text):
        return [ln for ln in text.splitlines()
                if ln.startswith("  ") and ":" in ln
                and not ln.startswith(("  stage", "  plan", "  resumed",
                                       "  skipped", "  finetune loss"))]
    assert metrics(outs[0]) == metrics(outs[1])
    assert float(next(ln for ln in metrics(outs[0]) if "export_parity"
                      in ln).split(":")[1]) < 1e-4


def test_canonical_arch_spellings_match_jax():
    from repro.pipeline import canonical_arch as j_canonical_arch
    from repro.pipeline.cli import _canon_arch as j_canon
    from repro_torch.pipeline import canonical_arch
    from repro_torch.pipeline.cli import _canon_arch
    for name in ("qwen3_8b", "qwen3-8b", "paper_cnn", "paper-cnn",
                 "phi4_mini_3_8b", "phi4-mini-3.8b", "qwen3_32b",
                 "command_r_plus_104b", "qwen2_moe_a2_7b",
                 "qwen2-moe-a2.7b", "deepseek_v2_236b", "deepseek-v2-236b",
                 "mamba2_1_3b", "mamba2-1.3b", "zamba2_7b", "zamba2-7b",
                 "qwen2_vl_7b", "qwen2-vl-7b", "seamless_m4t_medium",
                 "seamless-m4t-medium"):
        assert canonical_arch(name) == j_canonical_arch(name), name
        assert _canon_arch(name) == j_canon(name), name
    assert canonical_arch("paper_cnn") == "paper-cnn"
    for bad in ("qwen2-vl", "nonexistent"):
        with pytest.raises(KeyError):
            _canon_arch(bad)
