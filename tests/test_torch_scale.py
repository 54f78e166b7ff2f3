"""repro_torch's training-at-scale modules vs the JAX package, on the CPU:

- remat (``models.transformer._maybe_remat``): the three policies give the
  JAX package's loss and gradients (f32 compute, 1e-6 on the loss, 1e-5
  relative L2 on each gradient leaf) on SMOKE qwen3-8b and SMOKE
  mamba2-1.3b, each layer's body is recomputed exactly where the reference
  wraps it, and ``save_dots`` keeps the linears' products;
- ``train.compression``: three steps of the error-feedback compressor
  against the JAX package's (the integer grid bit-equal);
- ``sharding.partition``: every parameter's and cache leaf's spec equals
  the JAX package's for every registry config at full size on the
  production meshes;
- ``train.elastic``: the JAX package's restart test, and a SMOKE QFT run
  through the launcher's sharded step whose injected failure and restore
  end bit-equal to the run without one;
- ``launch.train``: the ``--smoke`` path on the CPU, and the production
  mesh's refusal of one rank.
"""
import dataclasses
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.configs.mamba2_1_3b import SMOKE as J_MAMBA  # noqa: E402
from repro.configs.qwen3_8b import SMOKE as J_DENSE  # noqa: E402
from repro.core.distill import qft_loss as j_qft_loss  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.sharding import partition as j_part  # noqa: E402
from repro.train import compression as j_comp  # noqa: E402
from repro.train import elastic as j_elastic  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.configs.mamba2_1_3b import SMOKE as T_MAMBA  # noqa: E402
from repro_torch.configs.qwen3_8b import SMOKE as T_DENSE  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.data.calib import CalibConfig, CalibDataset  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.models import init_cache, init_model  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.sharding import partition as t_part  # noqa: E402
from repro_torch.train import compression as t_comp  # noqa: E402
from repro_torch.train import elastic as t_elastic  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.steps import make_value_and_grad  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("full", "save_dots", "none")
CFGS = {"dense": (J_DENSE, T_DENSE), "mamba2": (J_MAMBA, T_MAMBA)}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ------------------------------------------------------------------ remat


@functools.lru_cache(maxsize=None)
def _jax_case(name, policy):
    """The JAX package's student and teacher (from a seed), a batch, and
    its loss and gradients under ``policy`` (f32 compute)."""
    jcfg = dataclasses.replace(CFGS[name][0], remat_policy=policy)
    student = j_init_model(jax.random.PRNGKey(1), jcfg, JQ())
    teacher = j_init_model(jax.random.PRNGKey(0), jcfg, None)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab, (4, 16)).astype(np.int32)

    def loss_fn(s):
        b = {"tokens": jnp.asarray(tokens)}
        hs = j_forward(s, jcfg, JQ(), b, compute_dtype=jnp.float32)["hidden"]
        ht = j_forward(teacher, jcfg, None, b,
                       compute_dtype=jnp.float32)["hidden"]
        return j_qft_loss(hs, ht)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(student)
    return student, teacher, tokens, float(loss), jax.device_get(grads)


def _port_vg(name, policy, student, teacher, tokens, **cfg_kw):
    tcfg = dataclasses.replace(CFGS[name][1], remat_policy=policy, **cfg_kw)
    ts = from_numpy_tree(jax.device_get(student), "cpu")
    tt = from_numpy_tree(jax.device_get(teacher), "cpu")
    vg = make_value_and_grad(tcfg, TQ(), compute_dtype=torch.float32)
    return vg(ts, tt, {"tokens": torch.from_numpy(tokens.copy())})


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", list(CFGS))
def test_remat_policies_match_jax(name, policy):
    """Loss 1e-6 relative, each gradient leaf 1e-5 relative L2 (a floor of
    1e-4 of the whole gradient's norm for a leaf whose gradient cancels),
    against the JAX package under the same policy."""
    student, teacher, tokens, jloss, jgrads = _jax_case(name, policy)
    loss, grads = _port_vg(name, policy, student, teacher, tokens)
    assert abs(float(loss) - jloss) <= 1e-6 * abs(jloss)
    jg = dict(tree_items(from_numpy_tree(jgrads, "cpu")))
    total = float(sum(float((g.double() ** 2).sum())
                      for g in jg.values())) ** 0.5
    for path, g in tree_items(grads):
        ref = jg[path].double()
        if g is None:
            assert float(ref.abs().max()) == 0.0, path
            continue
        err = float((g.double() - ref).norm())
        assert err <= 1e-5 * (float(ref.norm()) + 1e-4 * total), (
            path, err, float(ref.norm()))


@pytest.mark.parametrize("name", list(CFGS))
def test_remat_policies_agree_bitwise(name):
    """On one device the recompute repeats the forward's arithmetic: the
    three policies give the same loss and gradients, bit for bit."""
    student, teacher, tokens, _, _ = _jax_case(name, "full")
    runs = [_port_vg(name, p, student, teacher, tokens) for p in POLICIES]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for (p, a), (_, b) in zip(tree_items(grads), tree_items(runs[0][1])):
            assert (a is None and b is None) or torch.equal(a, b), p


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _counts(name, policy, monkeypatch, **cfg_kw):
    """(layer-norm calls, linear products) over one forward + backward."""
    student, teacher, tokens, _, _ = _jax_case(name, "full")
    calls = [0]
    rmsnorm = t_tf.rmsnorm

    def counted(*a, **k):
        calls[0] += 1
        return rmsnorm(*a, **k)
    monkeypatch.setattr(t_tf, "rmsnorm", counted)
    with _CountMM() as mm:
        _port_vg(name, policy, student, teacher, tokens, **cfg_kw)
    return calls[0], mm.n


@pytest.mark.parametrize("name", list(CFGS))
def test_remat_recomputes_each_layer_where_the_reference_wraps_it(
        name, monkeypatch):
    """``full`` runs each student layer's body again in the backward (one
    more ``norm1`` call a layer, two for the dense layer's ``norm2``; the
    teacher's forward takes no gradient), and recomputes its linears;
    ``save_dots`` recomputes the layers but keeps the linears' products;
    ``none``, ``remat=False`` and ``scan_layers=False`` recompute nothing,
    as the reference's ``_maybe_remat``/``_scan_layers``."""
    cfg = CFGS[name][1]
    per_layer = 2 if name == "dense" else 1
    base = _counts(name, "none", monkeypatch)
    full = _counts(name, "full", monkeypatch)
    dots = _counts(name, "save_dots", monkeypatch)
    assert full[0] == base[0] + per_layer * cfg.n_layers
    assert dots[0] == full[0]
    assert full[1] > base[1] and dots[1] == base[1]
    assert _counts(name, "full", monkeypatch, remat=False) == base
    assert _counts(name, "full", monkeypatch, scan_layers=False) == base


# ------------------------------------------------------------- compression


def test_error_feedback_compressor_matches_jax():
    """Three steps on a tree with a zero, a large and a small leaf: the
    dequantized gradients and the bf16 buffers equal the JAX package's,
    and so the integer grid (dequantized / scale) bit for bit."""
    rng = np.random.default_rng(0)
    shapes = {"a": (64,), "b": {"w": (8, 16)}, "z": (5,)}
    jinit, jcomp = j_comp.make_error_feedback_compressor(8)
    tinit, tcomp = t_comp.make_error_feedback_compressor(8)
    like = jax.tree.map(lambda s: np.zeros(s, np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))
    js, ts = jinit(like), tinit(from_numpy_tree(like, "cpu"))
    for step in range(3):
        g = jax.tree.map(lambda x: (rng.normal(size=x.shape)
                                    * 10.0 ** rng.integers(-4, 2)
                                    ).astype(np.float32), like)
        g["z"] = np.zeros((5,), np.float32)
        ef0 = {p: e.float().numpy() for p, e in tree_items(ts["ef"])}
        jq, js = jcomp(jax.tree.map(jnp.asarray, g), js)
        tq, ts = tcomp(from_numpy_tree(g, "cpu"), ts)
        jq = dict(tree_items(from_numpy_tree(jax.device_get(jq), "cpu")))
        jef = dict(tree_items(jax.device_get(js["ef"])))
        for path, t in tree_items(tq):
            assert torch.equal(t, jq[path]), (step, path)
            ref = torch.from_numpy(np.asarray(jef[path]).astype(np.float32))
            assert torch.equal(dict(tree_items(ts["ef"]))[path].float(),
                               ref), (step, path)
            # the grid: round-half-even of (g + e) / scale, times scale
            gf = dict(tree_items(g))[path] + ef0[path]
            scale = np.float32(max(np.abs(gf).max() / np.float32(127),
                                   np.float32(1e-12)))
            grid = np.clip(np.round(gf / scale), -127, 127)
            assert np.array_equal(grid * scale, t.numpy()), (step, path)


def test_error_feedback_tracks_the_true_sum():
    """The JAX package's own check, on the port: accumulated compressed
    gradients track the true sum (5 %); a None gradient stays None."""
    init, compress = t_comp.make_error_feedback_compressor(bits=8)
    state = init({"w": torch.zeros(64), "unused": torch.zeros(3)})
    rng = np.random.default_rng(0)
    true, comp = np.zeros(64), np.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(size=64).astype(np.float32) * 0.01)
        gq, state = compress({"w": g, "unused": None}, state)
        assert gq["unused"] is None
        true += g.numpy()
        comp += gq["w"].numpy()
    assert np.linalg.norm(comp - true) / np.linalg.norm(true) < 0.05


def test_grad_compress_hook_runs_after_the_mask(monkeypatch):
    """make_train_step calls the hook on the masked gradients, before the
    update; the error-feedback hook keeps its buffer."""
    from repro_torch.optim.adam import paper_recipe
    from repro_torch.train.steps import make_train_step
    student, teacher, tokens, _, _ = _jax_case("dense", "full")
    ts = from_numpy_tree(jax.device_get(student), "cpu")
    tt = from_numpy_tree(jax.device_get(teacher), "cpu")
    seen = {}
    hook = t_comp.error_feedback_hook(ts)

    def spy(grads, opt_state):
        seen["g"] = grads
        return hook(grads, opt_state)

    def mask(path, g):
        return torch.zeros_like(g) if path[-1] == "log_swr" else g
    opt = paper_recipe(4)
    step = make_train_step(T_DENSE, TQ(), opt, grad_compress=spy,
                           grad_mask=mask, compute_dtype=torch.float32)
    step(ts, opt.init(ts), tt, {"tokens": torch.from_numpy(tokens.copy())})
    got = dict(tree_items(seen["g"]))
    assert all(float(g.abs().max()) == 0 for p, g in got.items()
               if p[-1] == "log_swr" and g is not None)
    ef = dict(tree_items(hook.state["ef"]))
    assert any(float(e.float().abs().max()) > 0 for e in ef.values())


# --------------------------------------------------------------- partition


class _Mesh:
    """A stand-in mesh: param_spec and cache_shardings read only the axis
    sizes."""

    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _jax_specs(tree, fn):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
            tuple(fn(p, leaf)) for p, leaf in flat}


def _flat_specs(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, prefix + (k,)))
        return out
    return {} if tree is None else {prefix: tree}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", j_registry.ARCH_IDS)
def test_param_and_cache_specs_equal_the_references(arch, mesh,
                                                    monkeypatch):
    """Student, teacher and decode-cache specs of the full-size config
    (``with_padding(tp=16)``): the JAX package's from ``jax.eval_shape``
    trees and a stand-in mesh (its ``NamedSharding`` reduced to the spec),
    the port's from ``meta`` tensors."""
    from jax.sharding import PartitionSpec
    monkeypatch.setattr(j_part, "NamedSharding", lambda mesh, spec: spec)
    jm, tm = _Mesh(MESHES[mesh]), _Mesh(MESHES[mesh])
    multi = mesh == "2x16x16"
    jpol = j_part.ShardingPolicy(dp=("pod", "data") if multi else ("data",))
    tpol = t_part.ShardingPolicy(dp=("pod", "data") if multi else ("data",))
    jcfg = j_registry.get_config(arch).with_padding(tp=16)
    tcfg = t_registry.get_config(arch).with_padding(tp=16)
    for jq, tq in ((JQ(), TQ()), (None, None)):
        jtree = jax.eval_shape(lambda k: j_init_model(k, jcfg, jq),
                               jax.random.PRNGKey(0))
        want = _jax_specs(jtree, lambda p, l: j_part.param_spec(
            p, l, jcfg, jm, jpol))
        got = _flat_specs(t_part.params_shardings(
            init_model(0, tcfg, tq, device="meta"), tcfg, tm, tpol))
        assert got == want
    kw = {"enc_len": 64} if jcfg.family == "encdec" else {}
    jcache = jax.eval_shape(lambda: j_init_cache(jcfg, 32, 256, **kw))
    flat = jax.tree_util.tree_flatten_with_path(
        j_part.cache_shardings(jcache, jcfg, jm, jpol),
        is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
            tuple(s) for p, s in flat}
    got = _flat_specs(t_part.cache_shardings(
        init_cache(tcfg, 32, 256, device="meta", **kw), tcfg, tm, tpol))
    assert got == want


def test_sharding_dataclasses_equal_the_references():
    for j, t in ((j_part.ShardingPolicy, t_part.ShardingPolicy),
                 (j_elastic.ElasticConfig, t_elastic.ElasticConfig)):
        jf = [(f.name, f.default) for f in dataclasses.fields(j)]
        tf = [(f.name, f.default) for f in dataclasses.fields(t)]
        assert jf == tf


@pytest.mark.parametrize("size,axes,mesh,want", [
    (16, ("pod", "data"), {"pod": 2, "data": 16}, "pod"),
    (64, ("pod", "data"), {"pod": 2, "data": 16}, ("pod", "data")),
    (3, "model", {"model": 16}, None)])
def test_div_axes_equals_the_references(size, axes, mesh, want):
    assert t_part.div_axes(size, axes, _Mesh(mesh)) == want \
        == j_part.div_axes(size, axes, _Mesh(mesh))


# ----------------------------------------------------------------- elastic


@pytest.fixture
def one_rank():
    """A one-rank gloo process group on a free localhost port."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_elastic_restart_with_injected_failure(tmp_path, one_rank):
    """The JAX package's test: failure at step 7 → remesh → restore from
    the checkpoint at 5 → complete; the state counts 12 steps."""
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    meshes = []

    def build_step(mesh):
        meshes.append(tuple(mesh.shape))

        def step(state, batch):
            return {"x": state["x"] + 1.0}, {}
        return step

    runner = t_elastic.ElasticRunner(
        build_step, ckpt, t_elastic.ElasticConfig(
            checkpoint_every=5, max_restarts=2, model_parallel=1),
        device_type="cpu")
    data = CalibDataset(CalibConfig(n_samples=64, seq_len=4, batch_size=4,
                                    vocab=16))
    state, s = runner.run({"x": torch.zeros(())}, data, steps=12,
                          inject_failure_at=7)
    assert s == 12 and runner.restarts == 1
    assert runner.events[0]["step"] == 7
    assert float(state["x"]) == 12.0
    assert meshes == [(1, 1), (1, 1)]


@pytest.mark.parametrize("policy", ["full", "none"])
def test_sharded_forward_gathers_one_layer_at_a_time(one_rank, monkeypatch,
                                                     policy):
    """The sharded step's forward gathers a DTensor layer's leaves inside
    that layer's body, never a whole stack; under remat the backward
    gathers them again.  Loss and gradients equal one process's on the
    plain trees."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.sharding.partition import (ShardingPolicy,
                                                params_shardings)
    cfg = dataclasses.replace(T_DENSE, remat_policy=policy)
    q = TQ()
    teacher = init_model(0, cfg, None, device="cpu")
    student = init_model(1, cfg, q, device="cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 8)))}
    mesh = make_elastic_mesh(1, 1, device_type="cpu")
    pol = ShardingPolicy()

    def placed(tree):
        return lt.place(tree, params_shardings(tree, cfg, mesh, pol), mesh)
    st, tt = placed(student), placed(teacher)
    for _, leaf in tree_items(st):
        leaf.requires_grad_(True)
    shapes = []
    full_tensor = DTensor.full_tensor

    def recorded(self, *a, **kw):
        shapes.append(tuple(self.shape))
        return full_tensor(self, *a, **kw)
    monkeypatch.setattr(DTensor, "full_tensor", recorded)
    loss, grads = lt.sharded_value_and_grad(cfg, q, mesh, pol)(st, tt, batch)
    monkeypatch.undo()

    def top(tree):     # the leaves gathered once a forward (no head)
        return [t for p, t in tree_items(tree) if p[0] not in (
            "layers", "lm_head", "head_stream")]
    L = cfg.n_layers
    n_s = len(list(tree_items(student["layers"])))
    n_t = len(list(tree_items(teacher["layers"])))
    stacks = {tuple(t.shape) for tree in (student, teacher)
              for _, t in tree_items(tree["layers"])}
    assert not stacks & set(shapes)
    passes = 2 if policy == "full" else 1
    # and one for the loss's sum over the ranks
    assert len(shapes) == (len(top(student)) + passes * L * n_s
                           + len(top(teacher)) + L * n_t + 1)
    want_loss, want = make_value_and_grad(cfg, q)(student, teacher, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * float(want_loss)
    got = dict(tree_items(grads))
    for path, g in tree_items(want):
        if g is None:
            assert got[path] is None, path
            continue
        err = float((got[path].full_tensor() - g).norm())
        assert err <= 1e-5 * max(float(g.norm()), 1e-6), (path, err)


def test_elastic_gives_up_after_max_restarts_and_spares_kernel_faults(
        tmp_path, one_rank):
    """Past ``max_restarts`` the failure propagates; a plain RuntimeError
    (a kernel fault) is never caught."""
    def failing(exc):
        def build_step(mesh):
            def step(state, batch):
                raise exc
            return step
        return build_step

    data = CalibDataset(CalibConfig(n_samples=16, seq_len=4, batch_size=4,
                                    vocab=16))
    cfg = t_elastic.ElasticConfig(max_restarts=1, model_parallel=1)
    r = t_elastic.ElasticRunner(failing(t_elastic.StepFailure("lost")),
                                CheckpointManager(str(tmp_path / "a")), cfg,
                                device_type="cpu")
    with pytest.raises(t_elastic.StepFailure):
        r.run({"x": torch.zeros(())}, data, steps=3)
    assert r.restarts == 2
    r = t_elastic.ElasticRunner(failing(RuntimeError("cudaError 700")),
                                CheckpointManager(str(tmp_path / "b")), cfg,
                                device_type="cpu")
    with pytest.raises(RuntimeError, match="cudaError"):
        r.run({"x": torch.zeros(())}, data, steps=3)
    assert r.restarts == 0


def _smoke_qft(tmp_path, inject):
    """SMOKE qwen3-8b QFT through the launcher's sharded step on a one-rank
    mesh, 5 steps, checkpoints every 2, optionally a failure at step 3."""
    from repro_torch.launch import train as lt
    from repro_torch.pipeline.adapters import resolve_quant_plan
    from repro_torch.train.qft_trainer import QFTConfig, QFTTrainer
    cfg, q = T_DENSE, TQ()
    teacher = init_model(0, cfg, None, device="cpu")
    data = CalibDataset(CalibConfig(n_samples=64, seq_len=16, batch_size=4,
                                    vocab=cfg.vocab))
    plan = resolve_quant_plan(cfg, q)
    tr = QFTTrainer(cfg, q, teacher, QFTConfig(), steps_per_epoch=8,
                    plan=plan)
    student = tr.prepare_student(1, [next(data)])
    data.skip_to(0)
    pol = t_part.ShardingPolicy()
    from repro_torch.launch.mesh import make_elastic_mesh
    state = lt.init_sharded_state(student, tr.opt, cfg,
                                  make_elastic_mesh(1, 1, "cpu"), pol)
    runner = t_elastic.ElasticRunner(
        lambda m: lt.build_step(m, cfg, q, tr.opt, teacher, pol, plan=plan,
                                microbatches=2),
        CheckpointManager(str(tmp_path), keep=3),
        t_elastic.ElasticConfig(checkpoint_every=2, model_parallel=1),
        device_type="cpu")
    state, s = runner.run(state, data, steps=5, inject_failure_at=inject)
    assert s == 5 and runner.restarts == (inject is not None)
    return state


def test_smoke_qft_restore_is_bit_equal_to_the_run_without_failure(
        tmp_path, one_rank):
    """A failure at step 3 restores the checkpoint of step 2 (student, Adam
    moments and step) and replays steps 2-4 on the same batches: every
    leaf of the state ends equal to the uninterrupted run's."""
    a = _smoke_qft(tmp_path / "a", None)
    b = _smoke_qft(tmp_path / "b", 3)
    assert sorted(os.listdir(tmp_path / "b")) == ["step_0000000002",
                                                  "step_0000000004"]
    for (p, x), (_, y) in zip(tree_items(a), tree_items(b)):
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        y = y.full_tensor() if hasattr(y, "full_tensor") else y
        assert torch.equal(x, y), p


# ---------------------------------------------------------------- launcher


def _launch(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_launcher_smoke_runs_on_the_cpu(tmp_path):
    r = _launch("--arch", "qwen3-8b", "--smoke", "--steps", "2",
                "--device", "cpu", "--ckpt-dir", str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "smoke done: loss" in r.stdout


def test_launcher_production_mesh_refuses_one_rank(tmp_path):
    """The sharded path needs the 256 ranks of the 16 × 16 mesh."""
    r = _launch("--arch", "qwen3-8b", "--device", "cpu", "--ckpt-dir",
                str(tmp_path), "--init-method",
                f"tcp://localhost:{_free_port()}")
    assert r.returncode != 0
    assert "needs exactly 256 ranks" in r.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_new_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """The meshes and the launcher run on the card unless asked for the
    CPU, and raise where there is none."""
    from repro_torch.launch import mesh, train
    for make in (mesh.make_host_mesh, lambda: mesh.make_elastic_mesh(1, 1),
                 mesh.make_production_mesh):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen3-8b", "--ckpt-dir", str(tmp_path)])


def test_moe_runtime_hooks(monkeypatch):
    """``set_runtime(moe_fn=)`` replaces the routed experts (None falls back
    to the in-graph path, as a decode step does), as the JAX package's
    hook does; ``moe_sorted(expert_fn=)`` (the expert-parallel path's)
    replaces the expert FFN over the dispatch buffer."""
    from repro.configs.qwen2_moe_a2_7b import SMOKE as J_MOE
    from repro.models import transformer as j_tf
    from repro_torch.configs.qwen2_moe_a2_7b import SMOKE as T_MOE
    params = j_init_model(jax.random.PRNGKey(0), J_MOE, None)
    tokens = np.random.default_rng(1).integers(0, J_MOE.vocab, (2, 8))

    def hidden(fwd, p, cfg, **kw):
        return np.asarray(fwd(p, cfg, None, {"tokens": tokens}, **kw)
                          ["hidden"], np.float32)
    tparams = from_numpy_tree(jax.device_get(params), "cpu")
    tt = {"tokens": torch.from_numpy(tokens)}

    def port(**rt):
        t_tf.set_runtime(**rt)
        try:
            return t_tf.forward(tparams, T_MOE, None, tt,
                                compute_dtype=torch.float32)["hidden"]
        finally:
            t_tf.set_runtime(moe_fn=None)
    base = port()
    assert torch.equal(port(moe_fn=lambda x, p, use_kernels: None), base)
    zero = port(moe_fn=lambda x, p, use_kernels: torch.zeros_like(x))
    assert not torch.equal(zero, base)
    lp = t_tf.layer_slice(tparams["layers"], 0)["mlp"]
    xt = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (16, T_MOE.d_model), np.float32))
    assert not torch.equal(t_moe.moe_sorted(xt, lp, T_MOE, None),
                           torch.zeros_like(xt))
    assert torch.equal(t_moe.moe_sorted(
        xt, lp, T_MOE, None, expert_fn=lambda h: torch.zeros_like(h)),
        torch.zeros_like(xt))
    # the JAX package's hooks give the same three forwards
    jbase = hidden(j_forward, params, J_MOE, compute_dtype=jnp.float32)
    j_tf.set_runtime(moe_fn=lambda x, p: jnp.zeros_like(x))
    try:
        jzero = hidden(j_forward, params, J_MOE, compute_dtype=jnp.float32)
    finally:
        j_tf.set_runtime(moe_fn=None)
    np.testing.assert_allclose(base.numpy(), jbase, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(zero.numpy(), jzero, rtol=1e-5, atol=1e-5)
