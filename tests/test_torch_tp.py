"""Tensor parallelism over ``model`` in the sharded QFT step
(``repro_torch.sharding.tp``), on the CPU over spawned ``gloo`` ranks at
SMOKE qwen3-8b width (2 layers, d 64, 4 query and 2 KV heads):

- at data 1 × model 2, 1 × 4 (each KV head's columns on 2 ranks: the
  KV-group gather) and 2 × 2, the sharded step's loss, every gradient leaf
  and every updated parameter against the JAX package's
  ``make_train_step`` on the same converted student, teacher and batch:
  in f32 compute, 1e-6 on the loss and 1e-5 relative L2 on each gradient
  leaf and updated parameter; in bf16 compute (the default), the step's
  distance from the f32 step at most twice the unsharded bf16 step's own
  distance from it, on the loss and on each gradient leaf, held both
  against the port's unsharded steps and against the JAX package's
  (tests/test_torch_dist.py holds the f32 step against the port's
  unsharded step, with the int8 compressor);
- the vocabulary-parallel embedding alone, forward bits and gradients;
- a ``make_fx`` trace of the step over fake ranks that gathers no dense
  layer's weight over ``model``: its all-gathers are over ``data`` or a
  KV group, and *f*/*g* are all-reduces over ``model``;
- a group-wise S_wR whose groups do not fall whole onto the row-parallel
  shards is refused.

The ranks run while the test process computes the references.
"""
import copy
import functools
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
mp = pytest.importorskip("torch.multiprocessing")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.qwen3_8b import SMOKE as J_DENSE  # noqa: E402
from repro.core.plan import resolve_plan as j_resolve_plan  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.optim import adam as j_adam  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402
from repro_torch.configs.qwen3_8b import SMOKE as DENSE  # noqa: E402
from repro_torch.core import dof  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.data.calib import CalibConfig, CalibDataset  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120
#: (world, model) of each mesh
MESHES = {"model2": (2, 2), "model4": (4, 4), "data2xmodel2": (4, 2)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


#: row blocks of the batch every step sees: a rank of a 1-row-group mesh
#: splits its rows into this many microbatches, a rank of data 2 takes one
ROW_BLOCKS = 2


@functools.lru_cache(maxsize=None)
def _setup():
    """SMOKE qwen3-8b: the FP teacher, the prepared student, a batch
    (shared: callers copy what they update)."""
    from repro_torch.pipeline.adapters import resolve_quant_plan
    from repro_torch.train.qft_trainer import QFTConfig, QFTTrainer
    q = QuantConfig()
    teacher = init_model(0, DENSE, None, device="cpu")
    data = CalibDataset(CalibConfig(n_samples=64, seq_len=16, batch_size=8,
                                    vocab=DENSE.vocab))
    plan = resolve_quant_plan(DENSE, q)
    tr = QFTTrainer(DENSE, q, teacher, QFTConfig(), steps_per_epoch=8,
                    plan=plan)
    student = tr.prepare_student(1, [next(data)])
    batch = {k: torch.as_tensor(v) for k, v in next(data).items()}
    return q, plan, tr, teacher, student, batch


def _embed_case():
    """A student embedding (with its per-row log_s), tokens over the whole
    vocabulary and an output cotangent, from seeds."""
    g = np.random.default_rng(5)
    V, d = DENSE.vocab, DENSE.d_model
    p = {"w": torch.from_numpy(g.normal(size=(V, d)).astype(np.float32)
                               * 0.02),
         "log_s": torch.from_numpy(
             np.log(g.uniform(1e-4, 4e-4, size=(V, 1))).astype(np.float32))}
    tokens = torch.from_numpy(g.integers(0, V, size=(3, 7)))
    cot = torch.from_numpy(g.normal(size=(3, 7, d)).astype(np.float32))
    return p, tokens, cot


def _full(grads) -> dict:
    return {".".join(p): None if g is None else g.full_tensor().detach()
            for p, g in tree_items(grads)}


def _rank(rank, world, port, model, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models.layers import embed_lookup
    from repro_torch.sharding import tp
    from repro_torch.sharding.partition import (ShardingPolicy,
                                                params_shardings)
    from repro_torch.train import steps
    q, plan, tr, teacher, student, batch = _setup()
    mesh = make_elastic_mesh(world, model, device_type="cpu")
    pol = ShardingPolicy()
    mb = ROW_BLOCKS * model // world

    def at(dtype):
        # the sharded step's forward at ``dtype`` (this process's copy)
        lt.make_value_and_grad = functools.partial(
            steps.make_value_and_grad, compute_dtype=dtype)
    st, ost = lt.init_sharded_state(student, tr.opt, DENSE, mesh, pol)
    tt = lt.place(teacher, params_shardings(teacher, DENSE, mesh, pol), mesh)
    # bf16: the loss and the gradients; f32: one step, its gradients
    # captured on their way to the update
    at(torch.bfloat16)
    loss, grads = lt.sharded_value_and_grad(
        DENSE, q, mesh, pol, microbatches=mb, plan=plan)(st, tt, batch)
    res = {"bf16": {"loss": loss, "grads": _full(grads)}}
    seen = {}

    def capture(g, opt_state):
        seen["grads"] = _full(g)
        return g, opt_state

    at(torch.float32)
    step = lt.build_step(mesh, DENSE, q, tr.opt, teacher, pol, plan=plan,
                         microbatches=mb, grad_compress=capture)
    (st, _), m = step((st, ost), batch)
    res["f32"] = {"loss": m["loss"], "grads": seen["grads"],
                  "new": {".".join(p): t.full_tensor().detach()
                          for p, t in tree_items(st)}}
    # the vocabulary-parallel embedding alone, on a 1-D model mesh
    p, tokens, cot = _embed_case()
    emesh = make_elastic_mesh(world, world, device_type="cpu")
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dp = {"w": distribute_tensor(p["w"], emesh, (Replicate(), Shard(0))),
          "log_s": distribute_tensor(p["log_s"], emesh,
                                     (Replicate(), Replicate()))}
    for t in dp.values():
        t.requires_grad_(True)
    local, g = tp.embed_view(dp)
    y = embed_lookup(tokens, local, q, torch.float32, tp=g)
    gw, gs = torch.autograd.grad((y * cot).sum(), [dp["w"], dp["log_s"]])
    res["embed"] = {"y": y.detach(), "w": gw.full_tensor(),
                    "log_s": gs.full_tensor(), "rows": local["w"].shape[0]}
    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()


def _start(world, model, out):
    return mp.start_processes(_rank, args=(world, _free_port(), model, out),
                              nprocs=world, join=False,
                              start_method="spawn")


def _join(ctx, world):
    deadline = time.time() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every mesh's ranks started at once; their results once the
    references below are computed."""
    d = tmp_path_factory.mktemp("tp")
    ctxs = {k: (_start(w, m, str(d / f"{k}.pt")), w)
            for k, (w, m) in MESHES.items()}

    def results(name):
        ctx, world = ctxs[name]
        if ctx is not None:
            _join(ctx, world)
            ctxs[name] = (None, world)
        return torch.load(d / f"{name}.pt")

    yield results
    for ctx, _ in ctxs.values():
        if ctx is not None:
            for p in ctx.processes:
                p.kill()


# ------------------------------------------------------------- references

@functools.lru_cache(maxsize=None)
def _port_ref(dtype_name: str):
    """The port's unsharded step over the row blocks the sharded steps
    see: bf16 its value_and_grad, f32 its train step (the gradients
    captured on their way to the update)."""
    from repro_torch.train.steps import make_train_step, make_value_and_grad
    q, plan, tr, teacher, student, batch = _setup()
    kw = dict(microbatches=ROW_BLOCKS, plan=plan,
              compute_dtype=DTYPES[dtype_name])
    s = copy.deepcopy(student)
    if dtype_name == "bf16":
        loss, grads = make_value_and_grad(DENSE, q, **kw)(s, teacher, batch)
        return {"loss": loss, "grads": {".".join(p): g
                                        for p, g in tree_items(grads)}}
    seen = {}

    def capture(g, opt_state):
        seen["grads"] = {".".join(p): g for p, g in tree_items(g)}
        return g, opt_state

    s, _, m = make_train_step(DENSE, q, tr.opt, grad_compress=capture,
                              **kw)(s, tr.opt.init(s), teacher, batch)
    return {"loss": m["loss"], "grads": seen["grads"],
            "new": {".".join(p): t.detach() for p, t in tree_items(s)}}


def _jnp_tree(tree):
    if isinstance(tree, dict):
        return {k: _jnp_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy())


def _torch_leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_torch_leaves(v, prefix + (k,)))
        else:
            out[".".join(prefix + (k,))] = torch.from_numpy(
                np.array(v, dtype=np.float32, copy=True))
    return out


@functools.lru_cache(maxsize=None)
def _jax_ref(dtype_name: str):
    """The JAX package's make_train_step on the converted student, teacher
    and batch, its gradients captured through the grad_compress hook; its
    forward at ``dtype_name`` (the JAX step's own default is bf16)."""
    _, plan_t, tr, teacher, student, batch = _setup()
    js, jt = _jnp_tree(student), _jnp_tree(teacher)
    jq = JQ()
    captured = {}

    def capture(grads, opt_state):
        captured["g"] = grads
        return grads, opt_state

    opt = j_adam.paper_recipe(8)
    plan = j_resolve_plan(jq, js, model_cfg=J_DENSE)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(j_steps, "forward", functools.partial(
            j_forward, compute_dtype=jnp.float32 if dtype_name == "f32"
            else jnp.bfloat16))
        step = j_steps.make_train_step(J_DENSE, jq, opt,
                                       grad_compress=capture,
                                       microbatches=ROW_BLOCKS, plan=plan)

        def run(*args):
            new, _, metrics = step(*args)
            return new, metrics, captured["g"]

        new, metrics, grads = jax.jit(run)(
            js, opt.init(js), jt, {"tokens": jnp.asarray(
                batch["tokens"].numpy())})
    return {"loss": torch.tensor(float(metrics["loss"])),
            "grads": _torch_leaves(jax.device_get(grads)),
            "new": _torch_leaves(jax.device_get(new))}


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm()) / max(
        float(b.double().norm()), 1e-30)


def _check(got, f32, bf16, what, zero=()):
    """``got[dtype]`` against a reference's f32 and bf16 results.  The
    leaves in ``zero`` have an exact zero gradient in the port (the
    zero-points where nothing clips); the JAX package sums the two paths
    apart and leaves rounding noise there, held to 1e-6 of the whole
    gradient's norm, as tests/test_torch_train.py's floor does."""
    total = float(sum(float(g.double().norm()) ** 2
                      for k, g in f32["grads"].items()
                      if g is not None)) ** 0.5
    g32, gb = got["f32"], got["bf16"]
    lr = float(f32["loss"])
    assert abs(float(g32["loss"]) - lr) <= 1e-6 * abs(lr), (what, "loss")
    d_tp = abs(float(gb["loss"]) - lr)
    d_ref = abs(float(bf16["loss"]) - lr)
    assert d_tp <= 2 * d_ref, (what, "bf16 loss", d_tp, d_ref)
    for k, ref in f32["grads"].items():
        if k.startswith(("lm_head", "head_stream")):
            assert g32["grads"][k] is None and gb["grads"][k] is None, k
            continue
        ref = ref.double()
        if k in zero:
            assert not g32["grads"][k].any(), (what, k)
            assert float(ref.norm()) <= 1e-6 * total, (what, k)
            continue
        scale = float(ref.norm())
        e32 = float((g32["grads"][k].double() - ref).norm())
        assert e32 <= 1e-5 * scale, (what, k, e32 / scale)
        e_tp = float((gb["grads"][k].double() - ref).norm())
        e_ref = float((bf16["grads"][k].double() - ref).norm())
        assert e_tp <= 2 * e_ref, (what, k, "bf16", e_tp, e_ref)
    for k, ref in f32["new"].items():
        err = _rel_l2(g32["new"][k], ref)
        assert err <= 1e-5, (what, k, "updated", err)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_step_matches_unsharded_and_jax(mesh, ranks):
    port = {n: _port_ref(n) for n in DTYPES}
    jx = {n: _jax_ref(n) for n in DTYPES}
    got = ranks(mesh)
    _check(got, port["f32"], port["bf16"], f"{mesh} vs the port")
    zero = {k for k, g in port["f32"]["grads"].items()
            if g is not None and not g.any()}
    assert zero <= {k for k in zero if k.endswith(".zp")}, zero
    _check(got, jx["f32"], jx["bf16"], f"{mesh} vs JAX", zero)


@pytest.mark.parametrize("mesh", ["model2", "model4"])
def test_vocab_parallel_embedding(mesh, ranks):
    """Each rank's rows, the others masked, summed over ``model``: the
    bits of the whole table's lookup, and its gradients."""
    from repro_torch.models.layers import embed_lookup
    world, _ = MESHES[mesh]
    got = ranks(mesh)["embed"]
    assert got["rows"] == DENSE.vocab // world
    p, tokens, cot = _embed_case()
    for t in p.values():
        t.requires_grad_(True)
    y = embed_lookup(tokens, p, QuantConfig(), torch.float32)
    gw, gs = torch.autograd.grad((y * cot).sum(), [p["w"], p["log_s"]])
    assert torch.equal(got["y"], y.detach())
    torch.testing.assert_close(got["w"], gw, rtol=1e-6, atol=0)
    torch.testing.assert_close(got["log_s"], gs, rtol=1e-5, atol=1e-9)


# ------------------------------------------------------------------ trace

_TRACE = r"""
import json, collections
import torch
from repro_torch.configs.qwen3_8b import SMOKE
from repro_torch.core.qconfig import QuantConfig
from repro_torch.analysis.graph_checks import trace, op_name
from repro_torch.launch.dryrun import init_fake_world
from repro_torch.launch.hlo_analysis import _group_size
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.launch.train import build_step
from repro_torch.models import init_model
from repro_torch.optim.adam import Adam
from repro_torch.sharding.partition import ShardingPolicy
from repro_torch.core.plan import resolve_plan
from torch.distributed.distributed_c10d import _resolve_process_group
init_fake_world(8)
mesh = make_elastic_mesh(8, 4, device_type="cpu")
q = QuantConfig()
student = init_model(0, SMOKE, q, device="meta")
teacher = init_model(0, SMOKE, None, device="meta")
opt = Adam(lr=1e-4)
step = build_step(mesh, SMOKE, q, opt, teacher, ShardingPolicy(),
                  plan=resolve_plan(q, student, model_cfg=SMOKE),
                  device="meta")
batch = {"tokens": torch.empty((8, 16), dtype=torch.int32, device="meta")}
tr = trace(lambda st, b: step(st, b), (student, opt.init(student)), batch)
names = {mesh.get_group(a).group_name: a for a in ("data", "model")}
seen = collections.Counter()
for n in tr.nodes():
    if getattr(n.target, "namespace", "") != "_c10d_functional":
        continue
    kind = op_name(n)
    if kind == "wait_tensor":
        continue
    g = [a for a in n.args if isinstance(a, str)][-1]
    axis = names.get(g) or f"size{_resolve_process_group(g).size()}"
    seen[f"{kind}/{axis}"] += 1
    # the dry-run's ring factors read the group's size off the node
    seen[f"group_size/{axis}/{_group_size(n, 8)}"] += 1
print(json.dumps(seen))
"""


def test_trace_gathers_no_dense_weight_over_model():
    """data 2 × model 4 over 8 fake ranks: every all-gather is over
    ``data`` (FSDP, a layer's shard) or a 2-rank KV group (SMOKE's 2 KV
    heads over 4 ranks); ``model`` carries all-reduces (*f*, *g*, the
    replicated leaves' partial gradients) and no gather; the dry-run's
    accounting reads each collective's group size off its node."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _TRACE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    seen = json.loads(r.stdout.strip().splitlines()[-1])
    gathers = {k for k in seen if k.startswith("all_gather")}
    assert gathers <= {"all_gather_into_tensor/data",
                       "all_gather_into_tensor/size2"}, seen
    assert seen.get("all_gather_into_tensor/size2", 0) > 0, seen
    assert seen.get("all_reduce/model", 0) > 0, seen
    assert not any(k.endswith("/model") and not k.startswith("all_reduce")
                   for k in seen), seen
    sizes = {k for k in seen if k.startswith("group_size/")}
    assert sizes <= {"group_size/data/2", "group_size/model/4",
                     "group_size/size2/2"}, sizes


def test_row_parallel_group_shape_is_refused():
    """``group:32`` on a 128-row ``down`` over 8 shards: 16 rows a rank,
    half a group; over 4 shards, 32 rows, one whole group."""
    p = {"w": torch.zeros(16, 64),
         "log_swr": torch.arange(4 * 64, dtype=torch.float32).reshape(4,
                                                                      64)}
    with pytest.raises(ValueError, match="whole groups"):
        dof.shard_qlinear(p, "row", 1, 8)
    p = {"w": torch.zeros(32, 64), "log_swr": p["log_swr"]}
    out = dof.shard_qlinear(p, "row", 2, 4)
    assert torch.equal(out["log_swr"], p["log_swr"][2:3])
    cols = dof.shard_qlinear({"w": torch.zeros(128, 16),
                              "log_swr": p["log_swr"], "b": torch.arange(
                                  64.)}, "col", 3, 4)
    assert torch.equal(cols["log_swr"], p["log_swr"][:, 48:64])
    assert torch.equal(cols["b"], torch.arange(48., 64.))
