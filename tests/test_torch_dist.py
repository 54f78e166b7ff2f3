"""repro_torch's sharded training over several ``gloo`` processes on the CPU,
held against one process:

- the launcher's sharded step (``launch.train``) at 2 ranks (data 2), 4
  ranks (data 2 × model 2), and the tensor-parallel meshes model 2 and
  model 4 (SMOKE's 2 KV heads over 4 ranks: each head's columns on 2
  ranks): the student, the teacher and Adam's moments stored as
  DTensors, the batch split over ``data``, the dense layers computed on
  the ``model`` shards (``sharding.tp``); its loss and every gradient
  leaf against one process's ``make_value_and_grad`` over the same batch
  in as many row groups (so the forward sees the same row blocks), then
  one step of the sharded ``build_step`` — with the int8 error-feedback
  compressor — against one process's train step with the same hook.
  Where ``model`` computes, both sides run in f32: a bf16 product summed
  over shards rounds elsewhere than the whole one (tests/test_torch_tp.py
  holds the bf16 step);
- the expert-parallel MoE (``sharding.ep``) on 2 ranks against
  ``models.moe.moe_sorted`` with no token dropped, forward and backward.

Each case spawns its ranks on a free localhost port with a time limit;
they write their results to files the test compares.
"""
import copy
import dataclasses
import functools
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
mp = pytest.importorskip("torch.multiprocessing")

from repro_torch.configs.qwen2_moe_a2_7b import SMOKE as MOE  # noqa: E402
from repro_torch.configs.qwen3_8b import SMOKE as DENSE  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.data.calib import CalibConfig, CalibDataset  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

SPAWN_TIMEOUT_S = 120
MICROBATCHES = 2


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(fn, world: int, *args):
    port = _free_port()
    ctx = mp.start_processes(fn, args=(world, port) + args, nprocs=world,
                             join=False, start_method="spawn")
    import time
    deadline = time.time() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")


def _setup():
    """SMOKE qwen3-8b: the FP teacher, the prepared student and a batch."""
    from repro_torch.train.qft_trainer import QFTConfig, QFTTrainer
    from repro_torch.pipeline.adapters import resolve_quant_plan
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


def _sharded_rank(rank, world, port, model, dtype, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.sharding.partition import (ShardingPolicy,
                                                params_shardings)
    from repro_torch.train.compression import error_feedback_hook
    from repro_torch.train import steps
    # the sharded step's forward at ``dtype`` (this process's copy)
    lt.make_value_and_grad = functools.partial(steps.make_value_and_grad,
                                               compute_dtype=dtype)
    q, plan, tr, teacher, student, batch = _setup()
    mesh = make_elastic_mesh(world, model, device_type="cpu")
    pol = ShardingPolicy()
    st, ost = lt.init_sharded_state(student, tr.opt, DENSE, mesh, pol)
    vg = lt.sharded_value_and_grad(DENSE, q, mesh, pol,
                                   microbatches=MICROBATCHES, plan=plan)
    tt = lt.place(teacher, params_shardings(teacher, DENSE, mesh, pol), mesh)
    loss, grads = vg(st, tt, batch)
    grads = {".".join(p): None if g is None else g.full_tensor()
             for p, g in tree_items(grads)}
    step = lt.build_step(mesh, DENSE, q, tr.opt, teacher, pol, plan=plan,
                         microbatches=MICROBATCHES,
                         grad_compress=error_feedback_hook(st))
    (st, ost), m = step((st, ost), batch)
    new = {".".join(p): t.full_tensor() for p, t in tree_items(st)}
    if rank == 0:
        torch.save({"loss": loss, "grads": grads, "new": new,
                    "step_loss": m["loss"], "placements": {
                        ".".join(p): str(t.placements)
                        for p, t in tree_items(st)}}, out)
    dist.destroy_process_group()


@pytest.mark.parametrize("world,model", [(2, 1), (4, 2), (2, 2), (4, 4)],
                         ids=["data2", "data2xmodel2", "model2", "model4"])
def test_sharded_step_equals_one_process(world, model, tmp_path):
    from repro_torch.train.compression import error_feedback_hook
    from repro_torch.train.steps import make_train_step, make_value_and_grad
    out = str(tmp_path / "rank0.pt")
    dtype = torch.bfloat16 if model == 1 else torch.float32
    _spawn(_sharded_rank, world, model, dtype, out)
    got = torch.load(out)
    q, plan, tr, teacher, student, batch = _setup()
    dp = world // model
    vg = make_value_and_grad(DENSE, q, microbatches=MICROBATCHES * dp,
                             plan=plan, compute_dtype=dtype)
    loss, grads = vg(copy.deepcopy(student), teacher, batch)
    assert abs(float(got["loss"]) - float(loss)) <= 1e-6 * float(loss)
    for path, g in tree_items(grads):
        k = ".".join(path)
        if g is None:
            assert got["grads"][k] is None, k
            continue
        err = float((got["grads"][k] - g).norm())
        assert err <= 1e-5 * max(float(g.norm()), 1e-6), (k, err)
    # the data axis shards weights (FSDP): a [d, H·hd] wq over data 2
    assert "Shard" in got["placements"]["layers.attn.wq.w"]
    s = copy.deepcopy(student)
    step = make_train_step(DENSE, q, tr.opt, grad_compress=error_feedback_hook(
        s), microbatches=MICROBATCHES * dp, plan=plan, compute_dtype=dtype)
    s, _, m = step(s, tr.opt.init(s), teacher, batch)
    assert abs(float(got["step_loss"]) - float(m["loss"])) \
        <= 1e-6 * float(m["loss"])
    for path, t in tree_items(s):
        k = ".".join(path)
        err = float((got["new"][k].detach() - t.detach()).abs().max())
        assert err <= 1e-6 * max(float(t.detach().abs().max()), 1.0), (k, err)


# ---------------------------------------------------------------------- EP

MOE_CFG = dataclasses.replace(MOE, moe=dataclasses.replace(
    MOE.moe, capacity_factor=float(MOE.moe.n_experts)))


def _moe_inputs():
    """A student MoE layer of SMOKE qwen2-moe (its layer slice), an input
    and an output cotangent, from seeds."""
    from repro_torch.models.transformer import layer_slice
    params = init_model(3, MOE_CFG, QuantConfig(), device="cpu")
    p = layer_slice(params["layers"]["mlp"], 0)
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.normal(size=(2, 8, MOE_CFG.d_model))
                         .astype(np.float32))
    c = torch.from_numpy(g.normal(size=(2, 8, MOE_CFG.d_model))
                         .astype(np.float32))
    return p, x, c


def _ep_rank(rank, world, port, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.sharding.ep import make_ep_moe
    p, x, c = _moe_inputs()
    leaves = [t.requires_grad_() for _, t in tree_items(p)]
    x.requires_grad_()
    mesh = make_elastic_mesh(world, world, device_type="cpu")
    fn = make_ep_moe(mesh, MOE_CFG, QuantConfig())
    y = fn(x, p)
    # the partial-sum convention of the sharded step: loss / ranks, every
    # rank's parameter gradient summed
    g = torch.autograd.grad((y * c).sum() / world, leaves + [x],
                            allow_unused=True)
    summed = []
    for t, leaf in zip(g[:-1], leaves):
        t = torch.zeros_like(leaf) if t is None else t.clone()
        dist.all_reduce(t)
        summed.append(t)
    assert fn(x[:, :1], p) is None           # a decode step: the baseline
    if rank == 0:
        torch.save({"y": y.detach(), "grads": summed,
                    "x_grad": g[-1] * world}, out)
    dist.destroy_process_group()


def test_ep_moe_on_two_ranks_equals_moe_sorted(tmp_path):
    from repro_torch.models.moe import moe_sorted
    out = str(tmp_path / "ep.pt")
    _spawn(_ep_rank, 2, out)
    got = torch.load(out)
    p, x, c = _moe_inputs()
    leaves = [t.requires_grad_() for _, t in tree_items(p)]
    x.requires_grad_()
    B, S, d = x.shape
    y = moe_sorted(x.reshape(B * S, d), p, MOE_CFG,
                   QuantConfig()).reshape(B, S, d)
    g = torch.autograd.grad((y * c).sum(), leaves + [x], allow_unused=True)
    torch.testing.assert_close(got["y"], y.detach(), rtol=1e-5, atol=1e-6)
    for (path, _), a, b in zip(tree_items(p), got["grads"], g[:-1]):
        b = torch.zeros_like(a) if b is None else b
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{path}: {m}")
    torch.testing.assert_close(got["x_grad"], g[-1], rtol=1e-5, atol=1e-6)
