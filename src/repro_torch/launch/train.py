"""Production QFT training launcher (the JAX package's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --steps 6000 --ckpt-dir /ckpt/qwen3-8b-w4a8 [--smoke] \\
        [--device cpu] [--init-method tcp://host:port --world-size N --rank R]

``--smoke`` runs the staged pipeline (``python -m repro_torch quantize``'s
path) with the reduced config and the JAX launcher's knobs, per-stage
checkpoints under ``--ckpt-dir``.  Without it, the sharded QFT step
(teacher + student + Adam, stored as DTensors) runs on the production mesh
(16 × 16, or 2 × 16 × 16 with ``--multi-pod``: 256 or 512 ranks, one
process each) under the elastic runner (checkpoint/restart, straggler
timeout) over the seekable calibration pipeline, with the paper's recipe.

The sharded step (:func:`build_step`): every parameter of the student and
the teacher and Adam's ``m``/``v`` are DTensors placed by
``sharding.partition``'s specs (ZeRO-style storage over ``data`` and
``model``).  A step splits the batch over the ``dp`` axes and runs
``train.steps.make_value_and_grad`` on the rank's rows over the DTensor
trees: the forward (``models.transformer``) gathers each layer's leaves to
plain local tensors at the start of that layer's body, inside the remat
region, so the kernels never see a DTensor and, under remat, a rank holds
one layer's whole weights at a time beside its shards (the backward
gathers them again).  The embedding, the head and the final norms are
gathered for the whole forward.  The gathers' backward takes each
gradient as a partial sum over every mesh axis; scaled by ``1 / ranks``,
the gradients arrive summed onto the shards' placements, the gradient one
process computes over the whole batch.  Adam then updates each rank's
shards.  The ``model`` axis shards storage, not compute: every rank of a
model group runs the same forward.  A checkpoint is written whole by
every rank (``train.checkpoint``, one leaf gathered at a time).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..configs.registry import get_config
from ..core.qconfig import deployment_oriented, permissive
from ..data.calib import CalibConfig, CalibDataset
from ..models import init_model
from ..pipeline.adapters import resolve_quant_plan
from ..sharding.partition import (ShardingPolicy, axis_size, batch_shardings,
                                  opt_state_shardings, params_shardings,
                                  spec_at, to_placements)
from ..train.checkpoint import CheckpointManager
from ..train.elastic import ElasticConfig, ElasticRunner
from ..train.qft_trainer import QFTConfig, QFTTrainer
from ..train.steps import make_train_step, make_value_and_grad
from ..tree import tree_from_items, tree_items
from .mesh import make_production_mesh

def _dtensor():
    from torch.distributed import tensor
    return tensor


def place(tree, specs, mesh) -> Any:
    """Each leaf of ``tree`` as a DTensor on ``mesh`` with its spec's
    placements.  A DTensor already so placed is kept; any other (a plain
    tensor, or a DTensor on another mesh after a remesh or restore) is
    distributed from its whole value.  ``requires_grad`` carries over."""
    dt = _dtensor()
    out = []
    for path, leaf in tree_items(tree):
        want = to_placements(spec_at(specs, path), mesh)
        if isinstance(leaf, dt.DTensor):
            if leaf.device_mesh == mesh and tuple(leaf.placements) == want:
                out.append((path, leaf))
                continue
            leaf = leaf.full_tensor()
        with torch.no_grad():
            d = dt.distribute_tensor(leaf.detach(), mesh, want)
        out.append((path, d.requires_grad_(leaf.requires_grad)))
    return tree_from_items(out)


def local_rows(batch: dict, mesh, pol: ShardingPolicy) -> dict:
    """This rank's rows of each batch leaf: axis 0 split over the ``dp``
    axes of ``batch_shardings`` (pod-major), or all rows where they do not
    divide."""
    specs = batch_shardings(batch, mesh, pol)
    out = {}
    for k, v in batch.items():
        axes = specs[k][0]
        if axes is None:
            out[k] = v
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        idx, n = 0, 1
        for a in axes:
            size = axis_size(mesh, a)
            idx = idx * size + mesh.get_local_rank(a)
            n *= size
        rows = v.shape[0] // n
        out[k] = v[idx * rows:(idx + 1) * rows]
    return out


def _mesh_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of a 0-dim tensor over every rank of ``mesh``."""
    dt = _dtensor()
    return dt.DTensor.from_local(
        x.reshape(1), mesh, (dt.Partial(),) * mesh.ndim).full_tensor()[0]


def sharded_value_and_grad(cfg, qcfg, mesh, pol: ShardingPolicy,
                           microbatches: int = 1, plan=None) -> Callable:
    """``value_and_grad(student, teacher, batch) -> (loss, grads)`` over
    DTensor trees: ``loss`` the whole batch's, ``grads`` DTensors on the
    student's placements (None where no gradient reaches)."""
    local = make_value_and_grad(cfg, qcfg, microbatches=microbatches,
                                plan=plan)
    n = mesh.size()

    def value_and_grad(student, teacher, batch):
        loss, grads = local(student, teacher, local_rows(batch, mesh, pol))
        grads = tree_from_items((p, None if g is None else g / n)
                                for p, g in tree_items(grads))
        return _mesh_sum(loss.to(torch.float32) / n, mesh), grads

    return value_and_grad


class _ShardAdam:
    """``opt``'s update applied to each rank's shards (the local tensors
    of the DTensor parameters, gradients and moments, in place)."""

    def __init__(self, opt):
        if opt.grad_clip is not None:
            raise ValueError("the sharded step takes no grad_clip: its "
                             "norm would be the rank's shards'")
        self.opt = opt

    def update(self, grads, state, params):
        def loc(tree):
            return tree_from_items(
                (p, None if t is None else t.to_local())
                for p, t in tree_items(tree))
        with torch.no_grad():
            self.opt.update(loc(grads), {**state, "m": loc(state["m"]),
                                         "v": loc(state["v"])}, loc(params))
        return params, {"m": state["m"], "v": state["v"],
                        "step": state["step"] + 1}


def place_state(state, cfg, mesh, pol: ShardingPolicy) -> tuple:
    """``(student, opt_state)`` as DTensors on ``mesh`` (see
    :func:`place`), Adam's ``m``/``v`` on the student's placements; the
    student's leaves require a gradient."""
    student, opt_state = state
    specs = params_shardings(student, cfg, mesh, pol)
    o_specs = opt_state_shardings(specs, mesh)
    student = place(student, specs, mesh)
    for _, leaf in tree_items(student):
        leaf.requires_grad_(True)
    return student, {"m": place(opt_state["m"], o_specs["m"], mesh),
                     "v": place(opt_state["v"], o_specs["v"], mesh),
                     "step": torch.as_tensor(opt_state["step"])}


def init_sharded_state(student, opt, cfg, mesh, pol: ShardingPolicy):
    """The sharded step's first state: ``student`` and Adam's zeros."""
    return place_state((student, opt.init(student)), cfg, mesh, pol)


def build_step(mesh, cfg, qcfg, opt, teacher,
               pol: ShardingPolicy = ShardingPolicy(), plan=None,
               microbatches: int = 1, grad_compress=None,
               device=None) -> Callable:
    """``step(state, batch) -> (state, metrics)`` for ``mesh``: the
    sharded QFT step, ``state = (student, opt_state)``.  The state and the
    teacher are (re)placed on ``mesh`` first, so the same call serves the
    launcher's first mesh and an elastic remesh.  ``batch`` is the whole
    batch (numpy or tensors); each rank takes its rows, on ``device``
    (``None``: the mesh's device type; the dry-run's shape-only state lies
    on the meta device)."""
    dev = torch.device(mesh.device_type if device is None else device)
    specs = params_shardings(teacher, cfg, mesh,
                             pol if pol.fsdp_teacher
                             else dataclasses.replace(pol, fsdp=None))
    teacher = place(teacher, specs, mesh)
    vg = sharded_value_and_grad(cfg, qcfg, mesh, pol,
                                microbatches=microbatches, plan=plan)
    raw = make_train_step(cfg, qcfg, _ShardAdam(opt),
                          grad_compress=grad_compress, value_and_grad=vg)

    def step(state, batch):
        student, opt_state = place_state(state, cfg, mesh, pol)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        student, opt_state, m = raw(student, opt_state, teacher, batch)
        gnorm = m["grad_norm"]
        if hasattr(gnorm, "full_tensor"):
            gnorm = gnorm.full_tensor()
        return (student, opt_state), {"loss": m["loss"], "grad_norm": gnorm}

    return step


def _init_dist(args, device: torch.device) -> None:
    if dist.is_initialized():
        return
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=args.init_method, world_size=args.world_size,
        rank=args.rank)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=6000)   # 12 epochs × 500
    ap.add_argument("--mode", choices=["w4a8", "w4chw"], default="w4a8")
    ap.add_argument("--cle", action="store_true")
    ap.add_argument("--ckpt-dir", default="qft_ckpt")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--init-method", default="tcp://localhost:29500",
                    help="torch.distributed rendezvous of the sharded path")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args(argv)

    if args.smoke:
        from ..pipeline import PipelineConfig, run_pipeline
        pcfg = PipelineConfig(
            arch=args.arch, mode=args.mode, smoke=True, cle=args.cle,
            steps=min(args.steps, 50), workdir=args.ckpt_dir,
            calib_samples=512, calib_seq_len=64, calib_batch_size=8,
            device=args.device or "cuda")
        result = run_pipeline(pcfg, log=lambda s: print(f"  {s}"))
        ft = result.metrics.get("finetune")
        if ft:
            print(f"smoke done: loss {ft['final_loss']:.4f}")
        return

    from ..device import resolve_device
    device = resolve_device(args.device)
    _init_dist(args, device)
    qcfg = deployment_oriented() if args.mode == "w4a8" else permissive()
    cfg = get_config(args.arch).with_padding(tp=16)
    mesh = make_production_mesh(multi_pod=args.multi_pod,
                                device_type=device.type)
    pol = ShardingPolicy(dp=("pod", "data") if args.multi_pod else ("data",))
    data = CalibDataset(CalibConfig(n_samples=8192, seq_len=512,
                                    batch_size=16, vocab=cfg.vocab))
    teacher = init_model(0, cfg, None, device=device)
    # one resolved plan for init + finetune forward + (later) export
    qplan = resolve_quant_plan(cfg, qcfg)
    trainer = QFTTrainer(cfg, qcfg, teacher, QFTConfig(cle_init=args.cle),
                         steps_per_epoch=data.steps_per_epoch, plan=qplan)
    calib = [next(iter(data)) for _ in range(4)]
    student = trainer.prepare_student(1, calib)
    ckpt_dir = args.ckpt_dir if args.world_size == 1 \
        else f"{args.ckpt_dir}/rank{args.rank}"
    ckpt = CheckpointManager(ckpt_dir, keep=3)
    state = init_sharded_state(student, trainer.opt, cfg, mesh, pol)
    runner = ElasticRunner(
        lambda m: build_step(m, cfg, qcfg, trainer.opt, teacher, pol,
                             plan=qplan),
        ckpt, ElasticConfig(checkpoint_every=200), device_type=device.type)
    state, done = runner.run(state, data, steps=args.steps)
    print(f"trained to step {done}; restarts={runner.restarts}")


if __name__ == "__main__":
    main()
