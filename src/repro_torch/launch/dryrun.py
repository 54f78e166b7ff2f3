"""Multi-pod dry-run: trace every (arch × shape) cell on the production mesh
in one process, over fake ranks, with nothing allocated and no card.

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \
        [--multi-pod]
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]

The world is ``torch.distributed``'s ``fake`` backend (``FakeStore``): this
process is rank 0 of 256 (16 × 16) or 512 (2 × 16 × 16 with
``--multi-pod``), and every collective returns at once.  The mesh is the
one ``launch.mesh.make_production_mesh`` builds; the state lies on the meta
device, and the step is traced with ``make_fx`` over fake tensors
(``analysis.graph_checks.trace``): one rank's program, kernels and
collectives as nodes (``launch.hlo_analysis`` reads them).

The step of a cell:

- train: ``launch.train.build_step``, the sharded QFT step (student,
  teacher and Adam's moments stored as DTensors; the rank's rows of the
  batch; the forward gathers each layer's leaves in that layer's body;
  remat on), with the paper's recipe (bf16 moments for the 100B+ models);
- prefill / decode: the deployed artifact's step (``export_for_layers``
  then ``deploy_view`` under the resolved plan), the view stored as
  DTensors by the same specs and gathered a layer at a time by the same
  forward, over the rank's rows of the batch (all rows where they do not
  divide) and their cache.

Where this moves other bytes than the JAX package's GSPMD compute, it
reports what the port does: the ``model`` axis shards storage, not compute
(every rank of a model group gathers each layer's leaves whole and runs the
same forward; tensor-parallel compute is ROADMAP Queue 1 item 4), so the
collectives are per-layer all-gathers and the gradient reductions.

The port's graphs are unrolled.  A cell is traced at 1 and 2 layer units
(a hybrid's unit is ``attn_every`` layers; an encoder-decoder's one encoder
and one decoder layer) and the whole depth is extrapolated,
``total = c(1) + (units - 1) · (c(2) - c(1))``, for the FLOPs, the bytes,
the collective traffic and the activation peak; ``per_layer_unit`` is
``c(2) - c(1)``.  The state bytes (parameters, optimizer, batch, cache)
are counted at the whole depth from their shapes.

Each cell is one JSON file under ``dryrun_results/`` at the repo root
(the JAX package's schema: ``status`` OK / SKIP / FAIL, ``memory``,
``cost``, ``collectives``, ``roofline``; its ``compile_s`` is ``trace_s``
here); a cell that fails to trace is recorded as FAIL with its error.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback

import torch
import torch.distributed as dist

from ..configs.registry import (ARCH_IDS, SHAPES, get_config, input_specs,
                                skip_reason)
from ..core.plan import resolve_plan
from ..core.qconfig import deployment_oriented
from ..models import init_cache, init_model
from ..optim.adam import paper_recipe
from ..serve.deploy import deploy_view, export_for_layers, make_deploy_plan
from ..sharding.partition import (ShardingPolicy, opt_state_shardings,
                                  params_shardings, spec_at, to_placements)
from ..train.steps import make_decode_step, make_prefill_step
from ..tree import tree_from_items, tree_items
from . import hlo_analysis as H
from .mesh import make_production_mesh
from .train import build_step, local_rows, place

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "dryrun_results"

# big models: bf16 optimizer moments
_BF16_OPT = {"deepseek-v2-236b", "command-r-plus-104b", "qwen3-32b"}


def init_fake_world(n: int) -> None:
    """This process as rank 0 of an ``n``-rank world on the fake backend
    (a world of another size is torn down first)."""
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _cfg_for(arch: str, n_layer_units: int | None = None):
    cfg = get_config(arch).with_padding(tp=16)
    cfg = dataclasses.replace(cfg, scan_layers=True, remat=True)
    if n_layer_units is not None:
        if cfg.family == "hybrid":
            k = cfg.attn_every
            r = cfg.n_layers % k
            cfg = dataclasses.replace(cfg, n_layers=k * n_layer_units + r)
        elif cfg.family == "encdec":
            cfg = dataclasses.replace(cfg, n_layers=n_layer_units,
                                      enc_layers=n_layer_units)
        else:
            cfg = dataclasses.replace(cfg, n_layers=n_layer_units)
    return cfg


def _layer_units(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def _bf16(tree):
    return tree_from_items(
        (p, t.to(torch.bfloat16) if t.is_floating_point() else t)
        for p, t in tree_items(tree))


def _local_bytes(tree, specs, mesh) -> int:
    """Bytes of a rank's shards of ``tree`` placed by ``specs``."""
    from torch.distributed.tensor import Shard
    n = 0
    for path, t in tree_items(tree):
        div = 1
        for i, p in enumerate(to_placements(spec_at(specs, path), mesh)):
            if isinstance(p, Shard):
                div *= mesh.size(i)
        n += -(-t.numel() // div) * t.element_size()
    return n


def build_cell(arch: str, shape: str, mesh, pol: ShardingPolicy,
               n_layer_units: int | None = None, qcfg=None):
    """``(fn, args, cfg, state)``: ``fn(*args)`` is one rank's step of the
    cell (``args`` shape-only, on the meta device); ``state`` holds what
    ``hlo_analysis.memory_summary`` takes: the rank's parameter and
    optimizer bytes, its batch rows and their cache."""
    qcfg = qcfg or deployment_oriented()
    cfg = _cfg_for(arch, n_layer_units)
    sp = SHAPES[shape]
    batch = input_specs(arch, shape, cfg)
    student = init_model(0, cfg, qcfg, device="meta")
    qplan = resolve_plan(qcfg, student, model_cfg=cfg)

    if sp.kind == "train":
        opt = paper_recipe(
            steps_per_epoch=500,
            state_dtype=torch.bfloat16 if arch in _BF16_OPT
            else torch.float32)
        teacher = _bf16(init_model(0, cfg, None, device="meta"))
        step = build_step(mesh, cfg, qcfg, opt, teacher, pol, plan=qplan,
                          device="meta")
        opt_state = opt.init(student)
        s_specs = params_shardings(student, cfg, mesh, pol)
        t_specs = params_shardings(
            teacher, cfg, mesh,
            pol if pol.fsdp_teacher else dataclasses.replace(pol, fsdp=None))
        o_specs = opt_state_shardings(s_specs, mesh)
        state = {"param_bytes": _local_bytes(student, s_specs, mesh)
                 + _local_bytes(teacher, t_specs, mesh),
                 "optimizer_bytes": _local_bytes(opt_state["m"],
                                                 o_specs["m"], mesh)
                 + _local_bytes(opt_state["v"], o_specs["v"], mesh),
                 "batch": local_rows(batch, mesh, pol), "cache": None}
        return (lambda st, b: step(st, b)), ((student, opt_state), batch), \
            cfg, state

    # inference cells run the deployed artifact under the same resolved
    # plan the train cells fake-quant against
    dplan = make_deploy_plan(qcfg, arch=arch, family=cfg.family,
                             quant_plan=qplan)
    with torch.no_grad():
        view = deploy_view(export_for_layers(student, dplan, device="meta"),
                           dplan)
    specs = params_shardings(view, cfg, mesh, pol)
    view_dt = place(view, specs, mesh)
    rows = local_rows(batch, mesh, pol)
    B = next(iter(rows.values())).shape[0]
    if sp.kind == "prefill":
        cache = init_cache(cfg, B, sp.seq_len + 8, device="meta")
        inner = make_prefill_step(cfg, None)
    else:
        cache = init_cache(cfg, B, sp.seq_len, device="meta",
                           enc_len=sp.seq_len if cfg.family == "encdec"
                           else None)
        inner = make_decode_step(cfg, None)

    def fn(c, b):
        with torch.no_grad():
            return inner(view_dt, c, b)

    state = {"param_bytes": _local_bytes(view, specs, mesh),
             "optimizer_bytes": 0, "batch": rows, "cache": cache}
    return fn, (cache, rows), cfg, state


def _model_flops(arch: str, shape: str) -> float:
    cfg = get_config(arch)
    sp = SHAPES[shape]
    pc = cfg.param_count()
    if sp.kind == "train":
        # QFT backbone params only: the lm_head is not run (loss on hidden)
        # and embed is a lookup.  6ND student (fwd+bwd) + 2ND frozen teacher.
        n = cfg.n_params_active() - pc["embed"] - pc["head"]
        tokens = sp.global_batch * sp.seq_len
        return 8.0 * n * tokens
    n = cfg.n_params_active() - pc["embed"]   # serving computes logits
    tokens = sp.global_batch * (sp.seq_len if sp.kind == "prefill" else 1)
    return 2.0 * n * tokens


def _extrapolate(c1: dict, c2: dict, units: int) -> tuple[dict, dict]:
    layer = {k: c2[k] - c1[k] for k in c1}
    return layer, {k: c1[k] + (units - 1) * layer[k] for k in c1}


def run_cell(arch: str, shape: str, multi_pod: bool,
             pol: ShardingPolicy | None = None, tag: str = "baseline",
             save: bool = True) -> dict:
    from ..analysis.graph_checks import trace
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out: dict = {"arch": arch, "shape": shape, "mesh": mesh_name, "tag": tag,
                 "variant": ""}
    reason = skip_reason(arch, shape)
    if reason:
        out["status"] = "SKIP"
        out["reason"] = reason
        if save:
            _save(out)
        return out
    n_chips = 512 if multi_pod else 256
    init_fake_world(n_chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    pol = pol or ShardingPolicy(dp=("pod", "data") if multi_pod
                                else ("data",))
    t0 = time.time()
    try:
        units = _layer_units(_cfg_for(arch))
        probes = {}
        for n in (1, 2):
            fn, args, _, state = build_cell(arch, shape, mesh, pol,
                                            n_layer_units=n)
            tr = trace(fn, *args)
            if tr.graph is None:
                raise RuntimeError(f"the step did not trace: "
                                   f"{tr.untraceable}")
            cost = H.cost_summary(tr)
            coll = H.collective_stats(tr, n_chips)
            probes[n] = {"flops": cost["flops"], "bytes": cost["bytes"],
                         "collective_bytes": coll["collective_bytes"],
                         "activation_peak_bytes":
                             float(H.activation_peak(tr)),
                         "n_collectives": float(coll["n_ops"]),
                         **{f"coll:{k}": v
                            for k, v in coll["per_kind"].items()}}
            keys = set(probes[n])
            if n == 2:
                for k in keys | set(probes[1]):
                    probes[1].setdefault(k, 0.0)
                    probes[2].setdefault(k, 0.0)
        out["trace_s"] = round(time.time() - t0, 1)
        layer, total = _extrapolate(probes[1], probes[2], units)
        # the state at the whole depth, from its shapes
        _, _, _, state = build_cell(arch, shape, mesh, pol)
        out["memory"] = H.memory_summary(
            state["param_bytes"], state["optimizer_bytes"], state["batch"],
            state["cache"], total["activation_peak_bytes"])
        out["cost"] = {"unit_traces": {str(k): {"flops": v["flops"],
                                                "bytes": v["bytes"]}
                                       for k, v in probes.items()},
                       "per_layer_unit": {"flops": layer["flops"],
                                          "bytes": layer["bytes"]},
                       "corrected_total": {"flops": total["flops"],
                                           "bytes": total["bytes"]},
                       "layer_units": units, "full_depth_traced": False}
        out["collectives"] = {
            "collective_bytes": total["collective_bytes"],
            "per_kind": {k[5:]: v for k, v in total.items()
                         if k.startswith("coll:")},
            "n_ops": int(total["n_collectives"]),
            "per_layer_unit_bytes": layer["collective_bytes"]}
        out["roofline"] = H.roofline_terms(
            total["flops"], total["bytes"], total["collective_bytes"],
            _model_flops(arch, shape), n_chips)
        out["status"] = "OK"
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        out["status"] = "FAIL"
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()[-2000:]
    out["total_s"] = round(time.time() - t0, 1)
    if save:
        _save(out)
    return out


def _save(out: dict) -> None:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    name = f"{out['arch']}__{out['shape']}__{out['mesh']}__{out['tag']}.json"
    (RESULTS_DIR / name).write_text(json.dumps(out, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = ([(a, s) for a in ARCH_IDS for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    failed = 0
    for mp in meshes:
        for arch, shape in cells:
            mesh_name = "pod2x16x16" if mp else "pod16x16"
            fname = RESULTS_DIR / f"{arch}__{shape}__{mesh_name}__{args.tag}.json"
            if args.skip_existing and fname.exists():
                prev = json.loads(fname.read_text())
                if prev.get("status") in ("OK", "SKIP"):
                    print(f"[skip-existing] {arch} {shape} {mesh_name}")
                    continue
            r = run_cell(arch, shape, mp, tag=args.tag)
            failed += r["status"] == "FAIL"
            line = {k: r.get(k) for k in
                    ("arch", "shape", "mesh", "status", "trace_s", "error")}
            if r.get("roofline"):
                line["dominant"] = r["roofline"]["dominant"]
                line["frac"] = round(r["roofline"]["roofline_fraction"], 3)
            print(json.dumps(line), flush=True)
    print(json.dumps({"cells": len(cells) * len(meshes), "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
