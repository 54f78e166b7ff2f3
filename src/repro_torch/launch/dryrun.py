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
  under the resolved plan, then ``make_prefill_step``/``make_decode_step``
  on it): the artifact stored as DTensors as the JAX package's
  ``param_spec`` places it (its ``q`` leaves over ``model`` only, no ZeRO
  over ``data``; scales and biases replicated), each rank dequantizing its
  shard of a layer inside the layer's body; the rank's rows of the batch
  (all rows where they do not divide) and their cache as
  ``cache_shardings`` places it (:func:`serve_cache_specs`); the logits
  the rank's slice of the vocabulary.

Where this moves other bytes than the JAX package's GSPMD compute, it
reports what the port does.  In every cell the ``model`` axis computes
the dense attention, the dense MLP and the embedding on shards
(``sharding.tp``): in a train cell with per-layer all-gathers over
``data``, the KV-group gathers, the *f*/*g* all-reduces over ``model``
and the gradient reductions; in an inference cell with no collective over
``data``: *f*/*g*, and where the cache is split over the sequence this
step's q/k/v gathered over ``model`` and the flash-decoding combine's
all-reduces.  In an inference cell the MoE experts run on the rank's
experts (one *g* a layer) and MLA on its heads, over its chunk of the
latent cache where the sequence divides ``model`` (the default form then
gathers ``k_up``/``v_up``'s ``q`` over ``model``, the one weight that
moves); in a train cell they are gathered whole.  Mamba2, the hybrid's
shared block and the encoder-decoder's layers are gathered whole and
repeated by every rank of a model group in every cell, and their caches
are whole over ``model`` (ROADMAP Queue 1).  ``collectives.per_axis``
splits the traffic by mesh axis.

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
from ..core.plan import PLAN_KEY, resolve_plan
from ..core.qconfig import deployment_oriented
from ..models import init_cache, init_model
from ..optim.adam import paper_recipe
from ..serve.deploy import export_for_layers, make_deploy_plan
from ..sharding.partition import (ShardingPolicy, axis_size,
                                  cache_shardings, opt_state_shardings,
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


#: the cache leaves kept split over ``model`` where the family's attention
#: runs on shards: the k/v of the dense, VLM and MoE families' GQA, MLA's
#: latent ``ckv``/``kr``
_SHARDED_CACHE = {"dense": (("k",), ("v",)), "vlm": (("k",), ("v",)),
                  "moe": (("k",), ("v",)), "mla_moe": (("ckv",), ("kr",))}


def serve_cache_specs(cache, cfg, mesh, pol: ShardingPolicy):
    """``cache_shardings``'s specs, with ``model`` dropped from every leaf
    but the top-level k/v of a family whose GQA runs on shards (dense, VLM,
    MoE) and MLA's latent ``ckv``/``kr``: the SSM state, the hybrid's
    shared attention and the encoder-decoder's caches stay whole over
    ``model``, as their blocks are gathered whole."""
    specs = cache_shardings(cache, cfg, mesh, pol)
    keep = _SHARDED_CACHE.get(cfg.family, ())

    def one(path):
        spec = spec_at(specs, path)
        if spec is None or path in keep:
            return spec
        return tuple(None if e == pol.tp else e for e in spec)

    return tree_from_items((p, one(p)) for p, _ in tree_items(cache))


def _local_shape(shape, spec, mesh) -> tuple:
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[d] //= axis_size(mesh, a)
    return tuple(out)


def local_cache(cache, specs, mesh):
    """The rank's shards of ``cache`` placed by ``specs``: shape-only
    tensors on the meta device (other leaves as they are)."""
    return tree_from_items(
        (p, torch.empty(_local_shape(t.shape, spec_at(specs, p), mesh),
                        dtype=t.dtype, device="meta")
         if isinstance(t, torch.Tensor) else t)
        for p, t in tree_items(cache))


def as_dtensors(local, specs, shapes, mesh):
    """``local`` (the rank's shards) as DTensors of the shapes and strides
    of the tensors of ``shapes``, placed by ``specs``: views, nothing is
    copied."""
    from torch.distributed.tensor import DTensor

    def one(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        whole = spec_at(shapes, path)
        return DTensor.from_local(
            t, mesh, to_placements(spec_at(specs, path), mesh),
            run_check=False, shape=whole.shape, stride=whole.stride())

    return tree_from_items((p, one(p, t)) for p, t in tree_items(local))


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
    # plan the train cells fake-quant against, stored as the JAX package's
    # param_spec places it (its q leaves over model only) and dequantized
    # a layer's shard at a time inside the step; the cache placed by
    # cache_shardings (serve_cache_specs), the logits the rank's slice of
    # the vocabulary
    dplan = make_deploy_plan(qcfg, arch=arch, family=cfg.family,
                             quant_plan=qplan)
    with torch.no_grad():
        exported = export_for_layers(student, dplan, device="meta")
    exported.pop(PLAN_KEY, None)
    specs = params_shardings(exported, cfg, mesh, pol)
    ex_dt = place(exported, specs, mesh)
    rows = local_rows(batch, mesh, pol)
    B = next(iter(batch.values())).shape[0]
    if sp.kind == "prefill":
        cache = init_cache(cfg, B, sp.seq_len + 8, device="meta")
        inner = make_prefill_step(cfg, None)
    else:
        cache = init_cache(cfg, B, sp.seq_len, device="meta",
                           enc_len=sp.seq_len if cfg.family == "encdec"
                           else None)
        inner = make_decode_step(cfg, None)
    c_specs = serve_cache_specs(cache, cfg, mesh, pol)
    local = local_cache(cache, c_specs, mesh)

    def fn(c, b):
        with torch.no_grad():
            logits, _ = inner(ex_dt, as_dtensors(c, c_specs, cache, mesh), b)
        return logits, c

    state = {"param_bytes": _local_bytes(exported, specs, mesh),
             "optimizer_bytes": 0, "batch": rows, "cache": local}
    return fn, (local, rows), cfg, state


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
    axes = H.mesh_axes(mesh)
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
            coll = H.collective_stats(tr, n_chips, axes)
            probes[n] = {"flops": cost["flops"], "bytes": cost["bytes"],
                         "collective_bytes": coll["collective_bytes"],
                         "activation_peak_bytes":
                             float(H.activation_peak(tr)),
                         "n_collectives": float(coll["n_ops"]),
                         **{f"coll:{k}": v
                            for k, v in coll["per_kind"].items()},
                         **{f"axis:{k}": v
                            for k, v in coll["per_axis"].items()}}
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
            "per_axis": {k[5:]: v for k, v in total.items()
                         if k.startswith("axis:")},
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
