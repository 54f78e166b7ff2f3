"""Serving launcher: QFT deployment artifact → batched engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        [--full] [--use-kernels] [--ckpt-dir DIR] [--device cpu]

Builds the model skeleton through the pipeline's export stage, restores a
QFT-trained student from ``--ckpt-dir`` if one exists (pipeline workdir
stage/finetune checkpoints, or a trainer-format root-level checkpoint), and
serves the artifact under its DeployPlan via ``Engine.from_artifact``, on
the card unless ``--device cpu``.  The engine serves through the
dequantized deploy view; ``--use-kernels`` routes the decode attention
through ``decode_attention`` and also drives one exported linear through
the ``quant_matmul`` kernel (``serve.deploy.kernel_route_check``) and
reports its error, so the kernel path is validated rather than assumed.
Prints one ``reqN: [tokens]`` line a request.  The paper CNN is a
classifier and is refused (exit 2).
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import torch

from ..pipeline import STAGES, PipelineConfig, run_pipeline
from ..serve.deploy import export_for_layers, kernel_route_check
from ..serve.engine import Engine, Request, ServeConfig
from ..train.checkpoint import CheckpointManager


def restore_student(ckpt_dir: str, student):
    """Newest trained student under ``ckpt_dir``, as ``(student, where)``,
    or None.

    Tries, in order: pipeline stage checkpoints (only if finetune
    completed), pipeline within-finetune step checkpoints, trainer-format
    checkpoints at the directory root (``{'student': ...}`` leaves).  A
    checkpoint whose leaves do not match this config raises
    ``RuntimeError``.  Never creates directories.
    """
    root = pathlib.Path(ckpt_dir)
    finetune_no = STAGES.index("finetune") + 1
    candidates = [(root / "stages", finetune_no), (root / "finetune", 1),
                  (root, 1)]
    for d, min_step in candidates:
        if not d.is_dir():
            continue
        ckpt = CheckpointManager(str(d))
        step = ckpt.latest_step()
        if step is None or step < min_step:
            continue
        try:
            restored = ckpt.restore(step, {"student": student})["student"]
        except (KeyError, ValueError) as e:
            raise RuntimeError(
                f"checkpoint at {d} step {step} does not match this config "
                f"(arch/mode/--full mismatch?): {e}") from e
        return restored, f"{d} step {step}"
    return None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", choices=["w4a8", "w4chw"], default="w4a8")
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: registry SMOKE); "
                         "required to restore a production-size checkpoint")
    ap.add_argument("--ckpt-dir", default=None,
                    help="pipeline workdir or training checkpoint dir; "
                         "restores a QFT-trained student")
    ap.add_argument("--use-kernels", action="store_true",
                    help="serve the decode attention through the CUDA "
                         "kernel and validate the quant_matmul route "
                         "against the exported artifact")
    ap.add_argument("--show-plan", action="store_true",
                    help="print the resolved per-tensor QuantPlan the "
                         "artifact is served under")
    ap.add_argument("--max-slots", type=int, default=4,
                    help="decode slot pool size (continuous batching)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens prefilled per slot per step")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy, the default)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation (0 disables)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus (top-p) truncation (1.0 disables)")
    ap.add_argument("--seed", type=int, default=0,
                    help="per-request sampling seed (same seed → same tokens)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are emitted (Engine.stream) "
                         "instead of waiting for full completions")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card) or cpu (every "
                         "kernel's plain version)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.arch in ("paper-cnn", "paper_cnn"):
        print("error: paper-cnn is a classifier — it has no token-serving "
              "engine; use `python -m repro_torch quantize --config "
              "paper_cnn` instead", file=sys.stderr)
        return 2

    # steps=0, no workdir: build + export the MMSE-initialized skeleton
    # without training and without writing into --ckpt-dir
    pcfg = PipelineConfig(arch=args.arch, mode=args.mode, smoke=not args.full,
                          steps=0, stop_after="export",
                          use_kernels=args.use_kernels, device=args.device,
                          calib_samples=128, calib_seq_len=32,
                          calib_batch_size=8)
    result = run_pipeline(pcfg, log=lambda s: print(f"  {s}"))
    student, artifact = result.student, result.artifact

    if args.ckpt_dir:
        hit = restore_student(args.ckpt_dir, student)
        if hit is None:
            print(f"warning: no usable checkpoint under {args.ckpt_dir!r} — "
                  f"serving the MMSE-initialized (untrained) student")
        else:
            student, where = hit
            with torch.no_grad():
                artifact = export_for_layers(student, result.plan,
                                             device=args.device)
            print(f"restored trained student from {where}")
    # the f32 masters are not served: free them before the engine
    del student
    result.student = result.teacher = None

    if args.show_plan:
        if result.plan.quant_plan is not None:
            print(result.plan.quant_plan.describe())
        else:
            print("no resolved QuantPlan on this DeployPlan (artifact "
                  "predates plan embedding); re-export to embed one")

    if args.use_kernels:
        print(f"kernel route: {kernel_route_check(artifact, result.plan)}")

    cfg = dataclasses.replace(result.model_cfg, scan_layers=False, remat=False)
    engine = Engine.from_artifact(
        cfg, result.plan, artifact,
        ServeConfig(max_slots=args.max_slots, max_len=128,
                    prefill_chunk=args.prefill_chunk), device=args.device)
    sampling = dict(temperature=args.temperature, top_k=args.top_k,
                    top_p=args.top_p)
    reqs = [Request(prompt=[1, 2, 3], max_new_tokens=8,
                    seed=args.seed, **sampling),
            Request(prompt=[4, 5], max_new_tokens=8,
                    seed=args.seed + 1, **sampling)]
    if args.stream:
        # streams drive the engine themselves; drain them in order — later
        # streams buffer whatever lands while an earlier one is iterated
        streams = [engine.stream(r) for r in reqs]
        for i, ts in enumerate(streams):
            print(f"req{i}:", end="", flush=True)
            for tok in ts:
                print(f" {tok}", end="", flush=True)
            print()
    else:
        outs = engine.generate(reqs)
        for i, o in enumerate(outs):
            print(f"req{i}: {o}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
