"""Command-line entry point:

    python -m repro_torch quantize --config paper_cnn --steps 60
    python -m repro_torch quantize --config qwen3_8b --device cpu --steps 2
    python -m repro_torch plan --config qwen3_8b --w-layout group:128
    python -m repro_torch list-configs

``quantize`` resolves a model of the port's registry (module or registry
spelling) and runs the full calibrate → MMSE/APQ init → QFT finetune →
export → evaluate pipeline on the card (``--device cpu`` runs every
kernel's plain version on the CPU), printing per-stage progress and the
final export-parity / degradation metrics.  Exit codes: 0, 1 (export parity
above 1e-3), 2 (unknown config or bad override).

``plan`` prints the resolved QuantPlan — the per-tensor
bits/layout/stream/packing table every pipeline stage consumes — without
running anything (shapes come from a meta-device skeleton, so full-size
entries resolve at once).  ``check`` (the static analyzer) is not ported.
"""
from __future__ import annotations

import argparse
import sys

from ..configs import registry
from .config import MODES, STAGES, PipelineConfig
from .runner import run_pipeline


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="QFT post-training quantization pipeline (PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="command", required=True)

    q = sub.add_parser("quantize", help="run the end-to-end PTQ pipeline")
    q.add_argument("--config", required=True,
                   help="registry entry (paper-cnn / qwen3_8b / ...)")
    q.add_argument("--mode", choices=MODES, default="w4a8",
                   help="paper setup: w4a8 (deployment) | w4chw (permissive)")
    q.add_argument("--w-bits", type=int, default=None,
                   help="override the mode's weight bits")
    q.add_argument("--w-layout", default=None, metavar="LAYOUT",
                   help="weight-scale layout: layerwise | channel | "
                        "group:<size> (e.g. group:128)")
    q.add_argument("--steps", type=int, default=60,
                   help="QFT finetune steps (0 = heuristic PTQ only)")
    q.add_argument("--full", action="store_true",
                   help="full-size config (default: registry SMOKE)")
    q.add_argument("--cle", action="store_true", help="CLE+QFT two-step")
    q.add_argument("--base-lr", type=float, default=1e-4)
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--teacher-steps", type=int, default=0,
                   help="paper-cnn: pre-train the FP teacher this many "
                        "steps")
    q.add_argument("--calib-samples", type=int, default=512)
    q.add_argument("--calib-seq-len", type=int, default=32)
    q.add_argument("--calib-batch-size", type=int, default=16)
    q.add_argument("--workdir", default=None,
                   help="per-stage checkpoint dir (enables --resume)")
    q.add_argument("--no-resume", action="store_true")
    q.add_argument("--stop-after", choices=STAGES, default=None)
    q.add_argument("--serve-smoke", action="store_true",
                   help="decode a demo batch from the artifact")
    q.add_argument("--max-slots", type=int, default=4,
                   help="serve smoke: decode slot pool size")
    q.add_argument("--prefill-chunk", type=int, default=32,
                   help="serve smoke: prompt tokens prefilled per step")
    q.add_argument("--serve-temperature", type=float, default=0.0,
                   help="serve smoke: sampling temperature (0 = greedy)")
    q.add_argument("--serve-top-k", type=int, default=0,
                   help="serve smoke: top-k truncation (0 disables)")
    q.add_argument("--serve-top-p", type=float, default=1.0,
                   help="serve smoke: nucleus truncation (1.0 disables)")
    q.add_argument("--serve-seed", type=int, default=0,
                   help="serve smoke: per-request sampling seed root")
    q.add_argument("--device", default="cuda",
                   help="cuda (default: the kernels on the card) | cpu "
                        "(their plain versions)")
    _add_plan_knobs(q)

    p = sub.add_parser(
        "plan", help="print the resolved per-tensor QuantPlan table")
    p.add_argument("--config", default=None,
                   help="registry entry (omit with --all)")
    p.add_argument("--all", action="store_true",
                   help="print the plan for every registry entry")
    p.add_argument("--mode", choices=MODES, default="w4a8")
    p.add_argument("--w-bits", type=int, default=None)
    p.add_argument("--w-layout", default=None, metavar="LAYOUT")
    p.add_argument("--full", action="store_true",
                   help="full-size config (default: registry SMOKE)")
    p.add_argument("--json", action="store_true",
                   help="emit the serialized plan instead of the table")
    _add_plan_knobs(p)

    sub.add_parser("list-configs", help="print every registry entry")
    sub.add_parser("check", help="static invariant analyzer (not ported: "
                                 "it waits for the port's analysis/)")
    return ap


def _add_plan_knobs(sp) -> None:
    sp.add_argument("--exempt-frac", type=float, default=None,
                    help="§4 1%%-rule weight-memory budget (0 disables)")
    sp.add_argument("--bits-override", action="append", default=[],
                    metavar="GLOB=BITS",
                    help="per-tensor bits override (path-glob grammar), "
                         "e.g. --bits-override 'layers.mlp.down=8'; "
                         "repeatable")
    sp.add_argument("--layout-override", action="append", default=[],
                    metavar="GLOB=LAYOUT",
                    help="per-tensor layout override, e.g. "
                         "--layout-override 'layers.mlp.*=group:64'")


def _parse_overrides(pairs: list[str], what: str) -> tuple:
    out = []
    for item in pairs:
        glob, sep, val = item.partition("=")
        if not sep or not glob or not val:
            raise ValueError(f"--{what} expects GLOB=VALUE, got {item!r}")
        out.append((glob, val))
    return tuple(out)


def _pcfg_from_args(args: argparse.Namespace) -> PipelineConfig:
    return PipelineConfig(
        arch=args.config, mode=args.mode, w_bits=args.w_bits,
        w_layout=args.w_layout, exempt_frac=args.exempt_frac,
        bits_overrides=_parse_overrides(args.bits_override, "bits-override"),
        layout_overrides=_parse_overrides(args.layout_override,
                                          "layout-override"),
        smoke=not args.full, steps=args.steps, seed=args.seed, cle=args.cle,
        base_lr=args.base_lr, teacher_steps=args.teacher_steps,
        calib_samples=args.calib_samples, calib_seq_len=args.calib_seq_len,
        calib_batch_size=args.calib_batch_size, workdir=args.workdir,
        resume=not args.no_resume, stop_after=args.stop_after,
        serve_smoke=args.serve_smoke, serve_max_slots=args.max_slots,
        serve_prefill_chunk=args.prefill_chunk,
        serve_temperature=args.serve_temperature,
        serve_top_k=args.serve_top_k, serve_top_p=args.serve_top_p,
        serve_seed=args.serve_seed, device=args.device,
        log_every=max(args.steps // 6, 1))


def cmd_quantize(args: argparse.Namespace) -> int:
    try:
        pcfg = _pcfg_from_args(args)
        qcfg = pcfg.quant_config()     # raises on e.g. --bits-override fc=x
    except (KeyError, ValueError) as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    print(f"pipeline: {pcfg.arch} mode={pcfg.mode} "
          f"w{qcfg.w_bits} layout={qcfg.layout} steps={pcfg.steps} "
          f"stages={' -> '.join(pcfg.stages())}")
    try:
        result = run_pipeline(pcfg, log=lambda s: print(f"  {s}"))
    except NotImplementedError as e:   # e.g. --serve-smoke on encdec
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 1
    if result.stages_skipped:
        print(f"  skipped (resume): {', '.join(result.stages_skipped)}")
    ft = result.metrics.get("finetune")
    if ft:
        print(f"  finetune loss: {ft['first_loss']:.4f} -> "
              f"{ft['final_loss']:.4f} over {ft['steps']} steps")
    ev = result.metrics.get("evaluate")
    if ev:
        for k, v in ev.items():
            print(f"  {k}: {v:.6g}" if isinstance(v, float) else
                  f"  {k}: {v}")
        err = ev.get("export_parity_max_err")
        if err is not None and err > 1e-3:
            print(f"ERROR: export parity {err:.3g} exceeds fp tolerance",
                  file=sys.stderr)
            return 1
    print("pipeline complete")
    return 0


def cmd_plan(args: argparse.Namespace) -> int:
    """Resolve and print the QuantPlan table (or JSON) per config."""
    from .adapters import resolve_quant_plan
    if not args.all and args.config is None:
        print("error: plan needs --config <entry> or --all", file=sys.stderr)
        return 2
    archs = (sorted(registry._MODULES) if args.all else [args.config])
    try:
        bits_ov = _parse_overrides(args.bits_override, "bits-override")
        layout_ov = _parse_overrides(args.layout_override, "layout-override")
    except ValueError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    rc = 0
    for arch in archs:
        try:
            # NOTE: keep these fields in sync with _pcfg_from_args — any new
            # plan-affecting quantize knob must reach both subcommands
            pcfg = PipelineConfig(
                arch=arch, mode=args.mode, w_bits=args.w_bits,
                w_layout=args.w_layout, exempt_frac=args.exempt_frac,
                bits_overrides=bits_ov, layout_overrides=layout_ov,
                smoke=not args.full, steps=0)
            qcfg = pcfg.quant_config()
            plan = resolve_quant_plan(pcfg.model_config(), qcfg)
        except (KeyError, ValueError) as e:
            # one broken entry must not kill an --all sweep
            print(f"error ({arch}): {e.args[0]}", file=sys.stderr)
            rc = 2
            if not args.all:
                return rc
            continue
        print(f"## {pcfg.arch} mode={pcfg.mode} w{qcfg.w_bits} "
              f"layout={qcfg.layout} exempt_frac={qcfg.exempt_frac}")
        print(plan.to_json(indent=1) if args.json else plan.describe())
        print()
    return rc


def cmd_list_configs() -> int:
    for arch, module in sorted(registry._MODULES.items()):
        print(f"{arch:<22s} repro_torch.configs.{module}")
    return 0


def cmd_check() -> int:
    print("check: the static analyzer is not ported yet (it waits for "
          "repro_torch's analysis/); run `python -m repro check` on the "
          "JAX package", file=sys.stderr)
    return 2


def _canon_arch(name: str) -> str:
    """Accept both registry ('qwen3-8b') and module ('qwen3_8b') spellings."""
    if name in registry._MODULES:
        return name
    for arch, module in registry._MODULES.items():
        if module == name:
            return arch
    raise KeyError(name)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "quantize":
        return cmd_quantize(args)
    if args.command == "plan":
        return cmd_plan(args)
    if args.command == "list-configs":
        return cmd_list_configs()
    if args.command == "check":
        return cmd_check()
    return 2


if __name__ == "__main__":
    sys.exit(main())
