"""The port's dry-run cells beside the JAX package's, as a markdown table.

    python tools/dryrun_compare.py --port dryrun_results \
        --jax <tree>/benchmarks/results/dryrun [--before <dir>] \
        [--arch qwen3-8b ...] [--shape decode_32k ...] [--mesh pod16x16]

``--port`` holds ``python -m repro_torch.launch.dryrun``'s JSON files,
``--jax`` ``python -m repro.launch.dryrun``'s (run in a copy of the tree:
it writes under ``benchmarks/``), ``--before`` optionally the port's files
from another tree.  One row a cell: rank 0's FLOPs, useful-FLOPs ratio,
collective bytes by kind, cache bytes and peak bytes, each ``port / JAX``
(and ``before`` first where given).  The JAX package's cache a rank is its
step's donated bytes (``alias_bytes``: the cache and its ``pos``).
"""
from __future__ import annotations

import argparse
import json
import pathlib

KINDS = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS",
         "all-to-all": "A2A", "collective-permute": "CP"}


def _load(d: pathlib.Path | None, arch: str, shape: str, mesh: str):
    if d is None:
        return None
    f = d / f"{arch}__{shape}__{mesh}__baseline.json"
    return json.loads(f.read_text()) if f.exists() else None


def _row(c: dict | None, jax: bool) -> dict | None:
    if c is None or c.get("status") != "OK":
        return None
    mem = c["memory"]
    return {"flops": c["cost"]["corrected_total"]["flops"],
            "useful": c["roofline"]["useful_flops_ratio"],
            "coll": c["collectives"]["collective_bytes"],
            "kinds": c["collectives"]["per_kind"],
            "cache": mem["alias_bytes"] if jax else mem["cache_bytes"],
            "peak": mem["peak_bytes"]}


def _kinds(r: dict) -> str:
    parts = [f"{KINDS.get(k, k)} {v / 1e9:.4g}"
             for k, v in sorted(r["kinds"].items()) if v]
    return f"{r['coll'] / 1e9:.4g} GB" + (f" ({', '.join(parts)})"
                                          if parts else "")


def table(port, jax, before, archs, shapes, mesh) -> str:
    cols = [("FLOPs", lambda r: f"{r['flops']:.3g}"),
            ("useful ratio", lambda r: f"{r['useful']:.3f}"),
            ("collective bytes", _kinds),
            ("cache a rank", lambda r: f"{r['cache'] / 1e9:.4g} GB"),
            ("peak a rank", lambda r: f"{r['peak'] / 1e9:.4g} GB")]
    who = ("before / " if before else "") + "port / JAX"
    out = [f"| cell | " + " | ".join(f"{n}, {who}" for n, _ in cols) + " |",
           "| --- " * (len(cols) + 1) + "|"]
    for arch in archs:
        for shape in shapes:
            rows = ([_row(_load(before, arch, shape, mesh), False)]
                    if before else []) + [
                _row(_load(port, arch, shape, mesh), False),
                _row(_load(jax, arch, shape, mesh), True)]
            cells = [" / ".join("n/a" if r is None else fmt(r)
                                for r in rows) for _, fmt in cols]
            out.append(f"| {arch} {shape} | " + " | ".join(cells) + " |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/dryrun_compare.py")
    ap.add_argument("--port", type=pathlib.Path, required=True)
    ap.add_argument("--jax", type=pathlib.Path, required=True)
    ap.add_argument("--before", type=pathlib.Path)
    ap.add_argument("--arch", nargs="+", default=[
        "qwen3-8b", "qwen3-32b", "phi4-mini-3.8b", "command-r-plus-104b",
        "qwen2-vl-7b"])
    ap.add_argument("--shape", nargs="+",
                    default=["decode_32k", "prefill_32k"])
    ap.add_argument("--mesh", default="pod16x16")
    a = ap.parse_args(argv)
    print(table(a.port, a.jax, a.before, a.arch, a.shape, a.mesh))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
