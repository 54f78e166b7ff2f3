#!/usr/bin/env python3
"""Phase 5 of chip_smoke.py (qwen3-8b served at full width and depth) on
two trees of the repository, alternated on one card in pairs: A B, B A,
A B, ...

    python3 tools/phase5_ab.py <tree A> <tree B> [--pairs N] [--out F]

Each run is a process of its own, in the tree's root: it builds the
kernels, then runs chip_smoke's ``main_path`` on qwen3-8b, whose
``decode ... ms/step`` line this script collects with the card's name and
power limit.  It prints each run, then per tree the median and quartiles
of the decode ms a step, and the median and quartiles of the pairs' B/A
ratios (each pair's two runs are adjacent, so a drift of the host between
pairs cancels in its ratio).  Used to measure what a change to the
kernels' dispatch costs a decode step (compare two trees only within one
call).  ``--out`` also writes the summary as JSON.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

_RUN = ("import sys; sys.path.insert(0, 'src'); import chip_smoke as c; "
        "c.probe(); c.build(); "
        "from repro_torch.configs.qwen3_8b import CONFIG; c.main_path(CONFIG)")
_DECODE = re.compile(r"decode (\d+\.\d+) ms/step")


def run(tree: Path) -> float:
    out = subprocess.run([sys.executable, "-c", _RUN], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode:
        sys.exit(f"{tree}: exit {out.returncode}\n{out.stderr[-4000:]}")
    hit = _DECODE.search(out.stdout)
    if hit is None:
        sys.exit(f"{tree}: no decode line\n{out.stdout[-4000:]}")
    return float(hit.group(1))


def quartiles(xs: list[float]) -> dict:
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return {"median": q2, "q1": q1, "q3": q3, "min": min(xs),
            "max": max(xs), "n": len(xs)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    a, b = Path(args.tree_a).resolve(), Path(args.tree_b).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card)
    runs, ratios = [], []
    for i in range(args.pairs):
        order = (("A", a), ("B", b)) if i % 2 == 0 else (("B", b), ("A", a))
        pair = {}
        for tag, tree in order:
            pair[tag] = run(tree)
            runs.append({"pair": i, "tree": tag, "decode_ms_step": pair[tag]})
            print(json.dumps(runs[-1]), flush=True)
        ratios.append(pair["B"] / pair["A"])
    summary = {"card": card, "pairs": args.pairs,
               "A": quartiles([r["decode_ms_step"] for r in runs
                               if r["tree"] == "A"]),
               "B": quartiles([r["decode_ms_step"] for r in runs
                               if r["tree"] == "B"]),
               "b_over_a_pairs": quartiles(ratios), "runs": runs}
    summary["b_over_a_medians"] = (summary["B"]["median"]
                                   / summary["A"]["median"])
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
