"""``python -m repro_torch.analysis`` — the lint layer alone.

The whole analyzer is ``python -m repro_torch check``; this entry runs only
the QFT AST rules, which import nothing of the model zoo.
"""
from __future__ import annotations

import argparse
import sys

from .lint import DEFAULT_LINT_ROOTS, iter_py_files
from .runner import find_repo_root, run_check


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="QFT lint rules (AST layer only)")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="repo-relative files/dirs (default: "
                         "src/repro_torch)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    root = find_repo_root()
    # zero matched files means the path spec (or cwd) rotted, not that the
    # tree is clean — fail loudly instead of passing vacuously
    if not iter_py_files(root, args.paths or DEFAULT_LINT_ROOTS):
        print(f"repro_torch.analysis: no .py files under {root} for "
              f"{args.paths or list(DEFAULT_LINT_ROOTS)}", file=sys.stderr)
        return 2

    report = run_check(lint_paths_arg=args.paths, trace=False, lint=True,
                       root=root)
    print(report.format(verbose=args.verbose))
    return 0 if report.ok() else 1


if __name__ == "__main__":
    sys.exit(main())
