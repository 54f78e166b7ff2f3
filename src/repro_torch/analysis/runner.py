"""Compose the two analyzer layers into one Report (the body of
``python -m repro_torch check``).

Kept apart from pipeline/cli.py so tests can run checks without argparse,
and apart from graph_checks so the lint layer imports without the model
zoo.
"""
from __future__ import annotations

from pathlib import Path

from .lint import DEFAULT_LINT_ROOTS, lint_paths
from .report import Report


def find_repo_root(start: Path | None = None) -> Path:
    """Nearest ancestor holding the port's package.  The lint layer needs
    repo-relative paths for its rule filters, so ``check`` works from any
    directory inside the repo."""
    p = (start or Path.cwd()).resolve()
    for cand in (p, *p.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return p


def run_check(configs: list[str] | None = None,
              lint_paths_arg: list[str] | None = None,
              trace: bool = True, lint: bool = True,
              prefill_budget: int | None = None,
              root: Path | None = None) -> Report:
    """Run the requested layers and return the combined Report.

    ``configs=None`` means every registry arch; ``lint_paths_arg=None``
    the default root (src/repro_torch).  ``trace=False`` skips the graph
    layer (lint only: fast, no model import).
    """
    report = Report()
    if lint:
        report.extend(lint_paths(find_repo_root(root),
                                 lint_paths_arg or DEFAULT_LINT_ROOTS))
    if trace:
        # deferred: graph_checks pulls in the model zoo, which lint-only
        # callers never need
        from .graph_checks import analyze
        report.extend(analyze(configs, prefill_budget=prefill_budget))
    return report
