"""Diagnostic / Report containers shared by both analyzer layers.

Everything the trace-time analyzer (graph_checks) and the AST lint pass
(lint) produce funnels into one `Report`, so the CLI and the JSON artifact
read a single schema: the JAX package's (``SCHEMA_VERSION`` 1, tool
``repro-check``), which ``benchmarks/check_results.py --analysis``
re-validates with the standard library alone.

The schema is deliberately flat: a summary dict plus one list of
diagnostic records, primitive values only (str/int/None/list/dict).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

SCHEMA_VERSION = 1
TOOL_NAME = "repro-check"

# severity ladder; "skip" records a check that could not run for a config
# (e.g. encdec has no serving path) so absence-of-error is never silent
SEVERITIES = ("error", "warning", "info", "skip")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding.  ``check`` is either a trace-check name
    (``trace.one-transfer``) or a lint rule id (``QFT003``)."""

    check: str
    message: str
    severity: str = "error"
    config: str | None = None       # registry arch id (trace checks)
    file: str | None = None         # repo-relative path (lint + injected srcs)
    line: int | None = None
    col: int | None = None
    value: Any = None               # machine-readable payload (counts etc.)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")

    def where(self) -> str:
        if self.file is not None:
            loc = self.file if self.line is None else f"{self.file}:{self.line}"
            if self.line is not None and self.col is not None:
                loc += f":{self.col}"
            return loc
        return self.config or "<repo>"

    def format(self) -> str:
        return f"{self.where()}: [{self.check}] {self.severity}: {self.message}"

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if d["value"] is not None:
            # keep the artifact schema primitive
            d["value"] = _jsonable(d["value"])
        return d


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except TypeError:
        return repr(v)


@dataclasses.dataclass
class Report:
    diagnostics: list[Diagnostic] = dataclasses.field(default_factory=list)

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, diags) -> None:
        self.diagnostics.extend(diags)

    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def count(self, severity: str) -> int:
        return sum(1 for d in self.diagnostics if d.severity == severity)

    def ok(self) -> bool:
        return not self.errors()

    def summary(self) -> dict:
        configs = sorted({d.config for d in self.diagnostics if d.config})
        files = sorted({d.file for d in self.diagnostics if d.file})
        return {
            "errors": self.count("error"),
            "warnings": self.count("warning"),
            "infos": self.count("info"),
            "skips": self.count("skip"),
            "configs": configs,
            "files": files,
        }

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "tool": TOOL_NAME,
            "summary": self.summary(),
            "diagnostics": [d.to_json() for d in self.diagnostics],
        }

    def write_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")

    def format(self, verbose: bool = False) -> str:
        """Human rendering: errors always, the rest behind ``verbose``."""
        shown = [d for d in self.diagnostics
                 if verbose or d.severity in ("error", "warning")]
        lines = [d.format() for d in shown]
        s = self.summary()
        lines.append(
            f"repro_torch check: {s['errors']} error(s), {s['warnings']} warning(s), "
            f"{s['infos']} info(s), {s['skips']} skip(s)"
        )
        return "\n".join(lines)
