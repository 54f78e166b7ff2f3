"""Layer 2: the repo's AST lint rules (QFT001..QFT006) over the port.

They encode conventions ruff cannot know about, the port's load-bearing
invariants expressed at the source level (the JAX package's rules, with
``repro_torch`` names):

QFT001  ``init_qlinear(...)`` call without ``name=`` (or an explicit
        ``spec=``): an unnamed site cannot resolve through the QuantPlan
        path table and silently falls back to the role ladder.
QFT002  ``forward``-family call that threads a real ``qcfg`` but drops
        ``plan=``: the forward would re-derive per-tensor decisions instead
        of using the resolved plan (breaks train≡export).  Teacher
        forwards (``qcfg=None``) are exempt.
QFT003  host sync inside serve/decode (and train) step code: ``.item()``,
        ``.cpu()``, ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize``
        / ``.synchronize()``, ``np.asarray``/``np.array`` (plus
        ``int()``/``float()`` on a tensor inside ``*_step`` bodies).  The
        serve loop's budget is ONE device→host transfer per step; every
        extra surface must be visible and deliberately suppressed.  Also
        under QFT003: host RNG (``np.random.*``, ``random.*``) inside a
        ``*_step`` body — the draw does not depend on the request's seed,
        so a request's tokens stop being reproducible (device draws go
        through ``core/sampling.py``'s per-slot counter hash).
QFT004  a hard-coded kernel route: a literal ``use_kernels=True/False``
        keyword at a call site, which forces the kernel or the plain route
        instead of threading the DeployPlan's (or the caller's) flag — the
        port's counterpart of a hard-coded ``interpret=`` (its wrappers
        select the plain version by the tensor's device, as the JAX
        package's ``default_interpret`` selects by backend); a literal
        ``interpret=True/False`` is flagged as in the JAX package.
QFT005  wall-clock or unseeded randomness in ``benchmarks/``: bench rows
        are step-counted and machine-independent by design.
QFT006  mutable default (``[]``/``{}``/``set()``/``list()``/``dict()``) on
        a dataclass field — shared-state bugs in frozen config objects.

Suppression: a ``# qft: noqa[QFT003]`` (or bare ``# qft: noqa``) comment on
the flagged line silences the finding — grep-able, rule-scoped, and
reviewable.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Callable, Iterable

from .report import Diagnostic

_NOQA_RE = re.compile(r"#\s*qft:\s*noqa(?:\[([A-Z0-9_,\s]+)\])?", re.I)


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    # path filter over repo-relative posix paths; None = all scanned files
    path_filter: Callable[[str], bool] | None = None


def _under(*prefixes: str) -> Callable[[str], bool]:
    return lambda p: any(p.startswith(pre) for pre in prefixes)


def _not_tests(p: str) -> bool:
    return not p.startswith("tests/")


# QFT001/QFT002 exempt tests/: unit tests construct standalone (unnamed)
# qlinears and raw-qcfg forwards as the subject under test — there is no
# plan table for them to resolve against.  All other rules apply to tests.
RULES: dict[str, Rule] = {
    "QFT001": Rule("QFT001", "init_qlinear call missing name= (plan path)",
                   _not_tests),
    "QFT002": Rule("QFT002", "forward-family call with real qcfg missing plan=",
                   _not_tests),
    "QFT003": Rule("QFT003", "host sync inside serve/decode step code",
                   _under("src/repro_torch/serve/", "src/repro_torch/train/")),
    "QFT004": Rule("QFT004", "hard-coded use_kernels= (or interpret=) "
                             "instead of the threaded route"),
    "QFT005": Rule("QFT005", "wall-clock / unseeded randomness in benchmarks",
                   _under("benchmarks/")),
    "QFT006": Rule("QFT006", "mutable default on a dataclass field"),
}

_FORWARD_NAMES = {"forward", "forward_cnn"}
_HOST_SYNC_ATTRS = {"item", "cpu", "tolist", "numpy", "synchronize"}
_NP_SYNC_FUNCS = {"asarray", "array"}
_WALL_CLOCK = {
    ("time", "time"), ("time", "perf_counter"), ("time", "monotonic"),
    ("time", "process_time"), ("datetime", "now"), ("datetime", "utcnow"),
}
# np.random.<unseeded draw>; RandomState/default_rng/Generator are the
# sanctioned seeded constructors
_UNSEEDED_RANDOM = {
    "rand", "randn", "random", "randint", "choice", "permutation",
    "shuffle", "uniform", "normal", "poisson", "exponential",
}


def _noqa_rules(lines: list[str], *linenos: int | None) -> set[str] | None:
    """Rules suppressed on any of the given 1-based lines.
    Returns None for a bare ``# qft: noqa`` (suppress everything)."""
    out: set[str] = set()
    for ln in linenos:
        if ln is None or not (1 <= ln <= len(lines)):
            continue
        m = _NOQA_RE.search(lines[ln - 1])
        if m:
            if m.group(1) is None:
                return None
            out |= {r.strip().upper() for r in m.group(1).split(",") if r.strip()}
    return out


def _call_name(node: ast.Call) -> str | None:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _dotted(node: ast.expr) -> str:
    """Best-effort dotted name for Name/Attribute chains ('' otherwise)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _kwarg_names(node: ast.Call) -> set[str]:
    return {k.arg for k in node.keywords if k.arg is not None}


def _has_splat_kwargs(node: ast.Call) -> bool:
    return any(k.arg is None for k in node.keywords)


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, rules: Iterable[str]):
        self.path = path
        self.active = set(rules)
        self.findings: list[tuple[str, int, int, str]] = []
        # QFT003 scope stack: "traced" = a step function's body (``*_step``
        # defs, run once per step on the card's stream); "host" = serve-loop
        # orchestration (Engine.step/generate) where the one-transfer
        # budget is audited
        self._scopes: list[str] = []
        self._class_stack: list[str] = []

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        if rule in self.active:
            self.findings.append(
                (rule, node.lineno, getattr(node, "col_offset", 0), msg))

    # -- scope bookkeeping ------------------------------------------------
    def _fn_scope(self, node) -> str | None:
        name = getattr(node, "name", "")
        if name.endswith("_step"):
            return "traced"
        if self._class_stack and "Engine" in self._class_stack[-1] and \
                name in ("step", "generate", "drain", "run"):
            return "host"
        return None

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._check_dataclass(node)
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_fn(self, node) -> None:
        self._check_interpret_defaults(node)
        scope = self._fn_scope(node)
        self._scopes.append(scope or (self._scopes[-1] if self._scopes else ""))
        self.generic_visit(node)
        self._scopes.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._scopes.append(self._scopes[-1] if self._scopes else "")
        self.generic_visit(node)
        self._scopes.pop()

    @property
    def _scope(self) -> str:
        return self._scopes[-1] if self._scopes else ""

    # -- QFT006 -----------------------------------------------------------
    def _check_dataclass(self, node: ast.ClassDef) -> None:
        deco_names = {_dotted(d.func) if isinstance(d, ast.Call) else _dotted(d)
                      for d in node.decorator_list}
        if not any(n.split(".")[-1] == "dataclass" for n in deco_names):
            return
        for stmt in node.body:
            if not (isinstance(stmt, ast.AnnAssign) and stmt.value is not None):
                continue
            v = stmt.value
            mutable = isinstance(v, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                and v.func.id in ("list", "dict", "set") and not v.args)
            if mutable:
                self._emit("QFT006", stmt,
                           f"mutable default on dataclass field in "
                           f"{node.name}; use dataclasses.field(...)")

    # -- QFT004 -----------------------------------------------------------
    def _check_interpret_defaults(self, node) -> None:
        args = node.args
        named = list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        defaults = list(args.defaults) + list(args.kw_defaults)
        # align trailing defaults with trailing positional args
        pos = list(args.posonlyargs) + list(args.args)
        pairs = list(zip(pos[len(pos) - len(args.defaults):], args.defaults))
        pairs += [(a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
                  if d is not None]
        del named, defaults
        for a, d in pairs:
            if a.arg == "interpret" and isinstance(d, ast.Constant) \
                    and d.value in (True, False):
                self._emit("QFT004", d,
                           f"default interpret={d.value}; use None "
                           f"(auto-select)")

    # -- calls ------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node)
        kwargs = _kwarg_names(node)
        splat = _has_splat_kwargs(node)

        # QFT001
        if name == "init_qlinear" and not splat \
                and not ({"name", "spec"} & kwargs):
            self._emit("QFT001", node,
                       "init_qlinear call without name= — the site cannot "
                       "resolve through the QuantPlan path table")

        # QFT002
        if name in _FORWARD_NAMES and not splat and "plan" not in kwargs:
            qcfg = None
            if len(node.args) >= 3:
                qcfg = node.args[2]
            elif "qcfg" in kwargs:
                qcfg = next(k.value for k in node.keywords if k.arg == "qcfg")
            teacher = isinstance(qcfg, ast.Constant) and qcfg.value is None
            if qcfg is not None and not teacher:
                self._emit("QFT002", node,
                           f"{name}(...) threads qcfg but drops plan= — "
                           "per-tensor decisions re-derive instead of using "
                           "the resolved QuantPlan")

        # QFT004 (call-site keyword)
        for k in node.keywords:
            if k.arg in ("use_kernels", "interpret") \
                    and isinstance(k.value, ast.Constant) \
                    and k.value.value in (True, False):
                self._emit("QFT004", k.value,
                           f"hard-coded {k.arg}={k.value.value}; thread the "
                           "DeployPlan's (or the caller's) route instead")

        # QFT003
        if self._scope in ("traced", "host"):
            dotted = _dotted(node.func)
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _HOST_SYNC_ATTRS:
                # x.item() / x.cpu() / x.tolist() / torch.cuda.synchronize()
                self._emit("QFT003", node,
                           f"host sync `{node.func.attr}` inside "
                           f"{self._scope} serve/decode code (budget: "
                           "one transfer per step)")
            elif dotted.split(".")[0] in ("np", "numpy") and \
                    dotted.split(".")[-1] in _NP_SYNC_FUNCS:
                self._emit("QFT003", node,
                           f"`{dotted}` forces a device→host copy inside "
                           f"{self._scope} serve/decode code")
            elif self._scope == "traced" and (
                    (dotted.split(".")[0] in ("np", "numpy")
                     and "random" in dotted.split(".")[1:])
                    or dotted.split(".")[0] == "random"):
                # np.random.<draw> / random.<draw> inside a step: a host draw
                # that the request's seed does not determine — tokens stop
                # being reproducible.  Device draws go through
                # core/sampling.py's per-slot counter hash.
                self._emit("QFT003", node,
                           f"host RNG `{dotted}` inside a step — the draw "
                           "does not follow the request's seed; sample on "
                           "the device (core/sampling.py)")
            elif self._scope == "traced" and isinstance(node.func, ast.Name) \
                    and node.func.id in ("int", "float") and len(node.args) == 1 \
                    and not isinstance(node.args[0], ast.Constant):
                self._emit("QFT003", node,
                           f"`{node.func.id}()` on a tensor forces a "
                           "device→host copy inside a step")

        # QFT005
        dotted = _dotted(node.func)
        if dotted:
            parts = dotted.split(".")
            tail2 = tuple(parts[-2:]) if len(parts) >= 2 else None
            if tail2 in _WALL_CLOCK:
                self._emit("QFT005", node,
                           f"wall-clock `{dotted}` in benchmarks — rows are "
                           "step-counted; confine wall time to wall_s columns")
            elif (len(parts) >= 2 and parts[0] in ("np", "numpy", "random")
                  and parts[-2] == "random"
                  and parts[-1] in _UNSEEDED_RANDOM):
                # np.random.RandomState / default_rng draws are exempt
                self._emit("QFT005", node,
                           f"unseeded `{dotted}` in benchmarks — draw from a "
                           "seeded RandomState/default_rng")

        self.generic_visit(node)


def lint_source(src: str, path: str,
                rules: Iterable[str] | None = None) -> list[Diagnostic]:
    """Lint one file's source.  ``path`` is repo-relative (used for rule
    path filters and diagnostics)."""
    active = set(rules) if rules is not None else set(RULES)
    active = {r for r in active
              if RULES[r].path_filter is None or RULES[r].path_filter(path)}
    if not active:
        return []
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Diagnostic(check="QFT000", message=f"syntax error: {e.msg}",
                           file=path, line=e.lineno or 1)]
    v = _Visitor(path, active)
    v.visit(tree)
    lines = src.splitlines()
    out = []
    for rule, lineno, col, msg in v.findings:
        suppressed = _noqa_rules(lines, lineno)
        if suppressed is None or rule in suppressed:
            continue
        out.append(Diagnostic(check=rule, message=msg, file=path,
                              line=lineno, col=col))
    out.sort(key=lambda d: (d.file or "", d.line or 0, d.check))
    return out


DEFAULT_LINT_ROOTS = ("src/repro_torch",)


def iter_py_files(root: Path, paths: Iterable[str]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        fp = root / p
        if fp.is_dir():
            files.extend(sorted(fp.rglob("*.py")))
        elif fp.suffix == ".py" and fp.exists():
            files.append(fp)
    return files


def lint_paths(root: Path, paths: Iterable[str] | None = None,
               rules: Iterable[str] | None = None) -> list[Diagnostic]:
    """Lint files under ``root`` (the repo root).  ``paths`` are
    root-relative files or directories; defaults to DEFAULT_LINT_ROOTS."""
    root = Path(root)
    diags: list[Diagnostic] = []
    for fp in iter_py_files(root, paths or DEFAULT_LINT_ROOTS):
        try:
            rel = fp.relative_to(root).as_posix()
        except ValueError:  # explicit --paths outside the repo root
            rel = fp.as_posix()
        try:
            src = fp.read_text()
        except OSError as e:
            diags.append(Diagnostic(check="QFT000", severity="warning",
                                    message=f"unreadable: {e}", file=rel))
            continue
        diags.extend(lint_source(src, rel, rules))
    return diags
