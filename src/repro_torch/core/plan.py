"""QuantPlan: every per-tensor quantization decision, resolved once.

``resolve_plan(qcfg, params)`` walks a quantized params tree (only shapes are
read) and maps every quantized tensor's path-qualified name
(``layers.mlp.down``; stacked subtrees are one tensor) to a frozen
:class:`TensorSpec`, through a chain of producers applied in order:

1. **default ladder** — role-based defaults (backbone linears at
   ``qcfg.w_bits``, ``lm_head`` at ``embed_bits``, ``fc`` at
   ``exempt_bits``, routers at ``router_bits``, embeddings at
   ``embed_bits``), with the group-∤-d_in single-group fallback resolved;
2. **§4 1 %-rule** — the smallest backbone tensors, accumulated until their
   weight memory reaches ``exempt_frac`` of the backbone, go to
   ``exempt_bits``;
3. **overrides** — ``qcfg.layout_overrides`` / ``qcfg.bits_overrides`` under
   a path-glob grammar.

The plan round-trips as JSON and rides inside exported artifacts as a uint8
leaf, so a served artifact carries its own decisions.  numpy and the
standard library only; the JSON is the JAX package's, byte for byte.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import warnings
from typing import Any, Callable

import numpy as np
import torch

from .policy import select_exempt_layers
from .qconfig import QLayout, QuantConfig

Params = dict[str, Any]

PLAN_KEY = "quant_plan"             # artifact leaf holding the JSON plan

# linear-name → stream-name that supplies S_wL (Eq. 2 tying; fan-out shares).
# Lives here (not serve/deploy) so plan resolution and export share one
# table without a core → serve import cycle.
STREAM_OF = {
    "wq": "in_stream", "wk": "in_stream", "wv": "in_stream",
    "wo": "out_stream",
    "up": "in_stream", "gate": "in_stream", "down": "act_stream",
    "router": "in_stream",
    "shared_up": "in_stream", "shared_gate": "in_stream",
    "shared_down": "shared_act_stream",
    "q_down": "in_stream", "kv_down": "in_stream",
    "q_up": "q_stream", "k_up": "kv_stream", "v_up": "kv_stream",
    "in_proj": "in_stream", "out_proj": "out_stream",
    "lm_head": "head_stream", "fc": "fc_stream",
    "frame_proj": None,
}
STREAM_KEYS = {"in_stream", "out_stream", "act_stream", "shared_act_stream",
               "q_stream", "kv_stream", "head_stream", "fc_stream"}


def _is_qlinear(node) -> bool:
    return isinstance(node, dict) and "w" in node and "log_swr" in node


def _is_qconv(node) -> bool:
    return isinstance(node, dict) and "w" in node and "log_f" in node


def _is_qembed(node) -> bool:
    return isinstance(node, dict) and "w" in node and "log_s" in node


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """One tensor's resolved quantization decisions (immutable plan row).

    ``layout`` is the *effectively resolved* layout string (after the
    group-∤-d_in single-group fallback), not the requested one;
    ``layout_fallback`` records that the fallback fired.  ``origin`` names
    the producer that last set the bits — the audit trail `repro plan`
    prints.
    """
    w_bits: int
    layout: str                        # effective QLayout str ("group:32", …)
    stream: str | None                 # S_wL-supplying stream name (Eq. 2)
    packed: bool                       # int4 nibble-packed in the artifact
    role: str                          # linear | conv | head | router | embed | kv
    shape: tuple[int, ...] = ()        # full param shape (incl. stacked axes)
    exempt: bool = False               # selected by the §4 1%-rule
    origin: str = "default"            # producer that decided the bits
    layout_fallback: bool = False

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 0


#: producer signature: (specs, ctx) -> specs (pure; return a new dict)
Producer = Callable[[dict[str, TensorSpec], "PlanContext"],
                    dict[str, TensorSpec]]


@dataclasses.dataclass
class PlanContext:
    """Read-only inputs shared by all producers during one resolution."""
    qcfg: QuantConfig
    model_cfg: Any = None
    fallbacks: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """path-qualified tensor name → TensorSpec, resolved once per run.

    The single API between config, the forward, export and serving:
    consumers look decisions up here instead of re-deriving them.  The
    forward (``models.forward(plan=)``) reads per-path fake-quant bits via
    :class:`PlanView`; export (``serve.deploy.export_for_layers``) reads bits
    and packing and embeds the serialized plan; serving
    (``Engine.from_artifact``) reconstructs it from the artifact leaf.

    Hashable (entries are a tuple) so it can ride inside the frozen
    :class:`serve.deploy.DeployPlan`.
    """
    entries: tuple = ()                # ((path, TensorSpec), ...)
    default_bits: int = 4              # fallback for paths outside the plan
    default_layout: str = "channel"

    def __post_init__(self):
        object.__setattr__(self, "_index", dict(self.entries))

    # ------------------------------------------------------------- lookups
    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)

    def __contains__(self, path: str) -> bool:
        return path in self._index

    @property
    def paths(self) -> tuple[str, ...]:
        return tuple(p for p, _ in self.entries)

    def spec(self, path: str) -> TensorSpec:
        try:
            return self._index[path]
        except KeyError:
            raise KeyError(f"{path!r} is not in the quant plan; known tensors:"
                           f" {', '.join(self.paths)}") from None

    def get(self, path: str, default=None):
        return self._index.get(path, default)

    def bits_for(self, path: str) -> int:
        spec = self._index.get(path)
        return self.default_bits if spec is None else spec.w_bits

    def is_packed(self, path: str) -> bool:
        spec = self._index.get(path)
        return False if spec is None else spec.packed

    def layout_for(self, path: str) -> str:
        spec = self._index.get(path)
        return self.default_layout if spec is None else spec.layout

    @property
    def exempt_names(self) -> frozenset:
        return frozenset(p for p, s in self.entries if s.exempt)

    # ------------------------------------------------------------ serialize
    def to_json(self, indent: int | None = None) -> str:
        return json.dumps({
            "version": 1,
            "default_bits": self.default_bits,
            "default_layout": self.default_layout,
            "specs": [[p, {**dataclasses.asdict(s),
                           "shape": list(s.shape)}] for p, s in self.entries],
        }, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "QuantPlan":
        doc = json.loads(text)
        entries = tuple(
            (p, TensorSpec(**{**d, "shape": tuple(d.get("shape", ()))}))
            for p, d in doc["specs"])
        return cls(entries=entries, default_bits=doc["default_bits"],
                   default_layout=doc["default_layout"])

    # ------------------------------------------------------------- display
    def describe(self) -> str:
        """The resolved table ``python -m repro_torch plan`` prints (the
        JAX package's, character for character)."""
        head = f"{'tensor':<28s} {'shape':<18s} bits layout      " \
               f"{'stream':<16s} pack role    origin"
        lines = [head, "-" * len(head)]
        for p, s in self.entries:
            layout = s.layout + ("!" if s.layout_fallback else "")
            lines.append(
                f"{p:<28s} {str(list(s.shape)):<18s} {s.w_bits:<4d} "
                f"{layout:<11s} {s.stream or '-':<16s} "
                f"{'y' if s.packed else '-':<4s} {s.role:<7s} {s.origin}")
        # same denominator the exemption rule budgets against: the backbone
        backbone = [s for _, s in self.entries
                    if s.role in ("linear", "conv", "router")]
        total = sum(s.size for s in backbone) or 1
        ex = sum(s.size for s in backbone if s.exempt)
        lines.append(f"# {len(self.entries)} tensors; exempt (1%-rule) "
                     f"backbone weight fraction: {ex / total:.4f}"
                     + ("; '!' = group layout fell back to a single group"
                        if any(s.layout_fallback for _, s in self.entries)
                        else ""))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# PlanView: the training forward's scoped lookup handle
# ---------------------------------------------------------------------------

class PlanView:
    """A :class:`QuantPlan` scoped to a path prefix — the lookup handle the
    plan-aware training forward threads through its call tree.

    The transformer forward is compositional (``models.forward`` → layer
    block → attention/MLP/MoE/SSM module → ``dof.qlinear``), so each level
    narrows the view with :meth:`child` instead of threading dotted path
    strings.  Lookups are plain-Python dict reads that return ints, and a
    stacked subtree (``layers``) keeps its single-path semantics: one
    ``PlanView("layers")`` covers every stacked layer.

    A view over ``plan=None`` is inert: :meth:`bits` returns the caller's
    ``default`` and :meth:`child` returns ``self``, reproducing the pre-plan
    role-ladder forward exactly (teacher forwards, legacy callers).
    """
    __slots__ = ("plan", "prefix")

    def __init__(self, plan: "QuantPlan | None", prefix: tuple = ()):
        self.plan = plan
        self.prefix = prefix

    def child(self, *names: str) -> "PlanView":
        """Narrow the view to a subtree, e.g. ``pv.child("layers", "mlp")``."""
        if self.plan is None:
            return self
        return PlanView(self.plan, self.prefix + names)

    def bits(self, name: str, default: int | None = None) -> int | None:
        """Static fake-quant bits for ``<prefix>.<name>``.

        With a plan this is exactly ``plan.bits_for(path)`` — the same
        lookup ``serve.deploy.export_for_layers`` does, which is what makes
        the training grid the deployment grid.  Without a plan it returns
        ``default`` (``None`` → ``qcfg.w_bits`` inside ``dof.qlinear``).
        """
        if self.plan is None:
            return default
        return self.plan.bits_for(".".join(self.prefix + (name,)))


def plan_view(plan) -> PlanView:
    """Normalize ``QuantPlan | PlanView | None`` to a :class:`PlanView`.

    Every plan-aware forward entry point calls this on its ``plan`` argument,
    so callers may hand over a resolved plan, an already-scoped view, or
    nothing at all.
    """
    if isinstance(plan, PlanView):
        return plan
    return PlanView(plan)


# ---------------------------------------------------------------------------
# Path-glob override grammar
# ---------------------------------------------------------------------------

def glob_match(pattern: str, path: str) -> bool:
    """fnmatch over the dotted path; a pattern without ``.`` also matches the
    bare tensor name (backwards compat with the old bare-name tuples)."""
    if fnmatch.fnmatchcase(path, pattern):
        return True
    return "." not in pattern and fnmatch.fnmatchcase(
        path.rsplit(".", 1)[-1], pattern)


# ---------------------------------------------------------------------------
# Tree walk: every quantized tensor, path-qualified
# ---------------------------------------------------------------------------

def iter_quantized(tree, prefix: tuple = ()):
    """Yield (path tuple, kind, node) for every quantized tensor.

    Only ``.shape`` is read downstream.  The tree must be a *student* tree
    (teacher trees carry no scale DoF, so nothing is quantized there).
    """
    if isinstance(tree, dict):
        if _is_qlinear(tree):
            yield prefix, "linear", tree
            return
        if _is_qembed(tree):
            yield prefix, "embed", tree
            return
        if _is_qconv(tree):
            yield prefix, "conv", tree
            return
        for k, v in tree.items():
            if k in STREAM_KEYS or k == PLAN_KEY:
                continue
            yield from iter_quantized(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_quantized(v, prefix + (str(i),))


def _effective_layout(layout: QLayout, d_in: int) -> tuple[QLayout, bool]:
    """Resolve the group-∤-d_in single-group fallback (QLayout.n_groups)."""
    if layout.kind == "group" and d_in % layout.group != 0:
        return QLayout("group", d_in), True
    return layout, False


def _norm_packed(spec: TensorSpec) -> TensorSpec:
    """packed is derived state: 4-bit + even packing axis, never embeddings."""
    packed = (spec.role != "embed" and spec.w_bits == 4
              and len(spec.shape) >= 2 and spec.shape[-2] % 2 == 0)
    if packed == spec.packed:
        return spec
    return dataclasses.replace(spec, packed=packed)


# ---------------------------------------------------------------------------
# Producers
# ---------------------------------------------------------------------------

def default_ladder(params) -> Producer:
    """Role-based defaults — the one place bare names resolve to roles."""

    def produce(specs: dict[str, TensorSpec], ctx: PlanContext):
        qcfg = ctx.qcfg
        out = dict(specs)
        for path, kind, node in iter_quantized(params):
            dotted = ".".join(path)
            name = path[-1]
            shape = tuple(int(d) for d in node["w"].shape)
            if kind == "embed":
                out[dotted] = TensorSpec(
                    w_bits=qcfg.embed_bits, layout="row", stream=None,
                    packed=False, role="embed", shape=shape)
                continue
            if kind == "conv":
                out[dotted] = TensorSpec(
                    w_bits=qcfg.w_bits,
                    layout="channel" if qcfg.swr_per_channel else "layerwise",
                    stream=None, packed=False, role="conv", shape=shape)
                continue
            if name == "lm_head":
                bits, role = qcfg.embed_bits, "head"
            elif name == "fc":
                bits, role = qcfg.exempt_bits, "head"
            elif name == "router":
                moe = getattr(ctx.model_cfg, "moe", None)
                bits = getattr(moe, "router_bits", qcfg.exempt_bits)
                role = "router"
            else:
                bits, role = qcfg.w_bits, "linear"
            layout, fell = _effective_layout(qcfg.layout, shape[-2])
            if fell:
                ctx.fallbacks.append((dotted, str(qcfg.layout), str(layout)))
            out[dotted] = TensorSpec(
                w_bits=bits, layout=str(layout), stream=STREAM_OF.get(name),
                packed=False, role=role, shape=shape, layout_fallback=fell)
        return {p: _norm_packed(s) for p, s in out.items()}

    return produce


def exemption_rule(specs: dict[str, TensorSpec],
                   ctx: PlanContext) -> dict[str, TensorSpec]:
    """The *wired* §4 1%-rule: smallest backbone tensors → exempt_bits.

    Backbone = linears, convs and routers (heads/embeddings have their own
    role precision).  Sizes are whole-tensor (stacked axes included), so a
    layer-stacked tensor is one all-layers decision — matching what one spec
    per stacked path can express.
    """
    qcfg = ctx.qcfg
    if qcfg.exempt_frac <= 0:
        return specs
    sizes = {p: s.size for p, s in specs.items()
             if s.role in ("linear", "conv", "router")}
    chosen = select_exempt_layers(sizes, qcfg)
    out = {}
    for p, s in specs.items():
        if p in chosen:
            s = _norm_packed(dataclasses.replace(
                s, w_bits=qcfg.exempt_bits, exempt=True, origin="exempt-1%"))
        out[p] = s
    return out


def apply_overrides(specs: dict[str, TensorSpec],
                    ctx: PlanContext) -> dict[str, TensorSpec]:
    """qcfg.layout_overrides / qcfg.bits_overrides under the path-glob
    grammar; first matching pattern wins (same rule as QuantConfig.layout_for
    so init-time and resolution-time agree on bare-name patterns).

    Overrides that land nowhere warn instead of vanishing: a typo'd glob, or
    a layout override aimed at a conv (convs carry the paper's per-cout
    ``log_f``, not a QLayout'd ``log_swr``), must not be mistaken for applied.
    """
    qcfg = ctx.qcfg
    bits_overrides = getattr(qcfg, "bits_overrides", ())
    # counters keyed by POSITION, not pattern: with first-match-wins, a
    # duplicated glob's second entry is dead and must still warn
    applied = {("layout", i): 0 for i in range(len(qcfg.layout_overrides))}
    applied.update({("bits", i): 0 for i in range(len(bits_overrides))})
    out = {}
    for path, s in specs.items():
        for i, (pat, layout) in enumerate(qcfg.layout_overrides):
            if glob_match(pat, path):
                applied[("layout", i)] += 1
                if s.role not in ("linear", "head", "router"):
                    warnings.warn(
                        f"layout override {pat!r} matches {path} "
                        f"(role {s.role}), which has no QLayout'd log_swr; "
                        f"ignored", UserWarning, stacklevel=4)
                    break
                eff, fell = _effective_layout(QLayout.parse(layout),
                                              s.shape[-2])
                if fell:
                    ctx.fallbacks.append((path, str(QLayout.parse(layout)),
                                          str(eff)))
                s = dataclasses.replace(s, layout=str(eff),
                                        layout_fallback=fell)
                break
        for i, (pat, bits) in enumerate(bits_overrides):
            if glob_match(pat, path):
                applied[("bits", i)] += 1
                if s.role == "embed":
                    # embeddings quantize at qcfg.embed_bits everywhere
                    # (forward + export); a plan row claiming otherwise would
                    # describe an artifact that is never produced
                    warnings.warn(
                        f"bits override {pat!r} matches embedding {path}; "
                        f"ignored — set qcfg.embed_bits instead",
                        UserWarning, stacklevel=4)
                    break
                # an explicit override supersedes the 1%-rule selection, so
                # the exempt flag (and everything reporting it) is cleared
                s = _norm_packed(dataclasses.replace(
                    s, w_bits=int(bits), origin="override", exempt=False))
                break
        out[path] = s
    all_overrides = {("layout", i): pat for i, (pat, _)
                     in enumerate(qcfg.layout_overrides)}
    all_overrides.update({("bits", i): pat for i, (pat, _)
                          in enumerate(bits_overrides)})
    unmatched = [f"{kind} override {all_overrides[kind, i]!r}"
                 for (kind, i), n in applied.items() if n == 0]
    if unmatched:
        warnings.warn(
            f"{'; '.join(unmatched)} matched no plan tensor — a duplicate "
            f"or typo'd glob (known: {', '.join(specs)})",
            UserWarning, stacklevel=4)
    return out


def make_sensitivity_producer(scores: dict[str, float], sensitive_bits: int,
                              top_frac: float = 0.1) -> Producer:
    """Example pluggable producer: keep the ``top_frac`` most sensitive
    backbone tensors (by caller-supplied score, e.g. Hessian trace) at
    ``sensitive_bits`` — the drop-in shape Sensitivity-Aware PTQ / EPTQ
    orderings plug into."""

    def produce(specs: dict[str, TensorSpec], ctx: PlanContext):
        ranked = sorted((p for p in specs if p in scores),
                        key=lambda p: -scores[p])
        keep = set(ranked[: max(int(len(ranked) * top_frac), 1)])
        return {p: (_norm_packed(dataclasses.replace(
                        s, w_bits=sensitive_bits, origin="sensitivity"))
                    if p in keep else s)
                for p, s in specs.items()}

    return produce


# ---------------------------------------------------------------------------
# Resolution entry point
# ---------------------------------------------------------------------------

#: families whose serve cache is the standard ``{"k","v","pos"}`` slot-KV
#: layout — the ones that get a ``kv_cache`` plan entry (and the paged int8
#: cache at serve time).  ssm has no length-indexed cache, hybrid nests its
#: attention cache, mla_moe caches compressed latents, encdec has no
#: serving path.
KV_CACHE_FAMILIES = ("dense", "moe", "vlm")


def resolve_plan(qcfg: QuantConfig, params, model_cfg=None,
                 producers: tuple = ()) -> QuantPlan:
    """(QuantConfig, student params tree) → QuantPlan, via the producer chain.

    Only shapes are read.  ``model_cfg`` supplies family knobs some
    producers read (MoE router bits).  Extra ``producers`` run after the
    built-in chain (default ladder → §4 1%-rule → path-glob overrides) and
    may re-assign bits/layouts freely — the sensitivity-guided
    mixed-precision hook (:func:`make_sensitivity_producer`).  Resolve
    **once** per run and hand the same object to the forward, export and
    serving; resolving twice from different skeletons is how grids silently
    diverge.
    """
    ctx = PlanContext(qcfg=qcfg, model_cfg=model_cfg)
    specs: dict[str, TensorSpec] = {}
    for produce in (default_ladder(params), exemption_rule, apply_overrides,
                    *producers):
        specs = produce(specs, ctx)
    # report only fallbacks still live in the FINAL specs (an override that
    # replaced a fallen-back default layout retires its record); last record
    # per path wins when both the default and an override fell back
    live = {}
    for p, req, eff in ctx.fallbacks:
        s = specs.get(p)
        if s is not None and s.layout_fallback and s.layout == eff:
            live[p] = (p, req, eff)
    if live:
        detail = "; ".join(f"{p}: {req} -> {eff}"
                           for p, req, eff in live.values())
        warnings.warn(
            f"group layout does not divide d_in for {len(live)} "
            f"tensor(s); fell back to a single group ({detail})",
            UserWarning, stacklevel=2)
    # the serve-time KV stream is a tensor class like any other: families
    # with the standard slot-KV cache get a plan entry.  The
    # "slot-head" layout names the scale granularity (per-slot × per-kv-head,
    # MMSE-fitted at slot install); shape is serve-time (depends on
    # max_slots), so it stays ().
    if (getattr(qcfg, "kv_bits", 0) and model_cfg is not None
            and getattr(model_cfg, "family", None) in KV_CACHE_FAMILIES):
        specs["kv_cache"] = TensorSpec(
            w_bits=qcfg.kv_bits, layout="slot-head", stream=None,
            packed=False, role="kv", origin="kv-cache")
    return QuantPlan(entries=tuple(specs.items()),
                     default_bits=qcfg.w_bits,
                     default_layout=str(qcfg.layout))


def apply_plan(tree: Params, plan: QuantPlan) -> Params:
    """Reconcile a freshly initialized student with the resolved plan.

    ``init_qlinear`` resolves bare-name layout overrides, but path-glob
    overrides (and producer-assigned layouts) are only known after
    resolution; this pass re-shapes any ``log_swr`` whose layout disagrees
    with the plan.  Values are a constant fill (the mean of the old leaf) —
    the MMSE init stage refits them right after.
    """
    def walk(node, prefix: tuple):
        if isinstance(node, dict):
            if _is_qlinear(node):
                spec = plan.get(".".join(prefix))
                if spec is None or spec.role == "conv":
                    return node
                w = node["w"]
                layout = QLayout.parse(spec.layout)
                want = tuple(w.shape[:-2]) + tuple(
                    layout.swr_shape(w.shape[-2], w.shape[-1]))
                old = node["log_swr"]
                if tuple(old.shape) == want:
                    return node
                return {**node, "log_swr": torch.full(
                    want, float(torch.mean(old)), dtype=torch.float32,
                    device=old.device)}
            return {k: v if k in STREAM_KEYS else walk(v, prefix + (k,))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        return node

    return walk(tree, ())


# ---------------------------------------------------------------------------
# Artifact embedding (JSON as a uint8 leaf)
# ---------------------------------------------------------------------------

def plan_to_array(plan: QuantPlan, device=None) -> torch.Tensor:
    """The plan's JSON as a uint8 tensor (the artifact leaf)."""
    raw = np.frombuffer(plan.to_json().encode(), np.uint8).copy()
    return torch.from_numpy(raw).to(device)


def plan_from_array(arr) -> QuantPlan:
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    return QuantPlan.from_json(bytes(np.asarray(arr, np.uint8)).decode())
