"""Layer 1: the trace-time invariant analyzer over the port.

Every check traces a *real* step constructor (the same
``make_slot_decode_step`` / ``make_prefill_step`` / ``make_train_step`` the
engine and the trainer run) with ``make_fx`` over fake tensors
(``FakeTensorMode``), then walks the FX graph.  Nothing is allocated and
nothing runs, and no card is needed, so the whole registry is checked in
seconds on a CPU.  The counterparts of the JAX package's jaxpr walk:

- a kernel launch is one node: every CUDA entry is a ``torch.library``
  operator (``kernels/_library.py``), which the trace records whole, as a
  jaxpr records ``pallas_call``;
- a host-transfer surface is an ``aten._local_scalar_dense`` (``.item()``)
  or a device→host copy; data-dependent host control flow that stops the
  trace counts as one too;
- an int→float convert of a tensor of ndim ≥ 2 that feeds a product
  (``mm``/``bmm``/``einsum``, …) through element-wise or layout ops is a
  dequant-dot violation.

The fake tensors lie on the meta device, where they take the kernels'
route as CUDA tensors do (``_library.on_card``): a CPU build of torch
refuses fake CUDA tensors in the autograd engine and in some operators
(``~`` on a bool tensor), and the graph is the same.

The invariants (the JAX package's ten check ids and severities):

one-transfer     The decode step has exactly ONE host-transfer surface: the
                 engine's fetch of (emitted, emit, done).  Any ``.item()``
                 or device→host copy inside the step is an extra sync.
int8dot          On the serve path the integer weight is the product's
                 operand: no int→float convert of a weight-shaped tensor
                 feeds a product.  Checked per distinct weight signature
                 through ``kernels.ops.qlinear_deployed`` (the int4 kernel
                 and K1's int8 entry are nodes with integer operands).  An
                 int4 shape the kernel does not tile takes the plain
                 version, reported as a skip, never silently passed.  The
                 plain route of an int8 leaf (``use_kernels`` False, and
                 CPU tensors) widens the weight to f32 and is not held
                 here: see check_int8dot.
prefill-recompile  Attention families pad prompt chunks to a fixed menu
                 (serve/kv_cache.prefill_buckets): the program surface is
                 ``len(menu)``; SSM families keep exact-length chunks and
                 report ``min(prefill_chunk, max_len)`` as info.
plan-coverage    Every quantized site of the init tree resolves through the
                 QuantPlan path table; a standard-KV family's plan carries
                 the ``kv_cache`` entry.
kernel-route     ``decode_route`` × ``_attn_layer_count`` predict whether
                 the decode graph holds a kernel node; the traced graph
                 must agree with and without the kernels.
kv-cache         The traced decode cache agrees with the plan's KV entry:
                 int8 page pools + per-slot scales + an int32 page table
                 when the plan says int8 KV.
kv-fused         KV quant/dequant stays fused: no float tensor at the page
                 pool's footprint, no ``mul`` at cache extent; at least one
                 int8 page read (a gather, or the paged kernel reading the
                 pools through the page table).
kv-page-table    The decode graph reads pages through the page table and
                 scatters the new token into the int8 pools.
train-step       ``make_train_step`` traces under the resolved plan with no
                 host-transfer surface.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException,
                                           FakeTensorMode)
from torch.fx.experimental.proxy_tensor import make_fx
from torch.fx.experimental.symbolic_shapes import GuardOnDataDependentSymNode

from ..configs import registry
from ..core.plan import KV_CACHE_FAMILIES, iter_quantized
from ..core.qconfig import QuantConfig
from ..kernels._library import kernel_of
from ..kernels.ops import qlinear_deployed
from ..models import init_cache, init_model
from ..models.attention import decode_route
from ..optim.adam import Adam
from ..serve.deploy import abstract_deploy_surfaces, find_exported_linears
from ..serve.engine import (ServeConfig, _attn_layer_count,
                            serve_trace_surfaces)
from ..serve.kv_cache import BUCKETED_PREFILL_FAMILIES, prefill_buckets
from ..train.steps import abstract_train_state, make_train_step
from .report import Diagnostic

#: the fake tensors' device: the kernels' route without a card
TRACE_DEVICE = "meta"

# ---------------------------------------------------------------------------
# tracing and graph walking (shared with the injection tests)
# ---------------------------------------------------------------------------

_UNTRACEABLE = (DataDependentOutputException, DynamicOutputShapeException,
                GuardOnDataDependentSymNode)

#: products a dequantized weight may feed
_DOTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "mv",
                   "addmv", "dot", "einsum", "linear", "_scaled_mm"})
#: converts: the int→float edge the int8dot walker looks for
_CONVERTS = frozenset({"_to_copy", "to", "convert_element_type", "type_as"})
#: element-wise / layout ops a dequantized weight flows through on its way
#: into a product — the provenance chain the int8dot walker follows
_PASSTHROUGH = frozenset({
    "mul", "add", "sub", "div", "neg", "expand", "expand_as", "view",
    "reshape", "_unsafe_view", "permute", "transpose", "t", "squeeze",
    "unsqueeze", "slice", "select", "cat", "flip", "clone", "contiguous",
    "alias", "broadcast_to", "repeat", "copy", "_reshape_alias",
})
_GATHERS = frozenset({"index", "index_select", "gather", "take"})
_SCATTERS = frozenset({"index_put", "index_put_", "_index_put_impl_",
                       "scatter", "scatter_", "index_copy", "index_copy_",
                       "_unsafe_index_put"})


@dataclasses.dataclass
class Trace:
    """One traced step: its graph, or why it could not be traced (a
    data-dependent host read stopped it — itself a transfer surface)."""
    graph: torch.fx.Graph | None
    untraceable: str | None = None

    def nodes(self):
        if self.graph is None:
            return []
        return [n for n in self.graph.nodes if n.op == "call_function"]


def _fake(tree, device):
    """A tree of fresh fake tensors (inside the active FakeTensorMode) with
    the shapes, strides and dtypes of ``tree``'s tensors."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tuple(tree.shape), tuple(tree.stride()),
                                   dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: _fake(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fake(v, device) for v in tree)
    return tree


def trace(fn: Callable, *args, device: str = TRACE_DEVICE) -> Trace:
    """``make_fx`` of ``fn`` over fake tensors on ``device`` shaped like
    ``args`` (shape-only trees, e.g. on the meta device; other leaves pass
    as constants, and so do the meta tensors ``fn`` closes over)."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fake_args = [_fake(a, device) for a in args]
    try:
        gm = make_fx(fn, tracing_mode="fake")(*fake_args)
    except _UNTRACEABLE as e:
        return Trace(None, f"{type(e).__name__}: {str(e)[:200]}")
    return Trace(gm.graph)


def op_name(node) -> str:
    """The ATen name of a node's operator (``mm``, ``_to_copy``, ...)."""
    return getattr(node.target, "_opname", "") or str(node.target)


def node_val(node):
    """A node's fake value (its shape, dtype and device), or None."""
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None



def _is_int(t) -> bool:
    return isinstance(t, torch.Tensor) and not t.is_floating_point() \
        and not t.is_complex() and t.dtype != torch.bool


def _host_copy(node) -> bool:
    """A device→host copy: a ``_to_copy``/``copy_`` whose result lies on
    the CPU and whose source does not."""
    name = op_name(node)
    if name not in ("_to_copy", "to", "copy", "copy_"):
        return False
    out, src = node_val(node), node_val(node.args[0] if name != "copy_"
                                 else node.args[1])
    if name == "copy_":
        out = node_val(node.args[0])
    return (isinstance(out, torch.Tensor) and isinstance(src, torch.Tensor)
            and out.device.type == "cpu" and src.device.type != "cpu")


def callback_count(tr: Trace) -> int:
    """Host reads inside the step: ``.item()``, device→host copies, and a
    data-dependent read that stopped the trace."""
    n = 0 if tr.graph is not None else 1
    for node in tr.nodes():
        if op_name(node) == "_local_scalar_dense" or _host_copy(node):
            n += 1
    return n


def transfer_surfaces(tr: Trace) -> int:
    """Host-transfer surfaces of one step: the engine's single output fetch
    plus every host read inside the step."""
    return 1 + callback_count(tr)


def kernel_nodes(tr: Trace) -> list[str]:
    """The kernels the graph launches, one entry per node."""
    return [k for k in (kernel_of(n.target) for n in tr.nodes()) if k]


def integer_operand_count(tr: Trace) -> int:
    """Products (and kernel nodes) with an integer operand of ndim ≥ 2 —
    the non-vacuity witness for the int8dot invariant."""
    n = 0
    for node in tr.nodes():
        if op_name(node) in _DOTS or kernel_of(node.target):
            if any(_is_int(node_val(a)) and node_val(a).ndim >= 2
                   for a in node.all_input_nodes):
                n += 1
    return n


def _dequant_chain(node, depth: int = 0) -> str | None:
    """Walk one product operand's provenance back through element-wise and
    layout ops; report the first int→float convert on an ndim ≥ 2 tensor."""
    if depth > 64 or not isinstance(node, torch.fx.Node) \
            or node.op != "call_function":
        return None
    name = op_name(node)
    if name in _CONVERTS and node.args:
        src = node.args[0]
        sv, dv = node_val(src), node_val(node)
        if (_is_int(sv) and isinstance(dv, torch.Tensor)
                and dv.is_floating_point() and sv.ndim >= 2):
            return (f"{name} {str(sv.dtype)[6:]}->{str(dv.dtype)[6:]} on "
                    f"shape {tuple(sv.shape)} feeds a product")
        return _dequant_chain(src, depth + 1)
    if name in _PASSTHROUGH:
        for a in node.all_input_nodes:
            v = node_val(a)
            if isinstance(v, torch.Tensor) and v.ndim >= 2:
                hit = _dequant_chain(a, depth + 1)
                if hit:
                    return hit
    return None           # a real compute producer — not a dequant chain


def dequant_dot_violations(tr: Trace) -> list[str]:
    """Every product fed by a materialised int→float weight dequant."""
    out: list[str] = []
    for node in tr.nodes():
        if op_name(node) not in _DOTS:
            continue
        for a in node.all_input_nodes:
            hit = _dequant_chain(a)
            if hit:
                out.append(hit)
    return out


# ---------------------------------------------------------------------------
# per-config checks
# ---------------------------------------------------------------------------

#: the analyzer's serving geometry: small enough to trace fast, a max_len
#: of whole pages, and a prefill surface that stays readable in reports
ANALYZER_SCFG = dict(max_slots=4, max_len=256, prefill_chunk=32)


def check_decode_transfers(arch: str, decode: Trace) -> list[Diagnostic]:
    n = transfer_surfaces(decode)
    if n != 1:
        why = f" ({decode.untraceable})" if decode.untraceable else ""
        return [Diagnostic(
            check="trace.one-transfer", config=arch, value=n,
            message=f"decode step has {n} host-transfer surfaces "
                    f"({n - 1} host read(s) beyond the output fetch){why}; "
                    "the serve loop budget is exactly one")]
    return [Diagnostic(check="trace.one-transfer", config=arch,
                       severity="info", value=1,
                       message="decode step: one host-transfer surface")]


def _routes(cfg, scfg: ServeConfig) -> bool:
    """Whether a routed decode step sends attention to the kernel:
    ``_attn_layer_count`` (no attention, no route) then ``decode_route``."""
    return _attn_layer_count(cfg) > 0 and decode_route(cfg, scfg.max_len,
                                                       True)


def check_kernel_route(arch: str, cfg, scfg: ServeConfig, deployed,
                       plan, decode: Trace | None = None) -> list[Diagnostic]:
    """``decode``: the decode step already traced under ``plan``'s route,
    reused for that route."""
    diags = []
    routed_nodes = 0
    for routed in (False, True):
        if decode is not None and routed == plan.use_kernels:
            tr = decode
        else:
            p = dataclasses.replace(plan, use_kernels=routed)
            s = serve_trace_surfaces(cfg, plan=p, scfg=scfg)
            tr = trace(s["decode_fn"], deployed, s["cache"], s["state"])
        nodes = [k for k in kernel_nodes(tr) if k == "decode_attention"]
        actual = bool(kernel_nodes(tr))
        expected = routed and _routes(cfg, scfg)
        if routed:
            routed_nodes = len(nodes)
        if actual != expected:
            diags.append(Diagnostic(
                check="trace.kernel-route", config=arch,
                value={"use_kernels": routed, "expected": expected,
                       "actual": actual},
                message=f"decode_route predicts a kernel node={expected} "
                        f"(use_kernels={routed}) but the traced decode graph "
                        f"has one={actual}"))
    if not diags:
        diags.append(Diagnostic(
            check="trace.kernel-route", config=arch, severity="info",
            value={"decode_route": _routes(cfg, scfg),
                   "decode_attention_nodes": routed_nodes},
            message="decode_route prediction matches the traced graph "
                    f"(routed and unrouted; {routed_nodes} decode_attention "
                    "node(s) a routed step)"))
    return diags


def check_prefill_recompile(arch: str, cfg, surfaces: dict,
                            budget: int | None = None) -> list[Diagnostic]:
    scfg = surfaces["scfg"]
    bucketed = cfg.family in BUCKETED_PREFILL_FAMILIES
    if bucketed:
        menu = prefill_buckets(scfg.prefill_chunk)
        count = len(menu)
        trace_lens = sorted({menu[0], menu[-1]})
    else:
        # SSM fallback: a recurrence consumes pad frames, so chunks stay
        # exact-length — one program per distinct remainder (documented)
        count = min(scfg.prefill_chunk, scfg.max_len)
        trace_lens = sorted({scfg.prefill_chunk, 1})
    diags = []
    cache = init_cache(cfg, 1, scfg.max_len, device="meta")
    # the scheme traces at the menu extremes (bucketed) or at the
    # steady-state chunk and a remainder length (exact-length)
    for L in trace_lens:
        batch = {"tokens": torch.empty((1, L), dtype=torch.int64,
                                       device="meta")}
        if bucketed:
            tr = trace(surfaces["prefill_bucketed_fn"], surfaces["deployed"],
                       cache, batch, L)
        else:
            tr = trace(surfaces["prefill_fn"], surfaces["deployed"], cache,
                       batch)
        cb = callback_count(tr)
        if cb:
            diags.append(Diagnostic(
                check="trace.prefill-recompile", config=arch, value=cb,
                message=f"prefill step (chunk len {L}) has {cb} host "
                        "read(s) — prefill must be sync-free"))
    # the bucketed budget is the menu itself — any extra program is a bug;
    # the exact-length fallback keeps the lenient documented cap
    cap = budget if budget is not None else \
        (count if bucketed else scfg.prefill_chunk)
    sev = "error" if count > cap else "info"
    if bucketed:
        msg = (f"prefill pads to a fixed {count}-bucket menu {menu} "
               f"(prefill_chunk={scfg.prefill_chunk}; real_len is an "
               f"argument)")
    else:
        msg = (f"prefill runs ≤ {count} distinct chunk-length "
               f"programs (exact-length SSM fallback; "
               f"prefill_chunk={scfg.prefill_chunk}, "
               f"max_len={scfg.max_len})")
    diags.append(Diagnostic(
        check="trace.prefill-recompile", config=arch, severity=sev,
        value=count,
        message=msg + (f" — exceeds budget {cap}" if sev == "error" else "")))
    return diags


def check_plan_coverage(arch: str, cfg, qcfg, plan) -> list[Diagnostic]:
    qplan = plan.quant_plan
    if qplan is None:
        return [Diagnostic(check="trace.plan-coverage", config=arch,
                           message="DeployPlan carries no resolved "
                                   "QuantPlan — legacy shim path")]
    params = init_model(0, cfg, qcfg, device="meta")
    tree_paths = {".".join(p) for p, _kind, _n in iter_quantized(params)}
    plan_paths = set(qplan.paths)
    diags = []
    # the KV cache is a serve-time tensor class, not an init-tree site —
    # expected exactly for the standard-KV families (never "stale")
    expects_kv = bool(getattr(qcfg, "kv_bits", 0)) \
        and cfg.family in KV_CACHE_FAMILIES
    has_kv = "kv_cache" in plan_paths
    plan_paths.discard("kv_cache")
    if expects_kv and not has_kv:
        diags.append(Diagnostic(
            check="trace.plan-coverage", config=arch, value="kv_cache",
            message="standard-KV family with kv_bits set, but the resolved "
                    "plan has no `kv_cache` entry — the serve cache would "
                    "silently stay in the activation dtype"))
    elif has_kv and not expects_kv:
        diags.append(Diagnostic(
            check="trace.plan-coverage", config=arch, severity="warning",
            value="kv_cache",
            message=f"plan entry `kv_cache` but family {cfg.family} has no "
                    "standard slot-KV cache to quantize"))
    for missing in sorted(tree_paths - plan_paths):
        diags.append(Diagnostic(
            check="trace.plan-coverage", config=arch, value=missing,
            message=f"quantized site `{missing}` is absent from the "
                    f"resolved plan — bits_for would silently fall back "
                    f"to default_bits={qplan.default_bits}"))
    for stale in sorted(plan_paths - tree_paths):
        diags.append(Diagnostic(
            check="trace.plan-coverage", config=arch, severity="warning",
            value=stale,
            message=f"plan entry `{stale}` matches no site in the init "
                    "tree (stale override?)"))
    if not diags:
        diags.append(Diagnostic(
            check="trace.plan-coverage", config=arch, severity="info",
            value=len(tree_paths),
            message=f"all {len(tree_paths)} quantized sites resolve "
                    "through the plan path table"
                    + (" (+ kv_cache tensor class)" if has_kv else "")))
    return diags


#: the KV-cache rule family — skipped together for non-standard-KV configs
_KV_CHECKS = ("trace.kv-cache", "trace.kv-fused", "trace.kv-page-table")


def _pages_read(node) -> bool:
    """A node that reads int8 KV pages: a gather producing int8 of ndim ≥ 4,
    or the paged decode kernel reading the pools through the page table."""
    if kernel_of(node.target) == "decode_attention":
        ins = [node_val(a) for a in node.all_input_nodes]
        return (any(isinstance(v, torch.Tensor) and v.dtype == torch.int8
                    for v in ins)
                and any(isinstance(v, torch.Tensor) and v.dtype == torch.int32
                        and v.ndim == 2 for v in ins))
    out = node_val(node)
    return (op_name(node) in _GATHERS and isinstance(out, torch.Tensor)
            and out.dtype == torch.int8 and out.ndim >= 4)


def _token_written(node) -> bool:
    out = node_val(node)
    return (op_name(node) in _SCATTERS and isinstance(out, torch.Tensor)
            and out.dtype == torch.int8)


def check_kv_cache(arch: str, cfg, surfaces: dict, plan) -> list[Diagnostic]:
    """The three KV rules over the decode trace the one-transfer check
    proves (so the scale leaves demonstrably ride the single transfer)."""
    if cfg.family not in KV_CACHE_FAMILIES:
        return [Diagnostic(
            check=c, config=arch, severity="skip",
            message=f"{cfg.family} keeps the monolithic slot cache (no "
                    "standard KV layout to page/quantize)")
            for c in _KV_CHECKS]
    kv, cache = surfaces["kv"], surfaces["cache"]
    qplan = plan.quant_plan
    entry = qplan.get("kv_cache") if qplan is not None else None
    paged = (kv is not None
             and getattr(cache.get("k"), "dtype", None) == torch.int8
             and {"k_scale", "v_scale", "pt"} <= set(cache))
    wants_int8 = entry is not None and entry.w_bits == 8
    if wants_int8 != paged:
        return [Diagnostic(
            check="trace.kv-cache", config=arch,
            value={"plan_kv_bits": None if entry is None else entry.w_bits,
                   "cache_paged_int8": paged},
            message="plan and traced cache disagree: plan says "
                    f"{'int8' if wants_int8 else 'no'} KV quantization but "
                    f"the decode cache is "
                    f"{'paged int8' if paged else 'monolithic float'} — "
                    "a silent precision fallback")] + [
            Diagnostic(check=c, config=arch, severity="skip",
                       message="skipped: kv-cache plan/trace mismatch")
            for c in _KV_CHECKS[1:]]
    if not paged:
        return [Diagnostic(
            check=c, config=arch, severity="skip",
            message="KV quantization disabled (kv_bits=0 or monolithic "
                    "mode) — plan and cache agree")
            for c in _KV_CHECKS]
    diags = [Diagnostic(
        check="trace.kv-cache", config=arch, severity="info",
        value={"kv_bits": entry.w_bits, "page_size": kv.page_size,
               "n_pages": kv.n_pages},
        message="plan kv_cache entry matches traced cache: int8 page pools"
                " + per-slot scales + int32 page table, all leaves of the "
                "one-transfer decode step")]
    P = kv.page_size
    Hkv, hd = int(cache["k"].shape[-2]), int(cache["k"].shape[-1])
    fused_viol: list[str] = []
    reads = writes = 0
    for node in surfaces["decode_trace"].nodes():
        name = op_name(node)
        reads += _pages_read(node)
        writes += _token_written(node)
        v = node_val(node)
        if not isinstance(v, torch.Tensor) or not v.is_floating_point():
            continue
        shp = tuple(v.shape)
        if len(shp) >= 4 and shp[-3:] == (P, Hkv, hd):
            fused_viol.append(
                f"{name} produces float {shp} at page-pool footprint "
                "— a materialized dequantized KV pool")
        elif (name == "mul" and len(shp) >= 4
              and shp[-2:] == (Hkv, hd) and shp[-3] >= P):
            fused_viol.append(
                f"mul produces float {shp} at cache extent — scales "
                "must fold into q (pre-dot) and context (post-dot), "
                "never into the gathered KV")
    if fused_viol:
        diags.extend(Diagnostic(check="trace.kv-fused", config=arch,
                                value=m.split(" ")[0], message=m)
                     for m in fused_viol[:4])
    elif reads == 0:
        diags.append(Diagnostic(
            check="trace.kv-fused", config=arch, value=0,
            message="no int8 page read in the decode graph — the fused "
                    "quant/dequant check would be vacuous"))
    else:
        diags.append(Diagnostic(
            check="trace.kv-fused", config=arch, severity="info",
            value=reads,
            message="KV dequant stays fused: the int8 pages feed the "
                    "attention (kernel or dots), scales hoisted out of the "
                    "cache extent"))
    pt_ok = getattr(cache.get("pt"), "dtype", None) == torch.int32
    if reads >= 1 and writes >= 1 and pt_ok:
        diags.append(Diagnostic(
            check="trace.kv-page-table", config=arch, severity="info",
            value={"gathers": reads, "scatters": writes},
            message="decode indexes through the page table: "
                    f"{reads} int8 page read(s), {writes} int8 token "
                    "scatter(s)"))
    else:
        diags.append(Diagnostic(
            check="trace.kv-page-table", config=arch,
            value={"gathers": reads, "scatters": writes, "pt_int32": pt_ok},
            message="paged decode must read int8 pages, scatter the new "
                    "token int8, and carry an int32 page table — traced "
                    f"graph has reads={reads}, scatters={writes}, "
                    f"pt_int32={pt_ok}"))
    return diags


def pallas_tiles_ok(M: int, N: int, K: int,
                    n_groups: int | None = None) -> bool:
    """The JAX package's routing predicate for its int4 Pallas kernel
    (blocks 128 x 128 x 256, each clamped to its dim, whole groups a
    K-block).  The port's kernel route takes every shape (the int4 kernel
    where it tiles, K1's int8 entry on the packed nibbles elsewhere); the
    int8dot check skips what the JAX package skips, so that the two
    reports hold the same checks."""
    bm, bn, bk = min(128, M), min(128, N), min(256, K)
    if M % bm or N % bn or K % bk:
        return False
    if n_groups is None:
        return True
    return K % n_groups == 0 and bk % (K // n_groups) == 0


def _linear_signatures(exported) -> dict[tuple, tuple]:
    """Distinct (packed, K_stored, N, n_groups) weight signatures across a
    shape-only exported artifact (stacked layer axes collapsed)."""
    sigs: dict[tuple, tuple] = {}
    for path in find_exported_linears(exported):
        node = exported
        for k in path:
            node = node[k]
        q, s_wr = node["q"], node["s_wr"]
        packed = q.dtype == torch.uint8
        k_st, n = int(q.shape[-2]), int(q.shape[-1])
        lead = q.ndim - 2
        rel = s_wr.ndim - lead
        n_groups = int(s_wr.shape[-2]) if rel == 2 else None
        sigs.setdefault((packed, k_st, n, n_groups),
                        tuple(str(p) for p in path))
    return sigs


def check_int8dot(arch: str, exported, plan) -> list[Diagnostic]:
    """Trace qlinear_deployed per distinct weight signature and prove no
    float weight materialisation feeds a product.

    Each leaf is traced on the plan's route.  With ``plan.use_kernels`` an
    int8 leaf is K1's int8 entry, one node with the integer operand, and
    the info message describes that route.  The port's plain route for an
    int8 leaf (``ref.quant_matmul_int8_ref``: the CPU, or ``use_kernels``
    False on the card) still widens the weight to f32, so
    ``analyze_config(arch, use_kernels=False)`` reports an error on each
    int8 leaf where the JAX package, whose one int8 route is the integer
    ``dot_general``, reports info."""
    diags = []
    checked = 0
    for (packed, k_st, n, n_groups), path in \
            sorted(_linear_signatures(exported).items(), key=str):
        K = k_st * 2 if packed else k_st
        sig = (f"{'.'.join(path)} [{'int4-packed' if packed else 'int8'} "
               f"K={K} N={n}"
               + (f" groups={n_groups}" if n_groups else "") + "]")

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        ex = {"q": meta((k_st, n), torch.uint8 if packed else torch.int8),
              "s_wl": meta((K,), torch.float32),
              "s_wr": meta((n_groups, n) if n_groups else (n,),
                           torch.float32)}
        M = 128 if packed else 8
        if packed and not (plan.use_kernels
                           and pallas_tiles_ok(M, n, K, n_groups)):
            diags.append(Diagnostic(
                check="trace.int8dot", config=arch, severity="skip",
                value=sig,
                message=f"{sig}: unrouted, or an int4 shape the JAX "
                        "package's Pallas blocks do not tile (its route "
                        "there is the f32 ref.quant_matmul_ref); skipped as "
                        "there, so the two reports compare"))
            continue
        tr = trace(lambda xx, ee: qlinear_deployed(xx, ee, plan=plan),
                   meta((M, K), torch.float32), ex)
        bad = dequant_dot_violations(tr)
        if bad:
            diags.append(Diagnostic(
                check="trace.int8dot", config=arch, value=sig,
                message=f"{sig}: {bad[0]} — integer weights must be the "
                        "product's operand (scales hoisted), never a "
                        "materialized float [K,N]"))
        elif integer_operand_count(tr) == 0:
            diags.append(Diagnostic(
                check="trace.int8dot", config=arch, value=sig,
                message=f"{sig}: no integer-operand product found — "
                        "the invariant check would be vacuous"))
        else:
            checked += 1
    if checked and not any(d.severity == "error" for d in diags):
        diags.append(Diagnostic(
            check="trace.int8dot", config=arch, severity="info",
            value=checked,
            message=f"{checked} weight signature(s): the integer operand "
                    "enters the kernel directly, no f32 dequant "
                    "materialization"))
    return diags


def check_train_step(arch: str, cfg, qcfg, plan) -> list[Diagnostic]:
    qplan = plan.quant_plan
    opt = Adam(lr=1e-4)
    student, opt_state = abstract_train_state(cfg, qcfg, opt)
    step = make_train_step(cfg, qcfg, opt, plan=qplan)
    batch = _small_train_batch(cfg)
    tr = trace(step, student, opt_state, student, batch)
    cb = callback_count(tr)
    if cb:
        why = f" ({tr.untraceable})" if tr.untraceable else ""
        return [Diagnostic(
            check="trace.train-step", config=arch, value=cb,
            message=f"train step has {cb} host read(s){why} — the "
                    "distillation loop must never sync mid-step")]
    return [Diagnostic(check="trace.train-step", config=arch,
                       severity="info", value=0,
                       message="train step traces under the resolved plan "
                               "with no host-transfer surface")]


def _small_train_batch(cfg, B: int = 2, S: int = 32) -> dict:
    """registry.input_specs geometry at trace-friendly size."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.family == "vlm":
        s_img = S // 4
        return {"tokens": meta((B, S - s_img), torch.int32),
                "patch_embeds": meta((B, s_img, cfg.d_model),
                                     torch.bfloat16),
                "positions": meta((B, 3, S), torch.int32)}
    if cfg.family == "encdec":
        return {"frames": meta((B, S, cfg.d_model), torch.bfloat16),
                "tokens": meta((B, max(S // 8, 16)), torch.int32)}
    return {"tokens": meta((B, S), torch.int32)}


# ---------------------------------------------------------------------------
# the analysis of a config, and of the registry
# ---------------------------------------------------------------------------

#: checks that need a serving path; encdec has none (its forward needs
#: frames; the engine builds token-only batches)
_SERVE_CHECKS = ("trace.one-transfer", "trace.kernel-route",
                 "trace.prefill-recompile") + _KV_CHECKS


def analyze_config(arch: str, qcfg: QuantConfig | None = None,
                   use_kernels: bool = True,
                   prefill_budget: int | None = None) -> list[Diagnostic]:
    """Run every Layer-1 check for one registry config (SMOKE geometry —
    the invariants are structural, so config scale is irrelevant)."""
    cfg = registry.get_config(arch, smoke=True)
    qcfg = qcfg if qcfg is not None else QuantConfig()
    diags: list[Diagnostic] = []
    try:
        plan, exported, deployed = abstract_deploy_surfaces(
            cfg, qcfg, use_kernels=use_kernels)
    except Exception as e:  # noqa: BLE001 — a config that cannot even
        # resolve abstractly is one diagnostic, not a crashed run
        return [Diagnostic(check="trace.resolve", config=arch,
                           message=f"shape-only init/export/deploy failed: "
                                   f"{type(e).__name__}: {e}")]
    diags.extend(check_plan_coverage(arch, cfg, qcfg, plan))
    diags.extend(check_int8dot(arch, exported, plan))
    diags.extend(check_train_step(arch, cfg, qcfg, plan))

    if cfg.family == "encdec":
        diags.extend(Diagnostic(
            check=c, config=arch, severity="skip",
            message="encdec has no serving path (forward needs frames; "
                    "the engine builds token-only batches)")
            for c in _SERVE_CHECKS)
        return diags

    scfg = ServeConfig(**ANALYZER_SCFG)
    surfaces = serve_trace_surfaces(cfg, plan=plan, scfg=scfg)
    surfaces["deployed"] = deployed
    surfaces["decode_trace"] = trace(surfaces["decode_fn"], deployed,
                                     surfaces["cache"], surfaces["state"])
    diags.extend(check_decode_transfers(arch, surfaces["decode_trace"]))
    diags.extend(check_kernel_route(arch, cfg, scfg, deployed, plan,
                                    surfaces["decode_trace"]))
    diags.extend(check_prefill_recompile(arch, cfg, surfaces,
                                         budget=prefill_budget))
    diags.extend(check_kv_cache(arch, cfg, surfaces, plan))
    return diags


def analyze(configs: list[str] | None = None,
            qcfg: QuantConfig | None = None,
            prefill_budget: int | None = None) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    for arch in (configs if configs is not None else registry.ARCH_IDS):
        diags.extend(analyze_config(arch, qcfg=qcfg,
                                    prefill_budget=prefill_budget))
    return diags


__all__ = ["ANALYZER_SCFG", "Trace", "analyze", "analyze_config",
           "callback_count", "dequant_dot_violations",
           "integer_operand_count", "kernel_nodes", "node_val", "op_name",
           "trace", "transfer_surfaces"]

