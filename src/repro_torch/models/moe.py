"""Mixture-of-Experts with quantized experts.

Dispatch modes, as in the JAX package:

- ``sorted``: top-k token-choice routing with sort-based capacity dispatch
  (O(T·k) memory, no [T, E, C] one-hot), differentiable with respect to the
  tokens and the gates;
- ``dense``: the oracle — every expert on every token, combined with the
  gate weights; exact (no capacity drops).

Experts are stacked ``[E, d_in, d_out]`` and quantized doubly-channelwise per
expert; the router and all experts share the input-stream scale (the
paper's fan-out rule, Appendix D constraint 2).  The router stays 8-bit.

Nothing here reads a tensor back to the host: ``C`` comes from Python ints,
the per-expert counts from ``scatter_add_`` and the combine sums each
token's contributions in a fixed order, so a decode step keeps its one
device→host transfer and its bits do not vary from run to run.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..core import dof
from ..core.plan import plan_view
from ..core.qconfig import QuantConfig
from .config import ModelConfig

Params = dict[str, Any]


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             qcfg: QuantConfig | None, lead: tuple = ()) -> Params:
    """Router, the stacked experts (``lead + (E,)``), the shared experts
    and (student) the three streams; keys in sorted order, as the JAX
    package's vmap-stacked tree has them."""
    e, d = cfg.moe, cfg.d_model
    E, ff = e.n_experts_padded, e.d_ff_expert
    lead = tuple(lead)
    p: Params = {
        "router": dof.init_qlinear(gen, d, E, qcfg, w_bits=e.router_bits,
                                   name="router", lead=lead),
        "up": dof.init_qlinear(gen, d, ff, qcfg, name="up", lead=lead + (E,)),
        "gate": dof.init_qlinear(gen, d, ff, qcfg, name="gate",
                                 lead=lead + (E,)),
        "down": dof.init_qlinear(gen, ff, d, qcfg, name="down",
                                 lead=lead + (E,)),
    }
    if e.n_shared:
        fs = ff * e.n_shared
        p["shared_up"] = dof.init_qlinear(gen, d, fs, qcfg, name="shared_up",
                                          lead=lead)
        p["shared_gate"] = dof.init_qlinear(gen, d, fs, qcfg,
                                            name="shared_gate", lead=lead)
        p["shared_down"] = dof.init_qlinear(gen, fs, d, qcfg,
                                            name="shared_down", lead=lead)
    if qcfg is not None:
        dev = gen.device
        p["in_stream"] = dof.init_stream(d, lead=lead, device=dev)
        p["act_stream"] = dof.init_stream(ff, lead=lead, device=dev)
        if e.n_shared:
            p["shared_act_stream"] = dof.init_stream(ff * e.n_shared,
                                                     lead=lead, device=dev)
    return {k: p[k] for k in sorted(p)}


def _router_logits(x: torch.Tensor, p: Params, cfg: ModelConfig,
                   qcfg: QuantConfig | None, plan=None,
                   use_kernels: bool = False) -> torch.Tensor:
    """f32 router logits ``[T, E]`` (the 8-bit router on ``in_stream``),
    padded experts at ``-1e30``."""
    e = cfg.moe
    logits = dof.qlinear(x, p["router"], qcfg, stream=p.get("in_stream"),
                         bits=plan_view(plan).bits("router", e.router_bits),
                         use_kernels=use_kernels).to(torch.float32)
    if e.n_experts_padded != e.n_experts:
        pad = torch.arange(e.n_experts_padded, device=x.device) >= e.n_experts
        logits = torch.where(pad, -1e30, logits)
    return logits


def _router_probs(x, p, cfg, qcfg, plan=None, use_kernels=False):
    return torch.softmax(_router_logits(x, p, cfg, qcfg, plan=plan,
                                        use_kernels=use_kernels), dim=-1)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest along the last axis, ties to
    the lower index (a stable descending sort; ``torch.topk`` promises no
    order among equal values on the card)."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _gates(probs: torch.Tensor, k: int):
    topv, topi = top_k(probs, k)
    return topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9), topi


def _expert_ffn(h: torch.Tensor, p: Params, cfg: ModelConfig,
                qcfg: QuantConfig | None, plan=None,
                use_kernels: bool = False) -> torch.Tensor:
    """``h [E, C, d] -> [E, C, d]`` through the stacked expert FFNs.  The
    expert stacks are single plan paths (``layers.mlp.up`` …), so one
    lookup covers every expert; ``use_kernels`` routes each stack's
    fake-quant through one ``fake_quant`` launch."""
    pv = plan_view(plan)
    ins = p.get("in_stream")
    log_sa = None if ins is None else ins["log_sa"]
    if qcfg is not None:
        h = dof.stream_fake_quant(h, ins, qcfg)
    w_up = dof.effective_weight(p["up"], qcfg, log_sa, h.dtype,
                                bits=pv.bits("up"), use_kernels=use_kernels)
    w_gate = dof.effective_weight(p["gate"], qcfg, log_sa, h.dtype,
                                  bits=pv.bits("gate"),
                                  use_kernels=use_kernels)
    a = F.silu(torch.bmm(h, w_gate)) * torch.bmm(h, w_up)
    acts = p.get("act_stream")
    if qcfg is not None:
        a = dof.stream_fake_quant(a, acts, qcfg)
    w_down = dof.effective_weight(
        p["down"], qcfg, None if acts is None else acts["log_sa"], h.dtype,
        bits=pv.bits("down"), use_kernels=use_kernels)
    return torch.bmm(a, w_down)


def moe_dense(x: torch.Tensor, p: Params, cfg: ModelConfig,
              qcfg: QuantConfig | None, plan=None,
              use_kernels: bool = False) -> torch.Tensor:
    """The oracle: all experts on all tokens.  ``x [T, d]``."""
    e = cfg.moe
    probs = _router_probs(x, p, cfg, qcfg, plan=plan, use_kernels=use_kernels)
    gates, topi = _gates(probs, e.top_k)
    mask = torch.zeros_like(probs).scatter(1, topi, gates)        # [T, E]
    h = x[None].expand((e.n_experts_padded,) + tuple(x.shape))    # [E, T, d]
    y = _expert_ffn(h, p, cfg, qcfg, plan=plan, use_kernels=use_kernels)
    return torch.einsum("te,etd->td", mask.to(y.dtype), y)


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Per-expert buffer rows for ``n_tokens`` routed tokens."""
    e = cfg.moe
    return max(int(n_tokens * e.top_k / max(e.n_experts, 1)
                   * e.capacity_factor), 1)


def route(topi: torch.Tensor, n_experts: int, C: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch of ``topi [T, K]``: ``(dest, keep)``,
    both ``[T, K]``.  Assignments are ranked within their expert in token
    order (a stable sort by expert); the first ``C`` of each expert keep
    buffer row ``e·C + rank``, the rest go to the drop row ``E·C``."""
    T, K = topi.shape
    dev = topi.device
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    counts = torch.zeros(n_experts, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=dev) - offsets[e_sorted]
    keep_s = pos < C
    dest_s = torch.where(keep_s, e_sorted * C + pos, n_experts * C)
    # back to the (token, choice) layout
    dest = torch.empty_like(dest_s).scatter_(0, order, dest_s)
    keep = torch.empty_like(keep_s).scatter_(0, order, keep_s)
    return dest.reshape(T, K), keep.reshape(T, K)


def moe_sorted(x: torch.Tensor, p: Params, cfg: ModelConfig,
               qcfg: QuantConfig | None, expert_fn=None, plan=None,
               use_kernels: bool = False) -> torch.Tensor:
    """Sort-based capacity dispatch.  ``x [T, d]``.

    ``expert_fn(h_ECd) -> y_ECd`` replaces the in-graph expert FFN (the
    expert-parallel hook).  The combine adds each token's kept
    contributions in ascending expert order in ``y``'s dtype — the order
    and the roundings of the JAX package's scatter-add."""
    e = cfg.moe
    T, d = x.shape
    E, K = e.n_experts_padded, e.top_k
    C = capacity(cfg, T)
    probs = _router_probs(x, p, cfg, qcfg, plan=plan, use_kernels=use_kernels)
    gates, topi = _gates(probs, K)
    dest, keep = route(topi, E, C)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    buf = x.new_zeros((E * C + 1, d)).index_copy(0, dest.reshape(-1),
                                                  x[tok])
    y = (expert_fn or (lambda h: _expert_ffn(
        h, p, cfg, qcfg, plan=plan, use_kernels=use_kernels)))(
        buf[:-1].reshape(E, C, d)).reshape(E * C, d)
    # each token's K contributions, in ascending expert order
    by_e = torch.argsort(topi, dim=-1)
    dest, keep = dest.gather(1, by_e), keep.gather(1, by_e)
    g = gates.gather(1, by_e).to(y.dtype)
    contrib = torch.where(keep[..., None],
                          y[torch.clamp(dest, max=E * C - 1)], 0.0) \
        * g[..., None]                                          # [T, K, d]
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]
    return out


def moe_block(x: torch.Tensor, p: Params, cfg: ModelConfig,
              qcfg: QuantConfig | None, mode: str = "sorted", plan=None,
              use_kernels: bool = False, moe_fn=None) -> torch.Tensor:
    """``x [B, S, d]`` → routed experts + shared experts.  ``plan`` is
    scoped to this module's path (``layers.mlp``).

    ``moe_fn(x, p, use_kernels)``: an override of the routed experts (the
    expert-parallel path, ``sharding.ep.make_ep_moe``), on this block's
    route; it may return None (a decode step) to fall back to the in-graph
    path."""
    B, S, d = x.shape
    pv = plan_view(plan)
    out = None if moe_fn is None else moe_fn(x, p, use_kernels)
    if out is None:
        xt = x.reshape(B * S, d)
        if mode == "dense":
            routed = moe_dense(xt, p, cfg, qcfg, plan=pv,
                               use_kernels=use_kernels)
        else:
            routed = moe_sorted(xt, p, cfg, qcfg, plan=pv,
                                use_kernels=use_kernels)
        out = routed.reshape(B, S, d)
    if cfg.moe.n_shared:
        ins = p.get("in_stream")
        gate = dof.qlinear(x, p["shared_gate"], qcfg, stream=ins,
                           bits=pv.bits("shared_gate"),
                           use_kernels=use_kernels)
        up = dof.qlinear(x, p["shared_up"], qcfg, stream=ins,
                         bits=pv.bits("shared_up"), use_kernels=use_kernels)
        h = F.silu(gate) * up
        out = out + dof.qlinear(h, p["shared_down"], qcfg,
                                stream=p.get("shared_act_stream"),
                                bits=pv.bits("shared_down"),
                                use_kernels=use_kernels)
    return out
