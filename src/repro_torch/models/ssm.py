"""Mamba2 (SSD — state-space duality) block, quantization-aware.

Chunked SSD for train/prefill (the intra-chunk quadratic term plus the
inter-chunk state recurrence, a loop over chunks where the JAX package
runs ``lax.scan``), an O(1)-state recurrent step for decode.  The in and
out projections are quantized linears; the SSD scan itself runs in f32.
No kernel of the repo computes the scan: it is einsums, as in the JAX
package.  A cache ``{ssm_state [B, H, P, N] f32, conv_state [B, d_conv-1,
conv_dim]}`` is updated in place.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..core import dof
from ..core.plan import plan_view
from ..core.qconfig import QuantConfig
from .config import ModelConfig
from .layers import tap

Params = dict[str, Any]


def _conv_dim(cfg: ModelConfig) -> int:
    s = cfg.ssm
    return s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state


def init_ssm(gen: torch.Generator, cfg: ModelConfig,
             qcfg: QuantConfig | None, lead: tuple = ()) -> Params:
    """The block's parameters (and, for a student, its two streams), keyed
    in the JAX package's (sorted, vmap-stacked) order; ``lead`` prepends
    stacked axes."""
    s, d = cfg.ssm, cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    cd = _conv_dim(cfg)
    lead = tuple(lead)
    dev = gen.device

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=torch.float32,
                          device=dev)

    # in_proj → [z(di), x(di), B(g*ds), C(g*ds), dt(nh)]
    p: Params = {
        "in_proj": dof.init_qlinear(gen, d, 2 * di + 2 * s.n_groups
                                    * s.d_state + nh, qcfg, name="in_proj",
                                    lead=lead),
        "conv_w": dof.randn(lead + (s.d_conv, cd), gen) * 0.2,
        "conv_b": full((cd,), 0.0),
        "A_log": torch.broadcast_to(torch.log(torch.linspace(
            1.0, 16.0, nh, dtype=torch.float32, device=dev)),
            lead + (nh,)).clone(),
        "D": full((nh,), 1.0),
        "dt_bias": full((nh,), 0.0),
        "norm_g": full((di,), 1.0),
        "out_proj": dof.init_qlinear(gen, di, d, qcfg, name="out_proj",
                                     lead=lead),
    }
    if qcfg is not None:
        p["in_stream"] = dof.init_stream(d, lead=lead, device=dev)
        p["out_stream"] = dof.init_stream(di, lead=lead, device=dev)
    return {k: p[k] for k in sorted(p)}


def init_ssm_cache(cfg: ModelConfig, batch: int, n_layers: int,
                   dtype=torch.float32, device=None) -> Params:
    """``ssm_state [L, B, H, P, N]`` and ``conv_state [L, B, d_conv-1,
    conv_dim]`` (no position: the state is the whole history)."""
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    return {"ssm_state": torch.zeros((n_layers, batch, nh, s.head_dim,
                                      s.d_state), dtype=dtype,
                                     device=device),
            "conv_state": torch.zeros((n_layers, batch, s.d_conv - 1,
                                       _conv_dim(cfg)), dtype=dtype,
                                      device=device)}


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    s, d = cfg.ssm, cfg.d_model
    di, nh, g, ds = s.d_inner(d), s.n_heads(d), s.n_groups, s.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * g * ds]
    dt = zxbcdt[..., -nh:]
    return z, xbc, dt


def _gated_norm(y: torch.Tensor, z: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """RMSNorm of ``y·silu(z)``: the product in the working dtype, the norm
    in f32, the result in ``y``'s dtype."""
    yf = (y * F.silu(z)).to(torch.float32)
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + 1e-6) * g).to(y.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.  x ``[B, S, H, P]``, dt ``[B, S, H]``, A ``[H]``, B and C
    ``[B, S, G, N]`` (G divides H), ``S`` a multiple of ``chunk``.

    Returns ``(y [B, S, H, P] in x's dtype, final_state [B, H, P, N] f32)``.
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk
    f32 = torch.float32
    rep = H // G
    Bm = torch.repeat_interleave(Bm, rep, dim=2)               # [B,S,H,N]
    Cm = torch.repeat_interleave(Cm, rep, dim=2)

    def r(t, shape):  # into chunks
        return t.reshape((Bsz, nc, chunk) + shape)

    xc = r(x, (H, P)).to(f32)
    dtc = r(dt.to(f32), (H,))
    Bc, Cc = r(Bm, (H, N)).to(f32), r(Cm, (H, N)).to(f32)
    dA = dtc * A.to(f32)[None, None, None, :]                 # [B,nc,Q,H] (<0)
    dA_cs = torch.cumsum(dA, dim=2)                           # within a chunk

    # intra-chunk (causal masked quadratic term); the exponent is masked
    # BEFORE exp: upper-triangle exponents are positive → inf, and inf·0
    # NaNs the backward
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]   # [B,nc,Q,Q,H]
    decay = torch.exp(torch.where(causal, seg,
                                  torch.full_like(seg, -math.inf)))
    cb = torch.einsum("bnqhs,bnkhs->bnqkh", Cc, Bc)           # [B,nc,Q,Q,H]
    att = torch.where(causal, cb * decay, torch.zeros_like(cb))
    y_diag = torch.einsum("bnqkh,bnkh,bnkhp->bnqhp", att, dtc, xc)

    # chunk-boundary states: sum_k B_k dt_k x_k decay(to the chunk's end)
    decay_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)        # [B,nc,Q,H]
    states = torch.einsum("bnkh,bnkhs,bnkhp->bnhps", dtc * decay_end, Bc,
                          xc)                                 # [B,nc,H,P,N]

    # inter-chunk recurrence, emitting the state BEFORE each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])               # [B,nc,H]
    carry = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for n in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, n, :, None, None] + states[:, n]
    prev_states = torch.stack(prev, dim=1)                    # [B,nc,H,P,N]

    # inter-chunk contribution: decay from the chunk's start
    y_off = torch.einsum("bnqhs,bnqh,bnhps->bnqhp", Cc, torch.exp(dA_cs),
                         prev_states)
    y = (y_diag + y_off).reshape(Bsz, S, H, P).to(x.dtype)
    return y, carry


def _recurrent_step(xbc: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    p: Params, cache: Params, cfg: ModelConfig
                    ) -> torch.Tensor:
    """One decode token: the conv over the cached window (one contraction),
    the f32 state update ``h = h·exp(dt·A) + dt·B·x`` written into the
    cache in place, ``y = C·h + D·x`` (f32, ``[B, 1, H, P]``)."""
    s = cfg.ssm
    B, di = xbc.shape[0], s.d_inner(cfg.d_model)
    nh, g, ds, P = s.n_heads(cfg.d_model), s.n_groups, s.d_state, s.head_dim
    f32 = torch.float32
    window = torch.cat([cache["conv_state"].to(xbc.dtype), xbc], dim=1)
    conv = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(xbc.dtype)) \
        + p["conv_b"].to(xbc.dtype)
    conv = F.silu(conv)                                       # [B, cd]
    xi = conv[..., :di].reshape(B, nh, P)
    Bm = torch.repeat_interleave(conv[..., di: di + g * ds].reshape(
        B, g, ds), nh // g, dim=1)                            # [B, H, N]
    Cm = torch.repeat_interleave(conv[..., di + g * ds:].reshape(
        B, g, ds), nh // g, dim=1)
    dt1 = dt[:, 0]                                            # [B, H]
    st = cache["ssm_state"].to(f32)                           # [B, H, P, N]
    dec = torch.exp(dt1 * A[None, :])
    st_new = (st * dec[:, :, None, None]
              + torch.einsum("bh,bhn,bhp->bhpn", dt1, Bm.to(f32),
                             xi.to(f32)))
    y = torch.einsum("bhn,bhpn->bhp", Cm.to(f32), st_new)
    y = (y + xi.to(f32) * p["D"][None, :, None])[:, None]
    cache["ssm_state"].copy_(st_new)
    cache["conv_state"].copy_(window[:, 1:])
    return y


def ssm_block(x: torch.Tensor, p: Params, cfg: ModelConfig,
              qcfg: QuantConfig | None, cache: Params | None = None,
              taps: dict | None = None, prefix: str = "", plan=None,
              use_kernels: bool = False) -> torch.Tensor:
    """The Mamba2 block, x ``[B, S, d]``.  Modes: no cache (train, eval);
    a cache and ``S > 1`` (prefill: the cache's ``conv_state`` is the
    conv's left context and ``ssm_state`` the scan's initial state); a
    cache and ``S == 1`` (the recurrent decode step).  The new state is
    written into ``cache`` in place.

    ``plan`` is scoped to the block's path (``layers.ssm``, ``tail.ssm``):
    the in/out projections' fake-quant bits; ``use_kernels`` routes their
    weights' fake-quant through the ``fake_quant`` kernel; ``taps``
    records ``{prefix}.out``."""
    s = cfg.ssm
    B, S, d = x.shape
    di, nh = s.d_inner(d), s.n_heads(d)
    g, ds, P = s.n_groups, s.d_state, s.head_dim
    pv = plan_view(plan)
    f32 = torch.float32

    zxbcdt = dof.qlinear(x, p["in_proj"], qcfg, stream=p.get("in_stream"),
                         bits=pv.bits("in_proj"), use_kernels=use_kernels)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                 # [H] < 0

    if cache is None or S > 1:
        w_conv = p["conv_w"].to(xbc.dtype)
        b_conv = p["conv_b"].to(xbc.dtype)
        # causal depthwise conv1d: d_conv shifted products, summed in the
        # JAX package's order; a cached prefill takes conv_state as context
        if cache is None:
            ctx = torch.zeros((B, s.d_conv - 1, xbc.shape[-1]),
                              dtype=xbc.dtype, device=x.device)
        else:
            ctx = cache["conv_state"].to(xbc.dtype)
        xb_pad = torch.cat([ctx, xbc], dim=1)
        conv = xb_pad[:, 0:S] * w_conv[0]
        for i in range(1, s.d_conv):
            conv = conv + xb_pad[:, i: i + S] * w_conv[i]
        conv = F.silu(conv + b_conv)
        # pad the sequence to a chunk multiple; dt = 0 on the padding
        # leaves the state untouched
        chunk = min(s.chunk, S)
        Sp = -(-S // chunk) * chunk
        if Sp != S:
            conv = F.pad(conv, (0, 0, 0, Sp - S))
            dt = F.pad(dt, (0, 0, 0, Sp - S))
        xi = conv[..., :di].reshape(B, Sp, nh, P)
        Bm = conv[..., di: di + g * ds].reshape(B, Sp, g, ds)
        Cm = conv[..., di + g * ds:].reshape(B, Sp, g, ds)
        init_state = None if cache is None else cache["ssm_state"]
        y, final = ssd_chunked(xi, dt, A, Bm, Cm, chunk,
                               init_state=init_state)
        y = y + xi * p["D"][None, None, :, None].to(y.dtype)
        y = y[:, :S]
        if cache is not None:
            cache["ssm_state"].copy_(final)
            cache["conv_state"].copy_(xb_pad[:, S: S + s.d_conv - 1])
    else:
        y = _recurrent_step(xbc, dt, A, p, cache, cfg).to(x.dtype)

    y = _gated_norm(y.reshape(B, S, di), z, p["norm_g"])
    tap(taps, prefix + ".out", y)
    return dof.qlinear(y, p["out_proj"], qcfg, stream=p.get("out_stream"),
                       bits=pv.bits("out_proj"), use_kernels=use_kernels)
