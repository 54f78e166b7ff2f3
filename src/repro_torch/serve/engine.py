"""Continuous-batching serving engine for QFT-quantized models.

A :class:`Scheduler` owns an arrival-ordered request queue and a fixed pool
of decode slots backed by one preallocated slot cache
(``serve.deploy.init_slot_cache``): paged int8 KV by default (fixed-size
pages from a shared per-layer pool, a per-slot page table, per-slot
per-kv-head MMSE scales fitted at install; admission is gated by free
pages), or the full-precision monolithic layout with
``ServeConfig(kv_mode="monolithic")``.  Admission prefills a request ALONE
(batch 1, chunked, chunks padded to a fixed bucket menu) and installs the
finished cache into its slot; the decode step is one shape-stable call over
all slots (dead slots masked, ``train.steps.make_slot_decode_step``) with
exactly one device→host transfer per step.  Because every request is
prefilled alone and decode slots never interact, a request's tokens are the
same served alone, in a static batch or interleaved.

Weights: the engine serves ``deploy_view(exported)`` — the int4 artifact
dequantized once to bf16 — through ordinary matmuls, as the JAX package's
engine does; ``quant_matmul`` is reached through
``serve.deploy.kernel_route_check`` on the artifact, not from the decode
loop.  The decode attention goes through the CUDA ``decode_attention``
kernel (its paged entry, which reads the pools through the page table, for
the paged cache) unless the DeployPlan says ``use_kernels=False``.  MLA
(DeepSeek-V2) serves its monolithic bf16 latent cache, and its attention is
einsums on either route: ``decode_route`` never routes it.  The Mamba2
SSM and the Zamba2 hybrid serve their monolithic cache (f32 Mamba2 state;
the hybrid's shared attention over bf16 KV, through the kernel) and
prefill in exact-length chunks: a recurrent state cannot mask pad tokens.
The VLM backbone (Qwen2-VL) serves text-only requests as the dense family
does (paged int8 KV, bucketed prefill), its M-RoPE streams equal; the
encoder-decoder family is refused, as the JAX package has no serving path
for it.

Sampling: per-request temperature/top_k/top_p/seed drawn on the device
(core/sampling.py); ``temperature=0`` (the default) is exact greedy.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable

import torch

from ..core.fakequant import quantize
from ..core.mmse import ppq_scale
from ..core.qconfig import QuantConfig
from ..core.sampling import sample_tokens
from ..device import resolve_device
from ..models import init_cache
from ..models.attention import decode_route
from ..models.config import ModelConfig
from ..models.moe import capacity
from ..models.transformer import FAMILIES
from ..train.steps import (make_bucketed_prefill_step, make_prefill_step,
                           make_slot_decode_step)
from .deploy import (DeployPlan, deploy_view, export_for_layers,
                     init_slot_cache, init_slot_state, make_deploy_plan,
                     plan_from_artifact, to_device)
from .kv_cache import (BUCKETED_PREFILL_FAMILIES, KVSpec, PageAllocator,
                       bucket_for, resolve_kv_spec)


@dataclasses.dataclass
class Request:
    """One serving request.  The sampling knobs default to exact greedy
    (``temperature=0``); ``seed`` makes sampled decoding reproducible."""
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: int = -1                  # -1: never stop early
    temperature: float = 0.0          # 0: greedy argmax (exact)
    top_k: int = 0                    # 0: disabled
    top_p: float = 1.0                # 1: disabled
    seed: int = 0                     # sampling chain root
    rid: int | None = None            # arrival order; assigned by submit()


@dataclasses.dataclass
class ServeConfig:
    max_slots: int = 8                # fixed decode slot pool
    max_len: int = 512                # per-slot KV capacity
    prefill_chunk: int = 128          # tokens prefilled per slot per step
    #: "paged" — int8 paged KV (dense family); "monolithic" — the
    #: full-precision [max_slots, max_len] preallocation
    kv_mode: str = "paged"
    kv_page_size: int = 16            # tokens per KV page
    #: page-pool size; 0 → capacity-equivalent auto
    #: (max_slots * ceil(max_len / kv_page_size))
    kv_pages: int = 0
    slots: dataclasses.InitVar[int | None] = None   # legacy alias

    def __post_init__(self, slots):
        if slots is not None:
            self.max_slots = slots


def _tree_bytes(tree) -> int:
    """Byte size of every tensor leaf, from shapes and dtypes only; a
    batch-1 cache's Python-int ``pos`` counts as the JAX package's int32
    scalar."""
    if isinstance(tree, dict):
        return sum(4 if k == "pos" and isinstance(v, int)
                   else _tree_bytes(v) for k, v in tree.items())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _attn_layer_count(cfg: ModelConfig) -> int:
    """Attention invocations per slot-decode step, the denominator of the
    route counters in :meth:`Engine.stats`: one shared-attention call per
    group of the hybrid, every layer of the dense, MoE and VLM families,
    none for the SSM or MLA (which never routes)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.n_layers
    return 0


class Scheduler:
    """Host-side continuous-batching scheduler: FIFO queue + slot pool.
    Admission order is arrival order; freed slots are reused lowest index
    first, so scheduling is deterministic."""

    def __init__(self, max_slots: int):
        self.max_slots = max_slots
        self.queue: collections.deque[Request] = collections.deque()
        self.free: list[int] = sorted(range(max_slots), reverse=True)
        self.running: dict[int, int] = {}          # slot -> rid
        self._next_rid = 0

    def submit(self, req: Request) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(dataclasses.replace(req, rid=rid))
        return rid

    def admit(self, can_admit: Callable[[Request], bool] | None = None
              ) -> list[tuple[int, Request]]:
        """Pop queued requests into free slots: [(slot, request), ...].
        Stops at the FIRST request ``can_admit`` rejects (strict FIFO, so a
        large request at the head is not starved)."""
        out = []
        while self.free and self.queue:
            if can_admit is not None and not can_admit(self.queue[0]):
                break
            slot = self.free.pop()
            req = self.queue.popleft()
            self.running[slot] = req.rid
            out.append((slot, req))
        return out

    def evict(self, slot: int) -> int:
        """Release a finished slot back to the pool; returns its rid."""
        rid = self.running.pop(slot)
        self.free.append(slot)
        self.free.sort(reverse=True)
        return rid

    @property
    def pending(self) -> int:
        """Requests submitted but not yet finished (queued + running)."""
        return len(self.queue) + len(self.running)


def _activate_state(state, slot: int, last_logits: torch.Tensor, req: Request
                    ) -> None:
    """Activate ``slot`` for ``req`` in place.  The first token is drawn
    from the prefill logits with counter 0 of the request's chain."""
    dev = last_logits.device

    def one(v, dtype):
        return torch.tensor([v], dtype=dtype, device=dev)

    first = sample_tokens(last_logits[None], one(req.seed, torch.int64),
                          one(0, torch.int32),
                          one(req.temperature, torch.float32),
                          one(req.top_k, torch.int32),
                          one(req.top_p, torch.float32))
    state["cur"][slot] = first[0]
    state["done"][slot] = False
    state["counts"][slot] = 0
    state["budget"][slot] = req.max_new_tokens
    state["eos"][slot] = req.eos_id
    state["seed"][slot] = req.seed
    state["temp"][slot] = req.temperature
    state["top_k"][slot] = req.top_k
    state["top_p"][slot] = req.top_p


def _install(cache, slot_cache, slot: int, plen: int) -> None:
    """Copy a finished batch-1 prefill into slot row ``slot`` of the
    monolithic cache: every leaf (``k``/``v``, MLA's latent ``ckv``/``kr``,
    the Mamba2 ``ssm_state``/``conv_state``, nested as the hybrid's are),
    the whole row, so garbage the masked decode wrote into a dead slot is
    erased; every ``pos`` becomes ``plen``.  The slot axis is the first
    whose size differs from the batch-1 leaf's, as the JAX package's
    ``_install_step`` finds it (axis 2 of the hybrid's ``[G, k, S, ...]``
    Mamba2 leaves)."""
    for name, leaf in cache.items():
        small = slot_cache[name]
        if name == "pos":
            leaf[slot] = plen
        elif isinstance(leaf, dict):
            _install(leaf, small, slot, plen)
        elif leaf.shape == small.shape:              # max_slots == 1
            leaf.copy_(small)
        else:
            axis = next(i for i in range(leaf.ndim)
                        if leaf.shape[i] != small.shape[i])
            leaf.select(axis, slot).copy_(small.select(axis, 0))


def _paged_install(cache, slot_cache, slot: int, pages: torch.Tensor,
                   plen: int, page_size: int, mmse_iters: int) -> None:
    """Quantize a finished batch-1 prefill into the slot's reserved pages —
    the KV tensor class's MMSE init.

    Per layer and kv-head an int8 scale is PPQ-fitted over the slot's true
    prefill rows (rows past ``plen`` are zeroed first, which is neutral in
    the projections) and frozen for the slot's lifetime.  ``pages`` is the
    slot's page list padded with the trash page to the page-table width.
    """
    k_buf = slot_cache["k"]                          # [L, 1, T, Hkv, hd]
    L, _, T, Hkv, hd = k_buf.shape
    n_pg = pages.shape[0]
    Tv = n_pg * page_size
    valid = (torch.arange(T, device=k_buf.device) < plen)[None, :, None, None]

    def fit_and_scatter(buf, pool):
        x = torch.where(valid, buf[:, 0].to(torch.float32), 0.0)
        s = ppq_scale(x, 8, axes=(1, 3), iters=mmse_iters)  # [L,1,Hkv,1]
        q = quantize(x, s, 8).to(torch.int8)
        if Tv > T:
            q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, Tv - T))
        pool[:, pages] = q[:, :Tv].reshape(L, n_pg, page_size, Hkv, hd)
        return s[:, 0, :, 0]                          # [L, Hkv]

    cache["k_scale"][:, slot] = fit_and_scatter(k_buf, cache["k"])
    cache["v_scale"][:, slot] = fit_and_scatter(slot_cache["v"], cache["v"])
    cache["pt"][slot] = pages
    cache["pos"][slot] = plen


class TokenStream:
    """Iterator over one request's tokens, in emission order (from
    :meth:`Engine.stream`).  Iterating drives the engine when the buffer is
    empty; requests those ticks finish for other callers stay retrievable
    through ``Engine.result``.  Token ownership moves to the stream."""

    def __init__(self, engine: "Engine", rid: int):
        self._engine = engine
        self.rid = rid
        self._buf: collections.deque[int] = collections.deque()
        self._finished = False

    @property
    def finished(self) -> bool:
        return self._finished

    def _push(self, token: int, fin: bool) -> None:
        self._buf.append(token)
        self._finished = self._finished or fin

    def __iter__(self) -> "TokenStream":
        return self

    def __next__(self) -> int:
        steps = 0
        limit = 64 + 2 * sum(self._engine._work.values())
        while not self._buf:
            if self._finished:
                raise StopIteration
            self._engine._step_collecting()
            steps += 1
            if steps > limit:
                raise RuntimeError(
                    f"stream for rid {self.rid} made no progress after "
                    f"{steps} engine steps")
        return self._buf.popleft()


class Engine:
    """Serves a deployment artifact under its DeployPlan on one device.

    Construct from student params (exports inline) or from an exported
    artifact with :meth:`from_artifact`.  ``submit`` enqueues (returns an
    arrival-ordered id), ``step`` runs one scheduler tick and returns the
    requests it finished, ``stream`` returns a :class:`TokenStream`, and
    ``generate`` submits a list and drains it.  ``device=None`` is the card.
    """

    def __init__(self, cfg: ModelConfig, qcfg: QuantConfig, student_params,
                 scfg: ServeConfig | None = None,
                 plan: DeployPlan | None = None, device=None):
        dev = resolve_device(device)
        if plan is None:
            plan = make_deploy_plan(qcfg, arch=cfg.name, family=cfg.family,
                                    params=student_params, model_cfg=cfg)
        exported = export_for_layers(student_params, plan, device=dev)
        self._setup(cfg, plan, exported, scfg, dev)

    @classmethod
    def from_artifact(cls, cfg: ModelConfig, plan: DeployPlan, exported,
                      scfg: ServeConfig | None = None,
                      device=None) -> "Engine":
        """Serve an exported artifact; if ``plan`` carries no QuantPlan, the
        one embedded in the artifact is used."""
        dev = resolve_device(device)
        if plan.quant_plan is None:
            qp = plan_from_artifact(exported)
            if qp is not None:
                plan = dataclasses.replace(plan, quant_plan=qp)
        self = cls.__new__(cls)
        self._setup(cfg, plan, to_device(exported, dev), scfg, dev)
        return self

    def _setup(self, cfg: ModelConfig, plan: DeployPlan, exported,
               scfg: ServeConfig | None, dev: torch.device) -> None:
        if cfg.family == "encdec":
            raise NotImplementedError(
                f"the engine does not serve family 'encdec' ({cfg.name}): "
                f"the JAX package has no encoder-decoder serving path (a "
                f"request carries no encoder frames); run its cache-mode "
                f"forward (models.forward with init_cache) instead")
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"the port's engine serves the {', '.join(FAMILIES)} "
                f"families, not {cfg.family!r}")
        self.cfg = cfg
        self.device = dev
        self.scfg = scfg if scfg is not None else ServeConfig()
        if self.scfg.max_slots < 1 or self.scfg.prefill_chunk < 1:
            raise ValueError(f"ServeConfig needs max_slots >= 1 and "
                             f"prefill_chunk >= 1, got {self.scfg}")
        self.plan = plan
        self.qcfg = plan.qcfg
        # MoE capacity: the slot-decode step routes max_slots tokens at
        # once, and a worst-case batch sends them all to one expert.  A
        # capacity below that silently drops tokens — outputs that are
        # wrong and vary with batch composition — so refuse to build.
        moe = cfg.moe
        if moe is not None:
            T = self.scfg.max_slots
            cap = capacity(cfg, T)
            if cap < T:
                min_cf = moe.n_experts / max(moe.top_k, 1)
                raise ValueError(
                    f"MoE capacity_factor={moe.capacity_factor} cannot hold "
                    f"a worst-case decode batch: all max_slots={T} tokens "
                    f"may route to one expert, but per-expert capacity is "
                    f"int({T}*top_k/n_experts*cf)={cap} < {T}, so tokens "
                    f"would be silently dropped (wrong outputs that depend "
                    f"on batch composition). Use capacity_factor >= "
                    f"{min_cf:g} (= n_experts/top_k) or fewer slots.")
        self._kv: KVSpec | None = resolve_kv_spec(
            cfg, self.scfg, getattr(plan.qcfg, "kv_bits", 8))
        self._mmse_iters = getattr(plan.qcfg, "mmse_iters", 10)
        with torch.no_grad():
            self.params = deploy_view(exported, plan)
        self.exported = exported
        self._bucketed = cfg.family in BUCKETED_PREFILL_FAMILIES
        self._prefill = (make_bucketed_prefill_step(cfg, None)
                         if self._bucketed else make_prefill_step(cfg, None))
        self._decode = make_slot_decode_step(cfg, None,
                                             use_kernels=plan.use_kernels)
        self._params_bytes = _tree_bytes(self.params)
        self._artifact_bytes = _tree_bytes(exported)
        # a batch-1 cache sized on the meta device
        self._prefill_slot_bytes = _tree_bytes(
            init_cache(cfg, 1, self.scfg.max_len, device="meta"))
        self.reset()

    # ------------------------------------------------------------ lifecycle
    def reset(self) -> None:
        """Fresh serving state: empty queue, all slots free, zeroed cache."""
        S = self.scfg.max_slots
        self.sched = Scheduler(S)
        self.cache = init_slot_cache(self.cfg, S, self.scfg.max_len,
                                     kv=self._kv, device=self.device)
        self.state = init_slot_state(S, device=self.device)
        self._pager = (None if self._kv is None
                       else PageAllocator(self._kv.n_pages))
        self._slot_pages: dict[int, list[int]] = {}
        self._peak_slots = 0
        self._prefilling: dict[int, dict] = {}
        self._alive: set[int] = set()
        self._results: dict[int, list[int]] = {}
        self._collected: dict[int, list[int]] = {}
        self._consumers: dict[int, TokenStream | Callable[[int, bool], None]]\
            = {}
        self._work: dict[int, int] = {}
        self.decode_steps = 0
        self._cache_bytes = _tree_bytes(self.cache) + _tree_bytes(self.state)
        self._peak_live_bytes = (self._params_bytes + self._artifact_bytes
                                 + self._cache_bytes)

    # ---------------------------------------------------------- accounting
    def _live_bytes(self) -> int:
        return (self._params_bytes + self._artifact_bytes + self._cache_bytes
                + len(self._prefilling) * self._prefill_slot_bytes)

    def stats(self) -> dict[str, int]:
        """Accounting snapshot, sized from shapes and dtypes.

        ``decode_attn_kernel_layers`` / ``decode_attn_ref_layers``: how many
        attention invocations of one decode step take the ``decode_attention``
        kernel route vs the plain masked route, per
        ``models.attention.decode_route`` — the predicate the forward uses.
        The hybrid has one invocation per group; the SSM and MLA have
        none (MLA never routes): both are 0.
        """
        n_attn = _attn_layer_count(self.cfg)
        depth = (self._kv.view_len if self._kv is not None
                 else self.scfg.max_len)
        routed = (n_attn if n_attn and decode_route(
            self.cfg, depth, self.plan.use_kernels) else 0)
        live = self._live_bytes()
        return {
            "decode_attn_kernel_layers": routed,
            "decode_attn_ref_layers": n_attn - routed,
            "decode_steps": self.decode_steps,
            "params_bytes": self._params_bytes,
            "artifact_bytes": self._artifact_bytes,
            "slot_cache_bytes": self._cache_bytes,
            "prefill_bytes": len(self._prefilling) * self._prefill_slot_bytes,
            "live_bytes": live,
            "peak_live_bytes": max(self._peak_live_bytes, live),
            "queue_depth": len(self.sched.queue),
            "slots_active": len(self._alive),
            "slots_prefilling": len(self._prefilling),
            "max_slots": self.scfg.max_slots,
            "peak_slots_active": max(self._peak_slots, len(self._alive)),
            "kv_page_size": 0 if self._kv is None else self._kv.page_size,
            "kv_pages_total": 0 if self._kv is None else self._kv.n_pages,
            "kv_pages_free": 0 if self._pager is None else self._pager.n_free,
        }

    # ------------------------------------------------------------ serve API
    def _validate(self, request: Request) -> None:
        p = request.prompt
        if not isinstance(p, (list, tuple)) or len(p) == 0:
            raise ValueError(
                f"request prompt must be a non-empty token list, got {p!r}")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {request.max_new_tokens}")
        need = len(p) + request.max_new_tokens
        if need > self.scfg.max_len:
            raise ValueError(
                f"request needs {need} cache positions ({len(p)} prompt + "
                f"{request.max_new_tokens} new) but ServeConfig.max_len is "
                f"{self.scfg.max_len}; raise max_len or shorten the request")
        if any(not 0 <= t < self.cfg.vocab for t in p):
            raise ValueError(f"prompt tokens must lie in [0, "
                             f"{self.cfg.vocab})")
        if self._kv is not None:
            n_need = self._kv.pages_for(need)
            if n_need > self._kv.n_pages:
                raise ValueError(
                    f"request needs {n_need} KV pages ({need} tokens at "
                    f"page size {self._kv.page_size}) but the page pool "
                    f"has only {self._kv.n_pages}; raise ServeConfig."
                    f"kv_pages or shorten the request")
        if not (request.temperature >= 0.0
                and math.isfinite(request.temperature)):
            raise ValueError(
                f"temperature must be finite and >= 0 (0 = greedy), got "
                f"{request.temperature}")
        if request.top_k < 0:
            raise ValueError(
                f"top_k must be >= 0 (0 disables), got {request.top_k}")
        if not (0.0 < request.top_p <= 1.0):
            raise ValueError(
                f"top_p must be in (0, 1] (1 disables), got {request.top_p}")

    def _enqueue(self, request: Request) -> int:
        self._validate(request)
        rid = self.sched.submit(request)
        self._work[rid] = (-(-len(request.prompt) // self.scfg.prefill_chunk)
                           + request.max_new_tokens)
        return rid

    def submit(self, request: Request,
               on_token: Callable[[int, bool], None] | None = None) -> int:
        """Enqueue a request; returns its arrival-ordered id.  With
        ``on_token`` every emitted token goes to ``on_token(token, done)``
        and the request does not appear in ``step()``'s result."""
        rid = self._enqueue(request)
        if on_token is not None:
            self._consumers[rid] = on_token
        else:
            self._results[rid] = []
        return rid

    def stream(self, request: Request) -> TokenStream:
        """Submit ``request`` and return an iterator over its tokens."""
        rid = self._enqueue(request)
        ts = TokenStream(self, rid)
        self._consumers[rid] = ts
        return ts

    def pending(self) -> int:
        return self.sched.pending

    def result(self, rid: int) -> list[int]:
        """In-flight tokens of a pending rid, or — once — a finished request
        drained by someone else's generate()."""
        if rid in self._results:
            return list(self._results[rid])
        return self._collected.pop(rid)

    @torch.no_grad()
    def step(self) -> dict[int, list[int]]:
        """One scheduler tick: admissions, one prefill chunk per prefilling
        slot (finished prefills install into their slot), then ONE decode
        call over all slots and ONE device→host transfer.  Returns {rid:
        tokens} for requests finished this tick."""
        scfg = self.scfg
        can = None
        reserved: dict[int, list[int]] = {}
        if self._pager is not None:
            # reserve pages AT the admission decision, so two requests in
            # one round are never approved against the same free pages
            def can(r: Request) -> bool:
                n = self._kv.pages_for(len(r.prompt) + r.max_new_tokens)
                if not self._pager.can_alloc(n):
                    return False
                reserved[r.rid] = self._pager.alloc(n)
                return True
        for slot, req in self.sched.admit(can):
            st = {"req": req, "off": 0,
                  "cache": init_cache(self.cfg, 1, scfg.max_len,
                                      device=self.device)}
            if self._pager is not None:
                st["pages"] = reserved.pop(req.rid)
            self._prefilling[slot] = st
        if reserved:
            raise RuntimeError("page reservation without an admitted slot")
        self._peak_live_bytes = max(self._peak_live_bytes, self._live_bytes())

        for slot in sorted(self._prefilling):
            st = self._prefilling[slot]
            req, off = st["req"], st["off"]
            chunk = list(req.prompt[off: off + scfg.prefill_chunk])
            # pad to the fixed bucket menu: prefill shapes are bounded by
            # the menu, not by prompt lengths (a recurrent state cannot
            # mask pads: the other families take the exact length)
            b = (bucket_for(len(chunk), scfg.prefill_chunk)
                 if self._bucketed else len(chunk))
            toks = torch.tensor([chunk + [0] * (b - len(chunk))],
                                dtype=torch.int64, device=self.device)
            logits, st["cache"] = self._prefill(
                self.params, st["cache"], {"tokens": toks},
                *((len(chunk),) if self._bucketed else ()))
            st["off"] = off + len(chunk)
            if st["off"] == len(req.prompt):
                if self._kv is not None:
                    pages = st["pages"]
                    padded = pages + [self._kv.trash_page] * (
                        self._kv.max_pages_per_slot - len(pages))
                    _paged_install(
                        self.cache, st["cache"], slot,
                        torch.tensor(padded, dtype=torch.int32,
                                     device=self.device),
                        len(req.prompt), self._kv.page_size,
                        self._mmse_iters)
                    self._slot_pages[slot] = pages
                else:
                    _install(self.cache, st["cache"], slot, len(req.prompt))
                _activate_state(self.state, slot, logits[0], req)
                self._alive.add(slot)
                del self._prefilling[slot]
        self._peak_slots = max(self._peak_slots, len(self._alive))

        finished: dict[int, list[int]] = {}
        if self._alive:
            self.cache, self.state, emitted, emit = self._decode(
                self.params, self.cache, self.state)
            self.decode_steps += 1
            host = torch.stack([emitted.to(torch.int64),
                                emit.to(torch.int64),
                                self.state["done"].to(torch.int64)]).cpu()
            toks_h, emit_h, done_h = host.tolist()   # the step's ONE sync
            for slot in sorted(self._alive):
                rid = self.sched.running[slot]
                if emit_h[slot]:
                    self._deliver(rid, toks_h[slot], bool(done_h[slot]))
                if done_h[slot]:
                    self.sched.evict(slot)
                    self._alive.discard(slot)
                    if self._pager is not None:
                        # before the next decode step: point the slot's
                        # page-table row at the trash page, then return its
                        # pages to the pool
                        self.cache["pt"][slot] = self._kv.trash_page
                        self.cache["pos"][slot] = 0
                        self._pager.release(self._slot_pages.pop(slot))
                    del self._work[rid]
                    toks = self._finish_rid(rid)
                    if toks is not None:
                        finished[rid] = toks
        return finished

    def _deliver(self, rid: int, token: int, fin: bool) -> None:
        consumer = self._consumers.get(rid)
        if consumer is None:
            self._results[rid].append(token)
        elif isinstance(consumer, TokenStream):
            consumer._push(token, fin)
        else:
            consumer(token, fin)

    def _finish_rid(self, rid: int) -> list[int] | None:
        if self._consumers.pop(rid, None) is not None:
            return None
        return self._results.pop(rid)

    def _step_collecting(self) -> None:
        self._collected.update(self.step())

    def generate(self, requests: list[Request]) -> list[list[int]]:
        """Serve a list of requests to completion (submit all, drain)."""
        if not requests:
            raise ValueError("Engine.generate needs a non-empty request "
                             "list; got an empty one")
        for r in requests:       # all-or-nothing: a bad request mid-list
            self._validate(r)    # must not leave earlier ones enqueued
        rids = set(self.submit(r) for r in requests)
        limit = 64 + 2 * sum(self._work.values())
        collected: dict[int, list[int]] = {}
        steps = 0
        while self.pending():
            collected.update(self.step())
            steps += 1
            if steps > limit:
                raise RuntimeError(
                    f"serve loop made no progress after {steps} steps "
                    f"({self.pending()} requests still pending)")
        self._collected.update(
            (rid, toks) for rid, toks in collected.items()
            if rid not in rids)
        return [collected[rid] for rid in sorted(rids)]

