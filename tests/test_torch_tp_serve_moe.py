"""Tensor parallelism over ``model`` in the forward with a cache for the
MoE experts and MLA (``repro_torch.sharding.tp``'s ``_moe_view`` and
``_mla_view``, ``models.moe`` and ``models.attention.mla_attention`` with a
group), on the CPU over spawned ``gloo`` ranks at SMOKE width, 2 layers:
qwen2-moe (6 experts, top-2, 2 shared; 4 query and 4 KV heads) and
deepseek-v2 (MLA with 4 heads, 8 experts, top-2, 2 shared).

- The exported artifact stored as ``params_shardings`` places it (its
  ``q`` leaves over ``model`` only) and the monolithic cache as
  ``cache_shardings`` places it, at model 2, model 4 and data 2 x model 2;
  a prefill at scalar ``pos`` and 3 decode steps through
  ``make_prefill_step``/``make_decode_step``, then the same prefill and 3
  decode steps at per-slot ``pos [B]`` through ``forward``, against the
  JAX package's steps and forward on the same artifact: in f32 compute
  each rank's vocabulary slice of the logits and its cache shard within
  1e-5 relative L2 of the matching slice, every cache position a step did
  not write bit-equal to what it held; in bf16 the logits' distance from
  the f32 step at most twice the port's unsharded bf16 step's (the JAX
  package's bf16 step breaks bf16 router ties its own way).
- deepseek-v2's latent cache at depth 16 is split over the sequence (model
  2 and 4), at depth 18 whole on every rank of model 4; one model-2 f32
  case runs the absorbed form (``mla_absorb``).  qwen2-moe's 6 experts do
  not divide model 4, so there its stacks stay replicated and every rank
  runs every expert, its shared experts still on shards; everywhere else
  both blocks run wholly on shards.
- At model 2 and 4 the configs' capacity factor (1.25) drops tokens, and
  the routing and capacity are the whole batch's on every rank, as in the
  JAX package.  At data 2 x model 2 a data group routes its own rows, so
  its capacity is its rows'; the case runs at the dropless factor
  ``n_experts / top_k`` that the serving engine asks for (no token drops
  in either package, so the two capacities give the same result).  At
  the configs' own factor the data groups' capacities give another result
  than the JAX package's whole batch (ROADMAP F25): that case is held to
  the JAX steps run on each data group's rows alone, and its distance from
  the whole batch's steps is pinned.
- ``moe_block`` refuses the dense oracle on a rank's split stacks.
- A ``make_fx`` trace over 8 fake ranks: nothing over ``data``; the only
  integer leaves gathered over ``model`` are MLA's ``k_up``/``v_up`` ``q``
  in the default form over a sequence split.

The ranks run while the test process computes the references.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
mp = pytest.importorskip("torch.multiprocessing")

import jax.numpy as jnp  # noqa: E402

from repro.configs.deepseek_v2_236b import SMOKE as J_MLA  # noqa: E402
from repro.configs.qwen2_moe_a2_7b import SMOKE as J_MOE  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.serve.deploy import deploy_view as j_deploy_view  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402
from repro_torch.configs.deepseek_v2_236b import SMOKE as MLA  # noqa: E402
from repro_torch.configs.qwen2_moe_a2_7b import SMOKE as MOE  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402

from test_torch_tp_serve import (B, DECODE, POS0, PROMPT,  # noqa: E402
                                 SPAWN_TIMEOUT_S, _free_port, _join, _np,
                                 _rel, _written)

ROOT = Path(__file__).resolve().parents[1]


def _dropless(cfg):
    """``cfg`` at capacity factor ``n_experts / top_k``: no token drops."""
    e = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        e, capacity_factor=e.n_experts / e.top_k))


#: name → (the port's config, the JAX package's, the artifact it serves)
CFGS = {"moe": (MOE, J_MOE, "moe"),
        "moe_dropless": (_dropless(MOE), _dropless(J_MOE), "moe"),
        "mla": (MLA, J_MLA, "mla"),
        "mla_dropless": (_dropless(MLA), _dropless(J_MLA), "mla"),
        "mla_absorb": (dataclasses.replace(MLA, mla_absorb=True),
                       dataclasses.replace(J_MLA, mla_absorb=True), "mla")}
#: (world, model, {config: cache depths}) of each mesh
MESHES = {"model2": (2, 2, {"moe": (16,), "mla": (16,), "mla_absorb": (16,)}),
          "model4": (4, 4, {"moe": (16,), "mla": (16, 18)}),
          "data2xmodel2": (4, 2, {"moe_dropless": (16,),
                                  "mla_dropless": (16,)})}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
#: the configs run in f32 only
F32_ONLY = ("mla_absorb",)
#: f32 runs at the configs' capacity factor over a data axis, each data
#: group routing and capping its own rows (F25): mesh → {config: depths}
PER_GROUP = {"data2xmodel2": {"moe": (16,), "mla": (16,)}}


def _leaves(name: str) -> tuple:
    return ("ckv", "kr") if CFGS[name][0].mla is not None else ("k", "v")


@functools.lru_cache(maxsize=None)
def _case(art: str):
    """A student of the artifact's SMOKE config from a seed, its exported
    artifact (plan leaf included), the prompt and the decode tokens."""
    from repro_torch.models import init_model
    from repro_torch.pipeline.adapters import resolve_quant_plan
    from repro_torch.serve.deploy import export_for_layers, make_deploy_plan
    cfg = {"moe": MOE, "mla": MLA}[art]
    q = QuantConfig()
    g = np.random.default_rng(17)
    student = init_model(5, cfg, q, device="cpu")
    plan = make_deploy_plan(q, arch=cfg.name, family=cfg.family,
                            quant_plan=resolve_quant_plan(cfg, q))
    with torch.no_grad():
        exported = export_for_layers(student, plan, device="cpu")
    prompt = torch.from_numpy(g.integers(0, cfg.vocab, size=(B, PROMPT)))
    steps = torch.from_numpy(g.integers(0, cfg.vocab, size=(DECODE, B, 1)))
    return exported, prompt, steps


def _runs(mesh: str):
    """(config, dtype name, cache depth) of every run a mesh's ranks make."""
    out = []
    for name, depths in MESHES[mesh][2].items():
        for dt in (("f32",) if name in F32_ONLY else DTYPES):
            out += [(name, dt, T) for T in depths]
    for name, depths in PER_GROUP.get(mesh, {}).items():
        out += [(name, "f32", T) for T in depths]
    return out


def _rank(rank, world, port, model, mesh_name, d, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    from repro_torch.core.plan import PLAN_KEY
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.launch.train import local_rows, place
    from repro_torch.models import forward, init_cache
    from repro_torch.models.transformer import layer_slice
    from repro_torch.sharding import tp
    from repro_torch.sharding.partition import (ShardingPolicy,
                                                cache_shardings,
                                                params_shardings)
    from repro_torch.train import steps
    mesh = make_elastic_mesh(world, model, device_type="cpu")
    pol = ShardingPolicy()
    res = {"coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model"))}
    placed = {}
    for name, dt, T in _runs(mesh_name):
        cfg, _, art_name = CFGS[name]
        dtype = DTYPES[dt][0]
        art, prompt, dec = torch.load(os.path.join(d, f"{art_name}.pt"))
        if art_name not in placed:
            art = {k: v for k, v in art.items() if k != PLAN_KEY}
            placed[art_name] = place(art, params_shardings(art, cfg, mesh,
                                                           pol), mesh)
        ex = placed[art_name]
        with torch.no_grad():
            lv, attn, mlp = tp.layer_view(layer_slice(ex["layers"], 0), cfg,
                                          dtype, cache=True)
        res[(name, "blocks")] = (attn is not None, mlp is not None,
                                 lv["mlp"]["up"]["w"].shape[0])
        steps.forward = functools.partial(forward, compute_dtype=dtype)
        prefill = steps.make_prefill_step(cfg, None)
        decode = steps.make_decode_step(cfg, None)
        pos0 = local_rows({"p": torch.tensor(POS0, dtype=torch.int32)},
                          mesh, pol)["p"]
        for mode in ("scalar", "slot"):
            whole = init_cache(cfg, B, T, dtype=dtype, device="cpu")
            cache = place(whole, cache_shardings(whole, cfg, mesh, pol),
                          mesh)
            trail = []

            def keep(logits):
                trail.append({"logits": logits.detach().clone(),
                              **{n: cache[n].to_local().clone()
                                 for n in _leaves(name)}})
            with torch.no_grad():
                logits, cache = prefill(ex, cache, local_rows(
                    {"tokens": prompt}, mesh, pol))
                keep(logits)
                if mode == "slot":
                    cache["pos"] = pos0.clone()
                for i in range(DECODE):
                    b = local_rows({"tokens": dec[i]}, mesh, pol)
                    if mode == "scalar":
                        logits, cache = decode(ex, cache, b)
                    else:
                        o = forward(ex, cfg, None, b, cache=cache,
                                    compute_dtype=dtype, use_kernels=True)
                        logits, cache = o["logits"][:, -1], o["cache"]
                    keep(logits)
            res[(name, dt, T, mode)] = {"steps": trail,
                                        "kv": tp.cache_view(cache)[1]}
    torch.save(res, out)
    dist.destroy_process_group()


def _rank_to_file(rank, world, port, model, mesh, d):
    _rank(rank, world, port, model, mesh, d,
          os.path.join(d, f"{mesh}.{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every mesh's ranks started at once; each rank's results once the
    references below are computed."""
    d = tmp_path_factory.mktemp("tp_serve_moe")
    for art in ("moe", "mla"):
        torch.save(_case(art), d / f"{art}.pt")
    ctxs = {}
    for m, (world, model, _) in MESHES.items():
        ctxs[m] = mp.start_processes(
            _rank_to_file, args=(world, _free_port(), model, m, str(d)),
            nprocs=world, join=False, start_method="spawn")

    def results(mesh):
        ctx = ctxs[mesh]
        world = MESHES[mesh][0]
        if ctx is not None:
            _join(ctx, world)
            ctxs[mesh] = None
        return [torch.load(d / f"{mesh}.{r}.pt") for r in range(world)]

    yield results
    for ctx in ctxs.values():
        if ctx is not None:
            for p in ctx.processes:
                p.kill()


# ------------------------------------------------------------- references

def _jnp(tree):
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


@functools.lru_cache(maxsize=None)
def _jax_ref(name: str, dt: str, T: int, mode: str, rows=None):
    """The JAX package's prefill + decode steps (scalar ``pos``) or its
    forward at per-slot ``pos`` on the converted artifact: per step the
    logits and the cache's leaves.  ``rows`` ``(first, stop)``: on those
    rows of the batch alone."""
    _, jcfg, art_name = CFGS[name]
    art, prompt, dec = _case(art_name)
    pos0 = POS0
    if rows is not None:
        sel = slice(*rows)
        prompt, dec, pos0 = prompt[sel], dec[:, sel], pos0[sel]
    jdt = DTYPES[dt][1]
    params = j_deploy_view(_jnp(art), JQ(), dtype=jdt)
    fwd = functools.partial(j_forward, compute_dtype=jdt)
    cache = j_init_cache(jcfg, prompt.shape[0], T, dtype=jdt)
    out = []

    def keep(logits, cache):
        out.append({"logits": _np(logits),
                    **{n: _np(cache[n]) for n in _leaves(name)}})
    with pytest.MonkeyPatch.context() as m:
        m.setattr(j_steps, "forward", fwd)
        logits, cache = j_steps.make_prefill_step(jcfg, None)(
            params, cache, {"tokens": jnp.asarray(prompt.numpy())})
        keep(logits, cache)
        if mode == "slot":
            cache = {**cache, "pos": jnp.asarray(pos0, jnp.int32)}
        for i in range(DECODE):
            b = {"tokens": jnp.asarray(dec[i].numpy())}
            if mode == "scalar":
                logits, cache = j_steps.make_decode_step(jcfg, None)(
                    params, cache, b)
            else:
                o = fwd(params, jcfg, None, b, cache=cache)
                logits, cache = o["logits"][:, -1], o["cache"]
            keep(logits, cache)
    return out


@functools.lru_cache(maxsize=None)
def _port_bf16(name: str, T: int, mode: str) -> list:
    """The port's unsharded bf16 steps on the artifact's deploy view (the
    plain process, no DTensor), as :func:`_jax_ref` runs them: per step
    the logits."""
    from repro_torch.models import forward, init_cache
    from repro_torch.serve.deploy import deploy_view
    cfg, _, art_name = CFGS[name]
    art, prompt, dec = _case(art_name)
    dt = torch.bfloat16
    params = deploy_view(art, QuantConfig(), dtype=dt)
    cache = init_cache(cfg, B, T, dtype=dt, device="cpu")
    out = []
    with torch.no_grad():
        o = forward(params, cfg, None, {"tokens": prompt}, cache=cache,
                    compute_dtype=dt)
        out.append(o["logits"][:, -1].float())
        if mode == "slot":
            cache["pos"] = torch.tensor(POS0, dtype=torch.int32)
        for i in range(DECODE):
            o = forward(params, cfg, None, {"tokens": dec[i]}, cache=cache,
                        compute_dtype=dt, use_kernels=mode == "slot")
            out.append(o["logits"][:, -1].float())
    return out


def _slices(res: dict, kv, cfg, world: int, model: int, T: int):
    """This rank's rows, vocabulary columns and the index of its cache
    shard (``[L, B, T, ...]``: the sequence, and the KV heads of k/v)."""
    d, m = res["coords"]
    n_data = world // model
    rows = slice(d * B // n_data, (d + 1) * B // n_data)
    V = cfg.vocab_padded
    vocab = slice(m * V // model, (m + 1) * V // model)
    seq = slice(m * T // model, (m + 1) * T // model) if kv == "seq" \
        else slice(0, T)
    Hkv = cfg.n_kv_heads_padded
    heads = slice(m * Hkv // model, (m + 1) * Hkv // model) \
        if kv == "heads" else slice(0, Hkv)
    shard = ((slice(None), rows, seq) if cfg.mla is not None
             else (slice(None), rows, seq, heads))
    return rows, vocab, seq, shard


def _check_f32(got: list, name: str, T: int, mesh: str,
               per_group: bool = False):
    """Every rank's f32 steps against the JAX package's on the whole batch,
    or with ``per_group`` on the rank's data group's rows alone."""
    world, model, _ = MESHES[mesh]
    cfg = CFGS[name][0]
    kinds = set()
    for mode in ("scalar", "slot"):
        for res in got:
            run = res[(name, "f32", T, mode)]
            kv = run["kv"]
            kinds.add(kv)
            rows, vocab, seq, shard = _slices(res, kv, cfg, world, model, T)
            if per_group:
                ref = _jax_ref(name, "f32", T, mode, (rows.start, rows.stop))
                ref_rows = slice(None)
                shard = (shard[0], ref_rows) + shard[2:]
            else:
                ref, ref_rows = _jax_ref(name, "f32", T, mode), rows
            before = None
            for i, (st, r) in enumerate(zip(run["steps"], ref)):
                what = (mesh, name, T, mode, kv, res["coords"], i)
                err = _rel(st["logits"], r["logits"][ref_rows, vocab])
                assert err <= 1e-5, (what, "logits", err)
                w = _written(mode, i, T)[rows, seq]
                for n in _leaves(name):
                    want = r[n][shard]
                    assert st[n].shape == want.shape, (what, n)
                    err = _rel(st[n], want)
                    assert err <= 1e-5, (what, n, err)
                    prev = (torch.zeros_like(st[n]) if before is None
                            else before[n])
                    w_n = w.reshape((1,) + w.shape
                                    + (1,) * (st[n].ndim - 3))
                    kept = ~w_n.expand_as(st[n])
                    assert torch.equal(st[n][kept], prev[kept]), (
                        what, n, "an unwritten position changed")
                before = st
    return kinds


#: each mesh's cache splits, and per config whether the attention and the
#: MoE block ran on shards and the experts of a rank's stacks (qwen2-moe's
#: 6 at model 4: the stacks whole, the shared experts on shards)
WANT = {"model2": ({"heads", "seq"},
                   {"moe": (True, True, 3), "mla": (True, True, 4),
                    "mla_absorb": (True, True, 4)}),
        "model4": ({"heads", "seq", None},
                   {"moe": (True, True, 6), "mla": (True, True, 2)}),
        "data2xmodel2": ({"heads", "seq"},
                         {"moe_dropless": (True, True, 3),
                          "mla_dropless": (True, True, 4)})}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_serve_moe_mla_f32_matches_jax(mesh, ranks):
    got = ranks(mesh)
    kinds = set()
    for name, depths in MESHES[mesh][2].items():
        for T in depths:
            kinds |= _check_f32(got, name, T, mesh)
    want_kinds, want_blocks = WANT[mesh]
    assert kinds == want_kinds, kinds
    for res in got:
        assert {n: res[(n, "blocks")] for n in want_blocks} == want_blocks


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_serve_moe_mla_bf16_within_twice_the_unsharded(mesh, ranks):
    """The whole logits (each rank's rows and vocabulary slice put
    together) of every step, in bf16: their distance from the JAX f32
    step's at most twice the port's unsharded bf16 step's.  The port's,
    not the JAX package's: the two packages' bf16 steps resolve bf16
    router ties differently (at deepseek-v2's prefill a layer-0 token's
    2nd and 3rd router logits tie in the port's bf16, 0.0029 apart in f32,
    under a bf16 ulp of the row's largest logit), so a routing decision
    may split them where sharding changes nothing."""
    got = ranks(mesh)
    world, model, depths = MESHES[mesh]
    for name in depths:
        if name in F32_ONLY:
            continue
        cfg = CFGS[name][0]
        V = cfg.vocab_padded
        for T in depths[name]:
            for mode in ("scalar", "slot"):
                f32 = _jax_ref(name, "f32", T, mode)
                b16 = _port_bf16(name, T, mode)
                for i in range(DECODE + 1):
                    full = torch.full((B, V), float("nan"))
                    for res in got:
                        run = res[(name, "bf16", T, mode)]
                        rows, vocab, _, _ = _slices(res, run["kv"], cfg,
                                                    world, model, T)
                        full[rows, vocab] = run["steps"][i]["logits"].float()
                    assert not full.isnan().any()
                    d_tp = float((full - f32[i]["logits"]).norm())
                    d_16 = float((b16[i] - f32[i]["logits"]).norm())
                    assert d_tp <= 2 * d_16, (mesh, name, T, mode, i, d_tp,
                                              d_16)


def test_tp_serve_moe_mla_data_groups_cap_their_own_rows(ranks):
    """At data 2 x model 2 and the configs' capacity factor (1.25, which
    drops tokens), every rank's f32 steps lie within 1e-5 of the JAX
    package's steps run on its data group's rows alone: a data group
    routes and caps its own rows.  The JAX package's step caps the whole
    batch, so its logits lie farther off: F25, pinned here until capacity
    is computed over the whole batch (or the difference is accepted as
    designed and the finding closed)."""
    mesh = "data2xmodel2"
    world, model, _ = MESHES[mesh]
    got = ranks(mesh)
    for name, depths in PER_GROUP[mesh].items():
        cfg = CFGS[name][0]
        for T in depths:
            _check_f32(got, name, T, mesh, per_group=True)
            worst = 0.0
            for mode in ("scalar", "slot"):
                whole = _jax_ref(name, "f32", T, mode)
                for res in got:
                    run = res[(name, "f32", T, mode)]
                    rows, vocab, _, _ = _slices(res, run["kv"], cfg, world,
                                                model, T)
                    for st, r in zip(run["steps"], whole):
                        worst = max(worst, _rel(st["logits"],
                                                r["logits"][rows, vocab]))
            assert worst > 1e-2, (name, T, worst)


def test_moe_block_refuses_the_dense_oracle_on_split_stacks():
    """The dense oracle runs every expert: ``moe_block`` refuses it on a
    rank's ``E/tp`` experts rather than run the rank's stacks as if whole."""
    import types
    from repro_torch.models.moe import moe_block
    E = MOE.moe.n_experts_padded
    half = {"up": {"w": torch.zeros(E // 2, 4, 4)}}
    x = torch.zeros(1, 2, MOE.d_model)
    with pytest.raises(ValueError, match="dense oracle"):
        moe_block(x, half, MOE, None, mode="dense",
                  tp=types.SimpleNamespace(rank=1, size=2))


# ------------------------------------------------------------------ trace

_TRACE = r"""
import dataclasses, json, collections
import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _resolve_process_group
from repro_torch.configs.deepseek_v2_236b import SMOKE as MLA
from repro_torch.configs.qwen2_moe_a2_7b import SMOKE as MOE
from repro_torch.core.plan import PLAN_KEY
from repro_torch.core.qconfig import QuantConfig
from repro_torch.analysis.graph_checks import trace, op_name, node_val
from repro_torch.launch.dryrun import (as_dtensors, init_fake_world,
                                       local_cache, serve_cache_specs)
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.launch.train import place
from repro_torch.models import init_cache, init_model
from repro_torch.pipeline.adapters import resolve_quant_plan
from repro_torch.serve.deploy import export_for_layers, make_deploy_plan
from repro_torch.sharding.partition import ShardingPolicy, params_shardings
from repro_torch.train.steps import make_decode_step, make_prefill_step
init_fake_world(8)
q = QuantConfig()
pol = ShardingPolicy()
out = {}
for tag, cfg, data, model in (
        ("moe 4x2", MOE, 4, 2), ("moe 2x4", MOE, 2, 4),
        ("mla 2x4", MLA, 2, 4), ("mla 4x2", MLA, 4, 2),
        ("absorb 2x4", dataclasses.replace(MLA, mla_absorb=True), 2, 4)):
    student = init_model(0, cfg, q, device="meta")
    plan = make_deploy_plan(q, family=cfg.family,
                            quant_plan=resolve_quant_plan(cfg, q))
    with torch.no_grad():
        art = export_for_layers(student, plan, device="meta")
    art.pop(PLAN_KEY)
    mesh = make_elastic_mesh(8, model, device_type="cpu")
    ex = place(art, params_shardings(art, cfg, mesh, pol), mesh)
    whole = init_cache(cfg, 8, 16, device="meta")
    specs = serve_cache_specs(whole, cfg, mesh, pol)
    local = local_cache(whole, specs, mesh)
    # an axis by its group's ranks: a DTensor may carry an earlier mesh of
    # the same ranks (DTensor compares meshes by value), whose groups are
    # other objects with other names
    by_ranks = {tuple(dist.get_process_group_ranks(mesh.get_group(a))): a
                for a in ("data", "model")}

    def axis(name):
        pg = _resolve_process_group(name)
        return by_ranks.get(tuple(dist.get_process_group_ranks(pg)), name)
    seen = collections.Counter()
    ints = []
    for step, S in ((make_prefill_step, 5), (make_decode_step, 1)):
        inner = step(cfg, None)

        def fn(c, t):
            with torch.no_grad():
                logits, _ = inner(ex, as_dtensors(c, specs, whole, mesh),
                                  {"tokens": t})
            return logits, c
        tokens = torch.empty((8 // data, S), dtype=torch.int64,
                             device="meta")
        tr = trace(fn, local, tokens)
        assert tr.graph is not None, tr.untraceable
        for n in tr.nodes():
            if getattr(n.target, "namespace", "") != "_c10d_functional":
                continue
            kind = op_name(n)
            if kind == "wait_tensor":
                continue
            g = [a for a in n.args if isinstance(a, str)][-1]
            src = node_val(n.args[0])
            fl = src.is_floating_point()
            seen[f"{kind}/{axis(g)}/{'float' if fl else 'int'}"] += 1
            if not fl:
                ints.append(src.numel())
    up = {n: ex["layers"]["attn"][n]["q"].to_local()[0].numel()
          for n in ("k_up", "v_up")} if cfg.mla is not None else {}
    lead = next(iter(local.values()))
    out[tag] = {"seen": seen, "ints": ints, "up": up,
                "cache": list(lead.shape), "layers": cfg.n_layers}
print(json.dumps(out))
"""


def test_trace_gathers_only_the_mla_up_projections():
    """On 8 fake ranks, a prefill and a decode step each: no collective
    over ``data``; over ``model`` all-reduces (*g*, the combine) and
    all-gathers of float activations; integer all-gathers only of MLA's
    ``k_up``/``v_up`` shards, one each a layer a step, in the default form
    over a latent cache split over the sequence — none in the absorbed
    form, and no expert stack's or shared expert's ``q`` anywhere
    (qwen2-moe's 6 experts at model 4 stay replicated, its shared experts
    on shards)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _TRACE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    allowed = {"all_reduce/model/float", "all_gather_into_tensor/model/float",
               "all_gather_into_tensor/model/int"}
    for tag, got in out.items():
        assert got["seen"].get("all_reduce/model/float", 0) > 0, (tag, got)
        assert set(got["seen"]) <= allowed, (tag, got)
    # the latent cache [L, B/data, T/model, lat] over the sequence
    assert out["mla 2x4"]["cache"] == [2, 4, 4, 16]
    assert out["mla 4x2"]["cache"] == [2, 2, 8, 16]
    for tag in ("mla 2x4", "mla 4x2"):
        got = out[tag]
        want = sorted(list(got["up"].values()) * 2 * got["layers"])
        assert sorted(got["ints"]) == want, (tag, got)
    for tag in ("moe 4x2", "moe 2x4", "absorb 2x4"):
        assert out[tag]["ints"] == [], (tag, out[tag])
