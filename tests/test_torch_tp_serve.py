"""Tensor parallelism over ``model`` in the forward with a cache
(``repro_torch.sharding.tp``'s deployed views, ``models.attention``'s
split caches), on the CPU over spawned ``gloo`` ranks at SMOKE qwen3-8b
width (2 layers, d 64, 4 query and 2 KV heads):

- the exported artifact stored as ``params_shardings`` places it (its
  ``q`` leaves over ``model`` only) and the monolithic cache as
  ``cache_shardings`` places it; at model 2 (KV heads split), model 4 (2
  KV heads over 4 ranks: the cache depth 16 splits over the sequence, the
  depth 18 stays whole on every rank) and data 2 x model 2 (KV heads
  split), a prefill at scalar ``pos`` and 3 decode steps through
  ``make_prefill_step``/``make_decode_step``, and the same prefill then 3
  decode steps at per-slot ``pos [B]`` through ``forward`` on the kernel
  route (K2's plain version here), against the JAX package's steps and
  forward on the same artifact: in f32 compute each rank's vocabulary
  slice of the logits and its cache shard within 1e-5 relative L2 of the
  matching slice, and every cache position a step did not write bit-equal
  to what it held; in bf16 compute the logits' distance from the f32 step
  at most twice the unsharded bf16 step's;
- qwen2-vl's SMOKE backbone (biased q/k/v, M-RoPE) the same way in f32 at
  model 2 and model 4;
- ``core.dof.shard_export``: a shard's dequantized weight is the slice of
  the whole one's, bit for bit, for every layout, packed or not;
- a ``make_fx`` trace over fake ranks: no all-gather over ``data``, and
  over ``model`` only activations (never a ``q`` leaf).

The ranks run while the test process computes the references.
"""
import functools
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
mp = pytest.importorskip("torch.multiprocessing")

import jax.numpy as jnp  # noqa: E402

from repro.configs.qwen2_vl_7b import SMOKE as J_VLM  # noqa: E402
from repro.configs.qwen3_8b import SMOKE as J_DENSE  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.serve.deploy import deploy_view as j_deploy_view  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402
from repro_torch.configs.qwen2_vl_7b import SMOKE as VLM  # noqa: E402
from repro_torch.configs.qwen3_8b import SMOKE as DENSE  # noqa: E402
from repro_torch.core import dof  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120
CFGS = {"dense": (DENSE, J_DENSE), "vlm": (VLM, J_VLM)}
#: (world, model, {config: cache depths}) of each mesh
MESHES = {"model2": (2, 2, {"dense": (16,), "vlm": (16,)}),
          "model4": (4, 4, {"dense": (16, 18), "vlm": (16,)}),
          "data2xmodel2": (4, 2, {"dense": (16,)})}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
#: the VLM runs in f32 only
VLM_DTYPES = ("f32",)
B, PROMPT, DECODE = 4, 5, 3
#: the per-slot decode's first positions: each row attends its own prefix,
#: three of them rewriting rows the prefill wrote
POS0 = (5, 2, 4, 3)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """A student of ``name``'s SMOKE config from a seed (biases drawn, so
    their shards show), its exported artifact (plan leaf included), the
    prompt and the decode tokens."""
    from repro_torch.models import init_model
    from repro_torch.pipeline.adapters import resolve_quant_plan
    from repro_torch.serve.deploy import export_for_layers, make_deploy_plan
    from repro_torch.tree import tree_from_items, tree_items
    cfg = CFGS[name][0]
    q = QuantConfig()
    g = np.random.default_rng(7)
    student = tree_from_items(
        (p, torch.from_numpy(g.normal(size=t.shape).astype(np.float32)
                             * 0.05) if p[-1] == "b" else t)
        for p, t in tree_items(init_model(3, cfg, q, device="cpu")))
    plan = make_deploy_plan(q, arch=cfg.name, family=cfg.family,
                            quant_plan=resolve_quant_plan(cfg, q))
    with torch.no_grad():
        art = export_for_layers(student, plan, device="cpu")
    prompt = torch.from_numpy(g.integers(0, cfg.vocab, size=(B, PROMPT)))
    steps = torch.from_numpy(g.integers(0, cfg.vocab, size=(DECODE, B, 1)))
    return art, prompt, steps


def _runs(mesh: str):
    """(config, dtype name, cache depth) of every run a mesh's ranks make."""
    out = []
    for name, depths in MESHES[mesh][2].items():
        for dt in (VLM_DTYPES if name == "vlm" else DTYPES):
            out += [(name, dt, T) for T in depths]
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
        cfg = CFGS[name][0]
        dtype = DTYPES[dt][0]
        art, prompt, dec = torch.load(os.path.join(d, f"{name}.pt"))
        if name not in placed:
            art = {k: v for k, v in art.items() if k != PLAN_KEY}
            placed[name] = place(art, params_shardings(art, cfg, mesh, pol),
                                 mesh)
        ex = placed[name]
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
                                 for n in ("k", "v")},
                              "pos": cache["pos"]})
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


def _join(ctx, world):
    deadline = time.time() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every mesh's ranks started at once; each rank's results once the
    references below are computed."""
    d = tmp_path_factory.mktemp("tp_serve")
    for name in CFGS:
        torch.save(_case(name), d / f"{name}.pt")
    ctxs = {m: _start_one(m, d) for m in MESHES}

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


def _start_one(mesh, d):
    world, model, _ = MESHES[mesh]
    return mp.start_processes(
        _rank_to_file, args=(world, _free_port(), model, mesh, str(d)),
        nprocs=world, join=False, start_method="spawn")


def _rank_to_file(rank, world, port, model, mesh, d):
    _rank(rank, world, port, model, mesh, d,
          os.path.join(d, f"{mesh}.{rank}.pt"))


# ------------------------------------------------------------- references

def _jnp(tree):
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _np(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


@functools.lru_cache(maxsize=None)
def _jax_ref(name: str, dt: str, T: int, mode: str):
    """The JAX package's prefill + decode steps (scalar ``pos``) or its
    forward at per-slot ``pos`` on the converted artifact: per step the
    logits and the cache's k/v, and the positions each step wrote."""
    jcfg = CFGS[name][1]
    art, prompt, dec = _case(name)
    jdt = DTYPES[dt][1]
    params = j_deploy_view(_jnp(art), JQ(), dtype=jdt)
    fwd = functools.partial(j_forward, compute_dtype=jdt)
    cache = j_init_cache(jcfg, B, T, dtype=jdt)
    out = []

    def keep(logits, cache):
        out.append({"logits": _np(logits), "k": _np(cache["k"]),
                    "v": _np(cache["v"])})
    with pytest.MonkeyPatch.context() as m:
        m.setattr(j_steps, "forward", fwd)
        logits, cache = j_steps.make_prefill_step(jcfg, None)(
            params, cache, {"tokens": jnp.asarray(prompt.numpy())})
        keep(logits, cache)
        if mode == "slot":
            cache = {**cache, "pos": jnp.asarray(POS0, jnp.int32)}
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


def _written(mode: str, step: int, T: int) -> torch.Tensor:
    """``[B, T]``: the positions step ``step`` writes."""
    w = torch.zeros(B, T, dtype=torch.bool)
    if step == 0:
        w[:, :PROMPT] = True
    elif mode == "scalar":
        w[:, PROMPT + step - 1] = True
    else:
        for b, p in enumerate(POS0):
            w[b, min(p + step - 1, T - 1)] = True
    return w


def _slices(res: dict, kv, cfg, world: int, model: int, T: int):
    """This rank's rows, vocabulary columns and cache slice (seq, heads)."""
    d, m = res["coords"]
    n_data = world // model
    rows = slice(d * B // n_data, (d + 1) * B // n_data)
    V = cfg.vocab_padded
    vocab = slice(m * V // model, (m + 1) * V // model)
    Hkv = cfg.n_kv_heads_padded
    seq = slice(m * T // model, (m + 1) * T // model) if kv == "seq" \
        else slice(0, T)
    heads = slice(m * Hkv // model, (m + 1) * Hkv // model) \
        if kv == "heads" else slice(0, Hkv)
    return rows, vocab, seq, heads


def _rel(a, b) -> float:
    na = float(b.double().norm())
    e = float((a.double() - b.double()).norm())
    return e / na if na > 0 else (0.0 if e == 0 else float("inf"))


def _check_f32(got: list, name: str, T: int, mesh: str):
    world, model, _ = MESHES[mesh]
    cfg = CFGS[name][0]
    kinds = set()
    for mode in ("scalar", "slot"):
        ref = _jax_ref(name, "f32", T, mode)
        for res in got:
            run = res[(name, "f32", T, mode)]
            kv = run["kv"]
            kinds.add(kv)
            rows, vocab, seq, heads = _slices(res, kv, cfg, world, model, T)
            before = None
            for i, (st, r) in enumerate(zip(run["steps"], ref)):
                what = (mesh, name, T, mode, kv, res["coords"], i)
                err = _rel(st["logits"], r["logits"][rows, vocab])
                assert err <= 1e-5, (what, "logits", err)
                w = _written(mode, i, T)[rows, seq]
                for n in ("k", "v"):
                    want = r[n][:, rows, seq, heads]
                    assert st[n].shape == want.shape, (what, n)
                    err = _rel(st[n], want)
                    assert err <= 1e-5, (what, n, err)
                    prev = (torch.zeros_like(st[n]) if before is None
                            else before[n])
                    kept = ~w[None, :, :, None, None].expand_as(st[n])
                    assert torch.equal(st[n][kept], prev[kept]), (
                        what, n, "an unwritten position changed")
                before = st
    return kinds


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_serve_f32_matches_jax(mesh, ranks):
    got = ranks(mesh)
    kinds = set()
    for name, depths in MESHES[mesh][2].items():
        for T in depths:
            kinds |= _check_f32(got, name, T, mesh)
    want = {"model2": {"heads"}, "model4": {"seq", None},
            "data2xmodel2": {"heads"}}[mesh]
    assert kinds == want, kinds


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_serve_bf16_within_twice_the_unsharded(mesh, ranks):
    """The whole logits (each rank's rows and vocabulary slice put
    together) of every step, in bf16: their distance from the JAX f32
    step's at most twice the JAX bf16 step's."""
    got = ranks(mesh)
    world, model, depths = MESHES[mesh]
    V = DENSE.vocab_padded
    for T in depths["dense"]:
        for mode in ("scalar", "slot"):
            f32 = _jax_ref("dense", "f32", T, mode)
            b16 = _jax_ref("dense", "bf16", T, mode)
            for i in range(DECODE + 1):
                full = torch.full((B, V), float("nan"))
                for res in got:
                    run = res[("dense", "bf16", T, mode)]
                    rows, vocab, _, _ = _slices(res, run["kv"], DENSE,
                                                world, model, T)
                    full[rows, vocab] = run["steps"][i]["logits"].float()
                assert not full.isnan().any()
                d_tp = float((full - f32[i]["logits"]).norm())
                d_16 = float((b16[i]["logits"] - f32[i]["logits"]).norm())
                assert d_tp <= 2 * d_16, (mesh, T, mode, i, d_tp, d_16)


# ------------------------------------------------------------ shard_export

@pytest.mark.parametrize("layout", ["channel", "group", "layerwise"])
@pytest.mark.parametrize("axis", ["col", "row"])
def test_shard_export_is_the_slice_of_the_whole(layout, axis):
    """Each of 4 shards of an exported [64, 32] linear (packed int4 and
    int8), dequantized: the matching rows or columns of the whole
    weight's dequantization, bit for bit; the bias sliced with the
    columns and kept whole on the rows."""
    from repro_torch.core.fakequant import pack_int4
    g = np.random.default_rng(11)
    K, N, size = 64, 32, 4
    q = torch.from_numpy(g.integers(-8, 8, size=(K, N)).astype(np.int8))
    s_wr = {"channel": (N,), "group": (K // 8, N), "layerwise": ()}[layout]
    ex = {"s_wl": torch.from_numpy(g.uniform(0.5, 2, size=K).astype(
              np.float32)),
          "s_wr": torch.from_numpy(g.uniform(0.01, 0.02, size=s_wr).astype(
              np.float32)),
          "b": torch.from_numpy(g.normal(size=N).astype(np.float32))}
    for packed in (True, False):
        whole = dict(ex, q=pack_int4(q) if packed else q)
        ref = dof.deploy_node(whole, torch.float32)
        for r in range(size):
            if axis == "col":
                c = N // size
                part = whole["q"][:, r * c:(r + 1) * c]
                want = ref["w"][:, r * c:(r + 1) * c]
                want_b = ref["b"][r * c:(r + 1) * c]
            else:
                k = K // size // (2 if packed else 1)
                part = whole["q"][r * k:(r + 1) * k]
                want = ref["w"][r * K // size:(r + 1) * K // size]
                want_b = ref["b"]
            got = dof.deploy_node(dof.shard_export(dict(whole, q=part),
                                                   axis, r, size),
                                  torch.float32)
            assert torch.equal(got["w"], want), (layout, axis, packed, r)
            assert torch.equal(got["b"], want_b)


# ------------------------------------------------------------------ trace

_TRACE = r"""
import json, collections
import torch
from repro_torch.configs.qwen3_8b import SMOKE
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
student = init_model(0, SMOKE, q, device="meta")
plan = make_deploy_plan(q, family="dense",
                        quant_plan=resolve_quant_plan(SMOKE, q))
with torch.no_grad():
    art = export_for_layers(student, plan, device="meta")
art.pop(PLAN_KEY)
out = {}
for data, model in ((2, 4), (4, 2)):
    mesh = make_elastic_mesh(8, model, device_type="cpu")
    ex = place(art, params_shardings(art, SMOKE, mesh, pol), mesh)
    whole = init_cache(SMOKE, 8, 16, device="meta")
    specs = serve_cache_specs(whole, SMOKE, mesh, pol)
    local = local_cache(whole, specs, mesh)
    names = {mesh.get_group(a).group_name: a for a in ("data", "model")}
    seen = collections.Counter()
    for step, S in ((make_prefill_step, 5), (make_decode_step, 1)):
        inner = step(SMOKE, None)

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
            seen[f"{kind}/{names.get(g, g)}/"
                 f"{'float' if src.is_floating_point() else 'int'}"] += 1
    out[f"{data}x{model}"] = {"seen": seen,
                              "k": list(local["k"].shape)}
print(json.dumps(out))
"""


def test_trace_gathers_no_weight():
    """data 2 x model 4 (the cache over the sequence) and data 4 x model
    2 (over KV heads) on 8 fake ranks, a prefill and a decode step: no
    collective over ``data``; over ``model`` all-reduces (*g*, the
    combine) and, where the cache is split over the sequence, all-gathers
    of this step's float activations — never of an integer ``q`` leaf."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _TRACE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    seq, heads = out["2x4"], out["4x2"]
    assert seq["k"] == [2, 4, 4, 2, 16] and heads["k"] == [2, 2, 16, 1, 16]
    for got in (seq["seen"], heads["seen"]):
        assert got.get("all_reduce/model/float", 0) > 0, got
        assert set(got) <= {"all_reduce/model/float",
                            "all_gather_into_tensor/model/float"}, got
    assert seq["seen"].get("all_gather_into_tensor/model/float", 0) > 0
    assert "all_gather_into_tensor/model/float" not in heads["seen"]
