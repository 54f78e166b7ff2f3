"""repro_torch's serving engine vs the JAX package, and its own contracts.

- Greedy tokens equal the JAX ``Engine``'s on the same converted artifact,
  paged int8 and monolithic, through the kernel route and the plain route.
  The two packages round bf16 at different places, so a token may differ
  only at a step where the JAX package's own top-2 logit margin is within
  ``MARGIN_ULPS`` bf16 ulps of its top logit; the request is not compared
  past that step, and the test reports how many such steps it met.
- Inside the port, a request's tokens are the same served alone, in a
  static batch or interleaved (greedy and sampled).
- One device→host transfer per decode step; paged KV bookkeeping.
"""
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.qwen3_8b import SMOKE as J_SMOKE  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.serve.deploy import deploy_view as j_deploy_view  # noqa: E402
from repro.serve.deploy import export_for_layers as j_export  # noqa: E402
from repro.serve.deploy import make_deploy_plan as j_make_plan  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs.qwen3_8b import SMOKE as T_SMOKE  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.serve.deploy import DeployPlan  # noqa: E402
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.serve.kv_cache import (KVSpec, PageAllocator,  # noqa: E402
                                        bucket_for, prefill_buckets,
                                        resolve_kv_spec)

#: bf16 keeps 8 significant bits; the packages' logits differ by a few ulps
MARGIN_ULPS = 4

PROMPTS = [[1, 2, 3], list(range(1, 12)), [5, 4, 3, 2, 1],
           list(range(100, 140)), [9, 9], [300, 7, 42, 42, 8, 1, 0]]
NEW = 8


def _scfg(cls, kv_mode):
    return cls(max_slots=3, max_len=64, prefill_chunk=8, kv_mode=kv_mode,
               kv_page_size=16)


@functools.lru_cache(maxsize=None)
def _jax_artifact():
    jq = JQ()
    params = j_init_model(jax.random.PRNGKey(0), J_SMOKE, jq)
    plan = j_make_plan(jq, params=params, model_cfg=J_SMOKE)
    return plan, jax.jit(lambda p: j_export(p, plan))(params)


@functools.lru_cache(maxsize=None)
def _jax_tokens(kv_mode):
    plan, ex = _jax_artifact()
    eng = JEngine.from_artifact(J_SMOKE, plan, ex, _scfg(JServeConfig, kv_mode))
    return eng.generate([JRequest(prompt=p, max_new_tokens=NEW)
                         for p in PROMPTS])


def _port_engine(kv_mode="paged", use_kernels=True, max_slots=3):
    _, ex = _jax_artifact()
    scfg = _scfg(ServeConfig, kv_mode)
    scfg.max_slots = max_slots
    return Engine.from_artifact(
        T_SMOKE, DeployPlan(qcfg=TQ(), use_kernels=use_kernels),
        from_numpy_tree(jax.device_get(ex), "cpu"), scfg, device="cpu")


def _jax_margin_ok(context):
    """JAX's top-2 logit margin for the next token after ``context``,
    within MARGIN_ULPS bf16 ulps of the top logit."""
    plan, ex = _jax_artifact()
    dv = j_deploy_view(ex, plan)
    logits = j_forward(dv, J_SMOKE, None,
                       {"tokens": jnp.asarray([context], jnp.int32)})
    z = np.sort(np.asarray(logits["logits"][0, -1], np.float32))[::-1]
    ulp = 2.0 ** (math.floor(math.log2(abs(z[0]))) - 7)
    return z[0] - z[1] <= MARGIN_ULPS * ulp


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("kv_mode", ["paged", "monolithic"])
def test_greedy_tokens_match_jax_engine(kv_mode, use_kernels):
    want = _jax_tokens(kv_mode)
    got = _port_engine(kv_mode, use_kernels).generate(
        [Request(prompt=p, max_new_tokens=NEW) for p in PROMPTS])
    near_ties = 0
    for prompt, w, g in zip(PROMPTS, want, got):
        assert len(g) == len(w) == NEW
        i = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if i is not None:
            assert _jax_margin_ok(prompt + w[:i]), (prompt, i, w, g)
            near_ties += 1
    print(f"{kv_mode} kernels={use_kernels}: {near_ties} of {len(PROMPTS)} "
          f"requests diverged at a near-tie step")
    assert near_ties <= 1          # a near-tie is rare, not the rule


def test_kernel_route_counts_and_stats():
    eng = _port_engine("paged", True)
    assert eng.stats()["decode_attn_kernel_layers"] == T_SMOKE.n_layers
    assert eng.stats()["decode_attn_ref_layers"] == 0
    plain = _port_engine("paged", False).stats()
    assert plain["decode_attn_kernel_layers"] == 0
    assert plain["decode_attn_ref_layers"] == T_SMOKE.n_layers
    before = decode_attention.launches
    eng.generate([Request(prompt=[1, 2], max_new_tokens=3)])
    assert decode_attention.launches == before     # plain version on the CPU
    assert eng.stats()["decode_steps"] == 3


REQS = [Request(prompt=[1, 2, 3], max_new_tokens=5),
        Request(prompt=[7, 8], max_new_tokens=3),
        Request(prompt=list(range(1, 12)), max_new_tokens=4),
        Request(prompt=[5, 4, 3, 2, 1], max_new_tokens=6),
        Request(prompt=[9, 9], max_new_tokens=2, eos_id=0)]


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kv_mode", ["paged", "monolithic"])
def test_solo_static_interleaved_identical(kv_mode, sampled):
    reqs = [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                    eos_id=r.eos_id, seed=i,
                    temperature=0.9 if sampled else 0.0,
                    top_k=20 if sampled else 0, top_p=0.9 if sampled else 1.0)
            for i, r in enumerate(REQS)]
    eng = _port_engine(kv_mode)
    solo = []
    for r in reqs:
        eng.reset()
        solo.append(eng.generate([r])[0])
    eng.reset()
    static = eng.generate(reqs)
    eng.reset()
    inter = {}
    rids = [eng.submit(reqs[3]), eng.submit(reqs[0])]
    inter.update(eng.step())
    rids += [eng.submit(reqs[4]), eng.submit(reqs[1])]
    inter.update(eng.step())
    inter.update(eng.step())
    rids.append(eng.submit(reqs[2]))
    while eng.pending():
        inter.update(eng.step())
    order = [3, 0, 4, 1, 2]
    inter_tokens = [None] * 5
    for rid, i in zip(rids, order):
        inter_tokens[i] = inter[rid]
    assert solo == static == inter_tokens
    assert eng.stats()["kv_pages_free"] == eng.stats()["kv_pages_total"]


def test_stream_and_callback_deliver_the_generate_tokens():
    eng = _port_engine("paged")
    want = eng.generate([REQS[0]])[0]
    eng.reset()
    assert list(eng.stream(REQS[0])) == want
    eng.reset()
    seen = []
    eng.submit(REQS[0], on_token=lambda t, fin: seen.append((t, fin)))
    while eng.pending():
        assert not eng.step()
    assert [t for t, _ in seen] == want and seen[-1][1]


def test_one_host_transfer_per_decode_step(monkeypatch):
    """Tensor→host conversions during serving: exactly one ``.cpu()`` per
    decode step and no ``.item()``/``bool()``/``int()`` on a tensor."""
    eng = _port_engine("paged")
    counts = {"cpu": 0, "other": 0}
    orig_cpu = torch.Tensor.cpu

    def cpu(self, *a, **k):
        counts["cpu"] += 1
        return orig_cpu(self, *a, **k)

    def bad(name):
        orig = getattr(torch.Tensor, name)

        def f(self, *a, **k):
            counts["other"] += 1
            return orig(self, *a, **k)
        return f

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    for name in ("item", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, bad(name))
    eng.generate(REQS)
    monkeypatch.undo()
    assert counts["cpu"] == eng.decode_steps > 0
    assert counts["other"] == 0


def test_engine_validation_and_entry_points():
    eng = _port_engine("paged")
    for bad, match in [(Request(prompt=[]), "non-empty"),
                       (Request(prompt=[1], max_new_tokens=0), ">= 1"),
                       (Request(prompt=[1] * 60, max_new_tokens=8), "max_len"),
                       (Request(prompt=[T_SMOKE.vocab]), "prompt tokens"),
                       (Request(prompt=[1], temperature=-1.0), "temperature"),
                       (Request(prompt=[1], top_p=0.0), "top_p")]:
        with pytest.raises(ValueError, match=match):
            eng.generate([bad])
    # the inline-export constructor serves what from_artifact serves
    params = init_model(0, T_SMOKE, TQ(), device="cpu")
    e2 = Engine(T_SMOKE, TQ(), params, _scfg(ServeConfig, "paged"),
                device="cpu")
    assert len(e2.generate([Request(prompt=[3, 4], max_new_tokens=3)])[0]) == 3


def test_bucketed_prefill_matches_exact_length_prefill():
    """Pad-and-mask prefill (what the engine runs) gives the exact-length
    prefill's last-token logits, cache rows and position."""
    from repro_torch.models import init_cache
    from repro_torch.serve.deploy import deploy_view, export_for_layers
    from repro_torch.train.steps import (make_bucketed_prefill_step,
                                         make_prefill_step)
    params = init_model(0, T_SMOKE, TQ(), device="cpu")
    dv = deploy_view(export_for_layers(params, TQ(), device="cpu"), TQ())
    toks = torch.tensor([[5, 9, 2, 7, 7]])
    exact = make_prefill_step(T_SMOKE, None)
    bucketed = make_bucketed_prefill_step(T_SMOKE, None)
    ca = init_cache(T_SMOKE, 1, 16, device="cpu")
    cb = init_cache(T_SMOKE, 1, 16, device="cpu")
    with torch.no_grad():
        la, ca = exact(dv, ca, {"tokens": toks})
        lb, cb = bucketed(dv, cb, {"tokens": torch.cat(
            [toks, torch.zeros((1, 3), dtype=toks.dtype)], 1)}, 5)
    torch.testing.assert_close(lb, la, rtol=0, atol=0)
    assert ca["pos"] == cb["pos"] == 5
    torch.testing.assert_close(cb["k"][:, :, :5], ca["k"][:, :, :5],
                               rtol=0, atol=0)


def test_page_allocator_and_kv_geometry():
    pa = PageAllocator(6)
    assert pa.alloc(3) == [0, 1, 2] and pa.alloc(1) == [3]
    pa.release([1])
    assert pa.alloc(2) == [1, 4]
    with pytest.raises(ValueError, match="double free"):
        pa.release([0, 0])
    with pytest.raises(ValueError, match="outside pool"):
        pa.release([99])
    with pytest.raises(RuntimeError, match="exhausted"):
        pa.alloc(5)
    kv = resolve_kv_spec(T_SMOKE, _scfg(ServeConfig, "paged"))
    assert kv == KVSpec(page_size=16, n_pages=12, max_pages_per_slot=4)
    assert kv.trash_page == 12 and kv.view_len == 64
    assert resolve_kv_spec(T_SMOKE, _scfg(ServeConfig, "monolithic")) is None
    assert prefill_buckets(12) == (1, 2, 4, 8, 12)
    assert [bucket_for(n, 8) for n in (1, 3, 5, 8)] == [1, 4, 8, 8]


@pytest.mark.parametrize("page_size", [16, 5])
def test_paged_decode_kernel_route_reads_the_pools(monkeypatch, page_size):
    """With ``use_kernels`` the paged decode step hands the int8 pools, the
    page table and the scales themselves to ``decode_attention_paged``: no
    gathered ``[S, T, Hkv, hd]`` view reaches the kernel route, and the
    unpaged entry is not called.  Its output (the plain version on the
    CPU) equals the plain route ``_paged_sdpa`` on the gathered view to
    1e-6 relative, and both routes write the step's K/V alike."""
    from repro_torch.models import attention as attn
    cfg = T_SMOKE
    H, Hkv, hd = cfg.n_heads_padded, cfg.n_kv_heads_padded, cfg.head_dim
    S, n_pg = 3, 4
    T, n_pages = n_pg * page_size, S * n_pg
    rng = np.random.default_rng(page_size)
    pools = [torch.from_numpy(rng.integers(
        -127, 128, (n_pages + 1, page_size, Hkv, hd)).astype(np.int8))
        for _ in range(2)]
    for pool in pools:
        pool[n_pages] = 127                           # the trash page
    pos = torch.tensor([0, 2 * page_size + 3, T - 1], dtype=torch.int32)
    pt = torch.from_numpy(
        rng.permutation(n_pages).astype(np.int32).reshape(S, n_pg))
    for s in range(S):
        pt[s, int(pos[s]) // page_size + 1:] = n_pages
    scales = [torch.from_numpy(rng.uniform(0.005, 0.03, (S, Hkv)).astype(
        np.float32)) for _ in range(2)]
    cache = {"k": pools[0], "v": pools[1], "k_scale": scales[0],
             "v_scale": scales[1], "pt": pt, "pos": pos}
    q = torch.from_numpy(rng.normal(size=(S, 1, H, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(S, 1, Hkv, hd)).astype(
        np.float32)) for _ in range(2))
    seen = []
    real = attn.decode_attention_paged

    def recording(*a):
        seen.append(a)
        return real(*a)

    def unpaged(*a, **kw):
        raise AssertionError("the paged step called the unpaged entry")

    monkeypatch.setattr(attn, "decode_attention_paged", recording)
    monkeypatch.setattr(attn, "decode_attention", unpaged)
    kc = {key: t.clone() for key, t in cache.items()}
    pc = {key: t.clone() for key, t in cache.items()}
    with torch.no_grad():
        out = attn._paged_decode(q, k, v, kc, cfg, use_kernels=True)
        plain = attn._paged_decode(q, k, v, pc, cfg, use_kernels=False)
    assert len(seen) == 1
    args = seen[0]
    assert args[1] is kc["k"] and args[2] is kc["v"] and args[3] is kc["pt"]
    assert args[5] is kc["k_scale"] and args[6] is kc["v_scale"]
    assert tuple(args[1].shape) == (n_pages + 1, page_size, Hkv, hd)
    assert all(tuple(a.shape) != (S, T, Hkv, hd) for a in args)
    assert out.shape == plain.shape == (S, 1, H, hd)
    err = float((out - plain).abs().max())
    assert err <= 1e-6 * float(plain.abs().max())
    for key in cache:
        assert torch.equal(kc[key], pc[key])


def test_deploy_plan_field_for_field():
    """F13: DeployPlan field for field the JAX one, the legacy ``packed``
    default included; ``use_pallas``/``interpret`` map to ``use_kernels``
    (on by default), as F11's test maps them for ServeConfig."""
    import dataclasses

    from repro.serve.deploy import DeployPlan as JDeployPlan
    jf = [(f.name, f.default) for f in dataclasses.fields(JDeployPlan)]
    want = [("use_kernels", True) if n == "use_pallas" else (n, d)
            for n, d in jf if n != "interpret"]
    assert [(f.name, f.default) for f in dataclasses.fields(DeployPlan)] \
        == want
    from repro.serve.deploy import make_deploy_plan as jmp
    from repro_torch.serve.deploy import make_deploy_plan
    for bits in (4, 8):
        assert make_deploy_plan(TQ(w_bits=bits)).packed == \
            jmp(JQ(w_bits=bits)).packed == (bits == 4)


def test_plan_less_artifact_takes_the_legacy_shim_like_jax():
    """F13: an artifact exported before plans were embedded (the JAX
    artifact with its plan leaf removed) goes through the port's
    deploy_view to the JAX package's dequantized leaves, bit for bit; and a
    DeployPlan with no QuantPlan gives every tensor the JAX package's
    legacy bits and packing, with the same DeprecationWarning."""
    from repro.core.plan import PLAN_KEY
    from repro.serve.deploy import DeployPlan as JDeployPlan
    from repro_torch.serve.deploy import deploy_view
    from repro_torch.tree import tree_items
    jplan, ex = _jax_artifact()
    legacy = {k: v for k, v in ex.items() if k != PLAN_KEY}
    want = dict(tree_items(from_numpy_tree(jax.device_get(j_deploy_view(
        legacy, JDeployPlan(qcfg=JQ()), dtype=jnp.float32)), "cpu")))
    got = deploy_view(from_numpy_tree(jax.device_get(legacy), "cpu"),
                      DeployPlan(qcfg=TQ()), dtype=torch.float32)
    assert sorted(want) == sorted(p for p, _ in tree_items(got))
    for path, leaf in tree_items(got):
        assert torch.equal(leaf, want[path]), path
    for bits in (4, 8):
        jp, tp = JDeployPlan(qcfg=JQ(w_bits=bits)), DeployPlan(
            qcfg=TQ(w_bits=bits))
        for path in [p for p, _ in jplan.quant_plan] + ["fc", "x.router"]:
            with pytest.warns(DeprecationWarning, match="legacy bare-name"):
                got_bits = tp.bits_for(path)
            with pytest.warns(DeprecationWarning, match="legacy bare-name"):
                assert got_bits == jp.bits_for(path), path
            with pytest.warns(DeprecationWarning):
                assert tp.is_packed(path) == jp.is_packed(path), path
