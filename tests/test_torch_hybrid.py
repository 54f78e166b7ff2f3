"""repro_torch's hybrid family (zamba2-7b: Mamba2 layers with one shared
attention block every ``attn_every`` layers) against the JAX package, on
the CPU at SMOKE size (5 layers = 2 groups of 2 + 1 tail layer, d 64, 4/4
heads x 16, ff 128, Mamba2 d_state 8, 8 heads x 16, chunk 16, vocab 512).

Parameters are initialised in JAX and converted; tokens and caches are
made with numpy.  Tolerances: integer outputs (packed nibbles) bit for
bit; the f32 model forward, its taps and its cached forward 1e-4; one f32
train step's loss 1e-6 relative and each gradient leaf 1e-4 relative L2;
scale leaves 1e-6; calibration, which writes nothing for this family,
exactly.  The engines serve in bf16: greedy tokens are held to the JAX
package's, a request that differs only at a step where JAX's own top-2
margin is within a few bf16 ulps.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import zamba2_7b as j_cfgs  # noqa: E402
from repro.core import distill as j_distill  # noqa: E402
from repro.core.plan import resolve_plan as j_resolve_plan  # noqa: E402
from repro.core.qconfig import Granularity as JG  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.serve import deploy as j_deploy  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.train import qft_trainer as j_trainer  # noqa: E402
from repro_torch.configs import zamba2_7b as t_cfgs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import dof  # noqa: E402
from repro_torch.core.plan import resolve_plan  # noqa: E402
from repro_torch.core.qconfig import Granularity as TG  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.models import forward, init_cache, init_model  # noqa: E402
from repro_torch.serve.deploy import (DeployPlan, deploy_view,  # noqa: E402
                                      export_for_layers, export_model,
                                      init_slot_cache, kernel_route_check,
                                      make_deploy_plan)
from repro_torch.serve.engine import (Engine, Request,  # noqa: E402
                                      ServeConfig, _install)
from repro_torch.serve.kv_cache import resolve_kv_spec  # noqa: E402
from repro_torch.train import qft_trainer  # noqa: E402
from repro_torch.train.steps import make_value_and_grad  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

J_SMOKE, T_SMOKE = j_cfgs.SMOKE, t_cfgs.SMOKE
J_UNSCANNED = dataclasses.replace(J_SMOKE, scan_layers=False, remat=False)
G, K, R = 2, 2, 1                    # groups, layers a group, tail layers
MARGIN_ULPS = 4


def _t(tree):
    return from_numpy_tree(jax.device_get(tree), "cpu")


def _qcfgs(name):
    if name is None:
        return None, None
    if name == "chw":
        return JQ(granularity=JG.CHW), TQ(granularity=TG.CHW)
    return JQ(), TQ()


def _j_init(seed, qcfg):
    """A JAX-initialised SMOKE tree with its keys sorted, as every
    converted tree (``jax.device_get``) and every tree out of a JAX
    ``jit``, ``tree.map`` or checkpoint has them: un-jitted, the JAX
    package's ``shared_attn`` keeps ``init_attention``'s insertion order,
    in which the init walk (and so F17's stream reset) visits the streams
    after their linears."""
    return jax.tree.map(lambda a: a, j_init_model(jax.random.PRNGKey(seed),
                                                  J_SMOKE, qcfg))


def _np_zeros(skel):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), skel)


def _leaves_close(got, want, rtol, atol=0.0):
    want = dict(tree_items(want))
    assert sorted(map(str, (p for p, _ in tree_items(got)))) == sorted(
        map(str, want))
    for path, leaf in tree_items(got):
        ref = want[path]
        assert leaf.shape == ref.shape, path
        if leaf.is_floating_point():
            np.testing.assert_allclose(leaf.numpy(), ref.numpy(), rtol=rtol,
                                       atol=atol, err_msg=str(path))
        else:
            assert torch.equal(leaf, ref), path


# ---------------------------------------------------------------------------
# configs, the family gate, init, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_values(which):
    """CONFIG and SMOKE field for field (SMOKE's reset padded fields
    re-derived at its size), and the registry serves them; 81 = 13 x 6 + 3
    at full size."""
    j, t = getattr(j_cfgs, which), getattr(t_cfgs, which)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert get_config("zamba2-7b", smoke=which == "SMOKE") == t
    assert t.family == "hybrid" and not t.tie_embeddings
    assert divmod(t.n_layers, t.attn_every) == ((13, 3) if which == "CONFIG"
                                                else (G, R))


def test_the_port_admits_hybrid_and_refuses_it_without_groups():
    """A hybrid config needs its ``SSMConfig`` and ``attn_every >= 1``."""
    init_model(0, T_SMOKE, None, device="meta")
    for bad in (dict(ssm=None), dict(attn_every=0)):
        with pytest.raises(NotImplementedError, match="family 'hybrid'"):
            init_model(0, dataclasses.replace(T_SMOKE, **bad), None,
                       device="meta")


@pytest.mark.parametrize("student", [False, True])
def test_init_model_keys_and_shapes(student):
    """The JAX package's tree: ``layers`` stacked ``[G, attn_every, ...]``,
    ``tail`` ``[r, ...]``, one unstacked ``shared_attn`` (a dense layer's
    keys), an untied ``lm_head``."""
    jq, tq = _qcfgs("dchw" if student else None)
    jskel = jax.eval_shape(lambda k: j_init_model(k, J_SMOKE, jq),
                           jax.random.PRNGKey(0))
    tp = init_model(0, T_SMOKE, tq, device="cpu")
    assert sorted((p, tuple(v.shape)) for p, v in tree_items(tp)) == sorted(
        (p, tuple(s.shape)) for p, s in tree_items(_np_zeros(jskel)))
    d, N = T_SMOKE.d_model, tp["layers"]["ssm"]["in_proj"]["w"].shape[-1]
    assert tuple(tp["layers"]["ssm"]["in_proj"]["w"].shape) == (G, K, d, N)
    assert tuple(tp["tail"]["ssm"]["in_proj"]["w"].shape) == (R, d, N)
    assert tuple(tp["shared_attn"]["attn"]["wq"]["w"].shape) == (d, 64)
    assert "lm_head" in tp
    assert ("in_stream" in tp["shared_attn"]["attn"]) == student


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_jax(dtype):
    """``{"mamba": [G, k, ...], "tail": [r, ...], "attn": {k, v [G, ...],
    pos}}``: the Mamba2 state f32 whatever the KV dtype, the attention KV
    in ``dtype``, one shared ``pos``."""
    want = j_init_cache(J_SMOKE, 3, 24, getattr(jnp, dtype))
    got = init_cache(T_SMOKE, 3, 24, getattr(torch, dtype), device="cpu")
    assert sorted(got) == sorted(want) == ["attn", "mamba", "tail"]
    assert sorted(got["attn"]) == sorted(want["attn"]) == ["k", "pos", "v"]
    assert got["attn"]["pos"] == 0
    for path, leaf in tree_items({k: got[k] for k in ("mamba", "tail")}):
        ref = want[path[0]][path[1]]
        assert tuple(leaf.shape) == ref.shape and leaf.dtype == \
            torch.float32, path
    for k in ("k", "v"):
        assert tuple(got["attn"][k].shape) == want["attn"][k].shape
        assert str(got["attn"][k].dtype) == f"torch.{dtype}"


# ---------------------------------------------------------------------------
# forward: full sequence, taps, cached
# ---------------------------------------------------------------------------

def _tokens(n, seed=0, B=2):
    return np.random.default_rng(seed).integers(0, T_SMOKE.vocab, (B, n))


@pytest.mark.parametrize("student", [False, True])
def test_forward_and_taps_match_jax(student):
    """The whole SMOKE model, f32: logits and hidden states within 1e-4 of
    JAX's, teacher and plan-aware W4A8 student; the taps named as the JAX
    package's unrolled forward writes them (``G.m{j}.*``, ``G.attn.*`` —
    each group overwriting the last one's — and ``T{i}.*``) with its
    values."""
    jq, tq = _qcfgs("dchw" if student else None)
    jp = j_init_model(jax.random.PRNGKey(1), J_SMOKE, jq)
    tp = _t(jp)
    jplan = tplan = None
    if student:
        jplan = j_resolve_plan(jq, jp, model_cfg=J_SMOKE)
        tplan = resolve_plan(tq, tp, model_cfg=T_SMOKE)
    toks = _tokens(21)
    jo = j_forward(jp, J_UNSCANNED, jq, {"tokens": jnp.asarray(toks)},
                   compute_dtype=jnp.float32, plan=jplan, collect_taps=True)
    with torch.no_grad():
        to = forward(tp, T_SMOKE, tq, {"tokens": torch.from_numpy(toks)},
                     compute_dtype=torch.float32, plan=tplan,
                     collect_taps=True)
    for key in ("logits", "hidden"):
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    names = sorted(to["taps"])
    assert names == sorted(jo["taps"])
    assert "G.m1.ssm.out" in names and "G.attn.attn.pre_o" in names
    assert "T0.ssm_in" in names and not any(n.startswith("L") for n in names)
    for name, st in to["taps"].items():
        for k, v in st.items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jo["taps"][name][k]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name}.{k}")


def _np_cache(seed, B=2, T=32):
    """A batch cache holding an earlier state: random Mamba2 state, KV rows
    below ``pos`` 5 random."""
    rng = np.random.default_rng(seed)
    c = jax.device_get(j_init_cache(J_SMOKE, B, T, jnp.float32))
    out = {"mamba": {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32)
                     for k, v in c["mamba"].items()},
           "tail": {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32)
                    for k, v in c["tail"].items()},
           "attn": {k: np.zeros(c["attn"][k].shape, np.float32)
                    for k in ("k", "v")}}
    for k in ("k", "v"):
        out["attn"][k][:, :, :5] = rng.normal(size=out["attn"][k][
            :, :, :5].shape)
    return out


@pytest.mark.parametrize("S", [7, 1])
def test_cached_forward_matches_jax(S):
    """A prefill of 7 tokens (scalar ``pos`` 5) and a decode step into a
    cache holding an earlier state, f32 teacher: logits 1e-4 of JAX's; the
    cache written in place (every group's Mamba2 state, the tail's, the
    shared attention's K/V rows) equal to JAX's new cache; ``pos``
    advanced."""
    jp = j_init_model(jax.random.PRNGKey(2), J_SMOKE, None)
    c = _np_cache(3)
    jc = jax.tree.map(jnp.asarray, c)
    jc["attn"]["pos"] = jnp.asarray(5, jnp.int32)
    tc = jax.tree.map(lambda a: torch.from_numpy(a.copy()), c)
    tc["attn"]["pos"] = 5
    toks = _tokens(S, seed=4)
    jo = j_forward(jp, J_UNSCANNED, None, {"tokens": jnp.asarray(toks)},
                   cache=jc, compute_dtype=jnp.float32)
    with torch.no_grad():
        to = forward(_t(jp), T_SMOKE, None, {"tokens": torch.from_numpy(toks)},
                     cache=tc, compute_dtype=torch.float32)
    assert to["cache"] is tc and tc["attn"]["pos"] == 5 + S
    assert int(jo["cache"]["attn"]["pos"]) == 5 + S
    np.testing.assert_allclose(to["logits"].numpy(),
                               np.asarray(jo["logits"]), rtol=1e-4,
                               atol=1e-4)
    want = dict(tree_items(_t({k: jo["cache"][k]
                               for k in ("mamba", "tail")})))
    want.update({("attn", k): _t(jo["cache"]["attn"][k])
                 for k in ("k", "v")})
    for path, ref in want.items():
        leaf = tc[path[0]][path[1]]
        np.testing.assert_allclose(leaf.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("split", [(20,), (7, 13), (1, 19)])
def test_chunked_prefill_then_decode_matches_one_full_forward(split):
    """f32 teacher: prefilling 20 tokens into a batch-1 cache in chunks of
    ``split``, then decoding 6 more one at a time, gives every position's
    logits of one cache-free forward over the 26 tokens (1e-4)."""
    tp = _t(j_init_model(jax.random.PRNGKey(4), J_SMOKE, None))
    toks = _tokens(26, seed=2, B=1)
    with torch.no_grad():
        full = forward(tp, T_SMOKE, None, {"tokens": torch.from_numpy(toks)},
                       compute_dtype=torch.float32)["logits"][0]
        cache = init_cache(T_SMOKE, 1, 32, torch.float32, device="cpu")
        rows, off = [], 0
        for n in split + (1,) * 6:
            out = forward(tp, T_SMOKE, None, {"tokens": torch.from_numpy(
                toks[:, off:off + n])}, cache=cache,
                compute_dtype=torch.float32)
            rows.append(out["logits"][0])
            off += n
    got = torch.cat(rows)
    assert cache["attn"]["pos"] == 26
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-4 * float(full.abs().max()))


# ---------------------------------------------------------------------------
# plan, calibration, init (F17), a train step
# ---------------------------------------------------------------------------

PLAN_OVERRIDES = dict(bits_overrides=(("shared_attn.attn.w[qv]", 8),
                                      ("tail.ssm.out_proj", 8)),
                      exempt_frac=0.0)


@pytest.mark.parametrize("overrides", [False, True])
@pytest.mark.parametrize("which", ["SMOKE", "CONFIG"])
def test_resolved_plan_json_matches_jax(which, overrides):
    """The plan byte for byte (the port's skeleton on the meta device),
    with no ``kv_cache`` entry (hybrid is not a paged-KV family), and with
    tests/test_plan_threading.py's hybrid overrides (the shared block's
    wq/wv and the tail's out_proj at 8 bits, no exemption)."""
    from repro_torch.pipeline.adapters import resolve_quant_plan
    jc, tc = getattr(j_cfgs, which), getattr(t_cfgs, which)
    kw = PLAN_OVERRIDES if overrides else {}
    jq, tq = JQ(**kw), TQ(**kw)
    jskel = jax.eval_shape(lambda k: j_init_model(k, jc, jq),
                           jax.random.PRNGKey(0))
    plan = resolve_quant_plan(tc, tq)
    assert plan.to_json() == j_resolve_plan(jq, jskel,
                                            model_cfg=jc).to_json()
    assert not any("kv_cache" in p for p in dict(plan))
    for path in ("layers.ssm.in_proj", "tail.ssm.out_proj",
                 "shared_attn.attn.wq", "shared_attn.mlp.down"):
        assert path in plan, path
    if overrides:
        assert plan.bits_for("shared_attn.attn.wv") == 8
        assert plan.bits_for("tail.ssm.out_proj") == 8
        assert plan.bits_for("layers.ssm.out_proj") == 4


def _calib_batches(seed=7, n=2):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, T_SMOKE.vocab, (2, 24)).astype(
        np.int32)} for _ in range(n)]


@pytest.mark.parametrize("qname", ["dchw", "chw"])
def test_calibration_writes_no_hybrid_stream(qname):
    """F17: calibration writes back only ``L{i}`` taps, and the hybrid's
    are ``G.m{j}``, ``G.attn`` and ``T{i}``, so — in both packages — the
    calibrated student equals the uncalibrated one, leaf for leaf."""
    jq, tq = _qcfgs(qname)
    teacher = j_init_model(jax.random.PRNGKey(2), J_SMOKE, None)
    student = j_init_model(jax.random.PRNGKey(3), J_SMOKE, jq)
    jcal = j_trainer.calibrate_student(
        student, J_SMOKE, jq, teacher,
        [{k: jnp.asarray(v) for k, v in b.items()} for b in _calib_batches()])
    ts = _t(student)
    got = qft_trainer.calibrate_student(
        ts, T_SMOKE, tq, _t(teacher),
        [{k: torch.from_numpy(v) for k, v in b.items()}
         for b in _calib_batches()])
    want = dict(tree_items(_t(jcal)))
    for path, leaf in tree_items(got):
        assert torch.equal(leaf, want[path]), path
        assert torch.equal(leaf, dict(tree_items(ts))[path]), path


@pytest.mark.parametrize("qname", ["dchw", "chw"])
def test_init_scales_matches_jax(qname):
    """MMSE (CHW) / APQ (DCHW) scale init over ``layers`` (a group at a
    time), ``tail`` (a layer at a time) and the shared block: every leaf
    1e-6 of the JAX package's."""
    jq, tq = _qcfgs(qname)
    jp = _j_init(3, jq)
    jplan = j_resolve_plan(jq, jp, model_cfg=J_SMOKE)
    want = _t(j_trainer.init_scales(jp, J_SMOKE, jq, plan=jplan))
    tp = _t(jp)
    got = qft_trainer.init_scales(tp, T_SMOKE, tq,
                                  plan=resolve_plan(tq, tp,
                                                    model_cfg=T_SMOKE))
    _leaves_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", ["channel", "layerwise"])
def test_apq_fits_a_group_as_one_stack(layout):
    """F17, as in the JAX package (its ``vmap`` runs over the groups
    only): under DCHW each group's ``[attn_every, in, out]`` Mamba2
    weights reach APQ as one stack, like an expert stack, so the group's
    layers get one geometric-mean ``S_wL``.  That ``S_wL`` never reaches
    the streams (the walk copies ``in_stream`` back after ``in_proj``, as
    for mamba2), so it shows only where ``S_wR`` is refitted against it:
    under a layerwise layout the group's ``log_swr`` is the stack's, not
    each layer's alone; a per-channel ``S_wR`` is APQ's own, the same
    either way.  The tail's layers are fitted alone."""
    tq = TQ(w_layout=layout)
    tp = init_model(3, T_SMOKE, tq, device="cpu")
    got = qft_trainer.init_scales(tp, T_SMOKE, tq)
    for g in range(G):
        lin = {k: v[g] for k, v in tp["layers"]["ssm"]["in_proj"].items()}
        stacked, _ = dof.apq_init_qlinear(lin, tq)
        alone = torch.stack([dof.apq_init_qlinear(
            {k: v[j] for k, v in lin.items()}, tq)[0]["log_swr"]
            for j in range(K)])
        fitted = got["layers"]["ssm"]["in_proj"]["log_swr"][g]
        assert torch.equal(fitted, stacked["log_swr"]), g
        assert torch.allclose(fitted, alone) == (layout == "channel"), g
    for st in ("in_stream", "out_stream"):
        assert torch.equal(got["layers"]["ssm"][st]["log_sa"],
                           tp["layers"]["ssm"][st]["log_sa"]), st
    tail = {k: v[0] for k, v in tp["tail"]["ssm"]["in_proj"].items()}
    assert torch.equal(got["tail"]["ssm"]["in_proj"]["log_swr"][0],
                       dof.apq_init_qlinear(tail, tq)[0]["log_swr"])


def test_cle_init_matches_jax():
    """CLE (``cle_init=True``): the tail's and the shared block's streams
    are skewed; a group's stacked ``in_proj`` (3-D under the group map) is
    not a CLE consumer, in both packages.  1e-6 of the JAX package's."""
    jq, tq = _qcfgs("chw")
    jp = _j_init(5, jq)
    want = _t(j_trainer.init_scales(jp, J_SMOKE, jq, cle_init=True))
    tp = _t(jp)
    got = qft_trainer.init_scales(tp, T_SMOKE, tq, cle_init=True)
    _leaves_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got["layers"]["ssm"]["in_stream"]["log_sa"],
                       tp["layers"]["ssm"]["in_stream"]["log_sa"])
    assert not torch.equal(got["tail"]["ssm"]["in_stream"]["log_sa"],
                           tp["tail"]["ssm"]["in_stream"]["log_sa"])


def test_train_step_f32_matches_jax():
    """One W4A8 student step's loss and gradients in f32 (backbone L2):
    the loss 1e-6 relative, each leaf 1e-4 relative L2 — every group's
    Mamba2 stack, the tail and the one shared block (whose gradient sums
    its calls)."""
    jq, tq = JQ(), TQ()
    teacher = j_init_model(jax.random.PRNGKey(0), J_SMOKE, None)
    student = j_init_model(jax.random.PRNGKey(1), J_SMOKE, jq)
    jplan = j_resolve_plan(jq, student, model_cfg=J_SMOKE)
    toks = _tokens(24, seed=3)
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    to = j_forward(teacher, J_SMOKE, None, batch, compute_dtype=jnp.float32)

    def loss(s):
        so = j_forward(s, J_SMOKE, jq, batch, compute_dtype=jnp.float32,
                       plan=jplan)
        return j_distill.qft_loss(so["hidden"], to["hidden"], so["logits"],
                                  to["logits"])
    jloss, jgrads = jax.value_and_grad(loss)(student)
    ts = _t(student)
    vg = make_value_and_grad(T_SMOKE, tq,
                             plan=resolve_plan(tq, ts, model_cfg=T_SMOKE),
                             compute_dtype=torch.float32)
    tloss, grads = vg(ts, _t(teacher), {"tokens": torch.from_numpy(toks)})
    assert abs(float(tloss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    jg = dict(tree_items(_t(jgrads)))
    gnorm = math.sqrt(sum(float((g.double() ** 2).sum())
                          for g in jg.values()))
    for path, g in tree_items(grads):
        ref = jg[path].double()
        if g is None:         # the head: the backbone loss never reads it
            assert path[0] in ("lm_head", "head_stream"), path
            assert float(ref.abs().max()) == 0.0, path
            continue
        err = float((g.double() - ref).norm())
        assert err <= 1e-4 * (float(ref.norm()) + 1e-3 * gnorm), (path, err)
    assert float(grads["shared_attn"]["attn"]["wq"]["w"].abs().max()) > 0
    assert float(grads["tail"]["ssm"]["in_proj"]["w"].abs().max()) > 0
    assert all(float(grads["layers"]["ssm"]["out_proj"]["w"][g, j]
                     .abs().max()) > 0 for g in range(G) for j in range(K))


# ---------------------------------------------------------------------------
# export, deploy view, route check
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_artifact():
    jq = JQ()
    params = _j_init(0, jq)
    plan = j_deploy.make_deploy_plan(jq, params=params, model_cfg=J_SMOKE)
    return plan, jax.jit(lambda p: j_deploy.export_for_layers(p, plan))(
        params), params


def test_export_model_and_deploy_view_match_jax():
    """The whole SMOKE hybrid student: export_for_layers (``layers``
    exported a group at a time, ``tail`` a layer at a time) and
    export_model equal the JAX artifact (integer leaves bit for bit,
    scales 1e-6): the ``[G, k, in/2, out]`` Mamba2 stack with its
    ``s_wl [G, k, in]``, the tail's ``[r, ...]``.  The deploy view equals
    JAX's (1e-6): ``_dequant`` slices the leading (group) axis only, and
    each group's ``[k, in]`` ``s_wl`` meets its ``[k, in, out]`` weight."""
    plan, jex, student = _jax_artifact()
    want = _t(jex)
    ts = _t(student)
    tplan = make_deploy_plan(TQ(), params=ts, model_cfg=T_SMOKE)
    got = export_for_layers(ts, tplan, device="cpu")
    one_walk = dict(tree_items(export_model(ts, tplan, device="cpu")))
    lin = got["layers"]["ssm"]["in_proj"]
    d = T_SMOKE.d_model
    assert tuple(lin["q"].shape[:3]) == (G, K, d // 2)
    assert tuple(lin["s_wl"].shape) == (G, K, d)
    assert tuple(got["tail"]["ssm"]["in_proj"]["s_wl"].shape) == (R, d)
    _leaves_close(got, want, rtol=1e-6)
    for path, leaf in tree_items(got):
        assert torch.equal(leaf, one_walk[path]), path
    dv = deploy_view(got, tplan, dtype=torch.float32)
    jdv = _t(j_deploy.deploy_view(jex, plan, dtype=jnp.float32))
    _leaves_close(dv, jdv, rtol=1e-6, atol=1e-9)
    w = dv["layers"]["ssm"]["in_proj"]["w"]
    for g in range(G):
        for j in range(K):
            one = dof.dequantize_export(
                {k: v[g, j] for k, v in lin.items()}, torch.float32)
            assert torch.equal(w[g, j], one), (g, j)


def test_kernel_route_check_picks_the_jax_path():
    """kernel_route_check on a hybrid artifact probes the linear the JAX
    package's does (walking the groups' Mamba2 stack down to one layer)
    and on the CPU launches nothing."""
    plan, jex, _ = _jax_artifact()
    want = j_deploy.kernel_route_check(jex, plan)
    got = kernel_route_check(_t(jex), DeployPlan(qcfg=TQ()))
    assert got["path"] == want["path"]
    assert got["layout"] == want["layout"]
    assert not got["kernel"]
    assert got["max_err"] <= 1e-5


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_init_slot_cache_matches_jax():
    """The slot cache: the JAX package's tree, its one ``pos`` (under
    ``attn``) a per-slot int32 vector, the Mamba2 leaves ``[G, k, S,
    ...]``; no paged KV spec for the family (the monolithic bf16 KV)."""
    want = jax.device_get(j_deploy.init_slot_cache(J_SMOKE, 3, 40))
    got = init_slot_cache(T_SMOKE, 3, 40, device="cpu")
    assert sorted((p, tuple(v.shape), str(v.dtype).split(".")[-1])
                  for p, v in tree_items(got)) == sorted(
        (p, tuple(v.shape), str(v.dtype))
        for p, v in tree_items(_np_zeros(want)))
    assert got["attn"]["pos"].dtype == torch.int32
    assert resolve_kv_spec(T_SMOKE, ServeConfig()) is None


def test_install_finds_each_leafs_slot_axis():
    """The engine's install copies a finished batch-1 prefill into the
    slot's row of every nested leaf — axis 2 of the ``[G, k, S, ...]``
    Mamba2 state, axis 1 of the tail's and of the attention KV — and sets
    the slot's ``pos``, as the JAX package's ``_install_step`` does."""
    cache = init_slot_cache(T_SMOKE, 3, 10, device="cpu")
    for _, v in tree_items(cache):
        v.fill_(7)
    small = init_cache(T_SMOKE, 1, 10, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for path, v in tree_items(small):
        if path[-1] != "pos":
            v.copy_(torch.randn(v.shape, generator=gen))
    _install(cache, small, 1, 4)
    for k in ("ssm_state", "conv_state"):
        big, one = cache["mamba"][k], small["mamba"][k]
        assert torch.equal(big[:, :, 1], one[:, :, 0]), k
        assert bool((big[:, :, [0, 2]] == 7).all()), k
        assert torch.equal(cache["tail"][k][:, 1], small["tail"][k][:, 0])
    for k in ("k", "v"):
        assert torch.equal(cache["attn"][k][:, 1],
                           small["attn"][k][:, 0].to(cache["attn"][k].dtype))
        assert bool((cache["attn"][k][:, [0, 2]] == 7).all()), k
    assert cache["attn"]["pos"].tolist() == [7, 4, 7]


PROMPTS = [[1, 2, 3], list(range(5, 25)), [300, 7, 42, 8, 9, 11, 500, 3, 2,
                                           1, 6], [9, 9]]
NEW = 6
SCFG = dict(max_slots=2, max_len=48, prefill_chunk=8)


def _port_engine(use_kernels=True, **kw):
    _, jex, _ = _jax_artifact()
    return Engine.from_artifact(T_SMOKE, DeployPlan(qcfg=TQ(),
                                                    use_kernels=use_kernels),
                                _t(jex), ServeConfig(**{**SCFG, **kw}),
                                device="cpu")


def _jax_margin_ok(context):
    plan, jex, _ = _jax_artifact()
    dv = j_deploy.deploy_view(jex, plan)
    logits = j_forward(dv, J_SMOKE, None,
                       {"tokens": jnp.asarray([context], jnp.int32)})
    z = np.sort(np.asarray(logits["logits"][0, -1], np.float32))[::-1]
    ulp = 2.0 ** (math.floor(math.log2(abs(z[0]))) - 7)
    return z[0] - z[1] <= MARGIN_ULPS * ulp


@pytest.mark.parametrize("use_kernels", [True, False])
def test_greedy_tokens_match_jax_engine(use_kernels):
    """The JAX artifact, converted, served by both engines (bf16 monolithic
    KV, exact-length chunked prefill: the 20- and 11-token prompts cross
    the 8-token chunk; the port on its kernel route — the plain version on
    the CPU — and its plain route): every request's greedy tokens equal, or
    first differ where JAX's own top-2 margin is a near-tie."""
    plan, jex, _ = _jax_artifact()
    want = JEngine.from_artifact(J_UNSCANNED, plan, jex,
                                 JServeConfig(**SCFG)).generate(
        [JRequest(prompt=p, max_new_tokens=NEW) for p in PROMPTS])
    got = _port_engine(use_kernels).generate(
        [Request(prompt=p, max_new_tokens=NEW) for p in PROMPTS])
    near = 0
    for prompt, w, g in zip(PROMPTS, want, got):
        assert len(g) == len(w) == NEW
        i = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if i is not None:
            assert _jax_margin_ok(prompt + w[:i]), (prompt, i, w, g)
            near += 1
    assert near <= 1


def test_engine_stats_route_every_shared_attention_call():
    """``stats()``: n_layers // attn_every shared-attention calls a decode
    step, all on the kernel route (``decode_attention``, hd 16 here) with
    ``use_kernels`` and all on the plain one without — the JAX package
    reports the same count as ``decode_attn_pallas_layers`` for a plan that
    routes.  The batch-1 prefill cache is sized as JAX's (its one int32
    ``pos`` included); prefill takes exact-length chunks."""
    n = T_SMOKE.n_layers // T_SMOKE.attn_every
    eng = _port_engine()
    s = eng.stats()
    assert (s["decode_attn_kernel_layers"], s["decode_attn_ref_layers"]) \
        == (n, 0)
    plain = _port_engine(use_kernels=False).stats()
    assert (plain["decode_attn_kernel_layers"],
            plain["decode_attn_ref_layers"]) == (0, n)
    plan, jex, _ = _jax_artifact()
    jeng = JEngine.from_artifact(
        J_UNSCANNED, dataclasses.replace(plan, use_pallas=True), jex,
        JServeConfig(**SCFG))
    js = jeng.stats()
    assert (js["decode_attn_pallas_layers"], js["decode_attn_ref_layers"]) \
        == (n, 0)
    assert jeng._prefill_slot_bytes == eng._prefill_slot_bytes
    assert not eng._bucketed


REQS = [Request(prompt=[1, 2, 3], max_new_tokens=5),
        Request(prompt=[7, 8], max_new_tokens=3),
        Request(prompt=list(range(1, 19)), max_new_tokens=4),
        Request(prompt=[5, 4, 3, 2, 1], max_new_tokens=6),
        Request(prompt=[9, 9], max_new_tokens=2, eos_id=0)]


def test_solo_static_interleaved_identical():
    """Within the port: a request's greedy tokens served alone, in a
    static batch and interleaved are bit-identical."""
    eng = _port_engine(max_slots=3)
    solo = []
    for r in REQS:
        eng.reset()
        solo.append(eng.generate([r])[0])
    eng.reset()
    static = eng.generate(REQS)
    eng.reset()
    inter = {}
    rids = [eng.submit(REQS[3]), eng.submit(REQS[0])]
    inter.update(eng.step())
    rids += [eng.submit(REQS[4]), eng.submit(REQS[1])]
    inter.update(eng.step())
    rids.append(eng.submit(REQS[2]))
    while eng.pending():
        inter.update(eng.step())
    inter_tokens = [None] * 5
    for rid, i in zip(rids, [3, 0, 4, 1, 2]):
        inter_tokens[i] = inter[rid]
    assert solo == static == inter_tokens


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_quantize_hybrid_runs_and_resumes(capsys, tmp_path):
    """``python -m repro_torch quantize --config zamba2_7b --device cpu``
    (SMOKE) with the serve smoke: every stage, export parity below 1e-4;
    the rerun skips calibrate, init and finetune with the same
    metrics."""
    from repro_torch.pipeline.cli import main
    args = ["quantize", "--config", "zamba2_7b", "--device", "cpu",
            "--steps", "2", "--calib-samples", "16", "--calib-seq-len", "16",
            "--calib-batch-size", "4", "--serve-smoke", "--workdir",
            str(tmp_path)]
    assert main(args) == 0
    first = capsys.readouterr().out
    assert "pipeline: zamba2-7b" in first
    assert "pipeline complete" in first
    parity = next(ln for ln in first.splitlines() if "export_parity" in ln)
    assert float(parity.split(":")[1]) < 1e-4
    assert main(args) == 0
    second = capsys.readouterr().out
    assert "skipped (resume): calibrate, init, finetune" in second

    def metrics(out):
        return [ln for ln in out.splitlines()
                if ln.startswith("  ") and ":" in ln and "stage" not in ln
                and "skipped" not in ln and "finetune loss" not in ln]
    assert metrics(second) == metrics(first)


@pytest.mark.parametrize("extra", [[], ["--full"]])
def test_cli_plan_table_matches_jax(capsys, extra):
    """``plan --config zamba2_7b [--full]`` prints the JAX package's
    table."""
    from repro.pipeline.cli import main as j_main
    from repro_torch.pipeline.cli import main
    argv = ["plan", "--config", "zamba2_7b"] + extra
    assert j_main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv) == 0
    assert capsys.readouterr().out == want
    assert "shared_attn.attn.wq" in want and "tail.ssm.in_proj" in want
