"""repro_torch's MLA + MoE family (deepseek-v2-236b) against the JAX package,
on the CPU at SMOKE size (d 64, 4 heads, kv_lora 16, q_lora 32, nope 16 +
rope 8, v 16; 8 routed experts top-2, 2 shared).

Parameters are initialised in JAX and converted; activations, caches and
tokens are made with numpy.  Tolerances: integer outputs (packed nibbles,
greedy tokens) bit for bit; f32 ``mla_attention`` outputs 1e-5 relative
and bf16 ones 2e-2 relative (one bf16 rounding of the products, which the
two packages round in different places), as tests/test_torch_moe.py holds
the MoE layer; the f32 model forward 1e-4; one f32 train step's loss 1e-6
relative and each gradient leaf 1e-4 relative L2; scale leaves 1e-6; the
absorbed decode form against the default one, within a package, 1e-5
relative in f32.

The engines serve in bf16, where one rounding can pick another expert or
token; their test holds the first split to a near-tie, as the MoE one does.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_v2_236b as j_cfgs  # noqa: E402
from repro.core import distill as j_distill  # noqa: E402
from repro.core.plan import resolve_plan as j_resolve_plan  # noqa: E402
from repro.core.qconfig import Granularity as JG  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.serve import deploy as j_deploy  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.train.qft_trainer import init_scales as j_init_scales  # noqa: E402
from repro_torch.configs import deepseek_v2_236b as t_cfgs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.plan import resolve_plan  # noqa: E402
from repro_torch.core.qconfig import Granularity as TG  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.models import attention, forward, init_cache  # noqa: E402
from repro_torch.models import init_model, moe, transformer  # noqa: E402
from repro_torch.serve.deploy import (DeployPlan, deploy_view,  # noqa: E402
                                      export_for_layers, export_model,
                                      init_slot_cache, kernel_route_check,
                                      make_deploy_plan)
from repro_torch.serve.engine import (Engine, Request,  # noqa: E402
                                      ServeConfig, _install)
from repro_torch.serve.kv_cache import resolve_kv_spec  # noqa: E402
from repro_torch.train.qft_trainer import init_scales  # noqa: E402
from repro_torch.train.steps import make_value_and_grad  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

J_SMOKE, T_SMOKE = j_cfgs.SMOKE, t_cfgs.SMOKE
MARGIN_ULPS = 4
MLA_STREAMS = ("in_stream", "q_stream", "kv_stream", "out_stream")


def _t(tree):
    return from_numpy_tree(jax.device_get(tree), "cpu")


def _qcfgs(name):
    if name is None:
        return None, None
    if name == "chw":
        return JQ(granularity=JG.CHW), TQ(granularity=TG.CHW)
    if name == "w4":                 # weights only: no activation fake-quant
        return JQ(a_bits=None), TQ(a_bits=None)
    return JQ(), TQ()


def _rel(a, b, rtol, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = float(np.max(np.abs(a - b)))
    assert err <= rtol * max(float(np.max(np.abs(b))), 1e-30), (what, err)


def _absorb(cfg, on=True):
    return dataclasses.replace(cfg, mla_absorb=on)


def _with_cf(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_values(which):
    """CONFIG and SMOKE field for field (SMOKE's reset padded fields
    re-derived at its size), and the registry serves them."""
    j, t = getattr(j_cfgs, which), getattr(t_cfgs, which)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert get_config("deepseek-v2-236b", smoke=which == "SMOKE") == t
    assert t.family == "mla_moe" and t.mla is not None and t.moe is not None


def test_the_port_admits_mla_moe_and_refuses_mla_alone():
    """``FAMILIES`` holds mla_moe; MLA without its MoE block is refused
    by name."""
    assert "mla_moe" in transformer.FAMILIES
    init_model(0, T_SMOKE, None, device="meta")
    with pytest.raises(NotImplementedError, match="family 'mla_moe'"):
        init_model(0, dataclasses.replace(T_SMOKE, moe=None), None,
                   device="meta")


@pytest.mark.parametrize("student", [False, True])
def test_init_mla_keys_and_shapes(student):
    """init_mla alone (against ``jax.eval_shape``) and inside init_model:
    the JAX package's keys in its sorted order and shapes, every leaf of
    the layer tree stacked ``[L, ...]``."""
    jq, tq = _qcfgs("dchw" if student else None)
    want = jax.eval_shape(lambda k: j_attn.init_mla(k, J_SMOKE, jq),
                          jax.random.PRNGKey(0))
    one = attention.init_mla(torch.Generator().manual_seed(0), T_SMOKE, tq)
    assert list(one) == list(want)
    assert {p: tuple(v.shape) for p, v in tree_items(one)} == {
        p: tuple(v.shape) for p, v in tree_items(_t(jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype), want)))}
    assert ("kv_stream" in one) == student
    jskel = jax.eval_shape(lambda k: j_init_model(k, J_SMOKE, jq),
                           jax.random.PRNGKey(0))
    tp = init_model(0, T_SMOKE, tq, device="cpu")
    assert sorted((p, tuple(v.shape)) for p, v in tree_items(tp)) == sorted(
        (p, tuple(s.shape)) for p, s in tree_items(jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype), jskel)))
    assert list(tp["layers"]["attn"]) == list(jskel["layers"]["attn"])
    m = T_SMOKE.mla
    assert tp["layers"]["attn"]["kv_down"]["w"].shape == (
        2, 64, m.kv_lora + m.d_rope)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mla_cache_matches_jax(dtype):
    """The latent cache: ``ckv [L, B, S, kv_lora]``, ``kr [L, B, S,
    d_rope]`` and ``pos``; ``init_cache`` picks it for mla_moe."""
    want = j_attn.init_mla_cache(J_SMOKE, 3, 20, 2, getattr(jnp, dtype))
    got = attention.init_mla_cache(T_SMOKE, 3, 20, 2, getattr(torch, dtype),
                                   device="cpu")
    assert sorted(got) == sorted(want) == ["ckv", "kr", "pos"]
    for k in ("ckv", "kr"):
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype) == f"torch.{dtype}"
    assert got["pos"] == 0
    assert sorted(init_cache(T_SMOKE, 1, 8, device="cpu")) == [
        "ckv", "kr", "pos"]


@functools.lru_cache(maxsize=None)
def _mla_case(qname, seed=0):
    """A converted MLA layer (JAX init; a student's four streams made
    non-trivial, as calibration leaves them) and numpy inputs."""
    jq, tq = _qcfgs(qname)
    jp = j_attn.init_mla(jax.random.PRNGKey(seed), J_SMOKE, jq)
    rng = np.random.default_rng(seed)
    if jq is not None:
        jp = dict(jp)
        for s in MLA_STREAMS:
            n = jp[s]["log_sa"].shape[-1]
            jp[s] = {"log_sa": jnp.asarray(
                np.log(0.05) + 0.2 * rng.normal(size=n), jnp.float32),
                "zp": jnp.asarray(rng.integers(-3, 4, n), jnp.float32)}
        jp = {k: jp[k] for k in sorted(jp)}
    return jq, tq, jp, _t(jp)


def _inputs(mode, dtype, seed=1):
    """``(x [B, Sq, d], positions [B, Sq], cache | None)`` from numpy:
    cache-free (B 2 x Sq 7), a scalar-pos prefill of 6 rows at pos 4 into
    a 16-row cache, and a vector-pos decode step (Sq 1) at per-slot
    offsets [5, 0, 15] (the last one at the cache end) of a 16-row cache;
    the caches hold earlier rows."""
    m = T_SMOKE.mla
    rng = np.random.default_rng(seed)
    B, Sq = {"none": (2, 7), "scalar": (2, 6), "vector": (3, 1)}[mode]
    x = rng.normal(size=(B, Sq, T_SMOKE.d_model)).astype(np.float32)
    if mode == "none":
        return x, np.broadcast_to(np.arange(Sq)[None], (B, Sq)), None
    T = 16
    cache = {"ckv": rng.normal(size=(B, T, m.kv_lora)).astype(np.float32),
             "kr": rng.normal(size=(B, T, m.d_rope)).astype(np.float32)}
    if mode == "scalar":
        pos = 4
        positions = np.broadcast_to(pos + np.arange(Sq)[None], (B, Sq))
    else:
        pos = np.array([5, 0, 15], np.int32)
        positions = pos[:, None] + np.arange(Sq)[None]
    return x, positions, (cache, pos)


def _both(mode, dtype, jp, tp, jq, tq, cfg_j, cfg_t, plan=(None, None)):
    """Run mla_attention in both packages on the same inputs; returns the
    outputs and the caches after the call."""
    x, positions, c = _inputs(mode, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jc = tc = None
    if c is not None:
        cache, pos = c
        jc = {k: jnp.asarray(v, jdt) for k, v in cache.items()}
        tc = {k: torch.from_numpy(v).to(tdt) for k, v in cache.items()}
        jc["pos"] = jnp.asarray(pos)
        tc["pos"] = pos if isinstance(pos, int) else torch.from_numpy(pos)
    jout, jnew = j_attn.mla_attention(jnp.asarray(x, jdt), jp, cfg_j, jq,
                                      jnp.asarray(positions), jc,
                                      plan=plan[0])
    with torch.no_grad():
        tout = attention.mla_attention(
            torch.from_numpy(x).to(tdt), tp, cfg_t, tq,
            torch.from_numpy(np.ascontiguousarray(positions)), tc,
            plan=plan[1])
    return jout, jnew, tout, tc


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["none", "scalar", "vector"])
@pytest.mark.parametrize("qname", [None, "dchw"])
def test_mla_attention_matches_jax(qname, mode, dtype, absorb):
    """mla_attention, teacher and W4A8 DCHW student, cache-free,
    scalar-pos cached and vector-pos cached (the serving engine's), in the
    default and the absorbed decode form: outputs 1e-5 (f32) / 2e-2 (bf16)
    relative; the written cache rows the same to the same tolerance, rows
    not written untouched, and ``pos`` left to the caller (JAX returns
    ``pos + Sq``; the port's forward advances it)."""
    jq, tq, jp, tp = _mla_case(qname)
    jout, jnew, tout, tc = _both(mode, dtype, jp, tp, jq, tq,
                                 _absorb(J_SMOKE, absorb),
                                 _absorb(T_SMOKE, absorb))
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert str(tout.dtype) == f"torch.{dtype}"
    _rel(tout.float().numpy(), np.asarray(jout.astype(jnp.float32)), tol)
    if tc is None:
        assert jnew is None
        return
    for k in ("ckv", "kr"):
        _rel(tc[k].float().numpy(), np.asarray(jnew[k].astype(jnp.float32)),
             tol, k)


@pytest.mark.parametrize("mode", ["none", "scalar", "vector"])
@pytest.mark.parametrize("qname", [None, "w4"])
def test_absorbed_form_equals_default_form_in_each_package(qname, mode):
    """Folding ``k_up`` into the query and ``v_up`` into the output is
    the same function (f32, 1e-5 relative), in JAX and in the port, for
    the teacher and for a weights-only W4 student (an A8 student differs
    by construction: the default form fake-quantizes the latent at
    ``kv_stream``, the absorbed form does not)."""
    jq, tq, jp, tp = _mla_case(qname)
    outs = {}
    for absorb in (False, True):
        jout, _, tout, _ = _both(mode, "float32", jp, tp, jq, tq,
                                 _absorb(J_SMOKE, absorb),
                                 _absorb(T_SMOKE, absorb))
        outs[absorb] = (np.asarray(jout), tout.numpy())
    _rel(outs[True][0], outs[False][0], 1e-5, "jax")
    _rel(outs[True][1], outs[False][1], 1e-5, "port")


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("student", [False, True])
def test_forward_matches_jax(student, absorb):
    """The whole SMOKE model, f32: logits and hidden states within 1e-4 of
    JAX's, teacher and plan-aware W4A8 student, in both decode forms."""
    jq, tq = _qcfgs("dchw" if student else None)
    jp = j_init_model(jax.random.PRNGKey(1), J_SMOKE, jq)
    tp = _t(jp)
    jplan = tplan = None
    if student:
        jplan = j_resolve_plan(jq, jp, model_cfg=J_SMOKE)
        tplan = resolve_plan(tq, tp, model_cfg=T_SMOKE)
    toks = np.random.default_rng(0).integers(0, T_SMOKE.vocab, (2, 10))
    jo = j_forward(jp, _absorb(J_SMOKE, absorb), jq,
                   {"tokens": jnp.asarray(toks)}, compute_dtype=jnp.float32,
                   plan=jplan)
    with torch.no_grad():
        to = forward(tp, _absorb(T_SMOKE, absorb), tq,
                     {"tokens": torch.from_numpy(toks)},
                     compute_dtype=torch.float32, plan=tplan)
    for key in ("logits", "hidden"):
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_forward_taps_only_attn_in_inside_the_layer():
    """Calibration taps: MLA taps nothing inside the attention (no
    ``attn.pre_o``), as the JAX package's ``_attn_block``, so of the MLA
    streams calibration writes only ``in_stream`` (F16)."""
    tp = init_model(2, T_SMOKE, None, device="cpu")
    toks = np.random.default_rng(1).integers(0, T_SMOKE.vocab, (2, 8))
    with torch.no_grad():
        to = forward(tp, T_SMOKE, None, {"tokens": torch.from_numpy(toks)},
                     collect_taps=True, compute_dtype=torch.float32)
    assert sorted(to["taps"]) == sorted(
        f"L{i}.{n}" for i in range(T_SMOKE.n_layers)
        for n in ("attn_in", "attn_out", "mlp_in", "mlp_out"))


@pytest.mark.parametrize("overrides", [False, True])
@pytest.mark.parametrize("which", ["SMOKE", "CONFIG"])
def test_resolved_plan_json_matches_jax(which, overrides):
    """The plan byte for byte (the port's skeleton built on the meta
    device), with no ``kv_cache`` entry (MLA caches latents), and with the
    ``layers.attn.q_up``/``layers.attn.v_up`` 8-bit overrides of
    tests/test_plan_threading.py."""
    from repro_torch.pipeline.adapters import resolve_quant_plan
    jc, tc = getattr(j_cfgs, which), getattr(t_cfgs, which)
    kw = dict(bits_overrides=(("layers.attn.q_up", 8),
                              ("layers.attn.v_up", 8))) if overrides else {}
    jq, tq = JQ(**kw), TQ(**kw)
    jskel = jax.eval_shape(lambda k: j_init_model(k, jc, jq),
                           jax.random.PRNGKey(0))
    plan = resolve_quant_plan(tc, tq)
    assert plan.to_json() == j_resolve_plan(jq, jskel,
                                            model_cfg=jc).to_json()
    assert not any("kv_cache" in p for p in dict(plan))
    assert plan.spec("layers.attn.k_up").stream == "kv_stream"
    assert plan.spec("layers.attn.q_up").stream == "q_stream"
    if overrides:
        assert plan.bits_for("layers.attn.q_up") == 8
        assert plan.bits_for("layers.attn.v_up") == 8


@pytest.mark.parametrize("qname", ["dchw", "chw"])
def test_init_scales_matches_jax(qname):
    """MMSE (CHW) / APQ (DCHW) scale init on the MLA student: every leaf
    1e-6 of the JAX package's.  F16: under CHW ``q_stream``,
    ``kv_stream`` and ``out_stream`` keep their init values in both
    packages (nothing taps them); under DCHW APQ writes their ``log_sa``
    (``kv_stream`` from ``v_up``, the last of its consumers in key order)
    and their ``zp`` stays 0."""
    jq, tq = _qcfgs(qname)
    jp = j_init_model(jax.random.PRNGKey(3), J_SMOKE, jq)
    jplan = j_resolve_plan(jq, jp, model_cfg=J_SMOKE)
    want = dict(tree_items(_t(j_init_scales(jp, J_SMOKE, jq, plan=jplan))))
    tp = _t(jp)
    got = init_scales(tp, T_SMOKE, tq,
                      plan=resolve_plan(tq, tp, model_cfg=T_SMOKE))
    assert sorted(p for p, _ in tree_items(got)) == sorted(want)
    for path, leaf in tree_items(got):
        np.testing.assert_allclose(leaf.numpy(), want[path].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=str(path))
    attn = got["layers"]["attn"]
    for s in ("q_stream", "kv_stream", "out_stream"):
        assert float(attn[s]["zp"].abs().max()) == 0.0, s
        at_init = torch.allclose(attn[s]["log_sa"],
                                 torch.full_like(attn[s]["log_sa"],
                                                 math.log(1 / 16)))
        assert at_init == (qname == "chw"), s


def test_train_step_f32_matches_jax():
    """One W4A8 student step's loss and gradients in f32 (backbone L2):
    the loss 1e-6 relative, each leaf 1e-4 relative L2 — the six MLA
    linears, both norms and the four streams included."""
    jq, tq = JQ(), TQ()
    teacher = j_init_model(jax.random.PRNGKey(0), J_SMOKE, None)
    student = j_init_model(jax.random.PRNGKey(1), J_SMOKE, jq)
    jplan = j_resolve_plan(jq, student, model_cfg=J_SMOKE)
    toks = np.random.default_rng(3).integers(0, T_SMOKE.vocab, (2, 12))
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
    attn = grads["layers"]["attn"]
    for k in ("q_down", "q_up", "kv_down", "k_up", "v_up", "wo"):
        assert float(attn[k]["w"].abs().max()) > 0, k


#: SMOKE with latent widths of 64: the first packed MLA linear (k_up,
#: K 64) then tiles for both kernels (the CUDA one steps K by 64; the
#: Pallas one clamps its blocks to K 16 at SMOKE and would take k_up there)
WIDE_MLA = dict(mla=dataclasses.replace(J_SMOKE.mla, kv_lora=64, q_lora=64))


@functools.lru_cache(maxsize=None)
def _jax_artifact(cf=4.0, wide=False):
    cfg = _with_cf(J_SMOKE, cf)
    if wide:
        cfg = dataclasses.replace(cfg, **WIDE_MLA)
    jq = JQ()
    params = jax.tree.map(lambda a: a,
                          j_init_model(jax.random.PRNGKey(0), cfg, jq))
    plan = j_deploy.make_deploy_plan(jq, params=params, model_cfg=cfg)
    return plan, jax.jit(lambda p: j_deploy.export_for_layers(p, plan))(
        params), params


def test_export_model_and_deploy_view_match_jax():
    """The whole SMOKE MLA student: export_for_layers and export_model
    equal the JAX artifact (integer leaves bit for bit, scales 1e-6; the
    latent linears' ``s_wl`` from ``q_stream``/``kv_stream``), and the
    deploy view's weights equal JAX's (1e-6)."""
    plan, jex, student = _jax_artifact()
    want = dict(tree_items(_t(jex)))
    ts = _t(student)
    tplan = make_deploy_plan(TQ(), params=ts, model_cfg=T_SMOKE)
    got = export_for_layers(ts, tplan, device="cpu")
    one_walk = dict(tree_items(export_model(ts, tplan, device="cpu")))
    assert sorted(map(str, want)) == sorted(
        map(str, (p for p, _ in tree_items(got)))) == sorted(
        map(str, one_walk))
    assert ("layers", "attn", "k_up", "s_wl") in want
    for path, leaf in tree_items(got):
        ref = want[path]
        assert leaf.dtype == ref.dtype and leaf.shape == ref.shape, path
        assert torch.equal(leaf, one_walk[path]), path
        if leaf.is_floating_point():
            np.testing.assert_allclose(leaf.numpy(), ref.numpy(), rtol=1e-6,
                                       err_msg=str(path))
        else:
            assert torch.equal(leaf, ref), path
    dv = dict(tree_items(deploy_view(got, tplan, dtype=torch.float32)))
    jdv = dict(tree_items(_t(j_deploy.deploy_view(jex, plan,
                                                  dtype=jnp.float32))))
    assert sorted(map(str, dv)) == sorted(map(str, jdv))
    for path, leaf in dv.items():
        np.testing.assert_allclose(leaf.numpy(), jdv[path].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=str(path))


def test_kernel_route_check_picks_the_jax_path():
    """kernel_route_check on an MLA artifact probes the linear the JAX
    package's does — the first packed linear in walk order whose shape the
    kernel tiles, ``layers.attn.k_up`` once the latent widths tile — and on
    the CPU launches nothing.  At SMOKE widths (K 16) only the Pallas
    tiling takes k_up; the CUDA kernel's picks ``layers.attn.wo``."""
    plan, jex, _ = _jax_artifact(wide=True)
    want = j_deploy.kernel_route_check(jex, plan)
    got = kernel_route_check(_t(jex), DeployPlan(qcfg=TQ()))
    assert got["path"] == want["path"] == "layers.attn.k_up"
    assert got["layout"] == want["layout"]
    assert not got["kernel"]
    assert got["max_err"] <= 1e-5
    plan, jex, _ = _jax_artifact()
    got = kernel_route_check(_t(jex), DeployPlan(qcfg=TQ()))
    assert got["path"] == "layers.attn.wo" and got["max_err"] <= 1e-5


def test_install_copies_the_latent_cache():
    """The engine's install copies every leaf of a finished batch-1
    prefill into the slot row — MLA's ``ckv`` and ``kr``, the whole row
    (garbage a dead slot's decode wrote past the prompt is erased) — and
    sets the slot's ``pos``, as the JAX package's generic install does."""
    cache = init_slot_cache(T_SMOKE, 3, 10, device="cpu")
    assert sorted(cache) == ["ckv", "kr", "pos"]
    for k in ("ckv", "kr"):
        cache[k].fill_(7.0)
    small = init_cache(T_SMOKE, 1, 10, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for k in ("ckv", "kr"):
        small[k].copy_(torch.randn(small[k].shape, generator=gen))
    _install(cache, small, 1, 4)
    for k in ("ckv", "kr"):
        assert torch.equal(cache[k][:, 1], small[k][:, 0]), k
        assert bool((cache[k][:, [0, 2]] == 7.0).all()), k
    assert cache["pos"].tolist() == [0, 4, 0]


PROMPTS = [[1, 2, 3], list(range(5, 20)), [300, 7, 42, 8], [9, 9]]
NEW = 6
SCFG = dict(max_slots=2, max_len=48, prefill_chunk=8)
#: n_experts / top_k: int(T·2/8·4) = T at every batch, nothing drops
CF = 4.0


def _port_engine(absorb=False, **kw):
    _, jex, _ = _jax_artifact(CF)
    return Engine.from_artifact(_absorb(_with_cf(T_SMOKE, CF), absorb),
                                DeployPlan(qcfg=TQ()), _t(jex),
                                ServeConfig(**{**SCFG, **kw}), device="cpu")


_EVENTS: list = []
_UNSCANNED = dataclasses.replace(_with_cf(J_SMOKE, CF), scan_layers=False,
                                 remat=False)


def _serve_alone(prompt, jax_engine, monkeypatch):
    """Serve ``prompt`` alone and record, in call order, each router
    call's rows (``("r", ·)``: the port's f32 logits, JAX's log
    probabilities) and each forward's logits (``("z", ·)``)."""
    events = _EVENTS
    events.clear()
    monkeypatch.undo()
    if jax_engine:
        from repro.train import steps as j_steps

        def put(kind):
            return lambda v: _EVENTS.append((kind, np.asarray(
                v, np.float32).reshape(-1, v.shape[-1])))
        probs, fwd = j_moe._router_probs, j_steps.forward

        def rec_probs(*a, **k):
            p = probs(*a, **k)
            jax.debug.callback(put("r"), jnp.log(p), ordered=True)
            return p

        def rec_fwd(*a, **k):
            out = fwd(*a, **k)
            jax.debug.callback(put("z"), out["logits"].astype(jnp.float32),
                               ordered=True)
            return out
        monkeypatch.setattr(j_moe, "_router_probs", rec_probs)
        monkeypatch.setattr(j_steps, "forward", rec_fwd)
        plan, jex, _ = _jax_artifact(CF)
        toks = JEngine.from_artifact(_UNSCANNED, plan, jex,
                                     JServeConfig(**SCFG)).generate(
            [JRequest(prompt=prompt, max_new_tokens=NEW)])[0]
    else:
        from repro_torch.train import steps as t_steps
        logits, fwd = moe._router_logits, t_steps.forward

        def rec_logits(*a, **k):
            z = logits(*a, **k)
            events.append(("r", z.float().numpy()))
            return z

        def rec_fwd(*a, **k):
            out = fwd(*a, **k)
            z = out["logits"].float()
            events.append(("z", z.reshape(-1, z.shape[-1]).numpy()))
            return out
        monkeypatch.setattr(moe, "_router_logits", rec_logits)
        monkeypatch.setattr(t_steps, "forward", rec_fwd)
        toks = _port_engine().generate(
            [Request(prompt=prompt, max_new_tokens=NEW)])[0]
    monkeypatch.undo()
    return toks, list(events)


def _ulp(z):
    return 2.0 ** (math.floor(math.log2(max(abs(float(z)), 1e-30))) - 7)


def _first_split(prompt, jev, tev):
    """The first decision that differs between the two runs — a real
    token's top-k experts in a layer, or an emitted token — as ``(kind,
    within)``: ``within`` says whether the JAX package's own margin there
    is within MARGIN_ULPS bf16 ulps (``("same", True)`` if none
    differs)."""
    K = T_SMOKE.moe.top_k
    chunk = SCFG["prefill_chunk"]
    lens = [min(chunk, len(prompt) - o) for o in range(0, len(prompt), chunk)]
    f = 0
    assert [k for k, _ in jev] == [k for k, _ in tev]
    for (kind, a), (_, b) in zip(jev, tev):
        prefill = f < len(lens)
        if kind == "r":
            for r in range(lens[f] if prefill else 1):
                ja = np.argsort(-a[r], kind="stable")
                tb = np.argsort(-b[r], kind="stable")
                if set(ja[:K]) != set(tb[:K]):
                    gap = a[r][ja[K - 1]] - a[r][ja[K]]
                    return "route", gap <= MARGIN_ULPS * _ulp(
                        np.abs(b[r]).max())
            continue
        emits = f >= len(lens) - 1
        row = lens[f] - 1 if prefill else 0
        f += 1
        if emits and int(np.argmax(a[row])) != int(np.argmax(b[row])):
            z = np.sort(a[row])[::-1]
            return "token", z[0] - z[1] <= MARGIN_ULPS * _ulp(z[0])
    return "same", True


def test_greedy_tokens_match_jax_engine(monkeypatch):
    """The JAX artifact, converted, served by both engines on the
    monolithic bf16 latent cache (``resolve_kv_spec`` gives None for
    mla_moe), each request alone.  Every routing decision and greedy token
    is the same until the first one that differs, and there the JAX
    package's own margin is within MARGIN_ULPS bf16 ulps."""
    assert resolve_kv_spec(T_SMOKE, ServeConfig(**SCFG)) is None
    kinds = []
    for prompt in PROMPTS:
        want, jev = _serve_alone(prompt, True, monkeypatch)
        got, tev = _serve_alone(prompt, False, monkeypatch)
        assert len(got) == len(want) == NEW
        kind, within = _first_split(prompt, jev, tev)
        assert within, (prompt, kind, want, got)
        assert kind != "same" or got == want, (prompt, want, got)
        kinds.append(kind)
    print(f"first splits: {kinds}")


REQS = [Request(prompt=[1, 2, 3], max_new_tokens=5),
        Request(prompt=[7, 8], max_new_tokens=3),
        Request(prompt=list(range(1, 12)), max_new_tokens=4),
        Request(prompt=[5, 4, 3, 2, 1], max_new_tokens=6),
        Request(prompt=[9, 9], max_new_tokens=2, eos_id=0)]


@pytest.mark.parametrize("absorb", [False, True])
def test_solo_static_interleaved_identical(absorb):
    """Within the port, in each decode form: a request's greedy tokens
    served alone, in a static batch and interleaved are bit-identical (the
    latent cache is installed whole, dead slots never leak)."""
    eng = _port_engine(absorb=absorb, max_slots=3)
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


def test_engine_stats_and_cache_on_the_latent_layout():
    """The engine serves the monolithic latent cache: no paged KV, 0
    decode-attention layers on either route (MLA never routes, as the JAX
    package's ``_attn_layer_count``), the slot and prefill caches sized
    from ``ckv``/``kr``; one ``.cpu()`` per decode step."""
    eng = _port_engine()
    s = eng.stats()
    assert s["decode_attn_kernel_layers"] == s["decode_attn_ref_layers"] == 0
    assert s["kv_pages_total"] == 0 and sorted(eng.cache) == [
        "ckv", "kr", "pos"]
    m, L = T_SMOKE.mla, T_SMOKE.n_layers
    row = L * SCFG["max_len"] * (m.kv_lora + m.d_rope) * 2
    assert eng._prefill_slot_bytes == row + 4          # + the int32 pos
    assert s["slot_cache_bytes"] == (SCFG["max_slots"] * (row + 4)
                                     + _state_bytes(eng))   # + pos int32
    _, jex, _ = _jax_artifact(CF)
    jeng = JEngine.from_artifact(_UNSCANNED, _jax_artifact(CF)[0], jex,
                                 JServeConfig(**SCFG))
    js = jeng.stats()
    assert js["decode_attn_pallas_layers"] == js["decode_attn_ref_layers"] \
        == 0
    assert jeng._prefill_slot_bytes == eng._prefill_slot_bytes


def _state_bytes(eng):
    return sum(t.numel() * t.element_size() for t in eng.state.values())


@pytest.mark.parametrize("cf,slots,ok", [
    (27.0, 8, True), (160 / 6, 8, None), (26.0, 8, False), (1.25, 1, True)])
def test_capacity_refusal_at_full_width(cf, slots, ok):
    """deepseek-v2-236b's 160 experts top-6 at 8 slots: capacity factor
    27 holds a worst-case decode batch and every prefill bucket up to 128
    (``int(T·6/160·27) >= T``); 26 is refused, with the JAX package's
    message; at ``n_experts/top_k`` itself the float product decides, and
    the port decides as the JAX package does."""
    cfg_t = _with_cf(t_cfgs.CONFIG, cf)
    cfg_j = _with_cf(j_cfgs.CONFIG, cf)
    if cf == 27.0:
        for T in (1, 2, 4, 8, 16, 32, 64, 128):
            assert moe.capacity(cfg_t, T) >= T, T
    jerr = terr = None
    try:
        JEngine.from_artifact(cfg_j, _jax_artifact(CF)[0], {},
                              JServeConfig(max_slots=slots))
    except ValueError as e:
        jerr = str(e)
    except Exception:                 # built past the check: no artifact
        jerr = None
    try:
        Engine.from_artifact(cfg_t, DeployPlan(qcfg=TQ()), {},
                             ServeConfig(max_slots=slots), device="cpu")
    except ValueError as e:
        terr = str(e)
    except Exception:
        terr = None
    assert terr == jerr
    if ok is not None:
        assert (terr is None) == ok, terr


def test_cli_quantize_mla_runs_and_resumes(capsys, tmp_path):
    """``python -m repro_torch quantize --config deepseek_v2_236b --device
    cpu`` (SMOKE, the CLI's default): every stage, export parity below
    1e-4; the rerun on its workdir skips calibrate, init and finetune and
    reports the same metrics."""
    from repro_torch.pipeline.cli import main
    args = ["quantize", "--config", "deepseek_v2_236b", "--device", "cpu",
            "--steps", "2", "--calib-samples", "16", "--calib-seq-len", "16",
            "--calib-batch-size", "4", "--workdir", str(tmp_path)]
    assert main(args) == 0
    first = capsys.readouterr().out
    assert "pipeline: deepseek-v2-236b" in first
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
    """``plan --config deepseek_v2_236b [--full]`` prints the JAX
    package's table."""
    from repro.pipeline.cli import main as j_main
    from repro_torch.pipeline.cli import main
    argv = ["plan", "--config", "deepseek_v2_236b"] + extra
    assert j_main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv) == 0
    assert capsys.readouterr().out == want
    assert "layers.attn.q_up" in want
