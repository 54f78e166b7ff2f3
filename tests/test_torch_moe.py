"""repro_torch's MoE family (qwen2-moe-a2.7b) against the JAX package, on
the CPU at SMOKE size (6 routed experts top-2, 2 shared, d 64).

Parameters are initialised in JAX and converted; activations and tokens
are made with numpy.  Tolerances: integer outputs (routing indices, the
capacity dispatch's ``keep``/``dest``, the expert buffer, packed nibbles,
greedy tokens) bit for bit; f32 MoE outputs 1e-5 relative, bf16 ones
2e-2 relative (one bf16 rounding of the batched products, which the two
packages round in different places); the f32 model forward 1e-4; one f32
train step's loss 1e-6 relative and each gradient leaf 1e-4 relative L2;
log-scale leaves 1e-6.

Routing is compared on the indices, so a near-tie between the k-th and
(k+1)-th router probability could split the two packages.  In the
dispatch cases the smallest such gap is 9.7e-3 (teacher) and 2.2e-3
(W4A8 student; 2.4e-3 in bf16), far above the packages' differences in a
probability where their inputs agree (3e-8).  The engines serve in bf16, where one rounding
can pick another expert; their test holds the first split to a near-tie.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import qwen2_moe_a2_7b as j_cfgs  # noqa: E402
from repro.core import distill as j_distill  # noqa: E402
from repro.core import dof as j_dof  # noqa: E402
from repro.core.plan import resolve_plan as j_resolve_plan  # noqa: E402
from repro.core.qconfig import Granularity as JG  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_transformer  # noqa: E402
from repro.serve import deploy as j_deploy  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.train.qft_trainer import init_scales as j_init_scales  # noqa: E402
from repro_torch.configs import qwen2_moe_a2_7b as t_cfgs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import dof as t_dof  # noqa: E402
from repro_torch.core.plan import resolve_plan  # noqa: E402
from repro_torch.core.qconfig import Granularity as TG  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.models import forward, init_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.deploy import (DeployPlan, deploy_view,  # noqa: E402
                                      export_for_layers, export_model,
                                      kernel_route_check, make_deploy_plan)
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.train.qft_trainer import init_scales  # noqa: E402
from repro_torch.train.steps import make_value_and_grad  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

J_SMOKE, T_SMOKE = j_cfgs.SMOKE, t_cfgs.SMOKE
MARGIN_ULPS = 4


def _t(tree):
    return from_numpy_tree(jax.device_get(tree), "cpu")


def _with_cf(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _qcfgs(name):
    if name is None:
        return None, None
    if name == "chw":
        return JQ(granularity=JG.CHW), TQ(granularity=TG.CHW)
    return JQ(), TQ()


def _rel(a, b, rtol, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = float(np.max(np.abs(a - b)))
    assert err <= rtol * max(float(np.max(np.abs(b))), 1e-30), (what, err)


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_values(which):
    j, t = getattr(j_cfgs, which), getattr(t_cfgs, which)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert get_config("qwen2-moe-a2.7b", smoke=which == "SMOKE") == t


def test_serving_families_match_jax():
    """The paged-KV and bucketed-prefill families, as the JAX package's;
    the port's engine and model admit the MoE family."""
    from repro.serve import kv_cache as j_kv
    from repro_torch.serve import kv_cache as t_kv
    assert t_kv.BUCKETED_PREFILL_FAMILIES == j_kv.BUCKETED_PREFILL_FAMILIES
    assert t_kv.PAGED_KV_FAMILIES == j_kv.PAGED_KV_FAMILIES
    assert "moe" in transformer.FAMILIES and "moe" in t_kv.PAGED_KV_FAMILIES
    with pytest.raises(NotImplementedError, match="family 'cnn'"):
        init_model(0, dataclasses.replace(T_SMOKE, family="cnn"), None,
                   device="meta")


@pytest.mark.parametrize("student", [False, True])
def test_init_moe_tree_keys_and_shapes(student):
    """init_moe alone and inside init_model: the JAX package's keys, in
    its (sorted) order, and shapes — experts ``[L, E, in, out]``,
    everything else ``[L, ...]``."""
    jq, tq = _qcfgs("dchw" if student else None)
    jp = j_init_model(jax.random.PRNGKey(0), J_SMOKE, jq)
    tp = init_model(0, T_SMOKE, tq, device="cpu")
    want = sorted((p, tuple(v.shape)) for p, v in tree_items(_t(jp)))
    assert sorted((p, tuple(v.shape)) for p, v in tree_items(tp)) == want
    assert list(tp["layers"]["mlp"]) == list(_t(jp)["layers"]["mlp"])
    one = moe.init_moe(torch.Generator().manual_seed(0), T_SMOKE, tq)
    jone = j_moe.init_moe(jax.random.PRNGKey(0), J_SMOKE, jq)
    assert list(one) == sorted(jone)
    assert {k: tuple(v.shape) for k, v in tree_items(one)} == {
        k: tuple(v.shape) for k, v in tree_items(_t(jone))}
    E, ff = T_SMOKE.moe.n_experts, T_SMOKE.moe.d_ff_expert
    assert tp["layers"]["mlp"]["up"]["w"].shape == (2, E, 64, ff)


@functools.lru_cache(maxsize=None)
def _moe_case(qname, cf=1.25, seed=0):
    """A converted MoE layer (JAX init, streams made non-trivial) and
    tokens ``x [T, d]`` from numpy."""
    jq, tq = _qcfgs(qname)
    cfg_j, cfg_t = _with_cf(J_SMOKE, cf), _with_cf(T_SMOKE, cf)
    jp = j_moe.init_moe(jax.random.PRNGKey(seed), cfg_j, jq)
    rng = np.random.default_rng(seed)
    if jq is not None:           # calibrated-looking streams and scales
        jp = jax.tree.map(lambda a: a, jp)
        for s in ("in_stream", "act_stream", "shared_act_stream"):
            n = jp[s]["log_sa"].shape[-1]
            jp[s] = {"log_sa": jnp.asarray(
                np.log(0.05) + 0.2 * rng.normal(size=n), jnp.float32),
                "zp": jnp.asarray(rng.integers(-3, 4, n), jnp.float32)}
    x = rng.normal(size=(24, cfg_t.d_model)).astype(np.float32)
    return jq, tq, cfg_j, cfg_t, jp, _t(jp), x


def _jax_route(cfg, jp, jq, x):
    """The JAX package's top-k of its router probabilities, and keep/dest
    in the (token, choice) layout, from moe_sorted's own formulas."""
    e = cfg.moe
    probs = j_moe._router_probs(x, jp, cfg, jq)
    topv, topi = jax.lax.top_k(probs, e.top_k)
    topi = np.asarray(topi)
    T, K = topi.shape
    C = max(int(T * K / e.n_experts * e.capacity_factor), 1)
    flat = topi.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=e.n_experts_padded)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(T * K) - offsets[flat[order]]
    keep_s = pos < C
    dest_s = np.where(keep_s, flat[order] * C + pos, e.n_experts_padded * C)
    keep, dest = np.empty_like(keep_s), np.empty_like(dest_s)
    keep[order], dest[order] = keep_s, dest_s
    return np.asarray(probs), topi, keep.reshape(T, K), dest.reshape(T, K)


def _buffer_capture():
    """``(seen, capture)``: ``capture(real)`` is an expert_fn that records
    its input buffer in ``seen["h"]`` and passes it to ``real``."""
    seen = {}

    def capture(real):
        def f(h):
            seen["h"] = h
            return real(h)
        return f
    return seen, capture


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qname", [None, "dchw"])
@pytest.mark.parametrize("mode", ["dense", "sorted"])
def test_moe_dispatch_matches_jax(mode, qname, dtype):
    """moe_dense and moe_sorted, teacher and W4A8 DCHW, f32 and bf16:
    routing indices bit-equal, the sorted dispatch's keep/dest and its
    expert buffer bit-equal, outputs within 1e-5 (f32) / 2e-2 (bf16)."""
    jq, tq, cfg_j, cfg_t, jp, tp, x = _moe_case(qname)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    probs, topi, keep, dest = _jax_route(cfg_j, jp, jq, jx)
    with torch.no_grad():
        tprobs = moe._router_probs(tx, tp, cfg_t, tq)
        _, ttopi = moe.top_k(tprobs, cfg_t.moe.top_k)
        C = moe.capacity(cfg_t, x.shape[0])
        tdest, tkeep = moe.route(ttopi, cfg_t.moe.n_experts_padded, C)
    srt = np.sort(probs, -1)[:, ::-1]
    print(f"smallest k-th/(k+1)-th probability gap "
          f"{float(np.min(srt[:, 1] - srt[:, 2])):.2e}")
    np.testing.assert_array_equal(ttopi.numpy(), topi)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    np.testing.assert_array_equal(tdest.numpy(), dest)
    if mode == "dense":
        want = j_moe.moe_dense(jx, jp, cfg_j, jq)
        with torch.no_grad():
            got = moe.moe_dense(tx, tp, cfg_t, tq)
    else:
        jseen, jcap = _buffer_capture()
        tseen, tcap = _buffer_capture()
        want = j_moe.moe_sorted(jx, jp, cfg_j, jq, expert_fn=jcap(
            lambda h: j_moe._expert_ffn(h, jp, cfg_j, jq)))
        with torch.no_grad():
            got = moe.moe_sorted(tx, tp, cfg_t, tq, expert_fn=tcap(
                lambda h: moe._expert_ffn(h, tp, cfg_t, tq)))
        np.testing.assert_array_equal(
            tseen["h"].float().numpy(),
            np.asarray(jseen["h"].astype(jnp.float32)))
    assert got.dtype == tdt
    _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
         1e-5 if dtype == "float32" else 2e-2, mode)


def test_low_capacity_drops_the_same_assignments_as_jax():
    """capacity_factor 0.5: C = 4 rows per expert for 48 assignments, so
    assignments drop; the same ones as in JAX, the same buffer, outputs
    within 1e-5."""
    jq, tq, cfg_j, cfg_t, jp, tp, x = _moe_case("dchw", cf=0.5)
    _, _, keep, _ = _jax_route(cfg_j, jp, jq, jnp.asarray(x))
    assert 0 < int((~keep).sum())
    jseen, jcap = _buffer_capture()
    tseen, tcap = _buffer_capture()
    want = j_moe.moe_sorted(jnp.asarray(x), jp, cfg_j, jq, expert_fn=jcap(
        lambda h: j_moe._expert_ffn(h, jp, cfg_j, jq)))
    with torch.no_grad():
        tx = torch.from_numpy(x)
        got = moe.moe_sorted(tx, tp, cfg_t, tq, expert_fn=tcap(
            lambda h: moe._expert_ffn(h, tp, cfg_t, tq)))
        _, ttopi = moe.top_k(moe._router_probs(tx, tp, cfg_t, tq), 2)
        _, tkeep = moe.route(ttopi, 6, moe.capacity(cfg_t, 24))
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    np.testing.assert_array_equal(tseen["h"].numpy(), np.asarray(jseen["h"]))
    _rel(got.numpy(), np.asarray(want), 1e-5)


def test_sorted_equals_dense_when_nothing_drops():
    """tests/test_serve_and_moe.py's case on the port: with capacity for
    every assignment the sorted dispatch is the dense oracle (f32)."""
    _, tq, _, cfg_t, _, tp, x = _moe_case("dchw", cf=3.0)
    xb = torch.from_numpy(x).reshape(2, 12, -1)
    with torch.no_grad():
        ys = moe.moe_block(xb, tp, cfg_t, tq, mode="sorted")
        yd = moe.moe_block(xb, tp, cfg_t, tq, mode="dense")
    np.testing.assert_allclose(ys.numpy(), yd.numpy(), rtol=1e-5, atol=1e-6)


def test_padded_experts_never_routed():
    """tests/test_serve_and_moe.py::test_moe_padding_experts_never_routed
    on the port (8 experts, 2 of them padding), on the JAX package's
    converted parameters: the padded probabilities are exactly 0, equal to
    JAX's, and neither dispatch routes a token there."""
    cfg_j = dataclasses.replace(J_SMOKE, moe=dataclasses.replace(
        J_SMOKE.moe, n_experts_padded=8))
    cfg_t = dataclasses.replace(T_SMOKE, moe=dataclasses.replace(
        T_SMOKE.moe, n_experts_padded=8))
    jp = j_moe.init_moe(jax.random.PRNGKey(1), cfg_j, None)
    x = np.random.default_rng(1).normal(size=(32, 64)).astype(np.float32)
    want = j_moe._router_probs(jnp.asarray(x), jp, cfg_j, None)
    tp = _t(jp)
    with torch.no_grad():
        probs = moe._router_probs(torch.from_numpy(x), tp, cfg_t, None)
        _, topi = moe.top_k(probs, 2)
    assert probs.shape[-1] == 8 and float(probs[:, 6:].max()) == 0.0
    _rel(probs.numpy(), np.asarray(want), 1e-6)
    assert int(topi.max()) < 6


@pytest.mark.parametrize("moe_mode", ["sorted", "dense"])
@pytest.mark.parametrize("student", [False, True])
def test_forward_matches_jax(student, moe_mode):
    """The whole SMOKE model, f32: logits and hidden states within 1e-4 of
    JAX's, teacher and plan-aware W4A8 student, under both dispatch modes
    (``set_runtime(moe_mode=...)``)."""
    jq, tq = _qcfgs("dchw" if student else None)
    jp = j_init_model(jax.random.PRNGKey(1), J_SMOKE, jq)
    tp = _t(jp)
    jplan = tplan = None
    if student:
        jplan = j_resolve_plan(jq, jp, model_cfg=J_SMOKE)
        tplan = resolve_plan(tq, tp, model_cfg=T_SMOKE)
    toks = np.random.default_rng(0).integers(0, T_SMOKE.vocab, (2, 10))
    j_transformer.set_runtime(moe_mode=moe_mode)
    transformer.set_runtime(moe_mode=moe_mode)
    try:
        jo = j_forward(jp, J_SMOKE, jq, {"tokens": jnp.asarray(toks)},
                       compute_dtype=jnp.float32, plan=jplan)
        with torch.no_grad():
            to = forward(tp, T_SMOKE, tq, {"tokens": torch.from_numpy(toks)},
                         compute_dtype=torch.float32, plan=tplan)
    finally:
        j_transformer.set_runtime(moe_mode="sorted")
        transformer.set_runtime(moe_mode="sorted")
    for key in ("logits", "hidden"):
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("which", ["SMOKE", "CONFIG"])
def test_resolved_plan_json_matches_jax(which):
    """The plan byte for byte: the router at router_bits with role
    ``router``, each expert stack one path, the shared experts' stream
    ties; the port's skeleton is built on the meta device (shapes
    only), as the pipeline's ``resolve_quant_plan`` builds it."""
    from repro_torch.pipeline.adapters import resolve_quant_plan
    jc, tc = getattr(j_cfgs, which), getattr(t_cfgs, which)
    jq, tq = JQ(), TQ()
    jskel = jax.eval_shape(lambda k: j_init_model(k, jc, jq),
                           jax.random.PRNGKey(0))
    plan = resolve_quant_plan(tc, tq)
    assert plan.to_json() == j_resolve_plan(jq, jskel,
                                            model_cfg=jc).to_json()
    router = plan.spec("layers.mlp.router")
    assert router.role == "router" and router.w_bits == tc.moe.router_bits
    assert plan.spec("layers.mlp.shared_down").stream == "shared_act_stream"
    assert plan.spec("layers.mlp.up").shape[-3] == tc.moe.n_experts_padded


@pytest.mark.parametrize("qname", ["dchw", "chw"])
def test_init_scales_matches_jax(qname):
    """MMSE (CHW) / APQ (DCHW) scale init on the MoE student: every leaf
    1e-6 of the JAX package's (the stacked experts' APQ with the
    geometric-mean S_wL, the in_stream written by its consumers in key
    order)."""
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


def test_train_step_f32_matches_jax():
    """One student step's loss and gradients in f32 (backbone L2): the
    loss 1e-6 relative, each leaf 1e-4 relative L2 — router, expert
    stacks, shared experts and the three streams included."""
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
    mlp = grads["layers"]["mlp"]
    for k in ("router", "up", "shared_down"):
        assert float(mlp[k]["w"].abs().max()) > 0, k


def _jax_stack(L=2, E=3, d_in=8, d_out=4, layout="channel"):
    jq = JQ(w_layout=layout)
    keys = jax.random.split(jax.random.PRNGKey(5), L)
    lin = jax.vmap(lambda k: j_dof.init_qlinear(
        k, d_in, d_out, jq, expert_dim=E, name="up"))(keys)
    rng = np.random.default_rng(5)
    lin = {**lin, "log_swr": lin["log_swr"] + jnp.asarray(
        0.3 * rng.normal(size=lin["log_swr"].shape), jnp.float32)}
    log_sa = jnp.asarray(np.log(0.05) + 0.3 * rng.normal(size=(L, d_in)),
                         jnp.float32)
    return jq, lin, log_sa


@pytest.mark.parametrize("layout", ["channel", "group:4", "layerwise"])
def test_stacked_expert_export_and_deploy_view_match_jax(layout):
    """F15: a ``[L, E, in, out]`` expert stack exported by the JAX
    package (``export_qlinear`` under ``jax.vmap`` over layers) and by the
    port: ``q`` bit-equal, ``s_wl [L, in]`` and ``s_wr`` within an ulp
    (each an ``exp`` of a log DoF, as test_torch_core.py holds them);
    ``deploy_view`` of the JAX artifact bit-equal in f32 to JAX's
    ``dequantize_export`` (the shared ``s_wl`` broadcast over the
    experts), and of the port's own artifact to its effective weights."""
    jq, lin, log_sa = _jax_stack(layout=layout)
    jex = jax.vmap(lambda p, s: j_dof.export_qlinear(p, jq, log_sa_in=s))(
        lin, log_sa)
    want_w = np.asarray(j_dof.dequantize_export(jex, jnp.float32))
    tq = TQ(w_layout=layout)
    tree = {"layers": {"mlp": {"up": _t(lin), "in_stream": {
        "log_sa": _t(log_sa), "zp": torch.zeros(2, 8)}}}}
    plan = make_deploy_plan(tq, params=tree)
    ex = export_for_layers(tree, plan, device="cpu")
    got = ex["layers"]["mlp"]["up"]
    assert got["s_wl"].shape == (2, 8)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(jex["q"]))
    for k in ("s_wl", "s_wr"):
        assert got[k].shape == jex[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jex[k]),
                                   rtol=1e-6, atol=0, err_msg=k)

    def view(artifact):
        return deploy_view({"layers": {"mlp": {"up": artifact}}}, plan,
                           dtype=torch.float32)["layers"]["mlp"]["up"]["w"]
    w = view(_t(jex))
    assert w.shape == (2, 3, 8, 4)
    np.testing.assert_array_equal(w.numpy(), want_w)
    eff = torch.stack([t_dof.effective_weight(
        {"w": tree["layers"]["mlp"]["up"]["w"][i],
         "log_swr": tree["layers"]["mlp"]["up"]["log_swr"][i]}, tq,
        _t(log_sa)[i], torch.float32) for i in range(2)])
    np.testing.assert_array_equal(view(got).numpy(), eff.numpy())


@functools.lru_cache(maxsize=None)
def _jax_artifact(cf=3.0):
    cfg = _with_cf(J_SMOKE, cf)
    jq = JQ()
    # keys sorted (jax.tree.map rebuilds dicts in key order), as the
    # converted tree has them, so both plans list their tensors in one order
    params = jax.tree.map(lambda a: a,
                          j_init_model(jax.random.PRNGKey(0), cfg, jq))
    plan = j_deploy.make_deploy_plan(jq, params=params, model_cfg=cfg)
    return plan, jax.jit(lambda p: j_deploy.export_for_layers(p, plan))(
        params), params


def test_export_model_and_deploy_view_match_jax():
    """The whole SMOKE student: export_for_layers and export_model equal
    the JAX artifact (integer leaves bit for bit, scales 1e-6), and the
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
    assert dv[("layers", "mlp", "down", "w")].shape == (2, 6, 32, 64)
    for path, leaf in dv.items():
        np.testing.assert_allclose(leaf.numpy(), jdv[path].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=str(path))


def test_kernel_route_check_picks_the_jax_path():
    """kernel_route_check on the MoE artifact probes the linear the JAX
    package's does (and on the CPU launches nothing)."""
    plan, jex, _ = _jax_artifact()
    want = j_deploy.kernel_route_check(jex, plan)
    got = kernel_route_check(_t(jex), DeployPlan(qcfg=TQ()))
    assert got["path"] == want["path"] and got["layout"] == want["layout"]
    assert not got["kernel"]
    assert got["max_err"] <= 1e-5


PROMPTS = [[1, 2, 3], list(range(5, 20)), [300, 7, 42, 8], [9, 9]]
NEW = 6
SCFG = dict(max_slots=2, max_len=48, prefill_chunk=8, kv_page_size=16)


def _port_engine(cf=3.0, **kw):
    _, jex, _ = _jax_artifact(cf)
    return Engine.from_artifact(_with_cf(T_SMOKE, cf), DeployPlan(qcfg=TQ()),
                                _t(jex), ServeConfig(**{**SCFG, **kw}),
                                device="cpu")


def _serve_alone(prompt, jax_engine, monkeypatch):
    """Serve ``prompt`` alone (slot 0) and record, in call order, each
    router call's rows (``("r", ·)``: the port's f32 logits, JAX's log
    probabilities — the logits less a per-row constant) and each forward's
    logits (``("z", ·)``)."""
    events = _EVENTS
    events.clear()
    monkeypatch.undo()
    if jax_engine:
        from repro.train import steps as j_steps

        def put(kind):           # the JAX engine keeps its compiled steps:
            return lambda v: _EVENTS.append((kind, np.asarray(  # one sink
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
        plan, jex, _ = _jax_artifact()
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


_EVENTS: list = []


def _ulp(z):
    return 2.0 ** (math.floor(math.log2(max(abs(float(z)), 1e-30))) - 7)


def _first_split(prompt, jev, tev):
    """Walk both runs' decisions in call order — each real token's top-k
    experts in every layer, then each emitted token — and return
    ``(kind, within)`` at the first one that differs (``("same", True)``
    if none does): ``within`` says whether the JAX package's own margin
    there (the k-th minus (k+1)-th router logit, or the top-2 logit) is
    within MARGIN_ULPS bf16 ulps of the row's largest logit in magnitude
    (the top logit, for the tokens), the scale of a bf16 product's
    rounding."""
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


_UNSCANNED = dataclasses.replace(_with_cf(J_SMOKE, 3.0), scan_layers=False,
                                 remat=False)


def test_greedy_tokens_match_jax_engine(monkeypatch):
    """The JAX artifact, converted, served by both engines (paged int8 KV,
    capacity_factor 3 = n_experts/top_k), each request alone.  Every
    routing decision and every greedy token is the same until the first
    one that differs, and there the JAX package's own margin is within
    MARGIN_ULPS bf16 ulps: a router near-tie (the k-th against the
    (k+1)-th expert's logit) or a top-2 logit near-tie.

    Routing turns one bf16 rounding into a different expert, and bf16
    router logits tie often at this size (6 experts; a 4-ulp gap between
    the 2nd and 3rd of 6 logits is common), so a split is not rare: the
    JAX package's own jitted and eager engines route ``range(5, 20)``
    differently at token 0.  The JAX engine runs the layers unscanned, the
    graph the port's layer loop is."""
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


@pytest.mark.parametrize("cf,slots", [(1.25, 8), (3.0, 2), (2.9, 2),
                                      (15.0, 8), (3.0, 3), (1.25, 1)])
def test_capacity_refusal_matches_jax(cf, slots):
    """The engine refuses to build where the JAX engine does, with its
    message, and builds where it builds."""
    plan, jex, _ = _jax_artifact()
    jerr = terr = None
    try:
        JEngine.from_artifact(_with_cf(J_SMOKE, cf), plan, jex,
                              JServeConfig(**{**SCFG, "max_slots": slots}))
    except ValueError as e:
        jerr = str(e)
    try:
        _port_engine(cf, max_slots=slots)
    except ValueError as e:
        terr = str(e)
    assert terr == jerr
    assert (jerr is None) == (cf >= 3.0 or slots == 1)


def test_engine_refuses_full_config_at_eight_slots():
    """qwen2-moe-a2.7b's own capacity_factor (1.25) at 8 slots gives a
    capacity of 1 < 8: refused before anything is built."""
    with pytest.raises(ValueError, match=r"capacity_factor >= 15 "):
        Engine.from_artifact(t_cfgs.CONFIG, DeployPlan(qcfg=TQ()), {},
                             ServeConfig(max_slots=8), device="cpu")


REQS = [Request(prompt=[1, 2, 3], max_new_tokens=5),
        Request(prompt=[7, 8], max_new_tokens=3),
        Request(prompt=list(range(1, 12)), max_new_tokens=4),
        Request(prompt=[5, 4, 3, 2, 1], max_new_tokens=6),
        Request(prompt=[9, 9], max_new_tokens=2, eos_id=0)]


@pytest.mark.parametrize("sampled", [False, True])
def test_solo_static_interleaved_identical(sampled):
    """Within the port: a request's tokens served alone, in a static batch
    and interleaved are bit-identical (no token is dropped, and the
    combine sums in a fixed order)."""
    reqs = [dataclasses.replace(r, seed=i,
                                temperature=0.9 if sampled else 0.0,
                                top_k=20 if sampled else 0,
                                top_p=0.9 if sampled else 1.0)
            for i, r in enumerate(REQS)]
    eng = _port_engine(max_slots=3)
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
    rids.append(eng.submit(reqs[2]))
    while eng.pending():
        inter.update(eng.step())
    inter_tokens = [None] * 5
    for rid, i in zip(rids, [3, 0, 4, 1, 2]):
        inter_tokens[i] = inter[rid]
    assert solo == static == inter_tokens


def test_one_host_transfer_per_decode_step(monkeypatch):
    """The MoE decode step keeps one ``.cpu()`` per step and no
    ``.item()``/``bool()``/``int()`` on a tensor."""
    eng = _port_engine(max_slots=3)
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
    for name in ("item", "__bool__", "__int__", "__float__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, bad(name))
    eng.generate(REQS)
    monkeypatch.undo()
    assert counts["cpu"] == eng.decode_steps > 0
    assert counts["other"] == eng.decode_steps      # the step's .tolist()


def test_cli_quantize_moe_runs_and_resumes(capsys, tmp_path):
    """``python -m repro_torch quantize --config qwen2_moe_a2_7b --device
    cpu`` (SMOKE size, the CLI's default): every stage, export parity below 1e-4; the rerun on
    its workdir skips calibrate, init and finetune and reports the same
    metrics."""
    from repro_torch.pipeline.cli import main
    args = ["quantize", "--config", "qwen2_moe_a2_7b", "--device", "cpu", "--steps", "2", "--calib-samples", "16",
            "--calib-seq-len", "16", "--calib-batch-size", "4",
            "--workdir", str(tmp_path)]
    assert main(args) == 0
    first = capsys.readouterr().out
    assert "pipeline: qwen2-moe-a2.7b" in first
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
