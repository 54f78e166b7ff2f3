"""repro_torch's Mamba2 SSM family (mamba2-1.3b) against the JAX package, on
the CPU at SMOKE size (2 layers, d 64, d_inner 128, 8 SSM heads x 16,
d_state 16, one group, chunk 16, vocab 512, the head tied).

Parameters are initialised in JAX and converted; activations, caches and
tokens are made with numpy.  Tolerances: integer outputs (packed nibbles)
bit for bit; ``ssd_chunked`` 1e-5 relative and its gradients 1e-4
relative L2; f32 ``ssm_block`` outputs and written caches 1e-5 relative,
bf16 ones 2e-2 relative (one bf16 rounding of the products, which the two
packages round in different places); the f32 model forward and its taps
1e-4; one f32 train step's loss 1e-6 relative and each gradient leaf 1e-4
relative L2; scale leaves 1e-6.  The engines serve in bf16: greedy tokens
are held to the JAX package's, a request that differs only at a step
where JAX's own top-2 margin is within a few bf16 ulps (as
tests/test_torch_serve.py holds the dense engine).
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import mamba2_1_3b as j_cfgs  # noqa: E402
from repro.core import distill as j_distill  # noqa: E402
from repro.core.plan import resolve_plan as j_resolve_plan  # noqa: E402
from repro.core.qconfig import Granularity as JG  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.serve import deploy as j_deploy  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.train import qft_trainer as j_trainer  # noqa: E402
from repro_torch.configs import mamba2_1_3b as t_cfgs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.plan import resolve_plan  # noqa: E402
from repro_torch.core.qconfig import Granularity as TG  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.models import forward, init_cache, init_model  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
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
MARGIN_ULPS = 4
SSM_STREAMS = ("in_stream", "out_stream")


def _t(tree):
    return from_numpy_tree(jax.device_get(tree), "cpu")


def _qcfgs(name):
    if name is None:
        return None, None
    if name == "chw":
        return JQ(granularity=JG.CHW), TQ(granularity=TG.CHW)
    return JQ(), TQ()


def _rel(a, b, rtol, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = float(np.max(np.abs(a - b)))
    assert np.all(np.isfinite(a)), what
    assert err <= rtol * max(float(np.max(np.abs(b))), 1e-30), (what, err)


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
# configs and the family gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_values(which):
    """CONFIG and SMOKE field for field (SMOKE's reset padded fields
    re-derived at its size: vocab 512, not 50280), and the registry serves
    them."""
    j, t = getattr(j_cfgs, which), getattr(t_cfgs, which)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert get_config("mamba2-1.3b", smoke=which == "SMOKE") == t
    assert t.family == "ssm" and t.tie_embeddings
    assert t.vocab_padded == (512 if which == "SMOKE" else 50280)


def test_the_port_admits_ssm_and_refuses_it_without_its_block():
    """``FAMILIES`` holds ssm and hybrid; an ssm config without its
    ``SSMConfig``, and a family the transformer does not run (the
    CNN's), are refused by name."""
    assert {"ssm", "hybrid"} <= set(transformer.FAMILIES)
    init_model(0, T_SMOKE, None, device="meta")
    with pytest.raises(NotImplementedError, match="family 'ssm'"):
        init_model(0, dataclasses.replace(T_SMOKE, ssm=None), None,
                   device="meta")
    with pytest.raises(NotImplementedError, match="family 'cnn'"):
        init_model(0, dataclasses.replace(T_SMOKE, family="cnn"), None,
                   device="meta")


# ---------------------------------------------------------------------------
# models/ssm.py
# ---------------------------------------------------------------------------

def _np_zeros(skel):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), skel)


@pytest.mark.parametrize("student", [False, True])
def test_init_ssm_keys_and_shapes(student):
    """init_ssm alone (against ``jax.eval_shape``) and inside init_model:
    the JAX package's keys in its sorted order and shapes, every leaf of
    the layer tree stacked ``[L, ...]``; ``A_log`` is log(1..16)."""
    jq, tq = _qcfgs("dchw" if student else None)
    want = jax.eval_shape(lambda k: j_ssm.init_ssm(k, J_SMOKE, jq),
                          jax.random.PRNGKey(0))
    one = ssm.init_ssm(torch.Generator().manual_seed(0), T_SMOKE, tq)
    assert list(one) == sorted(want)
    assert {p: tuple(v.shape) for p, v in tree_items(one)} == {
        p: tuple(v.shape) for p, v in tree_items(_t(_np_zeros(want)))}
    assert ("in_stream" in one) == student
    jp = j_ssm.init_ssm(jax.random.PRNGKey(0), J_SMOKE, jq)
    np.testing.assert_allclose(one["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1e-6)
    jskel = jax.eval_shape(lambda k: j_init_model(k, J_SMOKE, jq),
                           jax.random.PRNGKey(0))
    tp = init_model(0, T_SMOKE, tq, device="cpu")
    assert sorted((p, tuple(v.shape)) for p, v in tree_items(tp)) == sorted(
        (p, tuple(s.shape)) for p, s in tree_items(_np_zeros(jskel)))
    assert "lm_head" not in tp                       # the tied head
    assert list(tp["layers"]["ssm"]) == list(jskel["layers"]["ssm"])


def test_init_ssm_cache_matches_jax():
    """``ssm_state [L, B, H, P, N]`` and ``conv_state [L, B, d_conv-1,
    conv_dim]``, f32, no ``pos``; ``init_cache`` picks it for ssm."""
    want = j_ssm.init_ssm_cache(J_SMOKE, 3, 2)
    got = ssm.init_ssm_cache(T_SMOKE, 3, 2)
    assert sorted(got) == sorted(want) == ["conv_state", "ssm_state"]
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.float32
    c = init_cache(T_SMOKE, 1, 8, device="cpu")
    assert sorted(c) == ["conv_state", "ssm_state"]
    assert tuple(c["ssm_state"].shape) == (2, 1, 8, 16, 16)


def _ssd_inputs(seed, S=48, B=2, H=4, P=8, G=2, N=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            (0.3 * np.abs(rng.normal(size=(B, S, H)))).astype(np.float32),
            -np.linspace(0.5, 3.0, H).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32),
            rng.normal(size=(B, H, P, N)).astype(np.float32))


@pytest.mark.parametrize("chunk", [8, 16, 48])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(with_state, chunk):
    """The chunked scan (G 2 groups under H 4 heads; one chunk, three, six)
    with and without an initial state: y and the final state 1e-5
    relative."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(chunk)
    init = s0 if with_state else None
    jy, jfin = j_ssm.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
        init_state=None if init is None else jnp.asarray(init))
    ty, tfin = ssm.ssd_chunked(
        *map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk,
        init_state=None if init is None else torch.from_numpy(init))
    _rel(ty.numpy(), np.asarray(jy), 1e-5, "y")
    _rel(tfin.numpy(), np.asarray(jfin), 1e-5, "final state")
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), 7)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_gradient_matches_jax(with_state):
    """The gradient of a weighted sum of y and the final state with
    respect to x, dt, A, B, C (and the initial state), against
    ``jax.grad``: all finite (the exponent is masked before ``exp``, so
    the upper triangle's inf never meets a zero), each 1e-4 relative L2."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(5)
    rng = np.random.default_rng(6)
    wy = rng.normal(size=x.shape).astype(np.float32)
    ws = rng.normal(size=s0.shape).astype(np.float32)
    args = [x, dt, A, Bm, Cm] + ([s0] if with_state else [])

    def jloss(*a):
        y, fin = j_ssm.ssd_chunked(*a[:5], 16,
                                   init_state=a[5] if with_state else None)
        return jnp.sum(y * wy) + jnp.sum(fin * ws)
    jg = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    ta = [torch.from_numpy(a).requires_grad_() for a in args]
    y, fin = ssm.ssd_chunked(*ta[:5], 16,
                             init_state=ta[5] if with_state else None)
    (torch.sum(y * torch.from_numpy(wy))
     + torch.sum(fin * torch.from_numpy(ws))).backward()
    for name, t, j in zip(("x", "dt", "A", "B", "C", "s0"), ta, jg):
        g, ref = t.grad.double().numpy(), np.asarray(j, np.float64)
        assert np.all(np.isfinite(g)), name
        assert np.linalg.norm(g - ref) <= 1e-4 * np.linalg.norm(ref), name


@functools.lru_cache(maxsize=None)
def _block_case(qname, seed=0):
    """A converted Mamba2 block (JAX init; a student's streams made
    non-trivial, as calibration leaves them; dt_bias, D and norm_g moved
    off their init)."""
    jq, tq = _qcfgs(qname)
    jp = dict(j_ssm.init_ssm(jax.random.PRNGKey(seed), J_SMOKE, jq))
    rng = np.random.default_rng(seed)
    for k in ("dt_bias", "D", "norm_g", "conv_b"):
        n = jp[k].shape[-1]
        jp[k] = jnp.asarray(rng.normal(size=n) * 0.3
                            + (1.0 if k != "dt_bias" else -1.0), jnp.float32)
    if jq is not None:
        for s in SSM_STREAMS:
            n = jp[s]["log_sa"].shape[-1]
            jp[s] = {"log_sa": jnp.asarray(
                np.log(0.05) + 0.2 * rng.normal(size=n), jnp.float32),
                "zp": jnp.asarray(rng.integers(-3, 4, n), jnp.float32)}
    jp = {k: jp[k] for k in sorted(jp)}
    return jq, tq, jp, _t(jp)


def _block_inputs(mode, seed=1):
    """``(x [B, S, d], cache | None)`` from numpy: cache-free (S 37, a
    ragged last chunk of 16), a cached prefill of 20 rows, and a decode
    step (S 1); the caches hold a random earlier state."""
    rng = np.random.default_rng(seed)
    B, S = 2, {"none": 37, "prefill": 20, "decode": 1}[mode]
    x = rng.normal(size=(B, S, T_SMOKE.d_model)).astype(np.float32)
    if mode == "none":
        return x, None
    c = j_ssm.init_ssm_cache(J_SMOKE, B, 1)
    cache = {k: (0.3 * rng.normal(size=v.shape[1:])).astype(np.float32)
             for k, v in sorted(c.items())}
    return x, cache


def _both_blocks(mode, dtype, jp, tp, jq, tq):
    x, c = _block_inputs(mode)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jc = None if c is None else {k: jnp.asarray(v) for k, v in c.items()}
    tc = None if c is None else {k: torch.from_numpy(v.copy())
                                 for k, v in c.items()}
    jtaps, ttaps = {}, {}
    jout, jnew = j_ssm.ssm_block(jnp.asarray(x, jdt), jp, J_SMOKE, jq, jc,
                                 taps=jtaps, prefix="L0.ssm")
    with torch.no_grad():
        tout = ssm.ssm_block(torch.from_numpy(x).to(tdt), tp, T_SMOKE, tq,
                             tc, taps=ttaps, prefix="L0.ssm")
    return jout, jnew, tout, tc, jtaps, ttaps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["none", "prefill", "decode"])
@pytest.mark.parametrize("qname", [None, "dchw"])
def test_ssm_block_matches_jax(qname, mode, dtype):
    """ssm_block, teacher and W4A8 DCHW student, in all three modes
    (cache-free at S 37, padded to a chunk multiple with dt = 0; a cached
    prefill whose conv takes ``conv_state`` as left context and whose scan
    starts from ``ssm_state``; a decode step): the output 1e-5 (f32) /
    2e-2 (bf16) relative, the cache written in place equal to JAX's new
    cache to the same tolerance (the state stays f32), and the
    ``{prefix}.out`` tap."""
    jq, tq, jp, tp = _block_case(qname)
    jout, jnew, tout, tc, jtaps, ttaps = _both_blocks(mode, dtype, jp, tp,
                                                      jq, tq)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert str(tout.dtype) == f"torch.{dtype}"
    _rel(tout.float().numpy(), np.asarray(jout.astype(jnp.float32)), tol)
    assert sorted(ttaps) == sorted(jtaps) == ["L0.ssm.out"]
    for k in ("min", "max", "mean"):
        _rel(ttaps["L0.ssm.out"][k].numpy(),
             np.asarray(jtaps["L0.ssm.out"][k]), 2e-5 if dtype ==
             "float32" else 3e-2, k)
    if tc is None:
        assert jnew is None
        return
    for k in ("ssm_state", "conv_state"):
        assert tc[k].dtype == torch.float32
        _rel(tc[k].numpy(), np.asarray(jnew[k]), tol, k)


@pytest.mark.parametrize("split", [(20,), (7, 13), (16, 4), (1, 19)])
def test_chunked_prefill_then_decode_matches_one_full_forward(split):
    """The SMOKE model in f32: prefilling 20 tokens into a batch-1 cache in
    chunks of ``split`` (one at a time included), then decoding 6 more one
    token at a time, gives every position's logits of one cache-free
    forward over the 26 tokens (1e-4 of max|logit|)."""
    tp = _t(j_init_model(jax.random.PRNGKey(4), J_SMOKE, None))
    toks = np.random.default_rng(2).integers(0, T_SMOKE.vocab, (1, 26))
    with torch.no_grad():
        full = forward(tp, T_SMOKE, None, {"tokens": torch.from_numpy(toks)},
                       compute_dtype=torch.float32)["logits"][0]
        cache = init_cache(T_SMOKE, 1, 32, device="cpu")
        rows, off = [], 0
        for n in split + (1,) * 6:
            out = forward(tp, T_SMOKE, None, {"tokens": torch.from_numpy(
                toks[:, off:off + n])}, cache=cache,
                compute_dtype=torch.float32)
            assert out["cache"] is cache
            rows.append(out["logits"][0])
            off += n
    got = torch.cat(rows)
    _rel(got.numpy(), full.numpy(), 1e-4)


# ---------------------------------------------------------------------------
# the model: plan, forward, taps, init, a train step
# ---------------------------------------------------------------------------

PLAN_OVERRIDES = dict(bits_overrides=(("layers.ssm.in_proj", 8),),
                      exempt_frac=0.0)


@pytest.mark.parametrize("overrides", [False, True])
@pytest.mark.parametrize("which", ["SMOKE", "CONFIG"])
def test_resolved_plan_json_matches_jax(which, overrides):
    """The plan byte for byte (the port's skeleton built on the meta
    device), with no ``kv_cache`` entry, and with
    tests/test_plan_threading.py's ssm overrides (``layers.ssm.in_proj``
    at 8 bits, no exemption)."""
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
    assert plan.spec("layers.ssm.in_proj").stream == "in_stream"
    assert plan.spec("layers.ssm.out_proj").stream == "out_stream"
    if overrides:
        assert plan.bits_for("layers.ssm.in_proj") == 8


@pytest.mark.parametrize("student", [False, True])
def test_forward_and_taps_match_jax(student):
    """The whole SMOKE model, f32: logits and hidden states within 1e-4 of
    JAX's, teacher and plan-aware W4A8 student; the calibration taps
    (``L{i}.ssm_in``, ``L{i}.ssm.out``, ``L{i}.ssm_out``) named and valued
    as the JAX package's unrolled forward records them."""
    jq, tq = _qcfgs("dchw" if student else None)
    jp = j_init_model(jax.random.PRNGKey(1), J_SMOKE, jq)
    tp = _t(jp)
    jplan = tplan = None
    if student:
        jplan = j_resolve_plan(jq, jp, model_cfg=J_SMOKE)
        tplan = resolve_plan(tq, tp, model_cfg=T_SMOKE)
    toks = np.random.default_rng(0).integers(0, T_SMOKE.vocab, (2, 21))
    jo = j_forward(jp, J_UNSCANNED, jq, {"tokens": jnp.asarray(toks)},
                   compute_dtype=jnp.float32, plan=jplan, collect_taps=True)
    with torch.no_grad():
        to = forward(tp, T_SMOKE, tq, {"tokens": torch.from_numpy(toks)},
                     compute_dtype=torch.float32, plan=tplan,
                     collect_taps=True)
    for key in ("logits", "hidden"):
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    assert sorted(to["taps"]) == sorted(jo["taps"]) == sorted(
        f"L{i}.{n}" for i in range(T_SMOKE.n_layers)
        for n in ("ssm_in", "ssm.out", "ssm_out"))
    for name, st in to["taps"].items():
        for k, v in st.items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jo["taps"][name][k]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name}.{k}")


def _calib_batches(seed=7, n=2):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, T_SMOKE.vocab, (2, 24)).astype(
        np.int32)} for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _calibrated(qname):
    """The JAX package's calibrated SMOKE student (from its bf16
    teacher's taps over two batches), the teacher and the student before
    calibration."""
    jq, _ = _qcfgs(qname)
    teacher = j_init_model(jax.random.PRNGKey(2), J_SMOKE, None)
    student = j_init_model(jax.random.PRNGKey(3), J_SMOKE, jq)
    jcal = j_trainer.calibrate_student(
        student, J_SMOKE, jq, teacher,
        [{k: jnp.asarray(v) for k, v in b.items()}
         for b in _calib_batches()])
    return teacher, student, jcal


@pytest.mark.parametrize("qname", ["dchw", "chw"])
def test_calibrate_matches_jax(qname):
    """Calibration writes each ``L{i}.ssm_in`` / ``L{i}.ssm.out`` tap's
    range into that layer's ``in_stream`` / ``out_stream``.  The range is
    the max/min of the teacher's bf16 taps, which the two packages round
    in different places: ``log_sa`` within one bf16 ulp of the range
    (log(1 + 2^-7)), the zero-point within 1 (as
    tests/test_torch_pipeline.py holds the dense calibration); every
    other leaf as it was."""
    jq, tq = _qcfgs(qname)
    teacher, student, jcal = _calibrated(qname)
    ts = _t(student)
    got = qft_trainer.calibrate_student(
        ts, T_SMOKE, tq, _t(teacher),
        [{k: torch.from_numpy(v) for k, v in b.items()}
         for b in _calib_batches()])
    want = dict(tree_items(_t(jcal)))
    for path, leaf in tree_items(got):
        if path[0] == "layers" and path[-1] in ("log_sa", "zp"):
            assert not torch.equal(leaf, dict(tree_items(ts))[path]), path
            atol = 1.0 if path[-1] == "zp" else math.log1p(2.0 ** -7)
            np.testing.assert_allclose(leaf.numpy(), want[path].numpy(),
                                       rtol=0, atol=atol, err_msg=str(path))
        else:
            assert torch.equal(leaf, want[path]), path


@pytest.mark.parametrize("qname", ["dchw", "chw"])
def test_init_scales_matches_jax(qname):
    """MMSE (CHW) / APQ (DCHW) scale init on the JAX package's calibrated
    student: every leaf 1e-6 of the JAX package's.  Under CHW the
    calibrated streams stay and ``log_swr`` is fitted against them.  Under
    DCHW APQ writes ``-log S_wL`` into each stream, but the walk over the
    block's sorted keys then reaches ``in_stream`` (after ``in_proj``) and
    ``out_stream`` (after ``out_proj``) and copies back the calibrated
    value, so the streams keep it while ``log_swr`` was refitted for APQ's
    ``S_wL`` (F17, as in the JAX package)."""
    jq, tq = _qcfgs(qname)
    _, student, jcal = _calibrated(qname)
    jplan = j_resolve_plan(jq, student, model_cfg=J_SMOKE)
    want = _t(j_trainer.init_scales(jcal, J_SMOKE, jq, plan=jplan))
    tcal = _t(jcal)
    got = qft_trainer.init_scales(tcal, T_SMOKE, tq,
                                  plan=resolve_plan(tq, tcal,
                                                    model_cfg=T_SMOKE))
    _leaves_close(got, want, rtol=1e-6, atol=1e-6)
    for st in SSM_STREAMS:
        assert torch.equal(got["layers"]["ssm"][st]["log_sa"],
                           tcal["layers"]["ssm"][st]["log_sa"]), st
    changed = not torch.equal(got["layers"]["ssm"]["in_proj"]["log_swr"],
                              tcal["layers"]["ssm"]["in_proj"]["log_swr"])
    assert changed


def test_cle_init_matches_jax():
    """The 4b-adapted CLE (``cle_init=True``) skews each Mamba2 block's
    ``in_stream`` by its consumer ``in_proj``: 1e-6 of the JAX
    package's."""
    jq, tq = _qcfgs("chw")
    jp = j_init_model(jax.random.PRNGKey(5), J_SMOKE, jq)
    want = _t(j_trainer.init_scales(jp, J_SMOKE, jq, cle_init=True))
    got = qft_trainer.init_scales(_t(jp), T_SMOKE, tq, cle_init=True)
    _leaves_close(got, want, rtol=1e-6, atol=1e-6)


def test_train_step_f32_matches_jax():
    """One W4A8 student step's loss and gradients in f32 (backbone L2):
    the loss 1e-6 relative, each leaf 1e-4 relative L2 — both projections,
    the conv, A_log, D, dt_bias, the gated norm and both streams; the tied
    head is not read."""
    jq, tq = JQ(), TQ()
    teacher = j_init_model(jax.random.PRNGKey(0), J_SMOKE, None)
    student = j_init_model(jax.random.PRNGKey(1), J_SMOKE, jq)
    jplan = j_resolve_plan(jq, student, model_cfg=J_SMOKE)
    toks = np.random.default_rng(3).integers(0, T_SMOKE.vocab, (2, 24))
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
        if g is None:       # the head's stream: the backbone loss never
            assert path[0] == "head_stream", path       # reads it
            assert float(ref.abs().max()) == 0.0, path
            continue
        err = float((g.double() - ref).norm())
        assert err <= 1e-4 * (float(ref.norm()) + 1e-3 * gnorm), (path, err)
    blk = grads["layers"]["ssm"]
    for k in ("in_proj", "out_proj"):
        assert float(blk[k]["w"].abs().max()) > 0, k
    for k in ("conv_w", "A_log", "D", "dt_bias", "norm_g"):
        assert float(blk[k].abs().max()) > 0, k


# ---------------------------------------------------------------------------
# export, deploy view, route check
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_artifact(head_dim=None):
    cfg = J_SMOKE
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, head_dim=head_dim))
    jq = JQ()
    params = j_init_model(jax.random.PRNGKey(0), cfg, jq)
    plan = j_deploy.make_deploy_plan(jq, params=params, model_cfg=cfg)
    return plan, jax.jit(lambda p: j_deploy.export_for_layers(p, plan))(
        params), params


def test_export_model_and_deploy_view_match_jax():
    """The whole SMOKE Mamba2 student: export_for_layers and export_model
    equal the JAX artifact (integer leaves bit for bit, scales 1e-6;
    ``in_proj``'s ``s_wl`` from ``in_stream``, ``out_proj``'s from
    ``out_stream``), and the deploy view equals JAX's (1e-6)."""
    plan, jex, student = _jax_artifact()
    want = _t(jex)
    ts = _t(student)
    tplan = make_deploy_plan(TQ(), params=ts, model_cfg=T_SMOKE)
    got = export_for_layers(ts, tplan, device="cpu")
    one_walk = dict(tree_items(export_model(ts, tplan, device="cpu")))
    assert ("layers", "ssm", "out_proj", "s_wl") in dict(tree_items(want))
    _leaves_close(got, want, rtol=1e-6)
    for path, leaf in tree_items(got):
        assert torch.equal(leaf, one_walk[path]), path
    dv = deploy_view(got, tplan, dtype=torch.float32)
    jdv = _t(j_deploy.deploy_view(jex, plan, dtype=jnp.float32))
    _leaves_close(dv, jdv, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("head_dim", [None, 4])
def test_kernel_route_check_picks_the_jax_path(head_dim):
    """kernel_route_check probes the linear the JAX package's does and on
    the CPU launches nothing.  At SMOKE (in_proj N 296) neither tiling
    takes in_proj, both take out_proj; with 32 heads of 4 in_proj's N is
    320, which the CUDA kernel's 64-wide tiles take and the Pallas 128-wide
    blocks do not (mamba2-1.3b's N 8512 likewise): both still probe
    out_proj."""
    plan, jex, _ = _jax_artifact(head_dim)
    want = j_deploy.kernel_route_check(jex, plan)
    got = kernel_route_check(_t(jex), DeployPlan(qcfg=TQ()))
    assert got["path"] == want["path"] == "layers.ssm.out_proj"
    assert got["layout"] == want["layout"]
    assert not got["kernel"]
    assert got["max_err"] <= 1e-5
    n = _t(jex)["layers"]["ssm"]["in_proj"]["q"].shape[-1]
    assert n == (320 if head_dim else 296)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_init_slot_cache_matches_jax():
    """The slot cache: the JAX package's tree (``ssm_state``,
    ``conv_state``, f32; no ``pos`` to vectorize), and no paged KV spec
    for the family."""
    want = j_deploy.init_slot_cache(J_SMOKE, 3, 40)
    got = init_slot_cache(T_SMOKE, 3, 40, device="cpu")
    assert sorted(got) == sorted(want) == ["conv_state", "ssm_state"]
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype) == f"torch.{want[k].dtype}"
    assert resolve_kv_spec(T_SMOKE, ServeConfig()) is None


def test_install_copies_the_state_rows():
    """The engine's install copies a finished batch-1 prefill's state into
    the slot's row (the whole row), other slots untouched."""
    cache = init_slot_cache(T_SMOKE, 3, 10, device="cpu")
    for v in cache.values():
        v.fill_(7.0)
    small = init_cache(T_SMOKE, 1, 10, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for v in small.values():
        v.copy_(torch.randn(v.shape, generator=gen))
    _install(cache, small, 1, 4)
    for k in cache:
        assert torch.equal(cache[k][:, 1], small[k][:, 0]), k
        assert bool((cache[k][:, [0, 2]] == 7.0).all()), k


PROMPTS = [[1, 2, 3], list(range(5, 25)), [300, 7, 42, 8, 9, 11, 500, 3, 2,
                                           1, 6], [9, 9]]
NEW = 6
SCFG = dict(max_slots=2, max_len=48, prefill_chunk=8)


def _port_engine(**kw):
    _, jex, _ = _jax_artifact()
    return Engine.from_artifact(T_SMOKE, DeployPlan(qcfg=TQ()), _t(jex),
                                ServeConfig(**{**SCFG, **kw}), device="cpu")


def _jax_margin_ok(context):
    """JAX's top-2 logit margin for the next token after ``context``
    (the deploy view's bf16 forward), within MARGIN_ULPS bf16 ulps."""
    plan, jex, _ = _jax_artifact()
    dv = j_deploy.deploy_view(jex, plan)
    logits = j_forward(dv, J_SMOKE, None,
                       {"tokens": jnp.asarray([context], jnp.int32)})
    z = np.sort(np.asarray(logits["logits"][0, -1], np.float32))[::-1]
    ulp = 2.0 ** (math.floor(math.log2(abs(z[0]))) - 7)
    return z[0] - z[1] <= MARGIN_ULPS * ulp


def test_greedy_tokens_match_jax_engine():
    """The JAX artifact, converted, served by both engines (bf16, exact-
    length chunked prefill: the 20- and 11-token prompts cross the 8-token
    chunk): every request's greedy tokens equal, or first differ where
    JAX's own top-2 margin is a near-tie."""
    plan, jex, _ = _jax_artifact()
    want = JEngine.from_artifact(J_UNSCANNED, plan, jex,
                                 JServeConfig(**SCFG)).generate(
        [JRequest(prompt=p, max_new_tokens=NEW) for p in PROMPTS])
    got = _port_engine().generate([Request(prompt=p, max_new_tokens=NEW)
                                   for p in PROMPTS])
    near = 0
    for prompt, w, g in zip(PROMPTS, want, got):
        assert len(g) == len(w) == NEW
        i = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if i is not None:
            assert _jax_margin_ok(prompt + w[:i]), (prompt, i, w, g)
            near += 1
    assert near <= 1


REQS = [Request(prompt=[1, 2, 3], max_new_tokens=5),
        Request(prompt=[7, 8], max_new_tokens=3),
        Request(prompt=list(range(1, 19)), max_new_tokens=4),
        Request(prompt=[5, 4, 3, 2, 1], max_new_tokens=6),
        Request(prompt=[9, 9], max_new_tokens=2, eos_id=0)]


def test_solo_static_interleaved_identical():
    """Within the port: a request's greedy tokens served alone, in a
    static batch and interleaved are bit-identical (the state is installed
    whole, dead slots never leak)."""
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


def test_engine_prefills_exact_length_chunks_and_sizes_like_jax():
    """ssm is outside the bucketed families: each prefill chunk is its
    exact length (no pad token ever enters the state).  Stats: 0
    decode-attention layers on either route (JAX's
    ``_attn_layer_count``), the batch-1 prefill cache sized as JAX's (no
    ``pos``), the slot cache from the state tensors."""
    eng = _port_engine()
    assert not eng._bucketed
    seen = []
    prefill = eng._prefill

    def rec(params, cache, batch):
        seen.append(batch["tokens"].shape[1])
        return prefill(params, cache, batch)
    eng._prefill = rec
    eng.generate([Request(prompt=list(range(1, 20)), max_new_tokens=2)])
    assert seen == [8, 8, 3]
    s = eng.stats()
    assert s["decode_attn_kernel_layers"] == s["decode_attn_ref_layers"] == 0
    plan, jex, _ = _jax_artifact()
    jeng = JEngine.from_artifact(J_UNSCANNED, plan, jex, JServeConfig(**SCFG))
    js = jeng.stats()
    assert js["decode_attn_pallas_layers"] == js["decode_attn_ref_layers"] \
        == 0
    assert jeng._prefill_slot_bytes == eng._prefill_slot_bytes
    state = sum(t.numel() * t.element_size() for t in eng.state.values())
    assert s["slot_cache_bytes"] == state + sum(
        t.numel() * 4 for t in eng.cache.values())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_quantize_ssm_runs_and_resumes(capsys, tmp_path):
    """``python -m repro_torch quantize --config mamba2_1_3b --device cpu``
    (SMOKE, the CLI's default) with the serve smoke: every stage, export
    parity below 1e-4; the rerun on its workdir skips calibrate, init and
    finetune and reports the same metrics."""
    from repro_torch.pipeline.cli import main
    args = ["quantize", "--config", "mamba2_1_3b", "--device", "cpu",
            "--steps", "2", "--calib-samples", "16", "--calib-seq-len", "16",
            "--calib-batch-size", "4", "--serve-smoke", "--workdir",
            str(tmp_path)]
    assert main(args) == 0
    first = capsys.readouterr().out
    assert "pipeline: mamba2-1.3b" in first
    assert "pipeline complete" in first
    parity = next(ln for ln in first.splitlines() if "export_parity" in ln)
    assert float(parity.split(":")[1]) < 1e-4
    assert "'requests': 2" in first
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
    """``plan --config mamba2_1_3b [--full]`` prints the JAX package's
    table."""
    from repro.pipeline.cli import main as j_main
    from repro_torch.pipeline.cli import main
    argv = ["plan", "--config", "mamba2_1_3b"] + extra
    assert j_main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv) == 0
    assert capsys.readouterr().out == want
    assert "layers.ssm.in_proj" in want
