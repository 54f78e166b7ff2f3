"""repro_torch's encoder-decoder family (seamless-m4t-medium's backbone)
against the JAX package, on the CPU at SMOKE size (2 encoder and 2 decoder
layers, d 64, 4/4 heads of 16, GELU MLP, vocab 512).

Parameters are initialised in JAX and converted; frames and tokens are made
with numpy.  Tolerances: the GELU MLP 1e-5 relative; the f32 model forward
in all three cache modes, the caches it writes and its encoder output
1e-4; one f32 train step's loss 1e-6 relative and each gradient leaf 1e-4
relative L2; scale leaves 1e-6; integer leaves (packed nibbles) and the
plan JSON bit for bit.

F18 (the reference's enc-dec, mirrored and pinned here): the encoder's
self-attention is causal; the forward taps nothing, so calibration writes
no stream; one ``in_stream`` quantizes both the cross attention's query
input and the encoder output; CLE never reaches ``cross``; no engine
serves the family.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import seamless_m4t_medium as j_cfgs  # noqa: E402
from repro.core import distill as j_distill  # noqa: E402
from repro.core.plan import resolve_plan as j_resolve_plan  # noqa: E402
from repro.core.qconfig import Granularity as JG  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.serve import deploy as j_deploy  # noqa: E402
from repro.train import qft_trainer as j_trainer  # noqa: E402
from repro_torch.configs import seamless_m4t_medium as t_cfgs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.plan import resolve_plan  # noqa: E402
from repro_torch.core.qconfig import Granularity as TG  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.models import forward, init_cache, init_model  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.serve.deploy import (DeployPlan, deploy_view,  # noqa: E402
                                      effective_view, export_for_layers,
                                      export_model, init_slot_cache,
                                      kernel_route_check, make_deploy_plan)
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.train import qft_trainer  # noqa: E402
from repro_torch.train.steps import make_value_and_grad  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

J_SMOKE, T_SMOKE = j_cfgs.SMOKE, t_cfgs.SMOKE
J_UNSCANNED = dataclasses.replace(J_SMOKE, scan_layers=False, remat=False)
N_FRAMES = 11


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


def _batch(B=2, S=9, seed=0, frames=N_FRAMES):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, T_SMOKE.vocab, (B, S)).astype(
                np.int32),
            "frames": rng.normal(size=(B, frames, T_SMOKE.d_model))
            .astype(np.float32)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _np_zeros(skel):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), skel)


# ---------------------------------------------------------------------------
# configs, the family gate, the GELU MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_values(which):
    """CONFIG and SMOKE field for field; the vocabulary is not padded
    (256206 at full size, whatever the JAX docstring says)."""
    j, t = getattr(j_cfgs, which), getattr(t_cfgs, which)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert get_config("seamless-m4t-medium", smoke=which == "SMOKE") == t
    assert t.family == "encdec" and t.mlp == "gelu" and not t.mrope_sections
    assert t.vocab_padded == (512 if which == "SMOKE" else 256206)


def test_the_port_admits_encdec_and_its_gelu_only():
    """``FAMILIES`` holds encdec; M-RoPE on it is refused by name, and the
    GELU MLP on any other family."""
    assert "encdec" in transformer.FAMILIES
    init_model(0, T_SMOKE, None, device="meta")
    with pytest.raises(NotImplementedError, match="family 'encdec'"):
        init_model(0, dataclasses.replace(T_SMOKE, mrope_sections=(4, 2, 2)),
                   None, device="meta")
    with pytest.raises(NotImplementedError, match="family 'dense'"):
        init_model(0, dataclasses.replace(T_SMOKE, family="dense"), None,
                   device="meta")


@pytest.mark.parametrize("qname", [None, "dchw"])
def test_gelu_mlp_matches_jax(qname):
    """The GELU MLP (``up``, ``down``, no ``gate``), teacher and W4A8
    student, f32: 1e-5 of JAX's.  Its GELU is the tanh form
    (``jax.nn.gelu``'s default); the exact erf form is off by up to 4e-4
    on [-4, 4], which the test tells apart."""
    jq, tq = _qcfgs(qname)
    jp = j_layers.init_mlp(jax.random.PRNGKey(0), 64, 128, jq, "gelu",
                           bias=False)
    tp = _t(jp)
    assert sorted(tp) == sorted(jp) and "gate" not in tp
    one = layers.init_mlp(torch.Generator().manual_seed(0), 64, 128, tq,
                          bias=False, mlp_type="gelu")
    assert list(one) == list(jp)
    x = np.random.default_rng(1).normal(size=(2, 5, 64)).astype(np.float32)
    want = j_layers.mlp(jnp.asarray(x), jp, jq, "gelu")
    with torch.no_grad():
        got = layers.mlp(torch.from_numpy(x), tp, tq, mlp_type="gelu")
    _rel(got.numpy(), np.asarray(want), 1e-5)
    u = torch.linspace(-4, 4, 8001)
    gap = (torch.nn.functional.gelu(u, approximate="tanh")
           - torch.nn.functional.gelu(u)).abs().max()
    assert 3e-4 < float(gap) < 5e-4
    np.testing.assert_allclose(
        torch.nn.functional.gelu(u, approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(u.numpy()))), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# init and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("student", [False, True])
def test_init_model_keys_and_shapes(student):
    """init_model: the JAX package's top-level keys, sorted as its
    ``jax.eval_shape`` tree returns them (F23), each stacked subtree's keys
    sorted, and every shape (``enc_layers`` ``[2, ...]``, ``dec_layers``
    with ``norm_x`` and ``cross``)."""
    jq, tq = _qcfgs("dchw" if student else None)
    jskel = jax.eval_shape(lambda k: j_init_model(k, J_SMOKE, jq),
                           jax.random.PRNGKey(0))
    tp = init_model(0, T_SMOKE, tq, device="cpu")
    want_top = ["final_norm", "lm_head"] + (["head_stream"] if student
                                            else []) + [
        "embed", "frame_proj", "enc_layers", "dec_layers", "enc_final_norm"]
    assert list(tp) == sorted(want_top) == list(jskel)
    assert sorted((p, tuple(v.shape)) for p, v in tree_items(tp)) == sorted(
        (p, tuple(s.shape)) for p, s in tree_items(_np_zeros(jskel)))
    assert list(tp["dec_layers"]) == ["attn", "cross", "mlp", "norm1",
                                      "norm2", "norm_x"]
    assert list(tp["enc_layers"]) == ["attn", "mlp", "norm1", "norm2"]
    assert "gate" not in tp["dec_layers"]["mlp"]


@pytest.mark.parametrize("enc_len", [None, 6])
def test_init_cache_matches_jax(enc_len):
    """``{"self": {k, v [L, B, T, Hkv, hd], pos}, "cross": None}``, or with
    ``enc_len`` the cross slots ``k, v [L, B, enc_len, Hkv, hd]``
    prebuilt; the slot cache vectorizes the nested ``self.pos``."""
    want = j_init_cache(J_SMOKE, 3, 16, enc_len=enc_len)
    got = init_cache(T_SMOKE, 3, 16, device="cpu", enc_len=enc_len)
    assert list(got) == ["self", "cross"]
    assert sorted(got["self"]) == sorted(want["self"]) == ["k", "pos", "v"]
    for k in ("k", "v"):
        assert tuple(got["self"][k].shape) == want["self"][k].shape
    assert got["self"]["pos"] == 0
    if enc_len is None:
        assert got["cross"] is None and want["cross"] is None
    else:
        for k in ("k", "v"):
            assert tuple(got["cross"][k].shape) == want["cross"][k].shape \
                == (2, 3, 6, 4, 16)
            assert got["cross"][k].dtype == torch.bfloat16
    jslot = j_deploy.init_slot_cache(J_SMOKE, 3, 16)
    slot = init_slot_cache(T_SMOKE, 3, 16, device="cpu")
    assert tuple(slot["self"]["pos"].shape) == jslot["self"]["pos"].shape \
        == (3,)
    assert slot["cross"] is None and jslot["cross"] is None


# ---------------------------------------------------------------------------
# the forward in its three modes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params(qname, seed=1):
    jq, _ = _qcfgs(qname)
    return j_init_model(jax.random.PRNGKey(seed), J_SMOKE, jq)


@pytest.mark.parametrize("qname", [None, "dchw"])
def test_forward_three_modes_matches_jax(qname):
    """The SMOKE model in f32, teacher and plan-aware W4A8 student, in all
    three modes: cache-free over 11 frames and 9 tokens (logits, hidden
    states and ``enc_out`` 1e-4 of JAX's); a prefill of the 9 tokens into
    a cache whose ``cross`` is None (the encoder runs and its cross K/V
    ``[L, B, 11, Hkv, hd]`` are written into the cache, self K/V and pos
    advanced); then a decode step with no frames at all, reading them
    (``enc_out`` None).  The forward taps nothing (F18)."""
    jq, tq = _qcfgs(qname)
    jp = _params(qname)
    tp = _t(jp)
    jplan = tplan = None
    if qname:
        jplan = j_resolve_plan(jq, jp, model_cfg=J_SMOKE)
        tplan = resolve_plan(tq, tp, model_cfg=T_SMOKE)
    b = _batch()
    kw_j = dict(compute_dtype=jnp.float32, plan=jplan)
    kw_t = dict(compute_dtype=torch.float32, plan=tplan)
    jo = j_forward(jp, J_SMOKE, jq, _jb(b), collect_taps=True, **kw_j)
    with torch.no_grad():
        to = forward(tp, T_SMOKE, tq, _tb(b), collect_taps=True, **kw_t)
    for key in ("logits", "hidden", "enc_out"):
        _rel(to[key].numpy(), np.asarray(jo[key]), 1e-4, key)
        assert float(to[key].abs().max()) > 0, key
    assert to["taps"] == jo["taps"] == {}

    jc = j_init_cache(J_SMOKE, 2, 16, jnp.float32)
    tc = init_cache(T_SMOKE, 2, 16, torch.float32, device="cpu")
    jo = j_forward(jp, J_SMOKE, jq, _jb(b), jc, **kw_j)
    with torch.no_grad():
        to = forward(tp, T_SMOKE, tq, _tb(b), tc, **kw_t)
    assert to["cache"] is tc and tc["self"]["pos"] == 9
    _rel(to["logits"].numpy(), np.asarray(jo["logits"]), 1e-4, "prefill")
    for part in ("self", "cross"):
        for k in ("k", "v"):
            _rel(tc[part][k].numpy(), np.asarray(jo["cache"][part][k]), 1e-4,
                 f"{part}.{k}")
    assert tuple(tc["cross"]["k"].shape) == (2, 2, N_FRAMES, 4, 16)

    nxt = {"tokens": b["tokens"][:, -1:]}
    jo = j_forward(jp, J_SMOKE, jq, _jb(nxt), jo["cache"], **kw_j)
    cross_before = tc["cross"]["k"].clone()
    with torch.no_grad():
        to = forward(tp, T_SMOKE, tq, _tb(nxt), tc, **kw_t)
    assert to["enc_out"] is None and jo["enc_out"] is None
    assert tc["self"]["pos"] == 10
    assert torch.equal(tc["cross"]["k"], cross_before)
    _rel(to["logits"].numpy(), np.asarray(jo["logits"]), 1e-4, "decode")
    _rel(tc["self"]["k"].numpy(), np.asarray(jo["cache"]["self"]["k"]), 1e-4)


@pytest.mark.parametrize("split", [(9,), (4, 5), (1, 8)])
def test_prefill_then_decode_matches_one_full_forward(split):
    """Prefilling 9 tokens (the encoder runs with the first piece, later
    pieces read the cached cross K/V) and decoding 5 more one at a time
    gives every position's logits of one cache-free forward over the 14
    tokens (f32, 1e-4 of max|logit|)."""
    tp = _t(_params(None, 4))
    b = _batch(2, 14, 2)
    with torch.no_grad():
        full = forward(tp, T_SMOKE, None, _tb(b),
                       compute_dtype=torch.float32)["logits"]
        cache = init_cache(T_SMOKE, 2, 16, torch.float32, device="cpu")
        rows, off = [], 0
        for n in split + (1,) * 5:
            piece = {"tokens": b["tokens"][:, off:off + n]}
            if off == 0:
                piece["frames"] = b["frames"]
            rows.append(forward(tp, T_SMOKE, None, _tb(piece), cache,
                                compute_dtype=torch.float32)["logits"])
            off += n
    _rel(torch.cat(rows, 1).numpy(), full.numpy(), 1e-4)


# ---------------------------------------------------------------------------
# plan, calibration, init, CLE, a train step
# ---------------------------------------------------------------------------

PLAN_OVERRIDES = dict(bits_overrides=(("dec_layers.cross.w[qk]", 8),
                                      ("frame_proj", 8)),
                      exempt_frac=0.0)


@pytest.mark.parametrize("overrides", [False, True])
@pytest.mark.parametrize("which", ["SMOKE", "CONFIG"])
def test_resolved_plan_json_matches_jax(which, overrides):
    """The plan byte for byte, with no ``kv_cache`` entry (encdec serves no
    paged KV), and with tests/test_plan_threading.py's encdec overrides
    (``dec_layers.cross.w[qk]`` and ``frame_proj`` at 8 bits)."""
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
    assert plan.spec("dec_layers.cross.wk").stream == "in_stream"
    if overrides:
        assert plan.bits_for("dec_layers.cross.wq") == 8
        assert plan.bits_for("dec_layers.cross.wv") == 4
        assert plan.bits_for("frame_proj") == 8


def test_calibration_writes_nothing():
    """F18: the forward taps nothing, so calibration leaves every stream
    as it was, in both packages, though the teacher ran."""
    jq, tq = _qcfgs("dchw")
    teacher = _params(None, 2)
    student = _params("dchw", 3)
    batches = [_batch(2, 8, s) for s in (7, 8)]
    jcal = j_trainer.calibrate_student(student, J_SMOKE, jq, teacher,
                                       [_jb(b) for b in batches])
    ts = _t(student)
    got = qft_trainer.calibrate_student(ts, T_SMOKE, tq, _t(teacher),
                                        [_tb(b) for b in batches])
    _leaves_close(got, ts, rtol=0)
    _leaves_close(_t(jcal), ts, rtol=0)


@pytest.mark.parametrize("qname", ["dchw", "chw"])
def test_init_scales_matches_jax(qname):
    """MMSE (CHW) / APQ (DCHW) scale init over the stacked ``enc_layers``
    and ``dec_layers`` (cross included) and the top-level ``frame_proj``:
    every leaf 1e-6 of JAX's."""
    jq, tq = _qcfgs(qname)
    student = _params(qname, 3)
    jplan = j_resolve_plan(jq, student, model_cfg=J_SMOKE)
    want = _t(j_trainer.init_scales(student, J_SMOKE, jq, plan=jplan))
    ts = _t(student)
    got = qft_trainer.init_scales(ts, T_SMOKE, tq,
                                  plan=resolve_plan(tq, ts,
                                                    model_cfg=T_SMOKE))
    _leaves_close(got, want, rtol=1e-6, atol=1e-6)
    for top in ("enc_layers", "dec_layers"):
        assert not torch.equal(got[top]["attn"]["wq"]["log_swr"],
                               ts[top]["attn"]["wq"]["log_swr"]), top
    assert not torch.equal(got["frame_proj"]["log_swr"],
                           ts["frame_proj"]["log_swr"])


def test_cle_init_matches_jax_and_skips_cross():
    """The 4b-adapted CLE skews the attention and MLP ``in_stream`` of
    every encoder and decoder layer: 1e-6 of JAX's; the cross block's
    stream keeps its init (F18)."""
    jq, tq = _qcfgs("chw")
    jp = _params("chw", 5)
    want = _t(j_trainer.init_scales(jp, J_SMOKE, jq, cle_init=True))
    plain = qft_trainer.init_scales(_t(jp), T_SMOKE, tq)
    got = qft_trainer.init_scales(_t(jp), T_SMOKE, tq, cle_init=True)
    _leaves_close(got, want, rtol=1e-6, atol=1e-6)
    for top in ("enc_layers", "dec_layers"):
        assert not torch.equal(got[top]["mlp"]["in_stream"]["log_sa"],
                               plain[top]["mlp"]["in_stream"]["log_sa"]), top
    assert torch.equal(got["dec_layers"]["cross"]["in_stream"]["log_sa"],
                       plain["dec_layers"]["cross"]["in_stream"]["log_sa"])


def _jax_grads(student, teacher, jq, jplan, b):
    to = j_forward(teacher, J_SMOKE, None, b, compute_dtype=jnp.float32)

    def loss(s):
        so = j_forward(s, J_SMOKE, jq, b, compute_dtype=jnp.float32,
                       plan=jplan)
        return j_distill.qft_loss(so["hidden"], to["hidden"], so["logits"],
                                  to["logits"])
    return jax.value_and_grad(loss)(student)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_f32_matches_jax(microbatches):
    """One W4A8 student step's loss and gradients in f32 (backbone L2 on
    the decoder's hidden states): the loss 1e-6 relative, each leaf 1e-4
    relative L2 — the encoder's, the cross block's (its one in_stream
    carries both the query's and the encoder output's gradient) and
    frame_proj's.  In 2 microbatches ``frames`` and tokens are both cut on
    axis 0: the port's accumulation equals the mean of JAX's two
    half-batch steps."""
    jq, tq = JQ(), TQ()
    teacher = _params(None, 0)
    student = _params("dchw", 1)
    jplan = j_resolve_plan(jq, student, model_cfg=J_SMOKE)
    b = _batch(4, 8, 3)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in b.items()}
              for i in range(2)] if microbatches == 2 else [b]
    parts = [_jax_grads(student, teacher, jq, jplan, _jb(h)) for h in halves]
    jloss = sum(float(p[0]) for p in parts) / len(parts)
    jgrads = jax.tree.map(lambda *g: sum(g) / len(g), *[p[1] for p in parts])
    ts = _t(student)
    vg = make_value_and_grad(T_SMOKE, tq, microbatches=microbatches,
                             plan=resolve_plan(tq, ts, model_cfg=T_SMOKE),
                             compute_dtype=torch.float32)
    tloss, grads = vg(ts, _t(teacher), _tb(b))
    assert abs(float(tloss) - jloss) <= 1e-6 * abs(jloss)
    jg = dict(tree_items(_t(jgrads)))
    gnorm = math.sqrt(sum(float((g.double() ** 2).sum())
                          for g in jg.values()))
    for path, g in tree_items(grads):
        ref = jg[path].double()
        if g is None:       # the head: the backbone loss never reads it
            assert path[0] in ("lm_head", "head_stream"), path
            assert float(ref.abs().max()) == 0.0, path
            continue
        err = float((g.double() - ref).norm())
        assert err <= 1e-4 * (float(ref.norm()) + 1e-3 * gnorm), (path, err)
    for leaf in (grads["frame_proj"]["w"],
                 grads["enc_layers"]["attn"]["wq"]["w"],
                 grads["dec_layers"]["cross"]["wk"]["w"],
                 grads["dec_layers"]["cross"]["in_stream"]["log_sa"]):
        assert float(leaf.abs().max()) > 0


def test_train_forward_matches_effective_view():
    """tests/test_plan_threading.py's train≡export invariant in the port:
    the plan-aware student forward equals the FP forward over its
    ``effective_view`` (CHW, cross wq/wk and frame_proj at 8 bits), and
    differs from the role-ladder forward."""
    tq = TQ(w_bits=4, a_bits=None, granularity=TG.CHW, **PLAN_OVERRIDES)
    student = init_model(0, T_SMOKE, tq, device="cpu")
    qplan = resolve_plan(tq, student, model_cfg=T_SMOKE)
    student = qft_trainer.init_scales(student, T_SMOKE, tq, plan=qplan)
    b = _tb(_batch(2, 8, 1, frames=4))
    dplan = make_deploy_plan(tq, family="encdec", quant_plan=qplan)
    with torch.no_grad():
        out = forward(student, T_SMOKE, tq, b, plan=qplan)
        eff = forward(effective_view(student, dplan, dtype=torch.float32),
                      T_SMOKE, None, b)
        ladder = forward(student, T_SMOKE, tq, b)
    assert torch.equal(out["logits"], eff["logits"])
    assert torch.equal(out["hidden"], eff["hidden"])
    assert not torch.equal(out["logits"], ladder["logits"])


# ---------------------------------------------------------------------------
# export, deploy view, route check, the engine's refusal
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_artifact():
    """The JAX export of a SMOKE student whose keys are sorted, as the
    converted tree's are, so both plans list the tensors in one order."""
    jq = JQ()
    params = jax.device_get(j_init_model(jax.random.PRNGKey(0), J_SMOKE, jq))
    plan = j_deploy.make_deploy_plan(jq, params=params, model_cfg=J_SMOKE)
    return plan, jax.jit(lambda p: j_deploy.export_for_layers(p, plan))(
        params), params


def test_export_model_and_deploy_view_match_jax():
    """export_for_layers over the stacked ``enc_layers``/``dec_layers``
    (the cross block's ``s_wl`` from its in_stream) and export_model equal
    the JAX artifact (integer leaves bit for bit, scales 1e-6); the deploy
    view equals JAX's (1e-6); a forward over it runs."""
    plan, jex, student = _jax_artifact()
    want = _t(jex)
    ts = _t(student)
    tplan = make_deploy_plan(TQ(), params=ts, model_cfg=T_SMOKE)
    got = export_for_layers(ts, tplan, device="cpu")
    one_walk = dict(tree_items(export_model(ts, tplan, device="cpu")))
    assert ("dec_layers", "cross", "wk", "s_wl") in dict(tree_items(want))
    assert got["dec_layers"]["cross"]["wk"]["q"].shape[0] == 2
    _leaves_close(got, want, rtol=1e-6)
    for path, leaf in tree_items(got):
        assert torch.equal(leaf, one_walk[path]), path
    dv = deploy_view(got, tplan, dtype=torch.float32)
    jdv = _t(j_deploy.deploy_view(jex, plan, dtype=jnp.float32))
    _leaves_close(dv, jdv, rtol=1e-6, atol=1e-9)
    with torch.no_grad():
        out = forward(dv, T_SMOKE, None, _tb(_batch()))
    assert bool(torch.isfinite(out["logits"]).all())


def test_kernel_route_check_picks_the_jax_path():
    """kernel_route_check probes the linear the JAX package's does (the
    8-bit lm_head is not packed; at full size its N 256206 would tile
    neither) and on the CPU launches nothing."""
    plan, jex, _ = _jax_artifact()
    want = j_deploy.kernel_route_check(jex, plan)
    got = kernel_route_check(_t(jex), DeployPlan(qcfg=TQ()))
    assert got["path"] == want["path"]
    assert got["path"].startswith("dec_layers.")
    assert got["layout"] == want["layout"]
    assert not got["kernel"]
    assert got["max_err"] <= 1e-5


def test_engine_refuses_encdec_by_name():
    """No engine serves the family: the JAX package has no enc-dec serving
    path (its engine fails on the missing frames); the port refuses by
    name before building anything."""
    _, jex, _ = _jax_artifact()
    with pytest.raises(NotImplementedError, match="family 'encdec'"):
        Engine.from_artifact(T_SMOKE, DeployPlan(qcfg=TQ()), _t(jex),
                             ServeConfig(max_slots=2, max_len=32),
                             device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli_args(tmp_path, *extra):
    return ["quantize", "--config", "seamless_m4t_medium", "--device", "cpu",
            "--steps", "2", "--calib-samples", "16", "--calib-seq-len", "16",
            "--calib-batch-size", "4", "--workdir", str(tmp_path), *extra]


def test_cli_quantize_encdec_runs_and_resumes(capsys, tmp_path):
    """``python -m repro_torch quantize --config seamless_m4t_medium
    --device cpu`` (SMOKE): every stage over batches with 8 frames, export
    parity below 1e-4; the rerun on its workdir skips calibrate, init and
    finetune and reports the same metrics."""
    from repro_torch.pipeline.cli import main
    args = _cli_args(tmp_path)
    assert main(args) == 0
    first = capsys.readouterr().out
    assert "pipeline: seamless-m4t-medium" in first
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


def test_cli_serve_smoke_is_refused(capsys, tmp_path):
    """With ``--serve-smoke`` the pipeline stops at evaluate with the
    engine's refusal and exits non-zero, as the JAX package does (there
    with a KeyError on the missing frames)."""
    from repro_torch.pipeline.cli import main
    assert main(_cli_args(tmp_path, "--serve-smoke")) == 1
    out = capsys.readouterr()
    assert "pipeline complete" not in out.out
    assert "family 'encdec'" in out.err


def test_augment_matches_the_jax_layout():
    """The adapter's stub frames have the JAX package's shape and dtype
    (``[B, 8, d]`` bf16; the draws differ) and are the same for every
    batch."""
    from repro.pipeline.adapters import get_adapter as j_get_adapter
    from repro.pipeline.config import PipelineConfig as JPC
    from repro_torch.pipeline.adapters import get_adapter
    from repro_torch.pipeline.config import PipelineConfig
    kw = dict(arch="seamless-m4t-medium", calib_samples=8, calib_seq_len=16,
              calib_batch_size=4)
    jb = j_get_adapter(JPC(**kw)).calib_batches()[0]
    tb = get_adapter(PipelineConfig(device="cpu", **kw)).calib_batches()
    assert sorted(jb) == sorted(tb[0]) == ["frames", "tokens"]
    for k in jb:
        assert tuple(tb[0][k].shape) == jb[k].shape, k
        assert str(tb[0][k].dtype) == f"torch.{jb[k].dtype}", k
    assert torch.equal(tb[0]["frames"], tb[1]["frames"])
