"""repro_torch's VLM family (qwen2-vl-7b's backbone) against the JAX package,
on the CPU at SMOKE size (2 layers, d 64, 4/2 heads of 16, M-RoPE sections
4/2/2, biased q/k/v, vocab 512).

Parameters are initialised in JAX and converted; activations, patch
embeddings, positions and tokens are made with numpy.  Tolerances: M-RoPE
and the f32 attention 1e-5 relative; the f32 model forward and its taps
1e-4; one f32 train step's loss 1e-6 relative and each gradient leaf 1e-4
relative L2; scale leaves 1e-6; integer leaves (packed nibbles) and the
plan JSON bit for bit.  The engines serve in bf16: greedy tokens are held
to the JAX package's, a request that differs only at a step where JAX's
own top-2 margin is within a few bf16 ulps (as tests/test_torch_serve.py
holds the dense engine).
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import qwen2_vl_7b as j_cfgs  # noqa: E402
from repro.core import distill as j_distill  # noqa: E402
from repro.core.plan import resolve_plan as j_resolve_plan  # noqa: E402
from repro.core.qconfig import Granularity as JG  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.serve import deploy as j_deploy  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.train import qft_trainer as j_trainer  # noqa: E402
from repro_torch.configs import qwen2_vl_7b as t_cfgs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.plan import resolve_plan  # noqa: E402
from repro_torch.core.qconfig import Granularity as TG  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.kernels.decode_attention import kernel_takes  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import forward, init_model, layers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.deploy import (DeployPlan, deploy_view,  # noqa: E402
                                      effective_view, export_for_layers,
                                      export_model, kernel_route_check,
                                      make_deploy_plan)
from repro_torch.serve.engine import (Engine, Request,  # noqa: E402
                                      ServeConfig, _attn_layer_count)
from repro_torch.train import qft_trainer  # noqa: E402
from repro_torch.train.steps import make_value_and_grad  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

J_SMOKE, T_SMOKE = j_cfgs.SMOKE, t_cfgs.SMOKE
J_UNSCANNED = dataclasses.replace(J_SMOKE, scan_layers=False, remat=False)
MARGIN_ULPS = 4
N_IMG = 4


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


def _grid_positions(B, S, seed):
    """``[B, 3, N_IMG + S]`` positions with three different streams: the
    patches on a 2 x 2 grid (t 0, h the row, w the column), the text
    after them at max + 1 + i on all three, shifted per row."""
    rng = np.random.default_rng(seed)
    side = int(math.isqrt(N_IMG))
    img = np.stack([np.zeros(N_IMG), np.arange(N_IMG) // side,
                    np.arange(N_IMG) % side])
    txt = np.broadcast_to(img.max() + 1 + np.arange(S), (3, S))
    pos = np.concatenate([img, txt], 1)[None] + rng.integers(0, 5, (B, 1, 1))
    return pos.astype(np.int32)


def _batch(B=2, S=9, seed=0):
    """numpy tokens, patch embeddings and grid positions."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, T_SMOKE.vocab, (B, S)).astype(
                np.int32),
            "patch_embeds": rng.normal(size=(B, N_IMG, T_SMOKE.d_model))
            .astype(np.float32),
            "positions": _grid_positions(B, S, seed)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# ---------------------------------------------------------------------------
# configs and the family gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_values(which):
    """CONFIG and SMOKE field for field (SMOKE's reset padded fields
    re-derived at its size), and the registry serves them."""
    j, t = getattr(j_cfgs, which), getattr(t_cfgs, which)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert get_config("qwen2-vl-7b", smoke=which == "SMOKE") == t
    assert t.family == "vlm" and t.bias and t.mrope_sections
    assert t.vocab_padded == (512 if which == "SMOKE" else 152064)


def test_the_port_admits_vlm_and_refuses_mrope_elsewhere():
    """``FAMILIES`` holds vlm; M-RoPE is refused by name on any other
    family, and so is the GELU MLP outside the encoder-decoder."""
    assert "vlm" in transformer.FAMILIES
    init_model(0, T_SMOKE, None, device="meta")
    with pytest.raises(NotImplementedError, match="family 'dense'"):
        init_model(0, dataclasses.replace(T_SMOKE, family="dense"), None,
                   device="meta")
    with pytest.raises(NotImplementedError, match="family 'vlm'"):
        init_model(0, dataclasses.replace(T_SMOKE, mlp="gelu"), None,
                   device="meta")


def test_decode_route_and_layer_count_at_full_size():
    """qwen2-vl-7b serves all 28 layers through the decode kernel at a GQA
    group of 7 (28 / 4 heads, hd 128), as the JAX package counts them."""
    from repro.serve.engine import _attn_layer_count as j_count
    cfg = t_cfgs.CONFIG
    G = cfg.n_heads_padded // cfg.n_kv_heads_padded
    assert G == 7 and kernel_takes(G, cfg.head_dim)
    assert t_attn.decode_route(cfg, 2048, True)
    assert _attn_layer_count(cfg) == j_count(j_cfgs.CONFIG) == 28


# ---------------------------------------------------------------------------
# M-RoPE and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("distinct", [True, False])
def test_apply_mrope_matches_jax(distinct):
    """apply_mrope at hd 128 with the 16/24/24 sections, f32 and bf16: 1e-5
    relative to JAX's (f32; bf16 to one rounding); distinct streams rotate
    each band by its own stream, equal streams give apply_rope exactly."""
    rng = np.random.default_rng(1)
    B, S, H, hd = 2, 11, 3, 128
    x = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    pos = rng.integers(0, 4000, (B, 3, S)).astype(np.int32)
    if not distinct:
        pos[:, 1:] = pos[:, :1]
    secs = t_cfgs.CONFIG.mrope_sections
    want = np.asarray(j_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                           1e6, secs))
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                             secs)
    _rel(got.numpy(), want, 1e-5)
    bf = layers.apply_mrope(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(pos), 1e6, secs)
    _rel(bf.float().numpy(), want, 1e-2)
    rope = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[:, 0]),
                             1e6)
    assert torch.equal(got, rope) != distinct
    with pytest.raises(ValueError, match="sum to"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                           (16, 24, 23))


@pytest.mark.parametrize("mode", ["none", "decode"])
@pytest.mark.parametrize("qname", [None, "dchw"])
def test_attention_with_biases_matches_jax(qname, mode):
    """GQA attention with biased wq/wk/wv and M-RoPE, teacher and W4A8
    student, f32: cache-free (causal) and a per-slot decode step over a
    monolithic cache holding earlier rows; 1e-5 relative, the cache row
    written in place equal to JAX's new cache."""
    jq, tq = _qcfgs(qname)
    jp = j_attn.init_attention(jax.random.PRNGKey(3), J_SMOKE, jq)
    rng = np.random.default_rng(4)
    jp = {**jp, **{k: {**jp[k], "b": jnp.asarray(
        rng.normal(size=jp[k]["b"].shape) * 0.5, jnp.float32)}
        for k in ("wq", "wk", "wv")}}
    tp = _t(jp)
    assert all("b" in tp[k] for k in ("wq", "wk", "wv"))
    B, d = 2, T_SMOKE.d_model
    S = 7 if mode == "none" else 1
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    if mode == "none":
        pos = _grid_positions(B, S - N_IMG, 5)
        jc = tc = None
    else:
        lens = np.array([3, 6], np.int32)
        pos = np.stack([lens, lens + 2, lens + 1], 1)[:, :, None]
        shape = (B, 8, T_SMOKE.n_kv_heads, T_SMOKE.head_dim)
        k0 = rng.normal(size=shape).astype(np.float32)
        v0 = rng.normal(size=shape).astype(np.float32)
        jc = {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
              "pos": jnp.asarray(lens)}
        tc = {"k": torch.from_numpy(k0.copy()),
              "v": torch.from_numpy(v0.copy()), "pos": torch.from_numpy(lens)}
    jout, jnew = j_attn.attention(jnp.asarray(x), jp, J_SMOKE, jq,
                                  jnp.asarray(pos), jc)
    with torch.no_grad():
        tout = t_attn.attention(torch.from_numpy(x), tp, T_SMOKE, tq,
                                torch.from_numpy(pos), tc)
    _rel(tout.numpy(), np.asarray(jout), 1e-5)
    if tc is not None:
        for k in ("k", "v"):
            _rel(tc[k].numpy(), np.asarray(jnew[k]), 1e-5, k)


# ---------------------------------------------------------------------------
# the model: forward, taps, plan, calibration, init, a train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("student", [False, True])
def test_forward_with_patch_embeds_and_taps_matches_jax(student):
    """The whole SMOKE model, f32, with 4 patch embeddings before 9 tokens
    and three distinct position streams: logits and hidden states
    ``[B, 13, ...]`` within 1e-4 of JAX's, teacher and plan-aware W4A8
    student; the calibration taps named and valued as the JAX package's
    unrolled forward records them."""
    jq, tq = _qcfgs("dchw" if student else None)
    jp = j_init_model(jax.random.PRNGKey(1), J_SMOKE, jq)
    tp = _t(jp)
    jplan = tplan = None
    if student:
        jplan = j_resolve_plan(jq, jp, model_cfg=J_SMOKE)
        tplan = resolve_plan(tq, tp, model_cfg=T_SMOKE)
    b = _batch()
    jo = j_forward(jp, J_UNSCANNED, jq, _jb(b), compute_dtype=jnp.float32,
                   plan=jplan, collect_taps=True)
    with torch.no_grad():
        to = forward(tp, T_SMOKE, tq, _tb(b), compute_dtype=torch.float32,
                     plan=tplan, collect_taps=True)
    assert tuple(to["logits"].shape) == (2, N_IMG + 9, T_SMOKE.vocab)
    for key in ("logits", "hidden"):
        _rel(to[key].numpy(), np.asarray(jo[key]), 1e-4, key)
        assert float(to[key].abs().max()) > 0, key
    assert sorted(to["taps"]) == sorted(jo["taps"])
    assert "L1.mlp.act" in to["taps"]
    for name, st in to["taps"].items():
        for k, v in st.items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jo["taps"][name][k]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name}.{k}")


def test_positions_from_the_cache_are_equal_streams():
    """Without ``positions`` the forward counts them from the cache's
    ``pos`` (a scalar at prefill, one per slot at decode), the three
    streams equal: equal to JAX's on a prefill then a per-slot decode."""
    from repro.models import init_cache as j_init_cache
    from repro_torch.models import init_cache
    jp = j_init_model(jax.random.PRNGKey(2), J_SMOKE, None)
    tp = _t(jp)
    toks = np.random.default_rng(3).integers(0, 512, (2, 6)).astype(np.int32)
    jc = j_init_cache(J_SMOKE, 2, 16, jnp.float32)
    tc = init_cache(T_SMOKE, 2, 16, torch.float32, device="cpu")
    jo = j_forward(jp, J_SMOKE, None, {"tokens": jnp.asarray(toks)}, jc,
                   compute_dtype=jnp.float32)
    with torch.no_grad():
        to = forward(tp, T_SMOKE, None, {"tokens": torch.from_numpy(toks)},
                     tc, compute_dtype=torch.float32)
    _rel(to["logits"].numpy(), np.asarray(jo["logits"]), 1e-4, "prefill")
    jc = {**jo["cache"], "pos": jnp.asarray([6, 6], jnp.int32)}
    tc["pos"] = torch.tensor([6, 6], dtype=torch.int32)
    nxt = toks[:, -1:]
    jo = j_forward(jp, J_SMOKE, None, {"tokens": jnp.asarray(nxt)}, jc,
                   compute_dtype=jnp.float32)
    with torch.no_grad():
        to = forward(tp, T_SMOKE, None, {"tokens": torch.from_numpy(nxt)},
                     tc, compute_dtype=torch.float32)
    _rel(to["logits"].numpy(), np.asarray(jo["logits"]), 1e-4, "decode")
    assert tc["pos"].tolist() == [7, 7]


PLAN_OVERRIDES = dict(bits_overrides=(("layers.mlp.down", 8),),
                      exempt_frac=0.2)


@pytest.mark.parametrize("overrides", [False, True])
@pytest.mark.parametrize("which", ["SMOKE", "CONFIG"])
def test_resolved_plan_json_matches_jax(which, overrides):
    """The plan byte for byte (the port's skeleton built on the meta
    device), with a ``kv_cache`` entry (vlm serves the paged int8 KV), and
    with tests/test_plan_threading.py's vlm overrides (``layers.mlp.down``
    at 8 bits, exempt_frac 0.2)."""
    from repro_torch.pipeline.adapters import resolve_quant_plan
    jc, tc = getattr(j_cfgs, which), getattr(t_cfgs, which)
    kw = PLAN_OVERRIDES if overrides else {}
    jq, tq = JQ(**kw), TQ(**kw)
    jskel = jax.eval_shape(lambda k: j_init_model(k, jc, jq),
                           jax.random.PRNGKey(0))
    plan = resolve_quant_plan(tc, tq)
    assert plan.to_json() == j_resolve_plan(jq, jskel,
                                            model_cfg=jc).to_json()
    assert any("kv_cache" in p for p in dict(plan))
    if overrides:
        assert plan.bits_for("layers.mlp.down") == 8


def _calib_batches(seed=7, n=2):
    return [_batch(2, 12, seed + i) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _calibrated(qname):
    jq, _ = _qcfgs(qname)
    teacher = j_init_model(jax.random.PRNGKey(2), J_SMOKE, None)
    student = j_init_model(jax.random.PRNGKey(3), J_SMOKE, jq)
    jcal = j_trainer.calibrate_student(student, J_SMOKE, jq, teacher,
                                       [_jb(b) for b in _calib_batches()])
    return teacher, student, jcal


@pytest.mark.parametrize("qname", ["dchw", "chw"])
def test_calibrate_matches_jax(qname):
    """Calibration over batches with patch embeddings writes each layer's
    four streams from the teacher's bf16 taps: ``log_sa`` within one bf16
    ulp of the range, the zero-point within 1 (as the dense calibration
    is held); every other leaf as it was."""
    jq, tq = _qcfgs(qname)
    teacher, student, jcal = _calibrated(qname)
    ts = _t(student)
    got = qft_trainer.calibrate_student(ts, T_SMOKE, tq, _t(teacher),
                                        [_tb(b) for b in _calib_batches()])
    want = dict(tree_items(_t(jcal)))
    moved = 0
    for path, leaf in tree_items(got):
        if path[0] == "layers" and path[-1] in ("log_sa", "zp"):
            moved += not torch.equal(leaf, dict(tree_items(ts))[path])
            atol = 1.0 if path[-1] == "zp" else math.log1p(2.0 ** -7)
            np.testing.assert_allclose(leaf.numpy(), want[path].numpy(),
                                       rtol=0, atol=atol, err_msg=str(path))
        else:
            assert torch.equal(leaf, want[path]), path
    assert moved >= 4


@pytest.mark.parametrize("qname", ["dchw", "chw"])
def test_init_scales_matches_jax(qname):
    """MMSE (CHW) / APQ (DCHW) scale init on the JAX package's calibrated
    student, the biased q/k/v included: every leaf 1e-6 of JAX's."""
    jq, tq = _qcfgs(qname)
    _, student, jcal = _calibrated(qname)
    jplan = j_resolve_plan(jq, student, model_cfg=J_SMOKE)
    want = _t(j_trainer.init_scales(jcal, J_SMOKE, jq, plan=jplan))
    tcal = _t(jcal)
    got = qft_trainer.init_scales(tcal, T_SMOKE, tq,
                                  plan=resolve_plan(tq, tcal,
                                                    model_cfg=T_SMOKE))
    _leaves_close(got, want, rtol=1e-6, atol=1e-6)


def test_cle_init_matches_jax():
    """The 4b-adapted CLE skews each layer's attention and MLP
    ``in_stream``: 1e-6 of the JAX package's."""
    jq, tq = _qcfgs("chw")
    jp = j_init_model(jax.random.PRNGKey(5), J_SMOKE, jq)
    want = _t(j_trainer.init_scales(jp, J_SMOKE, jq, cle_init=True))
    got = qft_trainer.init_scales(_t(jp), T_SMOKE, tq, cle_init=True)
    _leaves_close(got, want, rtol=1e-6, atol=1e-6)


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
    """One W4A8 student step's loss and gradients in f32 (backbone L2) over
    a batch with patch embeddings and distinct M-RoPE streams: the loss
    1e-6 relative, each leaf 1e-4 relative L2 (the biases included).  In 2
    microbatches every batch leaf — tokens, ``patch_embeds``,
    ``positions [B, 3, S]`` — is cut on axis 0: the port's accumulation
    equals the mean of JAX's two half-batch steps."""
    jq, tq = JQ(), TQ()
    teacher = j_init_model(jax.random.PRNGKey(0), J_SMOKE, None)
    student = j_init_model(jax.random.PRNGKey(1), J_SMOKE, jq)
    jplan = j_resolve_plan(jq, student, model_cfg=J_SMOKE)
    b = _batch(4, 10, 3)
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
    assert float(grads["layers"]["attn"]["wk"]["b"].abs().max()) > 0


def test_train_forward_matches_effective_view():
    """tests/test_plan_threading.py's train≡export invariant in the port:
    the plan-aware student forward equals the FP forward over its
    ``effective_view`` (CHW, layers.mlp.down at 8 bits)."""
    tq = TQ(w_bits=4, a_bits=None, granularity=TG.CHW, **PLAN_OVERRIDES)
    student = init_model(0, T_SMOKE, tq, device="cpu")
    qplan = resolve_plan(tq, student, model_cfg=T_SMOKE)
    student = qft_trainer.init_scales(student, T_SMOKE, tq, plan=qplan)
    b = _tb(_batch(2, 8, 1))
    dplan = make_deploy_plan(tq, family="vlm", quant_plan=qplan)
    with torch.no_grad():
        out = forward(student, T_SMOKE, tq, b, plan=qplan)
        eff = forward(effective_view(student, dplan, dtype=torch.float32),
                      T_SMOKE, None, b)
        ladder = forward(student, T_SMOKE, tq, b)
    assert torch.equal(out["logits"], eff["logits"])
    assert not torch.equal(out["logits"], ladder["logits"])


# ---------------------------------------------------------------------------
# export, deploy view, route check
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_artifact(kv_heads=None):
    """The JAX export of a SMOKE student whose keys are sorted, as the
    converted tree's are (``jax.device_get``), so both plans list the
    tensors in one order."""
    jq = JQ()
    cfg = J_SMOKE if kv_heads is None else dataclasses.replace(
        J_SMOKE, n_kv_heads=kv_heads, n_kv_heads_padded=kv_heads)
    params = jax.device_get(j_init_model(jax.random.PRNGKey(0), cfg, jq))
    plan = j_deploy.make_deploy_plan(jq, params=params, model_cfg=cfg)
    return plan, jax.jit(lambda p: j_deploy.export_for_layers(p, plan))(
        params), params


def test_export_model_and_deploy_view_match_jax():
    """The whole SMOKE VLM student: export_for_layers and export_model
    equal the JAX artifact (integer leaves bit for bit, scales and the
    q/k/v biases 1e-6), and the deploy view equals JAX's (1e-6)."""
    plan, jex, student = _jax_artifact()
    want = _t(jex)
    ts = _t(student)
    tplan = make_deploy_plan(TQ(), params=ts, model_cfg=T_SMOKE)
    got = export_for_layers(ts, tplan, device="cpu")
    one_walk = dict(tree_items(export_model(ts, tplan, device="cpu")))
    assert ("layers", "attn", "wk", "b") in dict(tree_items(want))
    _leaves_close(got, want, rtol=1e-6)
    for path, leaf in tree_items(got):
        assert torch.equal(leaf, one_walk[path]), path
    dv = deploy_view(got, tplan, dtype=torch.float32)
    jdv = _t(j_deploy.deploy_view(jex, plan, dtype=jnp.float32))
    _leaves_close(dv, jdv, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kv_heads", [2, 4])
def test_kernel_route_check_picks_the_jax_path(kv_heads):
    """kernel_route_check probes the biased ``layers.attn.wk`` (the 8-bit
    lm_head is not packed) where the CUDA kernel tiles it: with 4 kv heads
    (N 64), as at full size (N 512), the JAX package's path, and the
    reference product adds the bias.  At SMOKE's N 32 the Pallas blocks
    tile wk but the CUDA kernel's 64-wide tiles do not, so the port probes
    the next linear both tile, wo.  On the CPU nothing launches."""
    plan, jex, _ = _jax_artifact(kv_heads)
    want = j_deploy.kernel_route_check(jex, plan)
    got = kernel_route_check(_t(jex), DeployPlan(qcfg=TQ()))
    assert want["path"] == "layers.attn.wk"
    assert "b" in _t(jex)["layers"]["attn"]["wk"]
    assert got["path"] == "layers.attn." + ("wk" if kv_heads == 4 else "wo")
    assert got["layout"] == want["layout"]
    assert not got["kernel"]
    assert got["max_err"] <= 1e-5


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

PROMPTS = [[1, 2, 3], list(range(5, 25)), [300, 7, 42, 8, 9, 11, 500, 3, 2,
                                           1, 6], [9, 9]]
NEW = 6
SCFG = dict(max_slots=2, max_len=48, prefill_chunk=8, kv_page_size=16)


def _port_engine(kv_mode="paged", use_kernels=True):
    _, jex, _ = _jax_artifact()
    return Engine.from_artifact(
        T_SMOKE, DeployPlan(qcfg=TQ(), use_kernels=use_kernels), _t(jex),
        ServeConfig(kv_mode=kv_mode, **SCFG), device="cpu")


def _jax_margin_ok(context):
    plan, jex, _ = _jax_artifact()
    dv = j_deploy.deploy_view(jex, plan)
    logits = j_forward(dv, J_SMOKE, None,
                       {"tokens": jnp.asarray([context], jnp.int32)})
    z = np.sort(np.asarray(logits["logits"][0, -1], np.float32))[::-1]
    ulp = 2.0 ** (math.floor(math.log2(abs(z[0]))) - 7)
    return z[0] - z[1] <= MARGIN_ULPS * ulp


@pytest.mark.parametrize("kv_mode", ["paged", "monolithic"])
def test_greedy_tokens_match_jax_engine(kv_mode):
    """The JAX artifact, converted, served text-only by both engines (bf16,
    bucketed prefill, M-RoPE's three streams equal): every request's
    greedy tokens equal, or first differ where JAX's own top-2 margin is
    a near-tie.  The port's engine counts every layer on the decode
    kernel's route, the plain route none."""
    plan, jex, _ = _jax_artifact()
    jeng = JEngine.from_artifact(J_SMOKE, plan, jex,
                                 JServeConfig(kv_mode=kv_mode, **SCFG))
    want = jeng.generate([JRequest(prompt=p, max_new_tokens=NEW)
                          for p in PROMPTS])
    eng = _port_engine(kv_mode)
    assert eng._bucketed and (eng._kv is not None) == (kv_mode == "paged")
    got = eng.generate([Request(prompt=p, max_new_tokens=NEW)
                        for p in PROMPTS])
    near = 0
    for prompt, w, g in zip(PROMPTS, want, got):
        assert len(g) == len(w) == NEW
        i = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if i is not None:
            assert _jax_margin_ok(prompt + w[:i]), (prompt, i, w, g)
            near += 1
    assert near <= len(PROMPTS) // 2   # a near-tie is rare, not the rule
    s = eng.stats()
    assert s["decode_attn_kernel_layers"] == T_SMOKE.n_layers
    assert s["decode_attn_ref_layers"] == 0
    assert _port_engine(kv_mode, False).stats()[
        "decode_attn_ref_layers"] == T_SMOKE.n_layers


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_quantize_vlm_runs_and_resumes(capsys, tmp_path):
    """``python -m repro_torch quantize --config qwen2_vl_7b --device cpu
    --serve-smoke`` (SMOKE): every stage over batches with 4 patch
    embeddings, export parity below 1e-4, the two served requests; the
    rerun on its workdir skips calibrate, init and finetune and reports
    the same metrics."""
    from repro_torch.pipeline.cli import main
    args = ["quantize", "--config", "qwen2_vl_7b", "--device", "cpu",
            "--steps", "2", "--calib-samples", "16", "--calib-seq-len", "16",
            "--calib-batch-size", "4", "--serve-smoke", "--workdir",
            str(tmp_path)]
    assert main(args) == 0
    first = capsys.readouterr().out
    assert "pipeline: qwen2-vl-7b" in first
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


def test_augment_matches_the_jax_layout():
    """The adapter's stub inputs have the JAX package's shapes, dtypes and
    positions (the draws differ: ``torch.Generator`` against
    ``jax.random``) and are the same for every batch."""
    from repro.pipeline.adapters import get_adapter as j_get_adapter
    from repro.pipeline.config import PipelineConfig as JPC
    from repro_torch.pipeline.adapters import get_adapter
    from repro_torch.pipeline.config import PipelineConfig
    kw = dict(arch="qwen2-vl-7b", calib_samples=8, calib_seq_len=16,
              calib_batch_size=4)
    ja, ta = j_get_adapter(JPC(**kw)), get_adapter(
        PipelineConfig(device="cpu", **kw))
    jb, tb = ja.calib_batches()[0], ta.calib_batches()
    assert sorted(jb) == sorted(tb[0]) == ["patch_embeds", "positions",
                                           "tokens"]
    for k in jb:
        assert tuple(tb[0][k].shape) == jb[k].shape, k
        assert str(tb[0][k].dtype) == f"torch.{jb[k].dtype}", k
    assert np.array_equal(tb[0]["positions"].numpy(),
                          np.asarray(jb["positions"]))
    assert torch.equal(tb[0]["patch_embeds"], tb[1]["patch_embeds"])
