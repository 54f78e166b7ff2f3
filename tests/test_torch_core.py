"""repro_torch core vs the JAX package: configs, fake-quant and int4
packing, export, MMSE scales, plan resolution and sampling masks.

Inputs are made with numpy from a seed and go through both packages in one
process; integer outputs must be bit-equal, float ones agree to the stated
tolerance.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import qwen3_8b as j_qwen  # noqa: E402
from repro.core import dof as j_dof  # noqa: E402
from repro.core import fakequant as j_fq  # noqa: E402
from repro.core import mmse as j_mmse  # noqa: E402
from repro.core import qconfig as j_qc  # noqa: E402
from repro.core import sampling as j_samp  # noqa: E402
from repro.core.plan import resolve_plan as j_resolve_plan  # noqa: E402
from repro.core.policy import select_exempt_layers as j_select  # noqa: E402
from repro.models import config as j_mc  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro_torch.configs import qwen3_8b as t_qwen  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import dof as t_dof  # noqa: E402
from repro_torch.core import fakequant as t_fq  # noqa: E402
from repro_torch.core import mmse as t_mmse  # noqa: E402
from repro_torch.core import qconfig as t_qc  # noqa: E402
from repro_torch.core import sampling as t_samp  # noqa: E402
from repro_torch.core.plan import (plan_from_array, plan_to_array,  # noqa: E402
                                   resolve_plan)
from repro_torch.core.policy import select_exempt_layers  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.models import config as t_mc  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _fields(cls):
    """(name, default) per field; enum defaults compare by value, since each
    package has its own Granularity class."""
    return [(f.name, getattr(f.default, "value", f.default))
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ModelConfig", "MoEConfig", "MLAConfig",
                                  "SSMConfig"])
def test_model_config_dataclasses_field_for_field(name):
    assert _fields(getattr(t_mc, name)) == _fields(getattr(j_mc, name))


@pytest.mark.parametrize("name", ["QuantConfig", "QLayout"])
def test_qconfig_dataclasses_field_for_field(name):
    assert _fields(getattr(t_qc, name)) == _fields(getattr(j_qc, name))
    assert [g.value for g in t_qc.Granularity] == \
        [g.value for g in j_qc.Granularity]


def test_serve_config_field_for_field_with_slots_alias():
    """F11: ServeConfig field for field the JAX one, the legacy ``slots=``
    InitVar alias included, and the alias sets ``max_slots`` in both."""
    def decl(cls):        # dataclass fields and InitVars, in order
        return [(f.name, f.default) for f in cls.__dataclass_fields__.values()]
    assert decl(t_engine.ServeConfig) == decl(j_engine.ServeConfig)
    for cls in (t_engine.ServeConfig, j_engine.ServeConfig):
        assert cls(slots=3).max_slots == 3
        assert cls(max_slots=5).max_slots == 5


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_qwen3_8b_config_values(which):
    t, j = getattr(t_qwen, which), getattr(j_qwen, which)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert get_config("qwen3-8b", smoke=which == "SMOKE") == t
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("nonexistent")


@pytest.mark.parametrize("spec", ["layerwise", "channel", "group:64"])
def test_qconfig_layout_resolution(spec):
    kw = dict(w_layout=spec, layout_overrides=(("layers.mlp.*", "group:32"),))
    t, j = t_qc.QuantConfig(**kw), j_qc.QuantConfig(**kw)
    for name in ("wq", "layers.mlp.down", None):
        assert str(t.layout_for(name)) == str(j.layout_for(name))
    assert t.layout.swr_shape(128, 64) == j.layout.swr_shape(128, 64)
    assert t_qc.permissive() == t_qc.QuantConfig(
        a_bits=None, granularity=t_qc.Granularity.DCHW)


def test_exemption_policy_matches():
    rng = np.random.default_rng(0)
    sizes = {f"t{i}": int(s) for i, s in enumerate(rng.integers(1, 10_000, 40))}
    cfg = j_qc.QuantConfig(exempt_frac=0.05)
    assert select_exempt_layers(sizes, t_qc.QuantConfig(exempt_frac=0.05)) \
        == j_select(sizes, cfg)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_and_pack_bit_equal(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(64, 48)).astype(np.float32)
    # exact .5 ties exercise round-half-to-even
    x[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5]) * 0.1
    s = np.full((1, 48), 0.1, np.float32)
    qj = np.asarray(j_fq.quantize(jnp.asarray(x), jnp.asarray(s), bits))
    qt = t_fq.quantize(_t(x), _t(s), bits).numpy()
    np.testing.assert_array_equal(qt, qj)
    if bits == 4:
        q8 = qj.astype(np.int8)
        pj = np.asarray(j_fq.pack_int4(jnp.asarray(q8), axis=0))
        pt = t_fq.pack_int4(_t(q8), axis=0)
        assert pt.dtype == torch.uint8
        np.testing.assert_array_equal(pt.numpy(), pj)
        np.testing.assert_array_equal(t_fq.unpack_int4(pt, axis=0).numpy(),
                                      q8)


def test_unpack_sign_extends_every_nibble():
    packed = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for axis in (0, 1):
        np.testing.assert_array_equal(
            t_fq.unpack_int4(_t(packed), axis=axis).numpy(),
            np.asarray(j_fq.unpack_int4(jnp.asarray(packed), axis=axis)))


@pytest.mark.parametrize("layout", ["layerwise", "channel", "group:32",
                                    "group:64", "group:128"])
@pytest.mark.parametrize("bits", [4, 8])
def test_export_qlinear_bit_equal(layout, bits):
    """q leaves bit-equal; the scale leaves (``exp`` of the log DoF) within
    an ulp; dequantize_export of one artifact equal in f32 in both packages,
    and equal to the port's own effective_weight (train≡export)."""
    cfg = j_qc.QuantConfig(w_layout=layout)
    p = j_dof.init_qlinear(jax.random.PRNGKey(3), 256, 64, cfg, bias=True)
    p = j_dof.mmse_init_qlinear(p, cfg, bits=bits)
    rng = np.random.default_rng(1)
    log_sa = jnp.asarray(rng.normal(size=(256,)).astype(np.float32) * 0.3
                         - 2.0)
    ej = jax.device_get(j_dof.export_qlinear(p, cfg, log_sa_in=log_sa,
                                             bits=bits))
    tp = from_numpy_tree(jax.device_get(p), "cpu")
    tcfg = t_qc.QuantConfig(w_layout=layout)
    et = t_dof.export_qlinear(tp, tcfg, log_sa_in=_t(log_sa), bits=bits)
    assert et["q"].dtype == (torch.uint8 if bits == 4 else torch.int8)
    np.testing.assert_array_equal(et["q"].numpy(), np.asarray(ej["q"]))
    np.testing.assert_array_equal(et["b"].numpy(), np.asarray(ej["b"]))
    for key in ("s_wl", "s_wr"):
        np.testing.assert_allclose(et[key].numpy(), np.asarray(ej[key]),
                                   rtol=1e-6, atol=0)
    dj = np.asarray(j_dof.dequantize_export(ej, jnp.float32))
    dt = t_dof.dequantize_export(from_numpy_tree(ej, "cpu"), torch.float32)
    np.testing.assert_array_equal(dt.numpy(), dj)
    eff = t_dof.effective_weight(tp, tcfg, _t(log_sa), torch.float32,
                                 bits=bits)
    np.testing.assert_array_equal(
        t_dof.dequantize_export(et, torch.float32).numpy(), eff.numpy())


@pytest.mark.parametrize("axes", [None, (0,), (1,), (1, 3)])
def test_ppq_scale_parity(axes):
    rng = np.random.default_rng(7)
    shape = (6, 40, 3, 16) if axes == (1, 3) else (96, 32)
    w = rng.normal(size=shape).astype(np.float32)
    w[:, 0] = 0.0                              # an all-zero slice for (0,)
    sj = np.asarray(j_mmse.ppq_scale(jnp.asarray(w), 4, axes=axes))
    st = t_mmse.ppq_scale(_t(w), 4, axes=axes).numpy()
    np.testing.assert_allclose(st, sj, rtol=1e-6, atol=1e-6)


def test_mmse_grouped_and_apq_parity():
    rng = np.random.default_rng(8)
    w = rng.normal(size=(128, 48)).astype(np.float32)
    np.testing.assert_allclose(
        t_mmse.ppq_scale_grouped(_t(w), 4, 4).numpy(),
        np.asarray(j_mmse.ppq_scale_grouped(jnp.asarray(w), 4, 4)),
        rtol=1e-6, atol=1e-6)
    for ts, js in zip(t_mmse.apq_scales(_t(w), 4),
                      j_mmse.apq_scales(jnp.asarray(w), 4)):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-6)
    for name in ("mmse_lw", "mmse_ch", "mmse_dch"):
        np.testing.assert_allclose(
            float(getattr(t_mmse, name)(_t(w), 4)),
            float(getattr(j_mmse, name)(jnp.asarray(w), 4)), rtol=1e-5)
    np.testing.assert_allclose(float(t_mmse.mmse_grp(_t(w), 4, 32)),
                               float(j_mmse.mmse_grp(jnp.asarray(w), 4, 32)),
                               rtol=1e-5)


@pytest.mark.parametrize("qkw", [
    {},
    {"w_layout": "group:32", "bits_overrides": (("layers.mlp.*", 8),)},
    {"exempt_frac": 0.2, "layout_overrides": (("wk", "layerwise"),)},
])
def test_resolve_plan_json_equal(qkw):
    """The SMOKE tree's plan JSON is the JAX package's, byte for byte: for
    each package's own init tree — the JAX package's key-sorted, as every
    JAX transformation (``jax.device_get``, ``jax.eval_shape``, a jitted
    step) returns it and as the port's ``init_model`` builds it (F23) —
    and for the same converted tree."""
    jq, tq = j_qc.QuantConfig(**qkw), t_qc.QuantConfig(**qkw)
    jp = j_init_model(jax.random.PRNGKey(0), j_qwen.SMOKE, jq)
    npt = jax.device_get(jp)
    want = j_resolve_plan(jq, npt, model_cfg=j_qwen.SMOKE).to_json()
    tp = init_model(0, t_qwen.SMOKE, tq, device="cpu")
    got = resolve_plan(tq, tp, model_cfg=t_qwen.SMOKE)
    assert got.to_json() == want
    assert resolve_plan(tq, from_numpy_tree(npt, "cpu"),
                        model_cfg=t_qwen.SMOKE).to_json() == want
    assert plan_from_array(plan_to_array(got)) == got


@pytest.mark.parametrize("k", [0, 1, 5, 37, 64])
def test_top_k_mask_parity(k):
    rng = np.random.default_rng(k)
    logits = rng.normal(size=(3, 64)).astype(np.float32)
    logits[1, :4] = logits[1, 4]                # ties at the boundary
    want = np.stack([np.asarray(j_samp.top_k_mask(jnp.asarray(r), k))
                     for r in logits])
    got = t_samp.top_k_mask(_t(logits), k).numpy()
    np.testing.assert_array_equal(got, want)


def np_top_k_support(logits: np.ndarray, k: int) -> np.ndarray:
    """Boolean support of a tie-inclusive top-k: everything >= the k-th
    largest VALUE survives (0 or >= vocab disables).  A copy of
    ``tests/test_sampling.py``'s reference."""
    v = logits.shape[-1]
    if k <= 0 or k >= v:
        return np.ones_like(logits, bool)
    kth = np.sort(logits)[::-1][k - 1]
    return logits >= kth


#: (logits, k): the two subnormal cases of F8 first (6.3e-40 is a float32
#: subnormal), then ties at the boundary, all-equal rows and the disabled k
TOP_K_CASES = [([0.0, 6.3e-40], 1), ([6.3e-40, 0.0, -1.0], 1),
               ([1e-45, -1e-45, 0.0, 2.0], 2), ([1.0, 2.0, 2.0, 0.5], 2),
               ([3.0, 3.0, 3.0], 1), ([-1.0, -5.0, 4.0, 4.0, 0.0], 3),
               ([0.5, 0.25], 0), ([0.5, 0.25], 2)]


@pytest.mark.parametrize("case", range(len(TOP_K_CASES)))
def test_top_k_mask_subnormal_exception(case):
    """F8: XLA on the CPU compares float32 subnormals as zero, so JAX's
    top_k_mask keeps both of [0.0, 6.3e-40] at k = 1; the port compares
    them exactly and keeps only 6.3e-40, as the numpy reference does.  The
    port holds the numpy reference on every case, and JAX once the
    subnormals are flushed to zero."""
    row, k = TOP_K_CASES[case]
    logits = np.asarray(row, np.float32)
    kept = np.isfinite(t_samp.top_k_mask(_t(logits), k).numpy())
    np.testing.assert_array_equal(kept, np_top_k_support(logits, k))
    flushed = np.where(np.abs(logits) < np.finfo(np.float32).tiny,
                       np.float32(0), logits)
    want = np.isfinite(np.asarray(j_samp.top_k_mask(jnp.asarray(flushed),
                                                    k)))
    got = np.isfinite(t_samp.top_k_mask(_t(flushed), k).numpy())
    np.testing.assert_array_equal(got, want)
    if case == 0:
        assert kept.tolist() == [False, True]


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_top_p_mask_parity(p):
    rng = np.random.default_rng(int(p * 10))
    logits = (rng.normal(size=(3, 64)) * 2).astype(np.float32)
    want = np.stack([np.asarray(j_samp.top_p_mask(jnp.asarray(r), p))
                     for r in logits])
    got = t_samp.top_p_mask(_t(logits), p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))


def test_sample_tokens_greedy_and_counter_chain():
    """temperature 0 is argmax; a draw is a function of the row's own
    (seed, counter), whatever else is in the batch (F3: no bit parity with
    JAX's threefry draws)."""
    rng = np.random.default_rng(5)
    logits = _t(rng.normal(size=(4, 50)).astype(np.float32))
    seeds = torch.tensor([1, 2, 3, 1])
    ctr = torch.tensor([0, 0, 0, 1])
    zero = torch.zeros(4)
    greedy = t_samp.sample_tokens(logits, seeds, ctr, zero,
                                  torch.zeros(4, dtype=torch.int32),
                                  torch.ones(4))
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.argmax(logits.numpy(), -1))
    temp = torch.full((4,), 1.5)
    kw = dict(top_k=torch.zeros(4, dtype=torch.int32), top_p=torch.ones(4))
    a = t_samp.sample_tokens(logits, seeds, ctr, temp, **kw)
    b = t_samp.sample_tokens(logits[[2, 0, 3, 1]], seeds[[2, 0, 3, 1]],
                             ctr[[2, 0, 3, 1]], temp, **kw)
    np.testing.assert_array_equal(a.numpy()[[2, 0, 3, 1]], b.numpy())
    draws = {int(t_samp.sample_tokens(logits[:1], seeds[:1],
                                      torch.tensor([c]), temp[:1], **{
                                          k: v[:1] for k, v in kw.items()}))
             for c in range(40)}
    assert len(draws) > 5                      # the chain moves
    u = t_samp.gumbel_noise(torch.tensor([9]), torch.tensor([4]), 10_000)
    assert torch.isfinite(u).all() and abs(float(u.mean()) - 0.5772) < 0.05
