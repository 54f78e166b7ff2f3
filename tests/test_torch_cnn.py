"""repro_torch's paper CNN (models/cnn.py, core/bias_correction.py and the
list-aware tree helpers) against the JAX package, on the CPU.

Parameters are initialised in JAX and converted; inputs are made with
numpy.  Tolerances: features and logits in f32 to 1e-5 relative (the two
convolutions sum in other orders); scale leaves 1e-6 (exp/log ulps);
integer artifact leaves bit for bit; dequantized and effective weights
1e-6; the bias correction 1e-6.  The ``fake_quant`` kernel's conv layout
(its plain version here) is held against the plain composition: forward
bit for bit, the weight's gradient bit for bit and the scale's to 1e-5
relative (a sum over up to 9·32·64 weights, in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_cnn import CONFIG as J_CNN  # noqa: E402
from repro.core.bias_correction import bias_correct as j_bias_correct  # noqa: E402,E501
from repro.core import qconfig as j_qc  # noqa: E402
from repro.core.qconfig import Granularity as JG  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import cnn as j_cnn  # noqa: E402
from repro.optim import adam as j_adam  # noqa: E402
from repro.pipeline.adapters import resolve_quant_plan as j_rqp  # noqa: E402
from repro.serve.deploy import make_deploy_plan as j_make_plan  # noqa: E402
from repro_torch.configs.paper_cnn import CONFIG as T_CNN  # noqa: E402
from repro_torch.core.bias_correction import bias_correct  # noqa: E402
from repro_torch.core.fakequant import fake_quant  # noqa: E402
from repro_torch.core import qconfig as t_qc  # noqa: E402
from repro_torch.core.qconfig import Granularity as TG  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.optim import adam as t_adam  # noqa: E402
from repro_torch.pipeline.adapters import resolve_quant_plan  # noqa: E402
from repro_torch.serve.deploy import make_deploy_plan  # noqa: E402
from repro_torch.tree import tree_from_items, tree_items, tree_map  # noqa: E402,E501

#: the pipeline's two modes (PipelineConfig.quant_config)
QCFGS = {"w4a8": "deployment_oriented", "w4chw": "permissive"}


def _t(tree):
    return from_numpy_tree(jax.device_get(tree), "cpu")


def _qcfgs(name):
    return getattr(j_qc, QCFGS[name])(), getattr(t_qc, QCFGS[name])()


def _x(cfg, n=4, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.img_hw, cfg.img_hw, cfg.in_ch)).astype(np.float32)


def _rel(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def _student(jq, cfg=J_CNN, seed=1, stream_seed=2):
    """A JAX student with its stream scales and recode factors drawn at
    random, so no scale is at its constant init."""
    p = j_cnn.init_cnn(jax.random.PRNGKey(seed), cfg, jq)
    rng = np.random.default_rng(stream_seed)
    for st in p["streams"] + [p["fc_stream"]]:
        n = st["log_sa"].shape
        st["log_sa"] = jnp.asarray(np.log(rng.uniform(0.02, 0.08, n)),
                                   jnp.float32)
        st["zp"] = jnp.asarray(rng.integers(0, 8, n), jnp.float32)
    for conv in p["convs"]:
        n = conv["log_f"].shape
        conv["log_f"] = jnp.asarray(rng.uniform(-4.0, -2.0, n), jnp.float32)
    return p


def _plans(jq, tq):
    jplan = j_make_plan(jq, arch="paper-cnn", family="cnn",
                        quant_plan=j_rqp(J_CNN, jq))
    tplan = make_deploy_plan(tq, arch="paper-cnn", family="cnn",
                             quant_plan=resolve_quant_plan(T_CNN, tq))
    return jplan, tplan


# ------------------------------------------------------------- forward


@pytest.mark.parametrize("hw", [16, 15])
@pytest.mark.parametrize("kind", ["teacher", "student", "student+plan"])
def test_forward_cnn_matches_jax(kind, hw):
    """Features (the stride-2 "SAME" convs included) and logits in f32,
    at the paper's 16x16 and an odd 15x15, teacher and student, with and
    without the plan."""
    cfg = dataclasses.replace(J_CNN, img_hw=hw)
    jq, tq = (None, None) if kind == "teacher" else _qcfgs("w4a8")
    jp = (j_cnn.init_cnn(jax.random.PRNGKey(0), cfg, None)
          if jq is None else _student(jq, cfg))
    jplan = tplan = None
    tcfg = dataclasses.replace(T_CNN, img_hw=hw)
    if kind == "student+plan":
        jplan = j_rqp(cfg, jq)
        tplan = resolve_quant_plan(tcfg, tq)
        assert tplan.to_json() == jplan.to_json()
    x = _x(cfg)
    jo = j_cnn.forward_cnn(jp, cfg, jq, jnp.asarray(x), plan=jplan,
                           collect_taps=True)
    with torch.no_grad():
        to = cnn.forward_cnn(_t(jp), tcfg, tq, torch.from_numpy(x),
                             plan=tplan, collect_taps=True)
    assert to["features"].shape == jo["features"].shape
    for key in ("features", "pooled", "logits"):
        _rel(to[key].numpy(), jo[key], 1e-5, key)
    assert sorted(to["taps"]) == sorted(jo["taps"])
    for name, st in to["taps"].items():
        for k, v in st.items():
            _rel(v.numpy(), jo["taps"][name][k], 1e-5, (name, k))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [16, 15, 7])
def test_conv2d_same_matches_xla_padding(hw, stride):
    """``"SAME"`` as XLA pads it: at stride 2 on an even size the extra row
    goes after (``padding=1`` on both sides would differ)."""
    rng = np.random.default_rng(hw + stride)
    x = rng.standard_normal((2, hw, hw, 16)).astype(np.float32)
    w = rng.standard_normal((3, 3, 16, 32)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = cnn.conv2d_same(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert got.shape == want.shape
    _rel(got.numpy(), want, 1e-5)


# --------------------------------------------------- scales and the init


def test_conv_weight_scale_matches_jax():
    jq, _ = _qcfgs("w4a8")
    jp = _student(jq)
    tp = _t(jp)
    for i in range(len(jp["convs"])):
        jin, jout = j_cnn._conv_stream_scales(jp, i)
        tin, tout = cnn._conv_stream_scales(tp, i)
        for args in ((jin, jout), (None, jout), (jin, None), (None, None)):
            targs = tuple(None if a is None else (tin, tout)[k]
                          for k, a in enumerate(args))
            want = j_cnn.conv_weight_scale(jp["convs"][i], *args)
            got = cnn.conv_weight_scale(tp["convs"][i], *targs)
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)


@pytest.mark.parametrize("granularity", ["chw", "lw"])
def test_mmse_init_qconv_matches_jax(granularity):
    jq = JQ(granularity=JG(granularity))
    tq = TQ(granularity=TG(granularity))
    jp = _student(jq)
    tp = _t(jp)
    for i in range(len(jp["convs"])):
        jin, jout = j_cnn._conv_stream_scales(jp, i)
        tin, tout = cnn._conv_stream_scales(tp, i)
        want = j_cnn.mmse_init_qconv(jp["convs"][i], jq, jin, jout)
        got = cnn.mmse_init_qconv(tp["convs"][i], tq, tin, tout)
        assert got["log_f"].shape == want["log_f"].shape
        np.testing.assert_allclose(got["log_f"].numpy(),
                                   np.asarray(want["log_f"]), rtol=1e-6,
                                   atol=1e-6)


def test_apq_init_qconv_matches_jax():
    jq, tq = _qcfgs("w4chw")
    jp = _student(jq)
    tp = _t(jp)
    for i in range(len(jp["convs"])):
        wp, wl = j_cnn.apq_init_qconv(jp["convs"][i], jq, bits=4)
        gp, gl = cnn.apq_init_qconv(tp["convs"][i], tq, bits=4)
        np.testing.assert_allclose(gp["log_f"].numpy(),
                                   np.asarray(wp["log_f"]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------------ the export


@pytest.mark.parametrize("qname", list(QCFGS))
def test_export_cnn_bit_equal(qname):
    """export_cnn: every q leaf bit for bit (conv0 int8 at cin 3, conv1 and
    conv2 nibble-packed uint8, the exempt fc int8), scales 1e-6, the
    embedded plan byte for byte; export_qconv alone at 8 bits too."""
    jq, tq = _qcfgs(qname)
    jplan, tplan = _plans(jq, tq)
    jp = _student(jq)
    want = dict(tree_items(_t(j_cnn.export_cnn(jp, jplan))))
    got = cnn.export_cnn(_t(jp), tplan)
    assert got["convs"][1]["q"].dtype == torch.uint8
    assert got["convs"][0]["q"].dtype == torch.int8
    assert sorted(map(str, want)) == sorted(map(str, dict(tree_items(got))))
    for path, leaf in tree_items(got):
        ref = want[path]
        assert leaf.dtype == ref.dtype and leaf.shape == ref.shape, path
        if leaf.is_floating_point():
            np.testing.assert_allclose(leaf.numpy(), ref.numpy(), rtol=1e-6,
                                       err_msg=str(path))
        else:
            assert torch.equal(leaf, ref), path
    jin, jout = j_cnn._conv_stream_scales(jp, 2)
    tin, tout = cnn._conv_stream_scales(_t(jp), 2)
    w8 = j_cnn.export_qconv(jp["convs"][2], jq, jin, jout, bits=8)
    g8 = cnn.export_qconv(_t(jp)["convs"][2], tq, tin, tout, bits=8)
    assert torch.equal(g8["q"], _t(w8)["q"])


@pytest.mark.parametrize("qname", list(QCFGS))
def test_deploy_and_effective_views_match_jax(qname):
    """cnn_deploy_view of the port's artifact and cnn_effective_view of the
    student, each against the JAX package's (1e-6), and against each other
    (the export parity, below 1e-4 as the pipeline requires)."""
    jq, tq = _qcfgs(qname)
    jplan, tplan = _plans(jq, tq)
    jp = _student(jq)
    tp = _t(jp)
    art = cnn.export_cnn(tp, tplan)
    dv = cnn.cnn_deploy_view(art, tplan)
    ev = cnn.cnn_effective_view(tp, tplan)
    jdv = dict(tree_items(_t(j_cnn.cnn_deploy_view(
        j_cnn.export_cnn(jp, jplan), jplan))))
    jev = dict(tree_items(_t(j_cnn.cnn_effective_view(jp, jplan))))
    for mine, ref in ((dv, jdv), (ev, jev)):
        items = dict(tree_items(mine))
        assert sorted(map(str, items)) == sorted(map(str, ref))
        for path, leaf in items.items():
            np.testing.assert_allclose(leaf.numpy(), ref[path].numpy(),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=str(path))
    from repro_torch.pipeline.adapters import tree_parity_error
    assert tree_parity_error(dv, ev) < 1e-4


# -------------------------------------------------------- bias correction


def test_bias_correct_matches_jax():
    rng = np.random.default_rng(5)
    params = {"convs": [{"w": rng.standard_normal((3, 3, 4, 8)),
                         "b": rng.standard_normal(8)},
                        {"w": rng.standard_normal((3, 3, 8, 8))}],
              "fc": {"w": rng.standard_normal((8, 10)),
                     "b": rng.standard_normal(10)}}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    taps_fp = {n: rng.standard_normal(s).astype(np.float32) for n, s in
               (("c0", (2, 5, 5, 8)), ("c1", (2, 3, 3, 8)), ("fc", (2, 10)))}
    taps_q = {n: (v + rng.standard_normal(v.shape) * 0.1).astype(np.float32)
              for n, v in taps_fp.items()}
    path_map = {"c0": ("convs", 0), "c1": ("convs", 1), "fc": ("fc",),
                "absent": ("fc",)}
    want = j_bias_correct({k: jnp.asarray(v) for k, v in taps_fp.items()},
                          {k: jnp.asarray(v) for k, v in taps_q.items()},
                          jax.tree.map(jnp.asarray, params), path_map)
    tparams = _t(params)
    got = bias_correct({k: torch.from_numpy(v) for k, v in taps_fp.items()},
                       {k: torch.from_numpy(v) for k, v in taps_q.items()},
                       tparams, path_map)
    ref = dict(tree_items(_t(want)))
    assert sorted(map(str, ref)) == sorted(map(str, dict(tree_items(got))))
    for path, leaf in tree_items(got):
        np.testing.assert_allclose(leaf.numpy(), ref[path].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=str(path))
    assert "b" not in tparams["convs"][1]          # the input is unchanged


# ----------------------------------------- the fake_quant kernel's layout


@pytest.mark.parametrize("with_in", [True, False])
@pytest.mark.parametrize("conv", [0, 1, 2])
def test_conv_fake_quant_kernel_layout(conv, with_in):
    """The conv weight as one ``[kh·kw, cin·cout]`` view with a per-column
    scale through ``fake_quant_kernel`` (here its plain versions) against
    the plain composition on the HWIO kernel: forward and the weight's
    gradient bit for bit, the scale's (the log-scale DoF behind it)
    1e-5 relative: a sum over up to 9·32·64 terms in another order."""
    jq, tq = _qcfgs("w4a8")
    tp = _t(_student(jq))
    log_in, log_out = cnn._conv_stream_scales(tp, conv)
    if not with_in:
        log_in = None
    rng = np.random.default_rng(conv)
    w0 = tp["convs"][conv]["w"]
    gy = torch.from_numpy(rng.standard_normal(tuple(w0.shape))
                          .astype(np.float32))
    outs = {}
    for route in ("kernel", "plain"):
        p = {k: v.clone().requires_grad_() for k, v in
             tp["convs"][conv].items()}
        lin = None if log_in is None else log_in.clone().requires_grad_()
        s = cnn.conv_weight_scale(p, lin, log_out)
        y = (cnn.conv_fake_quant_kernel(p["w"], s, 4) if route == "kernel"
             else fake_quant(p["w"], s, 4))
        wrt = [p["w"], p["log_f"]] + ([] if lin is None else [lin])
        outs[route] = (y.detach(), *torch.autograd.grad(y, wrt, gy))
    got, want = outs["kernel"], outs["plain"]
    assert torch.equal(got[0], want[0])             # forward
    assert torch.equal(got[1], want[1])             # d/dw
    for name, g, r in zip(("log_f", "log_sa_in"), got[2:], want[2:]):
        _rel(g.numpy(), r.numpy(), 1e-5, name)


# ----------------------------------------------------- the tree helpers


def test_list_aware_tree_round_trip_and_adam_step():
    """tree_items/tree_from_items/tree_map over the CNN student (lists of
    convs and streams, int path entries, ``convs.1`` as the plan names it),
    and one Adam step over it against the JAX package's."""
    jq, tq = _qcfgs("w4a8")
    jp = _student(jq)
    tp = _t(jp)
    items = list(tree_items(tp))
    assert (("convs", 1, "w") in dict(items)
            and ("streams", 2, "zp") in dict(items))
    back = tree_from_items(items)
    assert isinstance(back["convs"], list) and len(back["convs"]) == 3
    assert [p for p, _ in tree_items(back)] == [p for p, _ in items]
    doubled = tree_map(lambda a, b: a + b, tp, back)
    assert torch.equal(doubled["convs"][2]["w"], 2 * tp["convs"][2]["w"])
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), jp)
    jopt = j_adam.paper_recipe(steps_per_epoch=2)
    want, _ = jopt.update(grads, jopt.init(jp), jp)
    topt = t_adam.paper_recipe(steps_per_epoch=2)
    got, state = topt.update(_t(grads), topt.init(tp), tp)
    assert isinstance(state["m"]["convs"], list)
    ref = dict(tree_items(_t(want)))
    for path, leaf in tree_items(got):
        np.testing.assert_allclose(leaf.numpy(), ref[path].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=str(path))
