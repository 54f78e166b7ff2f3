"""repro_torch's QFT training slice vs the JAX package on qwen3-8b SMOKE:
distillation losses, the Adam recipe, the calibration data and taps, the
MMSE/APQ scale init, one student step's loss and gradients, and the
trainer's prepare → run.

Inputs are made with numpy (or by the JAX package from a seed) and go
through both packages.  Every stage is held on identical f32 inputs:
losses 1e-6, Adam 1e-6, taps 1e-5, scale leaves 1e-6 (exp/log ulps), each
gradient leaf 1e-4 relative L2.  The shipped bf16 step and the chained
trainer round bf16 in other places than JAX and are held loosely, with the
tolerance stated where it is used.
"""
import dataclasses
import functools
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.qwen3_8b import SMOKE as J_SMOKE  # noqa: E402
from repro.core import calibration as j_cal  # noqa: E402
from repro.core import cle as j_cle  # noqa: E402
from repro.core import distill as j_distill  # noqa: E402
from repro.core import dof as j_dof  # noqa: E402
from repro.core.plan import resolve_plan as j_resolve_plan  # noqa: E402
from repro.core.qconfig import Granularity as JG  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.data import calib as j_data  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.optim import adam as j_adam  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402
from repro.train.qft_trainer import QFTConfig as JQFTConfig  # noqa: E402
from repro.train.qft_trainer import cle_init_student as j_cle_init  # noqa: E402
from repro.train.qft_trainer import QFTTrainer as JQFTTrainer  # noqa: E402
from repro_torch.configs.qwen3_8b import SMOKE as T_SMOKE  # noqa: E402
from repro_torch.core import calibration as t_cal  # noqa: E402
from repro_torch.core import cle as t_cle  # noqa: E402
from repro_torch.core import distill as t_distill  # noqa: E402
from repro_torch.core import dof as t_dof  # noqa: E402
from repro_torch.core.distill import backbone_l2  # noqa: E402
from repro_torch.core.plan import resolve_plan  # noqa: E402
from repro_torch.core.qconfig import Granularity as TG  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.data import calib as t_data  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.optim import adam as t_adam  # noqa: E402
from repro_torch.train.qft_trainer import QFTConfig, QFTTrainer  # noqa: E402
from repro_torch.train.qft_trainer import cle_init_student  # noqa: E402
from repro_torch.train.steps import (make_train_step,  # noqa: E402
                                     make_value_and_grad)
from repro_torch.tree import tree_from_items, tree_items  # noqa: E402

QCFGS = {"dchw": {}, "channel": {"granularity": "chw"},
         "group32": {"w_layout": "group:32"}}
STEPS_PER_EPOCH = 4


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _torch_tree(tree):
    return from_numpy_tree(jax.device_get(tree), "cpu")


def _qcfgs(name):
    kw = QCFGS[name]
    jkw = {k: JG(v) if k == "granularity" else v for k, v in kw.items()}
    tkw = {k: TG(v) if k == "granularity" else v for k, v in kw.items()}
    return JQ(**jkw), TQ(**tkw)


def _rel(a, b, rtol, what=""):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(float(np.max(np.abs(b))), 1e-30) if b.size else 1.0
    err = float(np.max(np.abs(a - b))) if b.size else 0.0
    assert err <= rtol * scale, (what, err, scale)


def _close_log(a, b, what=""):
    """Log-domain scale leaves: 1e-6 relative or absolute (an absolute
    1e-6 in the log is a relative 1e-6 in the scale), as the MMSE parity
    tests in test_torch_core.py hold them."""
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                               atol=1e-6, err_msg=str(what))


def _data(n_samples=32, seq_len=16, batch_size=4, seed=0):
    cfg = dict(n_samples=n_samples, seq_len=seq_len, batch_size=batch_size,
               vocab=J_SMOKE.vocab, seed=seed)
    return (j_data.CalibDataset(j_data.CalibConfig(**cfg)),
            t_data.CalibDataset(t_data.CalibConfig(**cfg)))


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("masked", [False, True])
def test_distill_losses_match_jax(masked):
    rng = np.random.default_rng(0)
    hs, ht = (rng.normal(size=(2, 5, 16)).astype(np.float32) for _ in "ab")
    zs, zt = (rng.normal(size=(2, 5, 32)).astype(np.float32) * 3
              for _ in "ab")
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    pairs = [
        (t_distill.backbone_l2(_t(hs), _t(ht), tm),
         j_distill.backbone_l2(jnp.asarray(hs), jnp.asarray(ht), jm)),
        (t_distill.logits_ce(_t(zs), _t(zt), tm),
         j_distill.logits_ce(jnp.asarray(zs), jnp.asarray(zt), jm)),
        (t_distill.qft_loss(_t(hs), _t(ht), _t(zs), _t(zt), 0.3, tm),
         j_distill.qft_loss(jnp.asarray(hs), jnp.asarray(ht), jnp.asarray(zs),
                            jnp.asarray(zt), 0.3, jm)),
    ]
    for t, j in pairs:
        _rel(float(t), float(j), 1e-6)


# ------------------------------------------------------------------ adam


def test_cosine_reload_schedule_matches_jax():
    jl = j_adam.cosine_reload_schedule(1e-4, steps_per_cycle=16, n_cycles=3)
    tl = t_adam.cosine_reload_schedule(1e-4, steps_per_cycle=16, n_cycles=3)
    for step in (0, 1, 7, 15, 16, 17, 31, 32, 40, 47, 48, 100):
        _rel(float(tl(step)), float(jl(step)), 1e-6, step)


def _adam_case(seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": {"w": rng.normal(size=(8, 6)), "b": rng.normal(size=(6,))},
              "s": np.array(rng.normal()), "frozen": rng.normal(size=(4,))}
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    grads = jax.tree.map(
        lambda x: (rng.normal(size=x.shape) * 0.3).astype(np.float32), params)
    grads["frozen"] = np.zeros((4,), np.float32)   # no gradient reached it
    m = jax.tree.map(
        lambda x: (rng.normal(size=x.shape) * 0.1).astype(np.float32), params)
    v = jax.tree.map(
        lambda x: (rng.random(x.shape) * 0.05).astype(np.float32), params)
    return params, grads, {"m": m, "v": v, "step": np.int32(3)}


@pytest.mark.parametrize("variant", ["recipe", "grad_clip", "bf16_state"])
def test_adam_update_matches_jax(variant):
    """One update on identical (params, grads, state); the port's ``None``
    gradient is JAX's zeros, and its update runs in place."""
    params, grads, state = _adam_case()
    lr = j_adam.cosine_reload_schedule(1e-4, 16, 3)
    tlr = t_adam.cosine_reload_schedule(1e-4, 16, 3)
    clip = 0.05 if variant == "grad_clip" else None
    jsd, tsd = ((jnp.bfloat16, torch.bfloat16) if variant == "bf16_state"
                else (jnp.float32, torch.float32))
    jopt = j_adam.Adam(lr=lr, grad_clip=clip, state_dtype=jsd)
    topt = t_adam.Adam(lr=tlr, grad_clip=clip, state_dtype=tsd)
    jstate = {**state, "m": jax.tree.map(lambda x: jnp.asarray(x, jsd),
                                         state["m"]),
              "v": jax.tree.map(lambda x: jnp.asarray(x, jsd), state["v"])}
    jp, js = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                         jax.tree.map(jnp.asarray, params))
    tp = from_numpy_tree(params, "cpu")
    tstate = {"m": from_numpy_tree(jax.device_get(jstate["m"]), "cpu"),
              "v": from_numpy_tree(jax.device_get(jstate["v"]), "cpu"),
              "step": torch.tensor(3, dtype=torch.int32)}
    tg = from_numpy_tree(grads, "cpu")
    tg["frozen"] = None
    tp2, ts = topt.update(tg, tstate, tp)
    assert tp2 is tp and int(ts["step"]) == int(js["step"]) == 4
    # bf16 moments: one bf16 rounding of f32 values that may differ by an ulp
    st_tol = 2.0 ** -8 if variant == "bf16_state" else 1e-6
    for path, leaf in tree_items(tp):
        pick = functools.partial(functools.reduce, lambda t, k: t[k], path)
        _rel(leaf.numpy(), np.asarray(pick(jp)), 1e-6, path)
        for key, tol in (("m", st_tol), ("v", st_tol)):
            _rel(pick(ts[key]).float().numpy(),
                 np.asarray(pick(js[key]).astype(jnp.float32)), tol,
                 (key,) + path)
    assert float(ts["m"]["frozen"].abs().max()) > 0     # decayed, not reset


# ------------------------------------------------------------------ data


def test_calib_dataset_tokens_bit_equal(tmp_path):
    """Epoch-shuffled batches across an epoch boundary, ``skip_to``, host
    sharding and a token file: the same tokens as the JAX loader."""
    kw = dict(n_samples=40, seq_len=8, batch_size=6, vocab=100, seed=3)
    np.save(tmp_path / "tok.npy",
            np.random.default_rng(1).integers(0, 100, (50, 12)))
    for extra in ({}, {"host_index": 1, "host_count": 2},
                  {"token_file": str(tmp_path / "tok.npy")}):
        jd = j_data.CalibDataset(j_data.CalibConfig(**kw, **extra))
        td = t_data.CalibDataset(t_data.CalibConfig(**kw, **extra))
        assert td.steps_per_epoch == jd.steps_per_epoch
        for _ in range(9):
            np.testing.assert_array_equal(next(td)["tokens"],
                                          next(jd)["tokens"])
        jd.skip_to(4)
        td.skip_to(4)
        for _ in range(3):
            np.testing.assert_array_equal(next(td)["tokens"],
                                          next(jd)["tokens"])


# ---------------------------------------------------------- calibration


@pytest.mark.parametrize("per_channel", [None, False])
def test_stream_params_from_range_matches_jax(per_channel):
    rng = np.random.default_rng(2)
    lo = (-np.abs(rng.normal(size=24)) * 2).astype(np.float32)
    hi = (np.abs(rng.normal(size=24)) * 3).astype(np.float32)
    lo[3], hi[3] = 0.0, 0.0               # a dead channel: the 1e-3 floor
    hi[5] = -0.5                          # a channel entirely below zero
    jq, tq = JQ(), TQ()
    j = j_cal.stream_params_from_range(jnp.asarray(lo), jnp.asarray(hi), jq,
                                       per_channel)
    t = t_cal.stream_params_from_range(_t(lo), _t(hi), tq, per_channel)
    _rel(t["log_sa"].numpy(), np.asarray(j["log_sa"]), 1e-6)
    np.testing.assert_array_equal(t["zp"].numpy(), np.asarray(j["zp"]))


def test_teacher_taps_match_jax():
    """The f32 teacher forward's taps: the JAX tap names, values to 1e-5;
    and the calibration the trainer derives from them."""
    jp = j_init_model(jax.random.PRNGKey(4), J_SMOKE, None)
    tp = _torch_tree(jp)
    toks = np.random.default_rng(5).integers(0, J_SMOKE.vocab, (2, 12))
    jcfg = dataclasses.replace(J_SMOKE, scan_layers=False, remat=False)
    jt = j_forward(jp, jcfg, None, {"tokens": jnp.asarray(toks)},
                   collect_taps=True, compute_dtype=jnp.float32)["taps"]
    with torch.no_grad():
        tt = forward(tp, T_SMOKE, None, {"tokens": _t(toks)},
                     collect_taps=True, compute_dtype=torch.float32,
                     logits=False)["taps"]
    assert sorted(tt) == sorted(jt) and "L1.attn.pre_o" in tt
    for name in jt:
        for stat in ("min", "max", "mean"):
            np.testing.assert_allclose(tt[name][stat].numpy(),
                                       np.asarray(jt[name][stat]),
                                       rtol=1e-5, atol=1e-5)
    j = j_cal.calibrate_streams(
        lambda p, b: (None, {k: v["max"][None] for k, v in
                             j_forward(p, jcfg, None, b, collect_taps=True,
                                       compute_dtype=jnp.float32)
                             ["taps"].items()}),
        jp, [{"tokens": jnp.asarray(toks)}], JQ())
    t = t_cal.calibrate_streams(
        lambda p, b: (None, {k: v["max"][None] for k, v in
                             forward(p, T_SMOKE, None, b, collect_taps=True,
                                     compute_dtype=torch.float32,
                                     logits=False)["taps"].items()}),
        tp, [{"tokens": _t(toks)}], TQ())
    for name in j:
        _rel(t[name]["log_sa"].numpy(), np.asarray(j[name]["log_sa"]), 1e-5)


# ------------------------------------------------------------ scale init


def _f1_matrix():
    """The stored Hypothesis example of the reference's red test F1
    (test_apq_improves_over_max_init, seed 695)."""
    seed = 695
    w = (jax.random.normal(jax.random.PRNGKey(seed), (16, 12))
         * jnp.exp(jax.random.normal(jax.random.PRNGKey(seed + 1), (16, 1))))
    return np.asarray(w)


@pytest.mark.parametrize("layout", ["channel", "layerwise", "group:32",
                                    "stacked", "f1"])
def test_mmse_and_apq_init_match_jax(layout):
    rng = np.random.default_rng(6)
    if layout == "f1":
        w = _f1_matrix()
        spec = "channel"
    else:
        shape = (3, 64, 48) if layout == "stacked" else (64, 48)
        w = (rng.normal(size=shape) * np.exp(rng.normal(size=shape[:-1]
                                                        + (1,)))
             ).astype(np.float32)
        spec = "channel" if layout == "stacked" else layout
    d_in, d_out = w.shape[-2:]
    jq, tq = JQ(w_layout=spec), TQ(w_layout=spec)
    swr = jq.layout.swr_shape(d_in, d_out)
    lead = w.shape[:-2]
    p = {"w": w, "log_swr": np.zeros(lead + swr, np.float32)}
    log_sa = (rng.normal(size=lead + (d_in,)) * 0.2 - 3).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = from_numpy_tree(p, "cpu")
    for bits in (4, 8):
        j = j_dof.mmse_init_qlinear(jp, jq, bits=bits,
                                    log_sa_in=jnp.asarray(log_sa))
        t = t_dof.mmse_init_qlinear(tp, tq, bits=bits, log_sa_in=_t(log_sa))
        _close_log(t["log_swr"].numpy(), j["log_swr"], "mmse")
        (j2, jl), (t2, tl) = (j_dof.apq_init_qlinear(jp, jq, bits=bits),
                              t_dof.apq_init_qlinear(tp, tq, bits=bits))
        _close_log(t2["log_swr"].numpy(), j2["log_swr"], "apq")
        _close_log(tl.numpy(), jl, "apq log_swl")


@pytest.mark.parametrize("bits_next", [4, 8, 2])
def test_cle_factors_match_jax(bits_next):
    """Eq. 21 with β from the bit widths (0, +½, −½) and a weighted fan-out
    of two consumers."""
    rng = np.random.default_rng(7)
    w_prev = (rng.normal(size=(32, 24)) * np.exp(rng.normal(size=(1, 24)))
              ).astype(np.float32)
    nxt = [(rng.normal(size=(24, n)) * np.exp(rng.normal(size=(24, 1))))
           .astype(np.float32) for n in (16, 40)]
    kw = dict(bits_prev=4, bits_next_list=[bits_next] * 2,
              fanout_weights=[0.25, 0.75])
    j = j_cle.cle_factors(jnp.asarray(w_prev), [jnp.asarray(w) for w in nxt],
                          cfg=JQ(), **kw)
    t = t_cle.cle_factors(_t(w_prev), [_t(w) for w in nxt], cfg=TQ(), **kw)
    _close_log(t.numpy(), j, "log C")
    _close_log(t_cle.apply_cle_to_stream(_t(np.ones(24, np.float32)),
                                         t).numpy(),
               j_cle.apply_cle_to_stream(jnp.ones(24), j), "apply")


def test_cle_init_student_matches_jax():
    """The trainer's cle_init (β = −1 on the norm-gain pivot) on a
    prepared student: every in_stream's log_sa as JAX skews it."""
    jq, tq, _, jstudent, _ = _prepared("dchw")
    j = j_cle_init(jstudent, J_SMOKE, jq)
    t = cle_init_student(_torch_tree(jstudent), T_SMOKE, tq)
    for mod in ("attn", "mlp"):
        _close_log(t["layers"][mod]["in_stream"]["log_sa"].numpy(),
                   j["layers"][mod]["in_stream"]["log_sa"], mod)


# ------------------------------------------------------- the student step


@functools.lru_cache(maxsize=None)
def _prepared(name, eager=False):
    """A calibrated, MMSE/APQ-initialised JAX student (the JAX trainer's
    prepare_student, under jit unless ``eager``) with its teacher, the
    next batch and both qcfgs.  Under jit XLA rounds the teacher's bf16
    taps elsewhere than the eager trainer, which moves a zero-point."""
    jq, tq = _qcfgs(name)
    teacher = j_init_model(jax.random.PRNGKey(0), J_SMOKE, None)
    jd, _ = _data()
    calib = [{"tokens": jnp.asarray(next(jd)["tokens"])} for _ in range(2)]
    tr = JQFTTrainer(J_SMOKE, jq, teacher, JQFTConfig(),
                     steps_per_epoch=STEPS_PER_EPOCH)
    prepare = tr.prepare_student if eager else jax.jit(tr.prepare_student)
    student = prepare(jax.random.PRNGKey(1), calib)
    batch = next(jd)["tokens"]
    return jq, tq, teacher, student, batch


def _jax_step(name, microbatches, freeze, compute_dtype, monkeypatch,
              ce=0.0):
    """The JAX package's own make_train_step, its post-mask gradients
    captured through the grad_compress hook; with ``monkeypatch`` its
    forward runs at ``compute_dtype`` (else at its bf16 default)."""
    jq, _, teacher, student, batch = _prepared(name)
    if monkeypatch is not None:
        monkeypatch.setattr(j_steps, "forward", functools.partial(
            j_forward, compute_dtype=compute_dtype))
    captured = {}

    def capture(grads, opt_state):
        captured["g"] = grads
        return grads, opt_state

    mask = None
    if freeze:
        mask = JQFTTrainer(J_SMOKE, jq, teacher,
                           JQFTConfig(freeze_scales=True))._grad_mask
    opt = j_adam.paper_recipe(STEPS_PER_EPOCH)
    plan = j_resolve_plan(jq, student, model_cfg=J_SMOKE)
    step = j_steps.make_train_step(J_SMOKE, jq, opt, ce_proportion=ce,
                                   grad_mask=mask, grad_compress=capture,
                                   microbatches=microbatches, plan=plan)

    def run(*args):          # the captured gradients leave the trace
        new, _, metrics = step(*args)
        return new, metrics, captured["g"]

    new, metrics, grads = jax.jit(run)(student, opt.init(student), teacher,
                                       {"tokens": jnp.asarray(batch)})
    return metrics, grads, new


def _port_step(name, microbatches, freeze, compute_dtype, ce=0.0):
    """The port's value_and_grad (post-mask) and make_train_step on the
    same converted student, teacher and batch."""
    _, tq, teacher, student, batch = _prepared(name)
    ts, tt = _torch_tree(student), _torch_tree(teacher)
    mask = QFTTrainer(T_SMOKE, tq, tt,
                      QFTConfig(freeze_scales=freeze))._grad_mask
    kw = dict(ce_proportion=ce, microbatches=microbatches,
              plan=resolve_plan(tq, ts, model_cfg=T_SMOKE),
              compute_dtype=compute_dtype)
    tbatch = {"tokens": _t(batch)}
    loss, grads = make_value_and_grad(T_SMOKE, tq, **kw)(ts, tt, tbatch)
    if mask is not None:
        grads = tree_from_items((p, None if g is None else mask(p, g))
                                for p, g in tree_items(grads))
    opt = t_adam.paper_recipe(STEPS_PER_EPOCH)
    step = make_train_step(T_SMOKE, tq, opt, grad_mask=mask, **kw)
    new, _, metrics = step(ts, opt.init(ts), tt, tbatch)
    return loss, grads, metrics, new


def _assert_grads_close(tgrads, jgrads, rtol, floor):
    """Per leaf: ||g_t − g_j|| <= rtol·(||g_j|| + floor·||G_j||), ||G_j||
    the whole gradient's norm.  The floor lets through a leaf whose true
    gradient cancels to zero (a zero-point where nothing clips: JAX sums
    its two paths apart and leaves rounding noise, the port gets 0)."""
    jg = dict(tree_items(_torch_tree(jgrads)))
    gnorm = float(sum(float((g.double() ** 2).sum())
                      for g in jg.values())) ** 0.5
    assert gnorm > 0
    for path, g in tree_items(tgrads):
        ref = jg[path].double()
        if g is None:
            assert float(ref.abs().max()) == 0.0, path
            continue
        err = float((g.double() - ref).norm())
        assert err <= rtol * (float(ref.norm()) + floor * gnorm), (
            path, err, float(ref.norm()), gnorm)


@pytest.mark.parametrize("qname", list(QCFGS))
@pytest.mark.parametrize("microbatches,freeze", [(1, False), (2, True)])
def test_student_step_f32_matches_jax(qname, microbatches, freeze,
                                      monkeypatch):
    """Loss and gradients of one step in f32 compute against the JAX step
    (1e-6 on the loss, each gradient leaf 1e-4 relative L2), with
    microbatches and the freeze_scales mask; the update leaves frozen
    scales as they were."""
    jm, jgrads, _ = _jax_step(qname, microbatches, freeze, jnp.float32,
                              monkeypatch)
    loss, grads, metrics, new = _port_step(qname, microbatches, freeze,
                                           torch.float32)
    _rel(float(loss), float(jm["loss"]), 1e-6, "loss")
    assert float(metrics["loss"]) == float(loss)
    _rel(float(metrics["grad_norm"]), float(jm["grad_norm"]), 1e-4)
    _assert_grads_close(grads, jgrads, 1e-4, 1e-3)
    # lm_head and head_stream: no gradient when the loss is backbone-L2
    assert grads["lm_head"]["w"] is None and \
        grads["head_stream"]["log_sa"] is None
    ref = _torch_tree(_prepared(qname)[3])
    for path, leaf in tree_items(new):
        before = functools.reduce(lambda t, k: t[k], path, ref)
        if freeze and path[-1] in ("log_swr", "log_sa", "zp", "log_s"):
            assert torch.equal(leaf, before), path
        elif path[-2:] == ("up", "w"):
            assert not torch.equal(leaf, before)


def test_student_step_with_ce_matches_jax(monkeypatch):
    """The Fig. 6 mix-in (ce_proportion 0.3): the head runs and the lm_head
    and head_stream get gradients, held as the backbone-only step."""
    jm, jgrads, _ = _jax_step("channel", 1, False, jnp.float32, monkeypatch,
                              ce=0.3)
    loss, grads, metrics, _ = _port_step("channel", 1, False, torch.float32,
                                         ce=0.3)
    _rel(float(loss), float(jm["loss"]), 1e-6, "loss")
    _rel(float(metrics["grad_norm"]), float(jm["grad_norm"]), 1e-4)
    _assert_grads_close(grads, jgrads, 1e-4, 1e-3)
    assert float(grads["lm_head"]["w"].abs().max()) > 0


def test_shipped_bf16_train_step_close_to_jax():
    """The shipped step (bf16 compute) against JAX's.  The two packages
    round bf16 in different places, and an 8-bit activation grid turns a
    rounding difference into a whole step, so they are held loosely: the
    loss to 1e-2 relative, the gradient norm to 2e-2, each gradient leaf
    to 0.15 relative L2 (measured on this case: 1.9e-3, 6.4e-3 and at most
    0.075)."""
    jm, jgrads, _ = _jax_step("channel", 1, False, jnp.bfloat16, None)
    loss, grads, metrics, _ = _port_step("channel", 1, False, torch.bfloat16)
    _rel(float(loss), float(jm["loss"]), 1e-2, "loss")
    _rel(float(metrics["grad_norm"]), float(jm["grad_norm"]), 2e-2)
    _assert_grads_close(grads, jgrads, 0.15, 1e-3)


def _degradation(student, teacher, qcfg, tokens):
    with torch.no_grad():
        hs = forward(student, T_SMOKE, qcfg, {"tokens": tokens},
                     logits=False)["hidden"]
        ht = forward(teacher, T_SMOKE, None, {"tokens": tokens},
                     logits=False)["hidden"]
    return float(backbone_l2(hs, ht))


def test_qft_trainer_prepare_matches_jax():
    """prepare_student (build → calibrate → APQ init) equals the JAX
    trainer's: weights bit-equal, log-scale leaves 1e-6; a zero-point
    within 1, since calibration reads the teacher's bf16 taps, which the
    two packages round in different places."""
    _, tq, jteacher, jstudent, _ = _prepared("dchw", eager=True)
    _, td = _data()
    tr = QFTTrainer(T_SMOKE, tq, _torch_tree(jteacher), QFTConfig(),
                    steps_per_epoch=STEPS_PER_EPOCH)
    student = tr.prepare_student(1, [next(td) for _ in range(2)])
    ref = dict(tree_items(_torch_tree(jstudent)))
    assert sorted(p for p, _ in tree_items(student)) == sorted(ref)
    for path, leaf in tree_items(student):
        if path[-1] == "zp":
            assert float((leaf - ref[path]).abs().max()) <= 1.0, path
        elif path[-1] in ("w", "g"):
            assert torch.equal(leaf, ref[path]), path
        else:
            _close_log(leaf.numpy(), ref[path].numpy(), path)


@pytest.mark.parametrize("freeze", [False, True])
def test_qft_trainer_run_reduces_distillation_loss(freeze):
    """prepare_student + 2 run steps on one repeated batch (the W4A8
    channel student): finite losses, the distillation loss on that batch
    falls by over 10 % (measured: 35 %), and freeze_scales trains the
    weights only.  (Over the shuffled stream, 2 steps of the paper's lr
    move a 64-wide student too little to show a fall: the JAX trainer's
    fixed-batch loss goes up there too, and both fall after 8 steps.)"""
    _, tq, jteacher, _, _ = _prepared("channel")
    tt = _torch_tree(jteacher)
    _, td = _data()
    calib = [next(td) for _ in range(2)]
    tr = QFTTrainer(T_SMOKE, tq, tt, QFTConfig(freeze_scales=freeze),
                    steps_per_epoch=STEPS_PER_EPOCH)
    student = tr.prepare_student(1, calib)
    fixed = _t(calib[0]["tokens"])
    d0 = _degradation(student, tt, tq, fixed)
    before = {p: t.clone() for p, t in tree_items(student)}
    student, hist = tr.run(student, itertools.repeat(calib[0]), steps=2,
                           log_every=1)
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[1]["loss"] < hist[0]["loss"]
    assert _degradation(student, tt, tq, fixed) < 0.9 * d0
    for path, leaf in tree_items(student):
        assert not leaf.requires_grad
        if path[0] in ("lm_head", "head_stream"):
            # no gradient reaches the head: Adam moves it by exactly 0
            assert torch.equal(leaf, before[path]), path
        elif path[-1] == "zp":
            # its gradient is exactly 0 unless an activation clips
            assert torch.equal(leaf, before[path]) or not freeze, path
        elif path[-1] in ("log_swr", "log_sa", "log_s"):
            assert torch.equal(leaf, before[path]) == freeze, path


def test_qft_config_field_for_field():
    """F14: QFTConfig field for field the JAX one (``epochs`` included,
    default 12, read by no stage in either package)."""
    jf = [(f.name, f.default) for f in dataclasses.fields(JQFTConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(QFTConfig)] == jf
    assert QFTConfig(epochs=4).epochs == JQFTConfig(epochs=4).epochs == 4
