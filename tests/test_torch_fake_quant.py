"""repro_torch's fake-quant against the JAX package: the clip gradient at the
grid bounds (the port once clipped with ``torch.clamp``, which passes the
whole gradient where ``jnp.clip`` passes half), and the ``fake_quant``
kernel's plain forward and both backward rules against the Pallas kernel
(interpret mode) and against ``jax.grad`` of the plain composition; the
factored entry's plain version and ``effective_weight`` on the CPU against
``repro.core.dof.effective_weight`` and its ``jax.grad`` at every layout,
with and without a stream, on a 2-D and a stacked weight, f32 and bf16
compute.

Inputs are made with numpy from a seed and go through both packages; the
forward is bit-equal, ``gx`` bit-equal, reduced scale gradients agree to
1e-6 relative (summation order), by the size of their terms where a sum
cancels.  XLA's and PyTorch's ``exp`` differ by an ulp at about one input
in ten, so the bit-equal comparisons feed both packages the same scale
factors, and ``effective_weight`` (which takes the exponentials itself) is
held to 1e-6 of the largest value.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import dof as j_dof  # noqa: E402
from repro.core import fakequant as j_fq  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.kernels import fake_quant_kernel as j_fq_kernel  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.core import dof as t_dof  # noqa: E402
from repro_torch.core import fakequant as t_fq  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.kernels.fake_quant import (  # noqa: E402
    factored_geometry, fake_quant_factored, fake_quant_kernel)

GS_RTOL = 1e-6

# the bound points: x/s = 6.9 and 7.2 round onto +7, -7.2 onto -7, 7.6 and
# 8.0 round past the grid, 3.3 and 0.2 are inside
SIGNED_X = [6.9, 7.0, 7.2, 7.6, -7.2, 3.3, 0.2, 8.0]
# unsigned 8-bit grid with zero-point 3: x/s + 3 lands on 0 (-3.2, -3.0,
# -2.9), on 255 (252.0, 251.6), past it (253.0, -4.0) and inside (10.2)
UNSIGNED_X = [-3.2, -3.0, -2.9, 252.0, 251.6, 253.0, -4.0, 10.2]


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(
        requires_grad)


def _assert_rel(a, b, rtol, scale=None):
    """max|a - b| <= rtol * scale, scale = max|b| unless given."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if scale is None:
        scale = max(float(np.max(np.abs(b))), 1e-30)
    assert float(np.max(np.abs(a - b))) <= rtol * scale, (a, b)


@pytest.mark.parametrize("signed", [True, False], ids=["signed4", "unsigned8"])
def test_clip_gradient_at_bounds_matches_jax(signed):
    """The port's plain fake_quant differentiates like jax.grad of the JAX
    one, also where round(x/s) (+zp) lands exactly on a clip bound."""
    x = np.array(SIGNED_X if signed else UNSIGNED_X, np.float32)
    g = np.arange(1, len(x) + 1, dtype=np.float32)
    s = np.float32(1.0)
    zp = None if signed else np.float32(3.0)
    bits = 4 if signed else 8

    def j_loss(x_, s_, zp_):
        y = (j_fq.fake_quant(x_, s_, bits) if signed
             else j_fq.fake_quant_act(x_, s_, bits, zero_point=zp_))
        return jnp.sum(y * g)

    jgrads = jax.grad(j_loss, (0, 1, 2))(jnp.asarray(x), jnp.asarray(s),
                                         jnp.asarray(zp if zp is not None
                                                     else 0.0))
    xt, st = _t(x, True), _t(s, True)
    zt = None if signed else _t(zp, True)
    y = (t_fq.fake_quant(xt, st, bits) if signed
         else t_fq.fake_quant_act(xt, st, bits, zero_point=zt))
    (y * _t(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrads[0]))
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jgrads[1]),
                               rtol=GS_RTOL)
    if not signed:
        np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jgrads[2]),
                                   rtol=GS_RTOL)
    # the bound points really are in the sample: half the gradient passes
    ratio = np.round(x / s) + (0 if zp is None else zp)
    on_bound = np.isin(ratio, [-7, 7] if signed else [0, 255])
    assert on_bound.sum() >= 3
    np.testing.assert_array_equal(xt.grad.numpy()[on_bound], g[on_bound] / 2)


def _case(R, C, scale_shape, bits, seed, dtype=np.float32):
    """x with a share of elements exactly on (and half an ulp of the grid
    around) the clip bounds, a positive scale of ``scale_shape`` and an
    upstream gradient."""
    rng = np.random.default_rng(seed)
    qmax = 2 ** (bits - 1) - 1
    s = np.exp(rng.normal(size=scale_shape) * 0.3).astype(np.float32) * 0.05
    sb = np.broadcast_to(s, (R, C))
    ratio = rng.normal(size=(R, C)) * qmax * 0.6
    special = rng.choice([qmax - 0.5, qmax, qmax + 0.4, qmax + 0.5,
                          qmax + 2.0], size=(R, C))
    ratio = np.where(rng.random((R, C)) < 0.25,
                     special * rng.choice([-1, 1], size=(R, C)), ratio)
    x = (ratio * sb).astype(dtype)
    g = rng.normal(size=(R, C)).astype(dtype)
    return x, s, g


SCALES = {"full": lambda R, C: (R, C), "row": lambda R, C: (R, 1),
          "col": lambda R, C: (1, C)}


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_bit_equal_to_pallas_kernel(bits, scale, dtype):
    R, C = 64, 96
    x, s, _ = _case(R, C, SCALES[scale](R, C), bits, seed=bits)
    jx = jnp.asarray(x).astype(dtype)
    jy = j_fq_kernel(jx, jnp.asarray(s), bits, 256, 256, True)
    xt = _t(x).to(getattr(torch, dtype))
    yt = fake_quant_kernel(xt, _t(s), bits)
    assert yt.dtype == xt.dtype
    np.testing.assert_array_equal(yt.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    np.testing.assert_array_equal(
        t_ref.fake_quant_ref(xt, _t(s), bits).float().numpy(),
        np.asarray(j_ref.fake_quant_ref(jx, jnp.asarray(s), bits)
                   .astype(jnp.float32)))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("scale", list(SCALES))
def test_kernel_rule_matches_pallas_vjp(bits, scale):
    """rule="kernel" is the Pallas kernel's custom VJP (_fq_bwd)."""
    R, C = 64, 96
    x, s, g = _case(R, C, SCALES[scale](R, C), bits, seed=10 + bits)
    jgx, jgs = jax.grad(
        lambda x_, s_: jnp.sum(j_fq_kernel(x_, s_, bits, 256, 256, True) * g),
        (0, 1))(jnp.asarray(x), jnp.asarray(s))
    xt, st = _t(x, True), _t(s, True)
    (fake_quant_kernel(xt, st, bits, rule="kernel") * _t(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgx))
    assert st.grad.shape == st.shape
    _assert_rel(st.grad.numpy(), np.asarray(jgs), GS_RTOL)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("scale", list(SCALES) + ["scalar"])
def test_ste_rule_matches_jax_grad_of_composition(bits, scale):
    """rule="ste" is jax.grad of core.fakequant.fake_quant — the gradient
    the QFT trainer takes — and the port's plain autograd agrees."""
    R, C = 64, 96
    shape = () if scale == "scalar" else SCALES[scale](R, C)
    x, s, g = _case(R, C, shape, bits, seed=20 + bits)
    jgx, jgs = jax.grad(
        lambda x_, s_: jnp.sum(j_fq.fake_quant(x_, s_, bits) * g),
        (0, 1))(jnp.asarray(x), jnp.asarray(s))
    # one sum over all R*C terms cancels heavily: hold the scalar to the
    # size of its terms (sum of |terms|), the others to their own size
    mag = None
    if scale == "scalar":
        _, terms = t_ref.fake_quant_grad_ref(
            _t(g), _t(x), _t(np.broadcast_to(s, (R, C))), bits, "ste")
        mag = float(terms.abs().sum())
    for route in ("kernel_fn", "plain"):
        xt, st = _t(x, True), _t(s, True)
        y = (fake_quant_kernel(xt, st, bits, rule="ste")
             if route == "kernel_fn" else t_fq.fake_quant(xt, st, bits))
        (y * _t(g)).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgx))
        assert st.grad.shape == st.shape
        _assert_rel(st.grad.numpy(), np.asarray(jgs), GS_RTOL, mag)


def test_the_two_rules_differ_between_half_steps():
    """F6: the reference disagrees with itself — _fq_bwd's hard indicator
    and the composition's gradient differ for |x/s| in [qmax-½, qmax+½)."""
    x = np.array([[6.4, 6.6, 7.0, 7.4, 7.6, -6.6, -7.4]], np.float32)
    s = np.ones((1, 1), np.float32)
    out = {}
    for rule in ("kernel", "ste"):
        gx, _ = t_ref.fake_quant_grad_ref(_t(np.ones_like(x)), _t(x), _t(s),
                                          4, rule)
        out[rule] = gx.numpy()[0]
    np.testing.assert_array_equal(out["kernel"], [1, 1, 1, 0, 0, 1, 0])
    np.testing.assert_array_equal(out["ste"], [1, .5, .5, .5, 0, .5, .5])


def test_fused_fake_quant_matches_jax_ops():
    """ops.fused_fake_quant: the kernel route (the "kernel" gradient rule)
    and the plain route, against the JAX wrapper in interpret mode."""
    R, C, bits = 32, 64, 4
    x, s, g = _case(R, C, (1, C), bits, seed=3)
    for use in (True, False):
        def j_loss(x_, s_):
            return jnp.sum(j_ops.fused_fake_quant(
                x_, s_, bits, use_pallas=use, interpret=True) * g)
        jy = j_ops.fused_fake_quant(jnp.asarray(x), jnp.asarray(s), bits,
                                    use_pallas=use, interpret=True)
        jgx, jgs = jax.grad(j_loss, (0, 1))(jnp.asarray(x), jnp.asarray(s))
        xt, st = _t(x, True), _t(s, True)
        y = t_ops.fused_fake_quant(xt, st, bits, use_kernels=use)
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
        (y * _t(g)).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgx))
        _assert_rel(st.grad.numpy(), np.asarray(jgs), GS_RTOL)


def test_effective_weight_takes_the_plain_route_on_the_cpu():
    """On CPU tensors weight_fake_quant is the plain composition, kernels
    asked for or not, and the launch counters do not move."""
    x, s, _ = _case(16, 32, (16, 32), 4, seed=5)
    before = (fake_quant_kernel.launches_fwd, fake_quant_kernel.launches_bwd)
    a = t_dof.weight_fake_quant(_t(x), _t(s), 4, use_kernels=True)
    b = t_fq.fake_quant(_t(x), _t(s), 4)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (fake_quant_kernel.launches_fwd,
            fake_quant_kernel.launches_bwd) == before


def test_wrapper_refuses_what_it_cannot_take():
    x = torch.zeros((4, 6))
    with pytest.raises(ValueError, match="does not broadcast"):
        fake_quant_kernel(x, torch.ones((4, 3)))
    with pytest.raises(ValueError, match="2-D"):
        fake_quant_kernel(torch.zeros((2, 4, 6)), torch.ones(()))
    with pytest.raises(ValueError, match="rule"):
        fake_quant_kernel(x, torch.ones(()), rule="lsq")


# ---------------------------------------------------------------------------
# the factored entry: S_wL ⊗ S_wR formed in the kernel, bf16 out
# ---------------------------------------------------------------------------

K, N, E, GROUP = 64, 24, 3, 16
LAYOUTS = ("channel", "group", "layerwise")


def _factored_case(layout, stream, stacked, seed):
    """w [E?, K, N] near an MMSE-like grid (a quarter of its elements on
    and half a step around the clip bounds), log_sa [K] (shared by the
    stacked axis) or None, log_swr in the layout's shape, an upstream
    gradient; numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    lead = (E,) if stacked else ()
    swr_shape = lead + {"channel": (N,), "group": (K // GROUP, N),
                        "layerwise": ()}[layout]
    log_swr = (rng.normal(size=swr_shape) * 0.3 - 3.0).astype(np.float32)
    log_sa = ((rng.normal(size=(K,)) * 0.3 + 1.0).astype(np.float32)
              if stream else None)
    s_wr = np.exp(log_swr.astype(np.float64))
    s_wr = (s_wr[..., None, None] if layout == "layerwise" else
            s_wr[..., None, :] if layout == "channel" else
            np.repeat(s_wr, GROUP, axis=-2))
    s = s_wr * (1.0 if log_sa is None else np.exp(-log_sa)[:, None])
    shape = lead + (K, N)
    ratio = rng.normal(size=shape) * 7 * 0.6
    special = rng.choice([6.5, 7.0, 7.4, 7.5, 9.0], size=shape)
    ratio = np.where(rng.random(shape) < 0.25,
                     special * rng.choice([-1, 1], size=shape), ratio)
    w = (ratio * s).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return w, log_sa, log_swr, g


CASES = [(lay, st, sk, dt) for lay in LAYOUTS for st in (True, False)
         for sk in (False, True) for dt in ("float32", "bfloat16")]
CASE_IDS = [f"{lay}-{'stream' if st else 'nostream'}-"
            f"{'stacked' if sk else '2d'}-{dt}" for lay, st, sk, dt in CASES]


@functools.lru_cache(maxsize=None)
def _jax_effective_weight(layout, stream, stacked, dtype):
    """JAX's effective_weight on the case and jax.grad of
    ``sum(y.astype(f32) * g)`` with respect to w, log_swr and log_sa, with
    the factors it forms (``exp(-log_sa)``, ``exp(log_swr)``), as numpy."""
    w, log_sa, log_swr, g = _factored_case(layout, stream, stacked,
                                           seed=LAYOUTS.index(layout))
    jdt = getattr(jnp, dtype)

    def f(w_, lswr, lsa):
        p = {"w": w_, "log_swr": lswr}
        return j_dof.effective_weight(p, JQ(), lsa if stream else None,
                                      compute_dtype=jdt, bits=4)

    lsa = jnp.asarray(log_sa if stream else np.zeros((K,), np.float32))
    args = (jnp.asarray(w), jnp.asarray(log_swr), lsa)
    y = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a).astype(jnp.float32) * g),
                     (0, 1, 2))(*args)
    s_wl = np.asarray(jnp.exp(-lsa)) if stream else None
    s_wr = np.asarray(jnp.exp(jnp.asarray(log_swr)))
    return (w, log_sa, log_swr, g, s_wl, s_wr,
            np.asarray(y.astype(jnp.float32)),
            tuple(np.asarray(a) for a in grads))


def _factored_run(w, s_wl, s_wr, g, dtype, fn):
    """``fn(w, s_wl, s_wr)`` on torch leaves → (y as f32, gw, gs_wl,
    gs_wr) of ``sum(y.float() * g)``."""
    wt, wrt = _t(w, True), _t(s_wr, True)
    wlt = None if s_wl is None else _t(s_wl, True)
    y = fn(wt, wlt, wrt)
    assert y.dtype == getattr(torch, dtype)
    (y.float() * _t(g)).sum().backward()
    return (y.detach().float().numpy(), wt.grad.numpy(),
            None if wlt is None else wlt.grad.numpy(), wrt.grad.numpy())


def _term_sizes(w, s_wl, s_wr, g, dtype, terms=None):
    """Σ|term| of each entry of the two scale gradients: the per-element
    LSQ terms (``fake_quant_grad_ref``, "ste", at the full scale) in
    absolute value, or the given per-element ``terms``, times the other
    factor, summed as the gradient sums them — the size a cancelling sum
    is held to."""
    wt, wrt = _t(w), _t(s_wr, True)
    wlt = None if s_wl is None else _t(s_wl, True)
    s_full = torch.broadcast_to(t_ref.factored_scale(wt.shape, wlt, wrt),
                                wt.shape)
    if terms is None:
        g_eff = _t(g).to(getattr(torch, dtype)).float()
        _, terms = t_ref.fake_quant_grad_ref(g_eff, wt, s_full.detach(), 4,
                                             "ste")
        terms = terms.abs()
    sizes = torch.autograd.grad((s_full * terms).sum(),
                                [t for t in (wlt, wrt) if t is not None])
    if wlt is None:
        return None, sizes[0].numpy()
    return sizes[0].numpy(), sizes[1].numpy()


def _same_factors(w_shape, t_wl, t_wr, j_wl, j_wr):
    """Elements of the weight whose two factors are the same bits in both
    packages (so is their scale)."""
    def mask(t, j):
        return None if t is None else _t(np.asarray(t == j, np.float32))
    both = t_ref.factored_scale(w_shape, mask(t_wl, j_wl), mask(t_wr, j_wr))
    return torch.broadcast_to(both, w_shape).numpy() == 1


def _assert_by_terms(got, want, sizes, rtol=GS_RTOL):
    """|got − want| <= rtol · (Σ|term| of the entry), entrywise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bad = np.abs(got - want) > rtol * np.asarray(sizes, np.float64)
    assert not bad.any(), (got[bad], want[bad])


@pytest.mark.parametrize("layout,stream,stacked,dtype", CASES, ids=CASE_IDS)
def test_factored_plain_version_matches_jax(layout, stream, stacked, dtype):
    """The factored entry's plain version (the CPU route of
    ``fake_quant_factored``) against ``repro.core.dof.effective_weight``
    fed the same factors: y and gx bit-equal, the gradients of log_swr
    and log_sa (through ``exp``: ``gs_wr·s_wr`` and ``−gs_wl·s_wl``)
    within 1e-6 of their terms' size."""
    (w, _lsa, _lswr, g, s_wl, s_wr, jy, (jgw, jglswr, jglsa)) = \
        _jax_effective_weight(layout, stream, stacked, dtype)
    out_dtype = getattr(torch, dtype)
    y, gw, gs_wl, gs_wr = _factored_run(
        w, s_wl, s_wr, g, dtype,
        lambda a, b, c: fake_quant_factored(a, b, c, 4, out_dtype))
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(gw, jgw)
    size_wl, size_wr = _term_sizes(w, s_wl, s_wr, g, dtype)
    _assert_by_terms(gs_wr * s_wr, jglswr, size_wr * s_wr)
    if stream:
        _assert_by_terms(-gs_wl * s_wl, jglsa, size_wl * s_wl)
    else:
        assert gs_wl is None and not np.any(jglsa)


@pytest.mark.parametrize("layout,stream,stacked,dtype", CASES, ids=CASE_IDS)
def test_effective_weight_on_the_cpu_matches_jax(layout, stream, stacked,
                                                 dtype):
    """``core.dof.effective_weight`` with ``use_kernels`` on CPU tensors
    (the plain composition, its own ``exp``s), and no launch counter moves:

    - bit for bit the factored plain version fed those ``exp``s (y, gx
      and the log-scale gradients);
    - against JAX's and its ``jax.grad``: y and gx bit-equal on every
      element whose two factors came out of both packages' ``exp`` as the
      same bits; elsewhere an ulp in the scale may move ``w/s`` across a
      half step, so y within one step of the grid there (and two bf16
      roundings);
      the log-scale gradients within 1e-6 of their terms' size plus the
      bound of the terms of those elements (|g|·(2·qmax + 2))."""
    (w, log_sa, log_swr, g, j_wl, j_wr, jy, (jgw, jglswr, jglsa)) = \
        _jax_effective_weight(layout, stream, stacked, dtype)
    out_dtype = getattr(torch, dtype)
    before = (fake_quant_kernel.launches_fwd, fake_quant_kernel.launches_bwd)
    wt, lswr = _t(w, True), _t(log_swr, True)
    lsa = _t(log_sa, True) if stream else None
    y = t_dof.effective_weight({"w": wt, "log_swr": lswr}, TQ(), lsa,
                               compute_dtype=out_dtype, bits=4,
                               use_kernels=True)
    (y.float() * _t(g)).sum().backward()
    assert (fake_quant_kernel.launches_fwd,
            fake_quant_kernel.launches_bwd) == before
    y = y.detach().float().numpy()
    s_wl = None if lsa is None else torch.exp(-lsa).detach().numpy()
    s_wr = torch.exp(lswr).detach().numpy()
    # the factored plain version on the same factors, bit for bit
    ry, rgw, rgwl, rgwr = _factored_run(
        w, s_wl, s_wr, g, dtype,
        lambda a, b, c: t_ref.fake_quant_factored_ref(a, b, c, 4, out_dtype))
    np.testing.assert_array_equal(y, ry)
    np.testing.assert_array_equal(wt.grad.numpy(), rgw)
    np.testing.assert_array_equal(lswr.grad.numpy(), rgwr * s_wr)
    if stream:
        np.testing.assert_array_equal(lsa.grad.numpy(), -(rgwl * s_wl))
    # JAX's effective_weight
    same = _same_factors(w.shape, s_wl, s_wr, j_wl, j_wr)
    np.testing.assert_array_equal(y[same], jy[same])
    np.testing.assert_array_equal(wt.grad.numpy()[same], jgw[same])
    step = np.broadcast_to(t_ref.factored_scale(
        w.shape, None if s_wl is None else _t(s_wl), _t(s_wr)).numpy(),
        w.shape)
    # one step, and each side's rounding to bf16 of a value <= 8 steps
    assert np.all(np.abs(y - jy)[~same] <= step[~same] * (1 + 2 ** -4))
    size_wl, size_wr = _term_sizes(w, s_wl, s_wr, g, dtype)
    moved = _t(np.where(same, 0.0, np.abs(g) * 16).astype(np.float32))
    slack_wl, slack_wr = _term_sizes(w, s_wl, s_wr, g, dtype, terms=moved)
    _assert_by_terms(lswr.grad.numpy(), jglswr,
                     (size_wr * 1e-6 + slack_wr) * s_wr / GS_RTOL)
    if stream:
        _assert_by_terms(lsa.grad.numpy(), jglsa,
                         (size_wl * 1e-6 + slack_wl) * s_wl / GS_RTOL)


GEOMETRIES = {
    # name: (w shape, s_wl shape or None, s_wr shape, (P, g, cs))
    "channel": ((64, 24), (64,), (24,), (64, 64, 1)),
    "channel-nostream": ((64, 24), None, (24,), (64, 64, 1)),
    "group": ((64, 24), (64,), (4, 24), (64, 16, 1)),
    "layerwise": ((64, 24), (64,), (), (64, 64, 0)),
    "stack-shared-stream": ((3, 64, 24), (64,), (3, 24), (64, 64, 1)),
    "stack-own-streams": ((3, 64, 24), (3, 64), (3, 24), (192, 64, 1)),
    "stack-group": ((3, 64, 24), (64,), (3, 4, 24), (64, 16, 1)),
    "stack-layerwise": ((3, 64, 24), None, (3,), (192, 64, 0)),
    "tp-row-shard": ((16, 24), (16,), (1, 24), (16, 16, 1)),
}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_factored_geometry_of_every_layout(name):
    """The index form ``s_wl[r mod P] · s_wr[r / g, c · cs]`` of each
    shape ``weight_scale`` produces, and the factored plain version's
    scale equal to ``core.dof.weight_scale``'s there."""
    w_shape, wl_shape, wr_shape, want = GEOMETRIES[name]
    rng = np.random.default_rng(len(name))
    w = torch.zeros(w_shape)
    lsa = None if wl_shape is None else _t(
        rng.normal(size=wl_shape).astype(np.float32))
    lswr = _t(rng.normal(size=wr_shape).astype(np.float32))
    assert factored_geometry(w, lsa, lswr) == want
    P, g, cs = want
    R, C = w.numel() // w_shape[-1], w_shape[-1]
    s = torch.broadcast_to(t_dof.weight_scale({"w": w, "log_swr": lswr},
                                              lsa), w_shape).reshape(R, C)
    wl = torch.ones(P) if lsa is None else torch.exp(-lsa).reshape(-1)
    wr = torch.exp(lswr).reshape(R // g, C if cs else 1)
    r = torch.arange(R)
    formed = wl[r % P][:, None] * wr[r // g][:, :C]
    if lsa is None:
        formed = torch.broadcast_to(wr[r // g], (R, C))
    assert torch.equal(torch.broadcast_to(formed, (R, C)), s)


def test_factored_wrapper_refuses_what_it_cannot_take():
    """Outside the index form (a stream over some of the stacked axes, a
    group that does not divide K, a bf16 master, a rank-1 weight) the
    wrapper raises, and ``factored_geometry`` says None, so
    ``effective_weight`` takes the broadcast entry before any launch."""
    w = torch.zeros((2, 3, 8, 12))
    bad = {"partial-stream": (w, torch.ones((2, 8)), torch.ones((2, 3, 12))),
           "ragged-group": (torch.zeros((8, 12)), None, torch.ones((3, 12))),
           "bf16-master": (torch.zeros((8, 12), dtype=torch.bfloat16),
                           None, torch.ones((12,))),
           "rank-1": (torch.zeros((12,)), None, torch.ones(())),
           "wrong-width": (torch.zeros((8, 12)), torch.ones((8,)),
                           torch.ones((10,)))}
    for name, (wt, wl, wr) in bad.items():
        assert factored_geometry(wt, wl, wr) is None, name
        with pytest.raises(ValueError, match="fake_quant_factored"):
            fake_quant_factored(wt, wl, wr, 4)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fake_quant_factored(torch.zeros((8, 12)), None, torch.ones((12,)),
                            4, torch.float16)


def test_factored_operators_trace_as_one_node_each():
    """On the card's route (fake meta tensors) the factored entry is one
    forward and one backward operator node, and effective_weight reaches
    it: no ``[K, N]`` scale is formed outside it."""
    from repro_torch.analysis.graph_checks import kernel_nodes, trace

    def step(w, lsa, lswr):
        w, lsa, lswr = (t.detach().requires_grad_() for t in (w, lsa, lswr))
        y = t_dof.effective_weight({"w": w, "log_swr": lswr}, TQ(), lsa,
                                   compute_dtype=torch.bfloat16,
                                   use_kernels=True)
        return torch.autograd.grad(y.float().sum(), (w, lsa, lswr))

    def meta(shape):
        return torch.empty(shape, device="meta")

    tr = trace(step, meta((64, 24)), meta((64,)), meta((4, 24)))
    names = [str(n.target) for n in tr.nodes()
             if "repro_torch" in str(n.target)]
    assert names == ["repro_torch.fake_quant_factored_fwd.default",
                     "repro_torch.fake_quant_factored_bwd.default"]
    assert kernel_nodes(tr) == ["fake_quant", "fake_quant"]
