"""repro_torch's fake-quant against the JAX package: the clip gradient at the
grid bounds (the port once clipped with ``torch.clamp``, which passes the
whole gradient where ``jnp.clip`` passes half), and the ``fake_quant``
kernel's plain forward and both backward rules against the Pallas kernel
(interpret mode) and against ``jax.grad`` of the plain composition.

Inputs are made with numpy from a seed and go through both packages; the
forward is bit-equal, ``gx`` bit-equal, reduced scale gradients agree to
1e-6 relative (summation order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import fakequant as j_fq  # noqa: E402
from repro.kernels import fake_quant_kernel as j_fq_kernel  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.core import dof as t_dof  # noqa: E402
from repro_torch.core import fakequant as t_fq  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels.fake_quant import fake_quant_kernel  # noqa: E402

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
