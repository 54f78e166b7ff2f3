"""repro_torch's dense forward vs the JAX package on qwen3-8b SMOKE:
teacher and student (W4A8 fake-quant, plan-aware) logits in f32 to 1e-4,
full sequence and through a cache (prefill, then scalar- and per-slot-pos
decode)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.qwen3_8b import SMOKE as J_SMOKE  # noqa: E402
from repro.core.plan import resolve_plan as j_resolve_plan  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro_torch.configs.qwen3_8b import SMOKE as T_SMOKE  # noqa: E402
from repro_torch.core.plan import resolve_plan  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.models import forward, init_cache, init_model  # noqa: E402

TOL = 1e-4


def _pair(student: bool):
    jq, tq = (JQ(), TQ()) if student else (None, None)
    jp = j_init_model(jax.random.PRNGKey(1), J_SMOKE, jq)
    tp = from_numpy_tree(jax.device_get(jp), "cpu")
    jplan = tplan = None
    if student:
        jplan = j_resolve_plan(jq, jp, model_cfg=J_SMOKE)
        tplan = resolve_plan(tq, tp, model_cfg=T_SMOKE)
    return (jp, jq, jplan), (tp, tq, tplan)


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, J_SMOKE.vocab, (B, S))


@pytest.mark.parametrize("student", [False, True])
def test_forward_logits_match_jax(student):
    (jp, jq, jplan), (tp, tq, tplan) = _pair(student)
    toks = _tokens(2, 12)
    jo = j_forward(jp, J_SMOKE, jq, {"tokens": jnp.asarray(toks, jnp.int32)},
                   compute_dtype=jnp.float32, plan=jplan)
    with torch.no_grad():
        to = forward(tp, T_SMOKE, tq, {"tokens": torch.from_numpy(toks)},
                     compute_dtype=torch.float32, plan=tplan)
    np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to["hidden"].numpy(), np.asarray(jo["hidden"]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("student", [False, True])
def test_cached_prefill_and_decode_match_jax(student):
    """Prefill 7 tokens into a 16-deep f32 cache, then one scalar-pos decode
    step and one per-slot-pos decode step (slots at different offsets)."""
    (jp, jq, jplan), (tp, tq, tplan) = _pair(student)
    toks = _tokens(2, 8, seed=1)
    jc = j_init_cache(J_SMOKE, 2, 16, jnp.float32)
    tc = init_cache(T_SMOKE, 2, 16, torch.float32, device="cpu")
    for sl in (slice(0, 7), slice(7, 8)):
        jo = j_forward(jp, J_SMOKE, jq,
                       {"tokens": jnp.asarray(toks[:, sl], jnp.int32)},
                       cache=jc, compute_dtype=jnp.float32, plan=jplan)
        jc = jo["cache"]
        with torch.no_grad():
            to = forward(tp, T_SMOKE, tq,
                         {"tokens": torch.from_numpy(toks[:, sl])},
                         cache=tc, compute_dtype=torch.float32, plan=tplan)
        np.testing.assert_allclose(to["logits"].numpy(),
                                   np.asarray(jo["logits"]), rtol=TOL,
                                   atol=TOL)
    assert tc["pos"] == int(jc["pos"]) == 8
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=TOL, atol=TOL)
    # per-slot offsets: slot 0 at 8, slot 1 rolled back to 5
    jc = {**jc, "pos": jnp.asarray([8, 5], jnp.int32)}
    tc["pos"] = torch.tensor([8, 5], dtype=torch.int32)
    nxt = _tokens(2, 1, seed=2)
    jo = j_forward(jp, J_SMOKE, jq, {"tokens": jnp.asarray(nxt, jnp.int32)},
                   cache=jc, compute_dtype=jnp.float32, plan=jplan)
    with torch.no_grad():
        to = forward(tp, T_SMOKE, tq, {"tokens": torch.from_numpy(nxt)},
                     cache=tc, compute_dtype=torch.float32, plan=tplan,
                     use_kernels=True)
    np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), [9, 6])


def test_port_init_matches_jax_tree_structure():
    """Same paths, shapes and dtypes as the JAX package's init tree."""
    jp = jax.device_get(j_init_model(jax.random.PRNGKey(0), J_SMOKE, JQ()))
    tp = init_model(0, T_SMOKE, TQ(), device="cpu")

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], prefix + (k,))
        else:
            yield prefix, tuple(tree.shape), str(tree.dtype).split(".")[-1]

    assert list(flat(tp)) == list(flat(jp))
