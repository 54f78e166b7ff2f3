"""The rest of repro_torch's dense registry (qwen3-32b, command-r-plus-104b,
phi4-mini-3.8b with its tied head) and the plan leftovers (the producer
hook, ``make_sensitivity_producer``, ``export_model``) against the JAX
package, on the CPU at each config's SMOKE size.

Parameters are initialised in JAX and converted; tokens are made with
numpy.  Tolerances: the config values and plan tables equal; f32 logits
and hidden states 1e-4; one f32 train step (backbone L2 mixed with 0.3 of
the logits' cross-entropy, so the head — tied or not — gets gradients):
the loss 1e-6 relative, each gradient leaf 1e-4 relative L2; integer
artifact leaves bit for bit, scales 1e-6; greedy tokens equal except at a
step where the JAX package's own top-2 margin is within ``MARGIN_ULPS``
bf16 ulps (as tests/test_torch_serve.py holds qwen3-8b).
"""
import dataclasses
import importlib
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import distill as j_distill  # noqa: E402
from repro.core.plan import resolve_plan as j_resolve_plan  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.core.qconfig import deployment_oriented as j_deploy_q  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.pipeline.cli import main as j_cli_main  # noqa: E402
from repro.serve import deploy as j_deploy  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.plan import (make_sensitivity_producer,  # noqa: E402
                                   resolve_plan)
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.core.qconfig import deployment_oriented  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.models import forward, init_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.pipeline.cli import main as cli_main  # noqa: E402
from repro_torch.serve.deploy import (DeployPlan,  # noqa: E402
                                      export_for_layers, export_model,
                                      make_deploy_plan)
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.train.steps import make_value_and_grad  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

ARCHS = {"qwen3-32b": "qwen3_32b",
         "command-r-plus-104b": "command_r_plus_104b",
         "phi4-mini-3.8b": "phi4_mini_3_8b"}
MARGIN_ULPS = 4
CE = 0.3


def _configs(arch, which="SMOKE"):
    mod = ARCHS[arch]
    j = importlib.import_module(f"repro.configs.{mod}")
    t = importlib.import_module(f"repro_torch.configs.{mod}")
    return getattr(j, which), getattr(t, which)


def _t(tree):
    return from_numpy_tree(jax.device_get(tree), "cpu")


def _sorted(tree):
    """The JAX tree with its dicts' keys sorted, as a converted tree has
    them (``jax.tree.map`` rebuilds dicts in key order), so plans resolved
    on the two list their tensors in one order."""
    return jax.tree.map(lambda a: a, tree)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", list(ARCHS) + ["paper-cnn"])
def test_registry_config_values(arch, which):
    mod = "paper_cnn" if arch == "paper-cnn" else ARCHS[arch]
    j = getattr(importlib.import_module(f"repro.configs.{mod}"), which)
    t = getattr(importlib.import_module(f"repro_torch.configs.{mod}"), which)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert get_config(arch, smoke=which == "SMOKE") == t


@pytest.mark.parametrize("student", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_jax(arch, student):
    """f32 logits and hidden states, teacher and plan-aware W4A8 student;
    phi4-mini has no lm_head and reads its logits off the embedding."""
    jc, tc = _configs(arch)
    jq, tq = (JQ(), TQ()) if student else (None, None)
    jp = _sorted(j_init_model(jax.random.PRNGKey(1), jc, jq))
    tp = _t(jp)
    assert ("lm_head" in tp) == (not tc.tie_embeddings)
    jplan = tplan = None
    if student:
        jplan = j_resolve_plan(jq, jp, model_cfg=jc)
        tplan = resolve_plan(tq, tp, model_cfg=tc)
        assert tplan.to_json() == jplan.to_json()
    toks = _tokens(tc, 2, 10)
    jo = j_forward(jp, jc, jq, {"tokens": jnp.asarray(toks, jnp.int32)},
                   compute_dtype=jnp.float32, plan=jplan)
    with torch.no_grad():
        to = forward(tp, tc, tq, {"tokens": torch.from_numpy(toks)},
                     compute_dtype=torch.float32, plan=tplan)
    for key in ("logits", "hidden"):
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def _jax_value_and_grad(jc, jq, jplan, student, teacher, toks):
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    to = j_forward(teacher, jc, None, batch, compute_dtype=jnp.float32)

    def loss(s):
        so = j_forward(s, jc, jq, batch, compute_dtype=jnp.float32,
                       plan=jplan)
        return j_distill.qft_loss(so["hidden"], to["hidden"], so["logits"],
                                  to["logits"], ce_proportion=CE)
    return jax.value_and_grad(loss)(student)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_f32_matches_jax(arch):
    """One student step's loss and gradients in f32 with the logits' CE
    mixed in: every leaf, the tied embedding (its lookup and the head)
    included."""
    jc, tc = _configs(arch)
    jq, tq = JQ(), TQ()
    teacher = j_init_model(jax.random.PRNGKey(0), jc, None)
    student = j_init_model(jax.random.PRNGKey(1), jc, jq)
    jplan = j_resolve_plan(jq, student, model_cfg=jc)
    toks = _tokens(tc, 2, 12, seed=3)
    jloss, jgrads = _jax_value_and_grad(jc, jq, jplan, student, teacher,
                                        toks)
    ts = _t(student)
    vg = make_value_and_grad(tc, tq, ce_proportion=CE,
                             plan=resolve_plan(tq, ts, model_cfg=tc),
                             compute_dtype=torch.float32)
    loss, grads = vg(ts, _t(teacher), {"tokens": torch.from_numpy(toks)})
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    jg = dict(tree_items(_t(jgrads)))
    gnorm = math.sqrt(sum(float((g.double() ** 2).sum())
                          for g in jg.values()))
    for path, g in tree_items(grads):
        ref = jg[path].double()
        if g is None:         # the tied head reads no head_stream
            assert path[0] == "head_stream" and tc.tie_embeddings, path
            assert float(ref.abs().max()) == 0.0, path
            continue
        err = float((g.double() - ref).norm())
        assert err <= 1e-4 * (float(ref.norm()) + 1e-3 * gnorm), (path, err)
    if tc.tie_embeddings:
        assert float(grads["embed"]["w"].abs().max()) > 0


def _jax_artifact(jc):
    jq = JQ()
    params = j_init_model(jax.random.PRNGKey(0), jc, jq)
    plan = j_deploy.make_deploy_plan(jq, params=params, model_cfg=jc)
    return plan, jax.jit(lambda p: j_deploy.export_for_layers(p, plan))(
        params)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_greedy_decode_matches_jax_engine(arch):
    """The JAX artifact, converted, served by both engines (paged int8 KV,
    the port on its kernels' plain versions): the same greedy tokens up to
    a near-tie step."""
    jc, tc = _configs(arch)
    plan, ex = _jax_artifact(jc)
    prompts = [[1, 2, 3], list(range(5, 20)), [300, 7, 42, 8]]
    new = 6
    kw = dict(max_slots=2, max_len=48, prefill_chunk=8, kv_page_size=16)
    want = JEngine.from_artifact(jc, plan, ex, JServeConfig(**kw)).generate(
        [JRequest(prompt=p, max_new_tokens=new) for p in prompts])
    got = Engine.from_artifact(tc, DeployPlan(qcfg=TQ()), _t(ex),
                               ServeConfig(**kw), device="cpu").generate(
        [Request(prompt=p, max_new_tokens=new) for p in prompts])
    dv = j_deploy.deploy_view(ex, plan)
    near_ties = 0
    for prompt, w, g in zip(prompts, want, got):
        assert len(g) == len(w) == new
        i = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if i is None:
            continue
        z = np.sort(np.asarray(j_forward(dv, jc, None, {"tokens": jnp.asarray(
            [prompt + w[:i]], jnp.int32)})["logits"][0, -1],
            np.float32))[::-1]
        ulp = 2.0 ** (math.floor(math.log2(abs(z[0]))) - 7)
        assert z[0] - z[1] <= MARGIN_ULPS * ulp, (prompt, i, w, g)
        near_ties += 1
    assert near_ties <= 1


@pytest.mark.parametrize("extra", [[], ["--full"]])
@pytest.mark.parametrize("arch", list(ARCHS) + ["paper-cnn"])
def test_cli_plan_table_matches_jax(capsys, arch, extra):
    assert j_cli_main(["plan", "--config", arch, *extra]) == 0
    want = capsys.readouterr().out
    assert cli_main(["plan", "--config", arch, *extra]) == 0
    assert capsys.readouterr().out == want


CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=64, vocab=64, head_dim=8, scan_layers=False,
           remat=False)


def test_sensitivity_producer_hook():
    """tests/test_plan.py::test_sensitivity_producer_hook on the port, and
    make_sensitivity_producer: both plans' JSON equal to the JAX
    package's."""
    from repro.core.plan import make_sensitivity_producer as j_sens

    def producer(specs, ctx):
        return {p: (dataclasses.replace(s, w_bits=2, origin="sens")
                    if p == "layers.mlp.down" else s)
                for p, s in specs.items()}

    cfg, jcfg = ModelConfig(**CFG), JModelConfig(**CFG)
    qcfg, jq = deployment_oriented(), j_deploy_q()
    def key_order(tree):      # as jax.eval_shape returns the JAX skeleton
        return ({k: key_order(tree[k]) for k in sorted(tree)}
                if isinstance(tree, dict) else tree)
    skel = key_order(init_model(0, cfg, qcfg, device="meta"))
    jskel = jax.eval_shape(lambda k: j_init_model(k, jcfg, jq),
                           jax.random.PRNGKey(0))
    plan = resolve_plan(qcfg, skel, model_cfg=cfg, producers=(producer,))
    assert plan.spec("layers.mlp.down").w_bits == 2
    assert plan.spec("layers.mlp.down").origin == "sens"
    assert plan.spec("layers.mlp.up").w_bits == 4
    scores = {"layers.attn.wq": 3.0, "layers.mlp.up": 9.0,
              "layers.mlp.gate": 1.0, "layers.attn.wo": 5.0}
    for prods, jprods in (((producer,), (producer,)),
                          ((make_sensitivity_producer(scores, 8, 0.5),),
                           (j_sens(scores, 8, 0.5),))):
        got = resolve_plan(qcfg, skel, model_cfg=cfg, producers=prods)
        want = j_resolve_plan(jq, jskel, model_cfg=jcfg, producers=jprods)
        assert got.to_json() == want.to_json()
    sens = resolve_plan(qcfg, skel, model_cfg=cfg, producers=(
        make_sensitivity_producer(scores, 8, 0.5),))
    assert {p for p, s in sens if s.origin == "sensitivity"} == {
        "layers.mlp.up", "layers.attn.wo"}
    assert not sens.spec("layers.mlp.up").packed


@pytest.mark.parametrize("arch", list(ARCHS))
def test_export_model_matches_jax(arch):
    """export_model (one walk, no layer stacking) against the JAX
    package's on a converted student, and against the port's own
    export_for_layers: the same artifact."""
    jc, tc = _configs(arch)
    jq, tq = JQ(), TQ()
    student = _sorted(j_init_model(jax.random.PRNGKey(2), jc, jq))
    jplan = j_deploy.make_deploy_plan(jq, params=student, model_cfg=jc)
    want = dict(tree_items(_t(j_deploy.export_model(student, jplan))))
    ts = _t(student)
    plan = make_deploy_plan(tq, params=ts, model_cfg=tc)
    got = export_model(ts, plan, device="cpu")
    stacked = dict(tree_items(export_for_layers(ts, plan, device="cpu")))
    assert sorted(map(str, want)) == sorted(
        map(str, (p for p, _ in tree_items(got)))) == sorted(
        map(str, stacked))
    for path, leaf in tree_items(got):
        ref = want[path]
        assert leaf.dtype == ref.dtype and leaf.shape == ref.shape, path
        assert torch.equal(leaf, stacked[path]), path
        if leaf.is_floating_point():
            np.testing.assert_allclose(leaf.numpy(), ref.numpy(), rtol=1e-6,
                                       err_msg=str(path))
        else:
            assert torch.equal(leaf, ref), path
