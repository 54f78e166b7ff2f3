"""GQA groups above 8 (F20): command-r-plus-104b's 96/8 heads are a group of
12, which the port's decode kernel takes since it splits a group into query
chunks of 8.  Here, on the CPU: the port engine routes every layer to the
kernel exactly where the JAX engine routes every layer to its Pallas
kernel, at a small config with its own head counts (24/2 heads at hd 16,
G 12; command-r-plus's SMOKE has G 3), and its greedy tokens match the JAX
engine's on the same converted artifact.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import command_r_plus_104b as j_cfgs  # noqa: E402
from repro.configs import qwen3_32b as j_q32  # noqa: E402
from repro.core.qconfig import QuantConfig as JQ  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models.attention import decode_route as j_decode_route  # noqa: E402
from repro.serve.deploy import deploy_view as j_deploy_view  # noqa: E402
from repro.serve.deploy import export_for_layers as j_export  # noqa: E402
from repro.serve.deploy import make_deploy_plan as j_make_plan  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import command_r_plus_104b as t_cfgs  # noqa: E402
from repro_torch.configs import qwen3_32b as t_q32  # noqa: E402
from repro_torch.core.qconfig import QuantConfig as TQ  # noqa: E402
from repro_torch.interop import from_numpy_tree  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    kernel_takes, query_chunks, split_rows, tile_rows)
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.serve.deploy import DeployPlan  # noqa: E402
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402

HEADS = dict(n_heads=24, n_kv_heads=2, head_dim=16, d_model=96,
             n_heads_padded=0, n_kv_heads_padded=0)
J_G12 = dataclasses.replace(j_cfgs.SMOKE, **HEADS)
T_G12 = dataclasses.replace(t_cfgs.SMOKE, **HEADS)
#: a cache depth that tiles by 128, so the JAX engine routes its kernel
SCFG = dict(max_slots=3, max_len=128, prefill_chunk=8, kv_mode="paged",
            kv_page_size=16)
PROMPTS = [[1, 2, 3], list(range(1, 12)), [300, 7, 42, 42, 8, 1, 0]]
NEW = 6
MARGIN_ULPS = 4


@functools.lru_cache(maxsize=None)
def _jax_artifact():
    jq = JQ()
    params = j_init_model(jax.random.PRNGKey(0), J_G12, jq)
    plan = j_make_plan(jq, params=params, model_cfg=J_G12)
    return plan, jax.jit(lambda p: j_export(p, plan))(params)


def _port_engine(use_kernels=True):
    _, ex = _jax_artifact()
    return Engine.from_artifact(
        T_G12, DeployPlan(qcfg=TQ(), use_kernels=use_kernels),
        from_numpy_tree(jax.device_get(ex), "cpu"), ServeConfig(**SCFG),
        device="cpu")


def test_the_config_is_a_group_of_12():
    assert T_G12.n_heads_padded // T_G12.n_kv_heads_padded == 12
    assert J_G12.n_heads_padded // J_G12.n_kv_heads_padded == 12


def test_kernel_layer_count_equals_the_jax_engines_at_g12():
    """``decode_attn_kernel_layers`` of the port engine equals the JAX
    engine's ``decode_attn_pallas_layers`` for a plan that routes (every
    layer), and the plain routes agree too (none)."""
    plan, jex = _jax_artifact()
    for use in (True, False):
        js = JEngine.from_artifact(
            J_G12, dataclasses.replace(plan, use_pallas=use), jex,
            JServeConfig(**SCFG)).stats()
        s = _port_engine(use).stats()
        assert (s["decode_attn_kernel_layers"], s["decode_attn_ref_layers"]) \
            == (js["decode_attn_pallas_layers"], js["decode_attn_ref_layers"])
        assert s["decode_attn_kernel_layers"] == (T_G12.n_layers if use
                                                  else 0)


@pytest.mark.parametrize("mod_j,mod_t", [(j_cfgs, t_cfgs), (j_q32, t_q32)],
                         ids=["command-r-plus-104b", "qwen3-32b"])
def test_full_size_decode_route_equals_the_references(mod_j, mod_t):
    """At the registry's full sizes (G 12 and G 8) and the engine's 2048
    rows, both packages' ``decode_route`` send the decode to the kernel."""
    G = mod_t.CONFIG.n_heads_padded // mod_t.CONFIG.n_kv_heads_padded
    assert kernel_takes(G, mod_t.CONFIG.head_dim)
    for max_len in (128, 2048):
        assert t_attn.decode_route(mod_t.CONFIG, max_len, True) \
            == j_decode_route(mod_j.CONFIG, max_len, True) is True


@pytest.mark.parametrize("G,chunks", [(1, 1), (4, 1), (7, 1), (8, 1),
                                      (9, 2), (12, 2), (16, 2)])
def test_query_chunks_and_gate(G, chunks):
    """A group above 8 is split into query chunks of 8; G 17 is refused."""
    assert query_chunks(G) == chunks
    assert kernel_takes(G, 128) and not kernel_takes(17, 128)
    # above 8 a block tiles as at G 8: 4-row int8 tiles at hd 128
    assert tile_rows(torch.int8, 128, G) == tile_rows(
        torch.int8, 128, min(G, 8))


def test_split_rows_counts_the_query_chunks():
    """command-r-plus's paged decode (S 8 × Hkv 8, 2048 rows, int8 at
    G 12): two query chunks make 128 blocks a split, so the 64-row tile
    is kept where G 8's 64 blocks a split would halve it at 256 rows."""
    tile = tile_rows(torch.int8, 128, 12)
    assert tile == 64
    assert split_rows(2048, 8 * 8 * query_chunks(12), tile) == 64
    assert split_rows(256, 8 * 8 * query_chunks(12), tile) == 64
    assert split_rows(256, 8 * 8 * query_chunks(8), tile) == 32


def _jax_margin_ok(context):
    plan, ex = _jax_artifact()
    logits = j_forward(j_deploy_view(ex, plan), J_G12, None,
                       {"tokens": jnp.asarray([context], jnp.int32)})
    z = np.sort(np.asarray(logits["logits"][0, -1], np.float32))[::-1]
    ulp = 2.0 ** (math.floor(math.log2(abs(z[0]))) - 7)
    return z[0] - z[1] <= MARGIN_ULPS * ulp


def test_greedy_tokens_match_jax_engine_at_g12():
    """The same converted artifact through both engines, the port's on its
    kernel route (the plain version on the CPU): tokens equal, or first
    differ where JAX's own top-2 margin is a near-tie."""
    plan, jex = _jax_artifact()
    want = JEngine.from_artifact(
        J_G12, plan, jex, JServeConfig(**SCFG)).generate(
        [JRequest(prompt=p, max_new_tokens=NEW) for p in PROMPTS])
    got = _port_engine().generate(
        [Request(prompt=p, max_new_tokens=NEW) for p in PROMPTS])
    near = 0
    for prompt, w, g in zip(PROMPTS, want, got):
        assert len(g) == len(w) == NEW
        i = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if i is not None:
            assert _jax_margin_ok(prompt + w[:i]), (prompt, i, w, g)
            near += 1
    assert near <= 1
