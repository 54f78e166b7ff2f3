"""``repro_torch.launch.dryrun`` over 256 fake ranks, and its accounting.

The dry-run runs in a subprocess under ``torch.distributed``'s ``fake``
backend, so no process group leaks into the test worker: deepseek-v2's
and qwen2-moe's inference cells, qwen3-32b's train cell after them (F24's
order), qwen3-8b's train, decode and prefill cells at full config, and
one skipped cell, each with the JAX package's schema, the H100 roofline
terms, the port's per-layer gathers and the tensor-parallel compute over
``model`` (in the inference cells on the artifact's shards, the MoE
experts and MLA included, and the cache as ``cache_shardings`` places
it, with bounds from the JAX package's dry-run); ``_model_flops`` equals
the JAX package's
arithmetic on every (arch × shape) cell (the JAX dry-run module is
imported in a subprocess too: it sets ``XLA_FLAGS`` when imported).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs.registry import (ARCH_IDS, SHAPES,  # noqa: E402
                                          skip_reason)
from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: in this order in one process: deepseek-v2's decode cell followed by
#: qwen3-32b's train cell once traced with another mesh's model group
#: (F24: the KV groups were found by the process-group object)
CELLS = [("deepseek-v2-236b", "decode_32k"),
         ("deepseek-v2-236b", "prefill_32k"),
         ("qwen2-moe-a2.7b", "decode_32k"), ("qwen2-moe-a2.7b", "prefill_32k"),
         ("qwen3-32b", "train_4k"),
         ("qwen3-8b", "train_4k"), ("qwen3-8b", "decode_32k"),
         ("qwen3-8b", "prefill_32k"), ("qwen3-8b", "long_500k")]


def _python(code: str, timeout: int = 480) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep + str(
        ROOT), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout.strip().splitlines()[-1]


@pytest.fixture(scope="module")
def cells():
    out = _python(
        "import json; from repro_torch.launch.dryrun import run_cell; "
        f"print(json.dumps([run_cell(a, s, False, save=False) "
        f"for a, s in {CELLS!r}]))")
    return {(c["arch"], c["shape"]): c for c in json.loads(out)}


def test_train_cell_traces_over_256_fake_ranks(cells):
    c = cells[("qwen3-8b", "train_4k")]
    assert c["status"] == "OK", c.get("error")
    assert c["mesh"] == "pod16x16" and c["trace_s"] > 0
    assert set(c) >= {"status", "memory", "cost", "collectives", "roofline",
                      "trace_s"}
    cost = c["cost"]
    assert cost["layer_units"] == 36 and cost["full_depth_traced"] is False
    u1, u2 = cost["unit_traces"]["1"], cost["unit_traces"]["2"]
    assert cost["per_layer_unit"]["flops"] == u2["flops"] - u1["flops"] > 0
    assert cost["corrected_total"]["flops"] == pytest.approx(
        u1["flops"] + 35 * cost["per_layer_unit"]["flops"])
    # the sharded step gathers each layer's leaves over data and reduces
    # the gradients onto the shards; the model axis computes the dense
    # layers on shards, with f/g all-reduces (sharding.tp): a rank does
    # about 1/16 of the whole step's work, as the JAX package's layout
    # (2.89e14 FLOPs a rank, useful ratio 0.786 in its dry-run)
    kinds = c["collectives"]["per_kind"]
    assert kinds["all-gather"] > 0 and kinds["reduce-scatter"] > 0
    assert kinds["all-reduce"] > 0
    assert c["roofline"]["useful_flops_ratio"] >= 0.5
    assert cost["corrected_total"]["flops"] <= 4.4e14
    assert kinds["all-gather"] <= 18.2e9
    assert c["memory"]["peak_bytes"] < 80e9
    mem = c["memory"]
    assert mem["param_bytes"] > 0 and mem["optimizer_bytes"] > 0
    assert mem["peak_bytes"] == pytest.approx(sum(
        v for k, v in mem.items() if k != "peak_bytes"))
    r = c["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["compute_s"] == pytest.approx(
        cost["corrected_total"]["flops"] / hlo_analysis.PEAK_FLOPS)
    assert r["collective_s"] == pytest.approx(
        c["collectives"]["collective_bytes"] / hlo_analysis.LINK_BW)
    assert r["model_flops"] == dryrun._model_flops("qwen3-8b", "train_4k")


def test_decode_cell_and_skipped_cell(cells):
    c = cells[("qwen3-8b", "decode_32k")]
    assert c["status"] == "OK", c.get("error")
    # each rank dequantizes its shards of the artifact: over model the
    # step gathers this step's activations (the cache is split over the
    # sequence) and reduces (g, the combine); nothing goes over data
    assert set(c["collectives"]["per_kind"]) == {"all-gather",
                                                 "all-reduce"}
    assert set(c["collectives"]["per_axis"]) == {"all-gather/model",
                                                 "all-reduce/model"}
    assert c["memory"]["cache_bytes"] > 0 and c["memory"][
        "optimizer_bytes"] == 0
    assert c["roofline"]["memory_s"] == pytest.approx(
        c["cost"]["corrected_total"]["bytes"] / hlo_analysis.HBM_BW)
    s = cells[("qwen3-8b", "long_500k")]
    assert s["status"] == "SKIP"
    assert s["reason"] == skip_reason("qwen3-8b", "long_500k")
    assert "memory" not in s


def _cache_bytes_a_rank(shape: str, arch: str = "qwen3-8b") -> tuple:
    """A rank's bytes of the cell's cache on 16 x 16 as
    ``cache_shardings`` places it, and the spec of its first leaf (``k``,
    or MLA's ``ckv``)."""
    from repro_torch.models import init_cache
    from repro_torch.sharding.partition import (ShardingPolicy,
                                                cache_shardings)

    class Mesh:
        shape = {"data": 16, "model": 16}
    cfg = dryrun._cfg_for(arch)
    sp = SHAPES[shape]
    depth = sp.seq_len + (8 if sp.kind == "prefill" else 0)
    cache = init_cache(cfg, sp.global_batch, depth, device="meta")
    specs = cache_shardings(cache, cfg, Mesh, ShardingPolicy())
    names = ("ckv", "kr") if cfg.mla is not None else ("k", "v")
    n = 0.0
    for name in names:
        div = 1
        for entry in specs[name]:
            div *= 16 if entry in ("data", "model") else 1
        n += cache[name].numel() * cache[name].element_size() / div
    return n, specs[names[0]]


@pytest.mark.parametrize("shape,bounds", [
    ("decode_32k", {"flops": 9.6e10, "useful": 0.08, "coll": 0.2e9,
                    "peak": 15.6e9, "seq": "model"}),
    ("prefill_32k", {"flops": 2.15e14, "useful": 0.29, "coll": 251e9,
                     "peak": 80e9, "seq": None}),
    # the MoE experts and MLA on shards: bounds from the JAX package's
    # dry-run, the cache a rank its own (1.132, 4.531, 3.221, 0.806 GB)
    pytest.param("decode_32k", {
        "arch": "deepseek-v2-236b", "flops": 5.1e13, "coll": 11.2e9,
        "peak": 80e9, "spec": (None, "data", "model", None),
        "cache": 1.132e9}, id="deepseek-v2-236b-decode_32k"),
    pytest.param("prefill_32k", {
        "arch": "deepseek-v2-236b", "flops": 3.45e15, "coll": 160e9,
        "peak": 544e9, "spec": (None, "data", None, None),
        "cache": 4.531e9}, id="deepseek-v2-236b-prefill_32k"),
    pytest.param("decode_32k", {
        "arch": "qwen2-moe-a2.7b", "flops": 1.5e10, "coll": 0.58e9,
        "peak": 80e9, "spec": (None, "data", None, "model", None),
        "cache": 3.221e9}, id="qwen2-moe-a2.7b-decode_32k"),
    pytest.param("prefill_32k", {
        "arch": "qwen2-moe-a2.7b", "flops": 1.0e14, "coll": 32e9,
        "peak": 80e9, "spec": (None, "data", None, "model", None),
        "cache": 0.806e9}, id="qwen2-moe-a2.7b-prefill_32k")])
def test_inference_cells_compute_on_shards(cells, shape, bounds):
    """The inference cells on 16 x 16, rank 0, the cache a rank as
    ``cache_shardings`` places it, no collective over ``data`` and a peak
    that fits a card (deepseek-v2's prefill: within 1.5x the JAX
    package's 362.6 GB).  qwen3-8b: within 1.5x the JAX package's FLOPs
    (6.43e10 decode, 1.43e14 prefill) and collective bytes (prefill 167.5
    GB); decode reads 1/16 of the rows' cache, over the sequence, prefill
    all of it, 32 776 not being a multiple of 16.  deepseek-v2 with the
    experts and MLA on shards: within 1.5x the JAX package's FLOPs
    (3.37e13, 2.30e15) and decode collectives (7.48 GB); the prefill's
    two *g*'s a layer (the rank's rows' ``[2, 32768, 5120]`` bf16, counted
    at the ring's 2(n - 1)/n: 151 GB) and little else; the latent cache
    over the sequence at decode, whole over ``model`` at prefill.
    qwen2-moe: FLOPs within 1.5x of 1e10 and 6.7e13 (the JAX package's
    6.32e10 and 1.90e14 count the dequantization too), decode collectives
    within 1.5x the JAX package's 0.387 GB, the prefill's two *g*'s a
    layer (24.2 GB) and little else; its KV heads split."""
    arch = bounds.get("arch", "qwen3-8b")
    c = cells[(arch, shape)]
    assert c["status"] == "OK", c.get("error")
    want_cache, spec = _cache_bytes_a_rank(shape, arch)
    if arch == "qwen3-8b":
        assert spec == (None, "data", bounds["seq"], None, None)
        assert c["roofline"]["useful_flops_ratio"] >= bounds["useful"]
    else:
        assert spec == bounds["spec"]
        assert want_cache == pytest.approx(bounds["cache"], rel=1e-3)
    assert c["memory"]["cache_bytes"] == want_cache
    assert c["cost"]["corrected_total"]["flops"] <= bounds["flops"]
    assert c["collectives"]["collective_bytes"] <= bounds["coll"]
    assert not any(k.endswith("/data")
                   for k in c["collectives"]["per_axis"]), c["collectives"]
    assert c["memory"]["peak_bytes"] < bounds["peak"]


def test_train_cell_after_an_mla_decode_cell(cells):
    """F24: qwen3-32b's train cell, traced after deepseek-v2's decode cell
    in one process, finds the KV groups ``prepare`` made (found by the
    ``model`` group's ranks, not its process-group object) and traces."""
    c = cells[("qwen3-32b", "train_4k")]
    assert c["status"] == "OK", c.get("error")
    assert c["collectives"]["per_kind"]["all-gather"] > 0


def test_model_flops_match_jax():
    out = _python(
        "import json; from repro.launch import dryrun as d; "
        "from repro.configs import ARCH_IDS, SHAPES; "
        "print(json.dumps({f'{a}/{s}': d._model_flops(a, s) "
        "for a in ARCH_IDS for s in SHAPES}))")
    want = json.loads(out)
    got = {f"{a}/{s}": dryrun._model_flops(a, s)
           for a in ARCH_IDS for s in SHAPES}
    assert got == want


def test_extrapolation_and_layer_units():
    c1 = {"flops": 10.0, "bytes": 4.0}
    c2 = {"flops": 16.0, "bytes": 5.0}
    layer, total = dryrun._extrapolate(c1, c2, 36)
    assert layer == {"flops": 6.0, "bytes": 1.0}
    assert total == {"flops": 10.0 + 35 * 6.0, "bytes": 4.0 + 35 * 1.0}
    zamba = dryrun._cfg_for("zamba2-7b", 2)
    assert dryrun._layer_units(zamba) == 2
    assert zamba.n_layers == 2 * zamba.attn_every \
        + dryrun._cfg_for("zamba2-7b").n_layers % zamba.attn_every
    seamless = dryrun._cfg_for("seamless-m4t-medium", 1)
    assert (seamless.n_layers, seamless.enc_layers) == (1, 1)
    assert dryrun.RESULTS_DIR.name == "dryrun_results"
    assert "benchmarks" not in dryrun.RESULTS_DIR.parts
    assert len(SHAPES) == 4 and len(ARCH_IDS) == 10


def test_prepare_makes_no_kv_group_for_a_family_with_no_attention():
    """mamba2 (no KV head) on a model axis of 16: nothing to make (its
    train cell raised ZeroDivisionError here before)."""
    from repro_torch.sharding import tp

    class Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return 16
    cfg = dryrun._cfg_for("mamba2-1.3b")
    assert cfg.n_kv_heads_padded == 0
    assert tp.prepare(Mesh(), cfg) is None
