"""``repro_torch.launch.dryrun`` over 256 fake ranks, and its accounting.

The dry-run runs in a subprocess under ``torch.distributed``'s ``fake``
backend, so no process group leaks into the test worker: one train cell
and one decode cell of qwen3-8b at full config, and one skipped cell,
each with the JAX package's schema, the H100 roofline terms and the
port's per-layer gathers; ``_model_flops`` equals the JAX package's
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
CELLS = [("qwen3-8b", "train_4k"), ("qwen3-8b", "decode_32k"),
         ("qwen3-8b", "long_500k")]


def _python(code: str, timeout: int = 240) -> str:
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
    # the sharded step gathers each layer's leaves and reduces the
    # gradients onto the shards (the model axis shards storage only)
    kinds = c["collectives"]["per_kind"]
    assert kinds["all-gather"] > 0 and kinds["reduce-scatter"] > 0
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
    # the deploy view gathered a layer at a time, nothing reduced
    assert set(c["collectives"]["per_kind"]) == {"all-gather"}
    assert c["memory"]["cache_bytes"] > 0 and c["memory"][
        "optimizer_bytes"] == 0
    assert c["roofline"]["memory_s"] == pytest.approx(
        c["cost"]["corrected_total"]["bytes"] / hlo_analysis.HBM_BW)
    s = cells[("qwen3-8b", "long_500k")]
    assert s["status"] == "SKIP"
    assert s["reason"] == skip_reason("qwen3-8b", "long_500k")
    assert "memory" not in s


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
