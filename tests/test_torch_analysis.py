"""The port's static analyzer (``repro_torch.analysis``, ``python -m
repro_torch check``) against the JAX package's, and tested by injection.

- the trace layer's ``(check, severity)`` multiset equals
  ``repro.analysis.jaxpr_checks.analyze_config``'s on four configs, and
  ``trace.int8dot`` holds on deepseek-v2's int8 leaves (F21: K1's int8
  entry is the integer operand; the old widening int8 branch is caught);
- each load-bearing claim has a test that injects the violation it must
  catch (the cases of ``tests/test_analysis.py``): a second host transfer
  in the decode step, a host RNG draw, a float dequant before a product,
  each lint rule with its ``# qft: noqa`` scoping;
- the CLI's exit codes and its JSON report, which the JAX package's
  stdlib validator accepts;
- ``launch.hlo_analysis``: FLOPs of a traced product, the H100 roofline
  constants.
"""
import collections
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from benchmarks.check_results import check_analysis  # noqa: E402
from repro.analysis.jaxpr_checks import (  # noqa: E402
    analyze_config as j_analyze_config)
from repro_torch.analysis.graph_checks import (  # noqa: E402
    _linear_signatures, analyze_config, callback_count, check_int8dot,
    dequant_dot_violations, integer_operand_count, kernel_nodes, trace,
    transfer_surfaces)
from repro_torch.analysis.lint import lint_source  # noqa: E402
from repro_torch.analysis.report import Diagnostic, Report  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.fakequant import unpack_int4  # noqa: E402
from repro_torch.core.qconfig import QuantConfig, permissive  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels._library import kernel_of  # noqa: E402
from repro_torch.kernels.ops import qlinear_deployed  # noqa: E402
from repro_torch.kernels.quant_matmul import (  # noqa: E402
    quant_matmul, quant_matmul_int8)
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.pipeline.cli import main as cli_main  # noqa: E402
from repro_torch.serve.deploy import abstract_deploy_surfaces  # noqa: E402
from repro_torch.serve.engine import (ServeConfig,  # noqa: E402
                                      serve_trace_surfaces)

TINY = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                   n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                   head_dim=8, scan_layers=False, remat=False)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _decode_surfaces():
    plan, _ex, deployed = abstract_deploy_surfaces(TINY, permissive())
    scfg = ServeConfig(max_slots=2, max_len=32, prefill_chunk=8)
    return serve_trace_surfaces(TINY, plan=plan, scfg=scfg), deployed


# ---------------------------------------------------------------------------
# the trace layer against the JAX package's
# ---------------------------------------------------------------------------

def _severities(diags) -> collections.Counter:
    return collections.Counter((d.check, d.severity) for d in diags)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b",
                                  "seamless-m4t-medium"])
def test_check_severities_match_jax(arch):
    """The same checks with the same severities, counted (a multiset):
    the skips of int8dot included, and no error on either side."""
    port = analyze_config(arch)
    assert _severities(port) == _severities(j_analyze_config(arch))
    assert not [d for d in port if d.severity == "error"]


def test_check_cli_on_the_port_matches_jax(tmp_path, capsys):
    """``python -m repro_torch check --config qwen3-8b`` on the port's own
    tree: the lint layer over src/repro_torch and the trace layer, exit 0;
    its JSON report's trace diagnostics have the JAX package's
    severities."""
    path = tmp_path / "report.json"
    assert cli_main(["check", "--config", "qwen3-8b", "--json",
                     str(path)]) == 0
    assert "0 error(s)" in capsys.readouterr().out
    rep = json.loads(path.read_text())
    assert rep["summary"]["configs"] == ["qwen3-8b"]
    trace_diags = [d for d in rep["diagnostics"] if d["config"]]
    assert collections.Counter(
        (d["check"], d["severity"]) for d in trace_diags) == \
        _severities(j_analyze_config("qwen3-8b"))


def test_int8dot_holds_on_deepseek_int8_leaves():
    """F21: deepseek-v2's int8 (exempt) leaves reach K1's int8 entry with
    the integer weight as its operand — info, no violation."""
    cfg = get_config("deepseek-v2-236b", smoke=True)
    plan, exported, _ = abstract_deploy_surfaces(cfg, QuantConfig())
    sigs = _linear_signatures(exported)
    assert any(not packed for packed, *_ in sigs)
    diags = check_int8dot("deepseek-v2-236b", exported, plan)
    assert [d.severity for d in diags if d.severity != "skip"] == ["info"]


def test_old_int8_branch_is_a_violation():
    """F21's fault, pinned: the widening int8 branch (the plain version,
    ``q.to(float32)`` then the product) fails trace.int8dot; the int8
    entry passes with a non-vacuous integer operand."""
    x, q = _meta((8, 64)), _meta((64, 96), torch.int8)
    s_wl, s_wr = _meta((64,)), _meta((96,))
    bad = trace(ref.quant_matmul_int8_ref, x, q, s_wl, s_wr)
    assert dequant_dot_violations(bad)
    good = trace(quant_matmul_int8, x, q, s_wl, s_wr)
    assert dequant_dot_violations(good) == []
    assert integer_operand_count(good) == 1
    assert kernel_nodes(good) == ["quant_matmul"]


# ---------------------------------------------------------------------------
# injection: one-transfer (tests/test_analysis.py:48-109)
# ---------------------------------------------------------------------------

def test_clean_decode_step_has_one_transfer_surface():
    s, deployed = _decode_surfaces()
    tr = trace(s["decode_fn"], deployed, s["cache"], s["state"])
    assert callback_count(tr) == 0
    assert transfer_surfaces(tr) == 1


def test_injected_second_host_transfer_is_caught():
    """A device→host round trip smuggled into the decode step bumps the
    surface count past 1."""
    s, deployed = _decode_surfaces()

    def leaky_decode(params, cache, state):
        cache, state, cur, emit = s["decode_fn"](params, cache, state)
        cur = cur.cpu().to(cur.device)          # the injected violation
        return cache, state, cur, emit

    tr = trace(leaky_decode, deployed, s["cache"], s["state"])
    assert callback_count(tr) == 1
    assert transfer_surfaces(tr) == 2


def test_decode_step_contains_device_rng():
    """Non-vacuity for device-side sampling: the per-slot counter hash
    (integer xor-shifts) and the Gumbel argmax are in the decode graph."""
    s, deployed = _decode_surfaces()
    tr = trace(s["decode_fn"], deployed, s["cache"], s["state"])
    ops = {str(n.target) for n in tr.nodes()}
    assert any("bitwise_xor" in o for o in ops)
    assert any("argmax" in o for o in ops) and any("log" in o for o in ops)


def test_injected_host_rng_draw_is_caught():
    """A host np.random draw resampling the token needs the token on the
    host: the data-dependent read is a second transfer surface."""
    s, deployed = _decode_surfaces()

    def leaky_decode(params, cache, state):
        cache, state, cur, emit = s["decode_fn"](params, cache, state)
        cur = torch.tensor([np.random.default_rng(t).integers(0, 64)
                            for t in cur.tolist()], dtype=cur.dtype)
        return cache, state, cur, emit

    tr = trace(leaky_decode, deployed, s["cache"], s["state"])
    assert tr.untraceable is not None
    assert transfer_surfaces(tr) == 2


# ---------------------------------------------------------------------------
# injection: int8dot (tests/test_analysis.py:115-171)
# ---------------------------------------------------------------------------

def _qmm_args(m=128, k=128, n=128):
    return (_meta((m, k)), _meta((k // 2, n), torch.uint8), _meta((k,)),
            _meta((n,)))


def _qmm(x, q, s_wl, s_wr):
    return quant_matmul(x, q, s_wl, s_wr)


def test_int8dot_kernel_node_is_clean():
    tr = trace(_qmm, *_qmm_args())
    assert dequant_dot_violations(tr) == []
    assert integer_operand_count(tr) >= 1
    assert kernel_nodes(tr) == ["quant_matmul"]


def test_injected_f32_dequant_before_dot_is_caught():
    """The int4 plain version unpacks and widens the weight to f32 before
    the product: exactly the signature the analyzer must flag."""
    bad = dequant_dot_violations(trace(ref.quant_matmul_ref, *_qmm_args()))
    assert bad, "the widening plain version must trip the int8dot invariant"
    assert "_to_copy" in bad[0]


def test_handwritten_dequant_matmul_is_caught():
    def f(x, q, s):
        w = q.to(torch.float32) * s               # materialized f32 [K, N]
        return x @ w

    tr = trace(f, _meta((8, 16)), _meta((16, 32), torch.int8), _meta((32,)))
    assert dequant_dot_violations(tr)


def test_float_weights_do_not_false_positive():
    def f(x, w):
        return x @ (w.to(torch.float32) * 2.0)    # bf16→f32: fine

    tr = trace(f, _meta((8, 16)), _meta((16, 32), torch.bfloat16))
    assert dequant_dot_violations(tr) == []


def test_int4_unpack_does_not_false_positive():
    """uint8→int8 nibble unpack is int→int: the unpacked weight through
    K1's int8 entry trips nothing."""
    def f(x, q4, s_wl, s_wr):
        return quant_matmul_int8(x, unpack_int4(q4, axis=0), s_wl, s_wr)

    tr = trace(f, _meta((8, 16)), _meta((8, 32), torch.uint8), _meta((16,)),
               _meta((32,)))
    assert dequant_dot_violations(tr) == []
    assert integer_operand_count(tr) == 1


def test_untiled_int4_takes_the_int8_entry_on_packed_nibbles():
    """An int4 leaf the int4 kernel does not tile (N 32, SMOKE width) goes,
    on the kernel route, to K1's int8 entry with the packed uint8 weight
    as its operand: one kernel node, no convert, no unpack."""
    ex = {"q": _meta((32, 32), torch.uint8), "s_wl": _meta((64,)),
          "s_wr": _meta((32,))}
    tr = trace(lambda x, e: qlinear_deployed(x, e), _meta((8, 64)), ex)
    assert dequant_dot_violations(tr) == []
    assert integer_operand_count(tr) == 1
    assert [str(n.target) for n in tr.nodes() if kernel_of(n.target)] == [
        "repro_torch.quant_matmul_i8.default"]
    assert [n for n in tr.nodes() if n.op == "call_function"
            and str(n.target).split(".")[1] in ("bitwise_and", "__rshift__",
                                                "bitwise_right_shift")] == []


# ---------------------------------------------------------------------------
# the lint layer (tests/test_analysis.py:177-311)
# ---------------------------------------------------------------------------

def _ids(diags):
    return [d.check for d in diags]


def test_qft001_unnamed_qlinear():
    src = "p = init_qlinear(gen, 4, 8, cfg)\n"
    diags = lint_source(src, "src/repro_torch/models/foo.py")
    assert _ids(diags) == ["QFT001"] and diags[0].line == 1
    clean = "p = init_qlinear(gen, 4, 8, cfg, name='layers.mlp.up')\n"
    assert lint_source(clean, "src/repro_torch/models/foo.py") == []


def test_qft002_dropped_plan_is_caught():
    src = "out = forward(params, cfg, qcfg, batch)\n"
    diags = lint_source(src, "src/repro_torch/serve/foo.py")
    assert _ids(diags) == ["QFT002"]
    assert (diags[0].file, diags[0].line) == ("src/repro_torch/serve/foo.py",
                                              1)
    assert lint_source("out = forward(params, cfg, None, batch)\n",
                       "src/repro_torch/serve/foo.py") == []
    assert lint_source("out = forward(params, cfg, qcfg, batch, plan=p)\n",
                       "src/repro_torch/serve/foo.py") == []
    assert lint_source(src, "tests/test_foo.py") == []


@pytest.mark.parametrize("sync", ["state.item()", "state.cpu()",
                                  "state.tolist()",
                                  "torch.cuda.synchronize()",
                                  "np.asarray(state)", "int(state)"])
def test_qft003_host_sync_in_step(sync):
    src = ("def make_thing(cfg):\n"
           "    def thing_step(params, state):\n"
           f"        x = {sync}\n"
           "        return state\n"
           "    return thing_step\n")
    diags = lint_source(src, "src/repro_torch/serve/foo.py")
    assert _ids(diags) == ["QFT003"]
    # scoped to serve/ and train/: the same code elsewhere is not flagged
    assert lint_source(src, "src/repro_torch/kernels/foo.py") == []


def test_qft003_host_rng_in_step():
    src = ("def make_thing(cfg):\n"
           "    def thing_step(params, state):\n"
           "        noise = np.random.normal(size=state.shape)\n"
           "        return state + noise\n"
           "    return thing_step\n")
    diags = lint_source(src, "src/repro_torch/train/foo.py")
    assert _ids(diags) == ["QFT003"]
    assert "request's seed" in diags[0].message
    assert lint_source(src.replace(
        "state.shape)", "state.shape)  # qft: noqa[QFT003]"),
        "src/repro_torch/train/foo.py") == []
    device = ("def make_thing(cfg):\n"
              "    def thing_step(params, state, seeds, counts):\n"
              "        return state + gumbel_noise(seeds, counts, 4)\n"
              "    return thing_step\n")
    assert lint_source(device, "src/repro_torch/train/foo.py") == []


def test_qft003_engine_host_loop():
    src = ("class Engine:\n"
           "    def step(self):\n"
           "        a = self.state.tolist()\n"
           "        b = self.more.cpu()\n"
           "        return a, b\n")
    diags = lint_source(src, "src/repro_torch/serve/engine2.py")
    assert _ids(diags) == ["QFT003", "QFT003"]


def test_qft004_hardcoded_route_is_caught():
    diags = lint_source("y = qlinear_deployed(x, ex, use_kernels=True)\n",
                        "src/repro_torch/kernels/foo.py")
    assert _ids(diags) == ["QFT004"] and diags[0].line == 1
    assert lint_source("y = qlinear_deployed(x, ex, plan=plan)\n",
                       "src/repro_torch/kernels/foo.py") == []
    assert lint_source("y = qlinear_deployed(x, ex, use_kernels=flag)\n",
                       "src/repro_torch/kernels/foo.py") == []
    assert _ids(lint_source("y = f(x, interpret=True)\n",
                            "src/repro_torch/kernels/foo.py")) == ["QFT004"]
    assert _ids(lint_source("def f(x, interpret=False):\n    return x\n",
                            "src/repro_torch/kernels/foo.py")) == ["QFT004"]


def test_qft005_wall_clock_and_unseeded_random():
    src = ("t0 = time.perf_counter()\n"
           "x = np.random.rand(4)\n"
           "r = np.random.RandomState(0).rand(4)\n")
    diags = lint_source(src, "benchmarks/foo.py")
    assert _ids(diags) == ["QFT005", "QFT005"]
    assert [d.line for d in diags] == [1, 2]
    assert lint_source(src, "src/repro_torch/train/foo.py") == []


def test_qft006_mutable_dataclass_default():
    src = ("@dataclasses.dataclass\n"
           "class Cfg:\n"
           "    xs: list = []\n"
           "    ok: tuple = ()\n"
           "    also_ok: list = dataclasses.field(default_factory=list)\n")
    assert _ids(lint_source(src, "src/repro_torch/models/c.py")) == [
        "QFT006"]


def test_noqa_suppression_is_rule_scoped():
    p = "src/repro_torch/kernels/foo.py"
    flagged = "y = f(x, use_kernels=True)\n"
    assert _ids(lint_source(flagged, p)) == ["QFT004"]
    assert lint_source(flagged[:-1] + "  # qft: noqa[QFT004]\n", p) == []
    assert _ids(lint_source(flagged[:-1] + "  # qft: noqa[QFT005]\n",
                            p)) == ["QFT004"]
    assert lint_source(flagged[:-1] + "  # qft: noqa\n", p) == []


def test_syntax_error_is_qft000():
    assert _ids(lint_source("def f(:\n", "src/repro_torch/x.py")) == [
        "QFT000"]


# ---------------------------------------------------------------------------
# the CLI and the report
# ---------------------------------------------------------------------------

def test_check_cli_injected_violation_exits_nonzero(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("y = qlinear_deployed(x, ex, use_kernels=False)\n")
    rc = cli_main(["check", "--lint-only", "--paths", str(bad)])
    out = capsys.readouterr().out
    assert rc == 1 and "QFT004" in out and "bad.py" in out


def test_check_cli_json_report_validates(tmp_path, capsys):
    path = tmp_path / "ANALYSIS_report.json"
    rc = cli_main(["check", "--lint-only", "--paths",
                   "src/repro_torch/analysis", "--json", str(path)])
    capsys.readouterr()
    assert rc == 0
    assert check_analysis(path) == []
    rep = json.loads(path.read_text())
    assert rep["schema"] == 1 and rep["tool"] == "repro-check"


def test_check_report_with_an_error_is_rejected(tmp_path):
    r = Report()
    r.add(Diagnostic(check="QFT004", message="boom", file="x.py", line=3))
    p = tmp_path / "bad_report.json"
    r.write_json(p)
    errs = check_analysis(p)
    assert errs and any("QFT004" in e for e in errs)


def test_check_cli_usage_errors(capsys):
    assert cli_main(["check", "--config", "not-a-config",
                     "--trace-only"]) == 2
    assert cli_main(["check", "--lint-only", "--trace-only"]) == 2
    capsys.readouterr()


# ---------------------------------------------------------------------------
# launch.hlo_analysis
# ---------------------------------------------------------------------------

def test_cost_summary_counts_products_and_kernels():
    tr = trace(lambda a, b: a @ b, _meta((16, 32)), _meta((32, 8)))
    got = H.cost_summary(tr)
    assert got["flops"] == 2 * 16 * 32 * 8
    assert got["bytes"] == 4 * (16 * 32 + 32 * 8 + 16 * 8)
    tr = trace(_qmm, *_qmm_args(m=4))
    assert H.cost_summary(tr)["kernel_flops"] == {
        "quant_matmul": 2.0 * 4 * 128 * 128}


def test_roofline_terms_take_the_h100_constants():
    r = H.roofline_terms(989e12, 3.35e12, 0.0, 989e12 * 256, 256)
    assert r["compute_s"] == pytest.approx(1.0)
    assert r["memory_s"] == pytest.approx(1.0)
    assert r["useful_flops_ratio"] == pytest.approx(1.0)
    assert (H.PEAK_FLOPS, H.HBM_BW, H.LINK_BW) == (989e12, 3.35e12, 450e9)
    slow = H.roofline_terms(1.0, 1.0, 1.0, 1.0, 1, peak_flops=1.0,
                            hbm_bw=0.5, link_bw=2.0)
    assert slow["dominant"] == "memory"
