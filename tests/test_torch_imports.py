"""repro_torch stands alone: no module of it, and not chip_smoke.py, imports
jax or the JAX package; it imports with jax blocked; and its entry points
run on the card unless asked for the CPU, raising where there is none."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_raise_without_cuda(no_cuda):
    from repro_torch import resolve_device
    from repro_torch.configs.qwen3_8b import SMOKE
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.interop import from_numpy_tree
    from repro_torch.models import init_model
    from repro_torch.serve.deploy import DeployPlan, export_for_layers
    from repro_torch.serve.engine import Engine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(0, SMOKE, QuantConfig())
    params = init_model(0, SMOKE, QuantConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_for_layers(params, QuantConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(SMOKE, QuantConfig(), params)
    ex = export_for_layers(params, QuantConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine.from_artifact(SMOKE, DeployPlan(qcfg=QuantConfig()), ex)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_numpy_tree({"a": [1, 2]})
    assert Engine.from_artifact(SMOKE, DeployPlan(qcfg=QuantConfig()), ex,
                                device="cpu").device.type == "cpu"


def test_pipeline_runs_on_the_card_unless_asked_for_the_cpu(no_cuda):
    """PipelineConfig defaults to the card: run_pipeline raises without one
    (no CPU fallback); ``device="cpu"`` is the explicit request."""
    from repro_torch.pipeline import PipelineConfig, run_pipeline
    from repro_torch.pipeline.adapters import get_adapter
    assert PipelineConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_pipeline(PipelineConfig(steps=0))
    assert get_adapter(PipelineConfig(device="cpu")).device.type == "cpu"


def test_cli_runs_with_jax_blocked():
    """``python -m repro_torch`` (plan, list-configs) with jax and the JAX
    package unimportable."""
    code = ("import sys, runpy\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.argv = ['repro_torch', 'plan', '--config', 'qwen3-8b']\n"
            "runpy.run_module('repro_torch', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("## qwen3-8b mode=w4a8")


def test_kernel_build_needs_nvcc(monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "Path", _NoCuda)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


class _NoCuda(type(pathlib.Path())):
    def exists(self):
        return False
