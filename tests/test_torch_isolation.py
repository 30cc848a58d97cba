"""The port stands alone: it imports no JAX and nothing of ``repro``.

* Every module of ``repro_torch`` imports in a fresh interpreter without
  pulling a ``jax*`` or ``repro``/``repro.*`` module into ``sys.modules``.
* ``chip_smoke.py`` imports neither.
* The pure-Python modules the port copies (configs, core, serving) stay
  byte-identical to their reference files, so the copies cannot drift.
* Entry points run on CUDA unless asked: without a card, a call that
  does not pass ``device="cpu"`` raises instead of running on the CPU.
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

COPIED = {
    "configs": sorted(p.name for p in (SRC / "repro" / "configs").glob("*.py")),
    "core": ["estimator.py", "interference.py", "knapsack.py",
             "multimodel.py", "profiler.py", "reconfig.py", "roofline.py"],
    "serving": ["allocator.py", "controller.py", "dispatcher.py",
                "instance.py", "metrics.py", "plane.py", "policy.py",
                "scenarios.py", "simulator.py", "workloads.py"],
}


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax_or_reference():
    modules = _port_modules()
    assert "repro_torch.kernels.flash_attention" in modules
    assert "repro_torch.launch.bench_serving" in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'repro.'))\n"
        "             or m == 'repro')\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_no_jax_or_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
    assert imported
    for name in imported:
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), name


@pytest.mark.parametrize("package", sorted(COPIED))
def test_copied_modules_are_byte_identical(package):
    files = COPIED[package]
    if package == "configs":
        assert len(files) == 13
    for name in files:
        ref = (SRC / "repro" / package / name).read_bytes()
        port = (SRC / "repro_torch" / package / name).read_bytes()
        assert port == ref, f"{package}/{name} drifted from the reference"


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.configs.gemma3_1b import GEMMA3_1B
    from repro_torch.models.lm import init_params
    from repro_torch.models.serve_lm import LmEngine, make_lm_engine
    for call in (lambda: LmEngine(), lambda: make_lm_engine("lm-tiny"),
                 lambda: init_params(GEMMA3_1B.reduced())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
