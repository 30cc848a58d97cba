"""The port stands alone: it imports no JAX and nothing of ``repro``.

* Every module of ``repro_torch`` imports in a fresh interpreter without
  pulling a ``jax*`` or ``repro``/``repro.*`` module into ``sys.modules``.
* ``chip_smoke.py`` imports neither.
* The pure-Python modules the port copies (configs, core, serving) stay
  byte-identical to their reference files, so the copies cannot drift.
* The launcher's framework-free functions (the simulated, fast, fabric
  and multi-model modes and their helpers) are the reference's
  functions, compared as syntax trees (docstrings included, comments
  not), so they cannot drift either.
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
             "multimodel.py", "paper_profiles.py", "profiler.py",
             "reconfig.py", "roofline.py"],
    "serving": ["allocator.py", "controller.py", "dispatcher.py",
                "fabric.py", "fastsim.py", "instance.py", "metrics.py",
                "plane.py", "policy.py", "scenarios.py", "simulator.py",
                "tenancy.py", "workloads.py"],
}
# functions of launch/bench_serving.py that use no framework: the port
# runs the reference's code for them
LAUNCHER_FUNCTIONS = [
    "_cap_rate", "_controller_report_fields", "_emit_report",
    "_make_backend", "_parse_models", "_select_scenarios", "_sim_loop",
    "_slo_feasible", "_static_optimizer", "policy_key", "run_fabric_policy",
    "run_fabric_scenario", "run_lm_policy", "run_mm_scenario",
    "run_multimodel_policy", "run_policy", "run_real_policy",
    "run_scenario",
]


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


def _functions(path):
    tree = ast.parse(path.read_text())
    return {node.name: ast.dump(node) for node in tree.body
            if isinstance(node, ast.FunctionDef)}


@pytest.mark.parametrize("name", LAUNCHER_FUNCTIONS)
def test_launcher_functions_match_the_reference(name):
    ref = _functions(SRC / "repro" / "launch" / "bench_serving.py")
    port = _functions(SRC / "repro_torch" / "launch" / "bench_serving.py")
    assert port[name] == ref[name], f"bench_serving.{name} drifted"


def test_launcher_constants_match_the_reference():
    from repro.launch import bench_serving as ref
    from repro_torch.launch import bench_serving as port
    for name in ("POLICIES", "DISPATCHES", "FABRIC_POLICIES", "ENGINES",
                 "SCHEMA_VERSION", "DRAIN_FACTOR", "DRAIN_MIN_S",
                 "REAL_DRAIN_MIN_S", "REAL_DRAIN_FACTOR"):
        assert getattr(port, name) == getattr(ref, name), name


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.configs.gemma3_1b import GEMMA3_1B
    from repro_torch.launch.bench_serving import run_real_scenario
    from repro_torch.launch.serve import make_torch_runner
    from repro_torch.models.lm import init_params
    from repro_torch.models.micro import (make_fidelity_micro_runner,
                                          make_micro_runner)
    from repro_torch.models.serve_lm import LmEngine, make_lm_engine
    from repro_torch.serving.scenarios import get_scenario
    for call in (lambda: LmEngine(), lambda: make_lm_engine("lm-tiny"),
                 lambda: init_params(GEMMA3_1B.reduced()),
                 lambda: make_micro_runner("mlp-tiny"),
                 lambda: make_micro_runner("attn-tiny"),
                 lambda: make_fidelity_micro_runner("mlp"),
                 lambda: make_torch_runner("gemma3-1b"),
                 lambda: run_real_scenario(
                     get_scenario("steady-poisson"), real_model="mlp-tiny",
                     units=2, duration=1.0, seed=0, initial_batch=1,
                     max_batch=2, slo_factor=4.0,
                     reconfigure_timeout=1.0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
