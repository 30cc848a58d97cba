"""The port stands alone: it imports no JAX and nothing of ``repro``.

* Every module of ``repro_torch`` imports in a fresh interpreter without
  pulling a ``jax*``, ``ml_dtypes`` or ``repro``/``repro.*`` module into
  ``sys.modules`` (the card's machine has none of them).
* ``chip_smoke.py`` imports neither.
* The pure-Python modules the port copies (configs, core, serving) stay
  byte-identical to their reference files, so the copies cannot drift.
* The launcher's framework-free functions (the simulated, fast, fabric
  and multi-model modes and their helpers) are the reference's
  functions, compared as syntax trees (docstrings included, comments
  not), so they cannot drift either; so are the HLO parser,
  ``CollectiveStats`` and ``ProgramCost`` that ``launch/step_cost.py``
  shares with ``hlo_analysis.py``, and ``launch/report.py``'s tables
  (whose residency column names the H100 in place of v5e).
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


# definitions the port's step cost and report share with the reference's
# hlo_analysis.py and report.py: (reference module, port module, names)
SHARED_DEFINITIONS = {
    "step_cost": ("hlo_analysis.py", "step_cost.py", [
        "CollectiveStats", "ProgramCost", "_COLLECTIVE_RE", "_DTYPE_BYTES",
        "_SHAPE_RE", "_shape_bytes", "collective_stats"]),
    "report": ("report.py", "report.py", [
        "GIB", "dryrun_table", "fmt_bytes", "load", "main",
        "multi_pod_table", "perf_table", "roofline_table"]),
}
# the one string the port's report changes: its card
REPORT_CARD = ("fits v5e", "fits H100")


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax_or_reference():
    modules = _port_modules()
    for name in ("repro_torch.kernels.flash_attention",
                 "repro_torch.distributed.compression",
                 "repro_torch.distributed.expert_parallel",
                 "repro_torch.distributed.sharding",
                 "repro_torch.launch.bench_serving",
                 "repro_torch.launch.dryrun",
                 "repro_torch.launch.hillclimb",
                 "repro_torch.launch.mesh",
                 "repro_torch.launch.profile_gpu",
                 "repro_torch.launch.report",
                 "repro_torch.launch.step_cost",
                 "repro_torch.core.hardware",
                 "repro_torch.launch.train", "repro_torch.data.pipeline",
                 "repro_torch.training.checkpoint",
                 "repro_torch.training.optimizer",
                 "repro_torch.training.train_loop",
                 "repro_torch.training.tree"):
        assert name in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'repro.',\n"
        "                              'ml_dtypes')))\n"
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


def _definitions(path):
    """{name: syntax tree} of a module's top-level functions, classes and
    assignments to one name."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.dump(node)
    return out


@pytest.mark.parametrize("module", sorted(SHARED_DEFINITIONS))
def test_shared_definitions_match_the_reference(module):
    ref_file, port_file, names = SHARED_DEFINITIONS[module]
    ref = _definitions(SRC / "repro" / "launch" / ref_file)
    port = _definitions(SRC / "repro_torch" / "launch" / port_file)
    for name in names:
        want = ref[name]
        if module == "report":
            want = want.replace(*REPORT_CARD)
        assert port[name] == want, f"{port_file}: {name} drifted"


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
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batches_for_model
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.bench_serving import run_real_scenario
    from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                         make_submesh)
    from repro_torch.launch.serve import make_torch_runner
    from repro_torch.models.lm import build_model
    from repro_torch.training import TrainConfig, train
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
                 lambda: make_mesh((1, 1), ("data", "model")),
                 lambda: make_production_mesh(),
                 lambda: make_submesh(1),
                 lambda: launch_train.main(["--arch", "gemma3-1b",
                                            "--reduced", "--steps", "1"]),
                 lambda: train(build_model(GEMMA3_1B.reduced()),
                               TrainConfig(), batches_for_model(
                                   GEMMA3_1B.reduced(), ShapeConfig(
                                       "t", 8, 1, "train")), steps=1),
                 lambda: run_real_scenario(
                     get_scenario("steady-poisson"), real_model="mlp-tiny",
                     units=2, duration=1.0, seed=0, initial_batch=1,
                     max_batch=2, slo_factor=4.0,
                     reconfigure_timeout=1.0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
