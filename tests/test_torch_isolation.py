"""The port stands alone: it imports no JAX and nothing of ``repro``.

* Every module of ``repro_torch`` imports in a fresh interpreter without
  pulling a ``jax*``, ``ml_dtypes`` or ``repro``/``repro.*`` module into
  ``sys.modules`` (the card's machine has none of them).
* ``chip_smoke.py`` imports neither, and nor does a run of any of the
  five ``examples/*_torch.py`` counterparts (nor ``benchmarks``); the
  five reference scripts stay as they were (their SHA-256 is recorded
  here).
* The pure-Python modules the port copies (configs, core, serving) stay
  byte-identical to their reference files, so the copies cannot drift.
  The port's span log (``serving/spans.py``) departs from the reference
  in the serving modules that stamp it and in ``run_lm_policy``: those
  are the reference's syntax trees once a counted number of span-log
  nodes is taken out of them (:class:`_WithoutSpanLog`), and
  ``RealPlane`` lost two counters nothing read.
* The launcher's framework-free functions (the simulated, fast, fabric
  and multi-model modes and their helpers) are the reference's
  functions, compared as syntax trees (docstrings included, comments
  not), so they cannot drift either; so are the HLO parser,
  ``CollectiveStats`` and ``ProgramCost`` that ``launch/step_cost.py``
  shares with ``hlo_analysis.py``, and ``launch/report.py``'s tables
  (whose residency column names the H100 in place of v5e).
* Entry points run on CUDA unless asked: without a card, a call that
  does not pass ``device="cpu"`` raises instead of running on the CPU,
  and so do the serve and train examples without ``--device cpu``.
"""

import ast
import hashlib
import pkgutil
import runpy
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
# the copies that carry the port's span log (serving/spans.py): each is
# compared with its reference once _WithoutSpanLog has taken the log out
# of it, which must take out exactly the listed number of nodes, and with
# the reference's statements that write the listed RealPlane counters
# (dropped by the port: nothing read them) taken out too
SPAN_LOG_COPIES = {
    ("serving", "plane.py"): (14, ("inflight", "batches_executed")),
    ("serving", "dispatcher.py"): (9, ()),
    ("serving", "policy.py"): (7, ()),
    ("serving", "fastsim.py"): (1, ()),
}
# launcher functions that carry it, with the nodes taken out of each
SPAN_LOG_FUNCTIONS = {"run_lm_policy": 6}
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


# the reference's examples/ scripts, which the port leaves as they were
REFERENCE_EXAMPLES = {
    "quickstart.py":
        "6919d2297e63adf28917faaf4ffe9104526ee5cadfaaaa93b8fd805e5083dbe2",
    "bench_scenarios.py":
        "e4db1090ad7e8ebf1cf9e508a8b4be79ba10d7524f78662dfc94955cd5009dec",
    "serve_online.py":
        "9a5ebfdd72ce0fbe043b2489efd21281822f96256ff1072cee011dfc67d60290",
    "train_small.py":
        "7fe2cc0a143ea1894c02218fde6a23a8984d3abfb1b80cd041feb07df0d3ad79",
    "reconfigure_live.py":
        "26056ebd6a2503aa736660785ba081ebbe05d637a23afd104071a64bc882f9a0",
}
# each counterpart's arguments for a short CPU run (train_small: one
# step, no checkpoint)
EXAMPLE_ARGV = {
    "quickstart": [],
    "bench_scenarios": ["--duration", "2"],
    "serve_online": ["--device", "cpu", "--duration", "1",
                     "--rate-step", "0.5", "--max-batch", "8"],
    "train_small": ["--device", "cpu", "--steps", "1", "--ckpt", ""],
    "reconfigure_live": [],
}


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


@pytest.mark.parametrize("name", sorted(EXAMPLE_ARGV))
def test_example_counterpart_runs_without_jax_reference_or_benchmarks(name):
    """``python examples/<name>_torch.py`` as ``runpy`` runs it: exit 0,
    and no ``jax*``, ``ml_dtypes``, ``repro``/``repro.*`` or
    ``benchmarks`` module in ``sys.modules`` afterwards."""
    path = ROOT / "examples" / f"{name}_torch.py"
    code = (
        "import contextlib, io, runpy, sys\n"
        f"sys.argv = [{str(path)!r}, *{EXAMPLE_ARGV[name]!r}]\n"
        "rc = 0\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    try:\n"
        "        runpy.run_path(sys.argv[0], run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        rc = e.code or 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m in ('jax', 'repro', 'benchmarks')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'repro.',\n"
        "                              'ml_dtypes', 'benchmarks.')))\n"
        "print(rc, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []"


@pytest.mark.parametrize("name", sorted(REFERENCE_EXAMPLES))
def test_reference_example_is_unchanged(name):
    digest = hashlib.sha256((ROOT / "examples" / name).read_bytes())
    assert digest.hexdigest() == REFERENCE_EXAMPLES[name], name


@pytest.mark.parametrize("package", sorted(COPIED))
def test_copied_modules_are_byte_identical(package):
    files = COPIED[package]
    if package == "configs":
        assert len(files) == 13
    for name in files:
        ref = (SRC / "repro" / package / name).read_bytes()
        port = (SRC / "repro_torch" / package / name).read_bytes()
        if (package, name) not in SPAN_LOG_COPIES:
            assert port == ref, f"{package}/{name} drifted from the reference"
            continue
        n_stripped, dropped = SPAN_LOG_COPIES[package, name]
        want = _without_counters(ast.parse(ref), dropped)
        strip = _WithoutSpanLog()
        got = strip.visit(ast.parse(port))
        assert strip.stripped == n_stripped, \
            f"{package}/{name}: the span log's nodes changed in number"
        assert ast.dump(got) == ast.dump(want), \
            f"{package}/{name} drifted from the reference"


def _span_log_value(node) -> bool:
    """``span`` or ``<x>.spans``: the plane's log or a batch record."""
    return ((isinstance(node, ast.Name) and node.id == "span")
            or (isinstance(node, ast.Attribute) and node.attr == "spans"))


class _WithoutSpanLog(ast.NodeTransformer):
    """A port module's syntax tree with the span log taken out, counting
    each node taken in ``stripped``: the import of ``spans``; the
    assignments of ``span``, ``spans`` and ``<x>.spans``; each ``if
    span is not None`` and ``if <x>.spans is not None`` that has no
    ``else``; and each parameter and keyword named ``span``, ``spans``,
    ``trigger`` or ``cause``."""

    NAMES = frozenset({"span", "spans", "trigger", "cause"})

    def __init__(self):
        self.stripped = 0

    def _strip(self):
        self.stripped += 1
        return None

    def visit_ImportFrom(self, node):
        return self._strip() if node.module == "spans" else node

    def _assign(self, node):
        targets = getattr(node, "targets", None) or [node.target]
        if len(targets) == 1 and (_span_log_value(targets[0]) or (
                isinstance(targets[0], ast.Name)
                and targets[0].id == "spans")):
            return self._strip()
        return self.generic_visit(node)

    visit_Assign = visit_AnnAssign = _assign

    def visit_If(self, node):
        test = node.test
        if (not node.orelse and isinstance(test, ast.Compare)
                and _span_log_value(test.left)
                and [type(op) for op in test.ops] == [ast.IsNot]
                and len(test.comparators) == 1
                and isinstance(test.comparators[0], ast.Constant)
                and test.comparators[0].value is None):
            return self._strip()
        return self.generic_visit(node)

    def visit_arguments(self, node):
        pos = node.posonlyargs + node.args
        defaults = [None] * (len(pos) - len(node.defaults)) + node.defaults
        keep = [i for i, a in enumerate(pos) if a.arg not in self.NAMES]
        kw = [i for i, a in enumerate(node.kwonlyargs)
              if a.arg not in self.NAMES]
        self.stripped += len(pos) - len(keep) + len(node.kwonlyargs) - len(kw)
        n_only = len(node.posonlyargs)
        node.posonlyargs = [pos[i] for i in keep if i < n_only]
        node.args = [pos[i] for i in keep if i >= n_only]
        node.defaults = [defaults[i] for i in keep
                         if defaults[i] is not None]
        node.kw_defaults = [node.kw_defaults[i] for i in kw]
        node.kwonlyargs = [node.kwonlyargs[i] for i in kw]
        return self.generic_visit(node)

    def visit_Call(self, node):
        keep = [k for k in node.keywords if k.arg not in self.NAMES]
        self.stripped += len(node.keywords) - len(keep)
        node.keywords = keep
        return self.generic_visit(node)


def _without_counters(tree, names):
    """The reference's tree without the statements that write
    ``self.<name>`` for each of ``names``."""
    class Drop(ast.NodeTransformer):
        def _write(self, node):
            targets = getattr(node, "targets", None) or [node.target]
            if any(isinstance(t, ast.Attribute) and t.attr in names
                   and isinstance(t.value, ast.Name) and t.value.id == "self"
                   for t in targets):
                return None
            return node

        visit_Assign = visit_AugAssign = _write

    return Drop().visit(tree) if names else tree


def _functions(path, strip=None):
    """Each top-level function of ``path``, dumped; the ones named in
    ``strip`` (a name -> :class:`_WithoutSpanLog` map) without the span
    log."""
    tree = ast.parse(path.read_text())
    strip = strip or {}
    return {node.name: ast.dump(strip[node.name].visit(node)
                                if node.name in strip else node)
            for node in tree.body if isinstance(node, ast.FunctionDef)}


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
    strip = {f: _WithoutSpanLog() for f in SPAN_LOG_FUNCTIONS}
    port = _functions(SRC / "repro_torch" / "launch" / "bench_serving.py",
                      strip)
    assert port[name] == ref[name], f"bench_serving.{name} drifted"
    if name in strip:
        assert strip[name].stripped == SPAN_LOG_FUNCTIONS[name], \
            f"bench_serving.{name}: the span log's nodes changed in number"


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

    def example(name, *argv):
        """``python examples/<name>_torch.py <argv>``, in this process."""
        path = str(ROOT / "examples" / f"{name}_torch.py")
        old = sys.argv
        sys.argv = [path, *argv]
        try:
            runpy.run_path(path, run_name="__main__")
        finally:
            sys.argv = old

    for call in (lambda: example("serve_online"),
                 lambda: example("train_small", "--steps", "1",
                                 "--ckpt", ""),
                 lambda: LmEngine(), lambda: make_lm_engine("lm-tiny"),
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
