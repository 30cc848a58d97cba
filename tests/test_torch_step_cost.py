"""The port's step cost (``repro_torch.launch.step_cost``) against the
reference's compiled-program analysis (``repro/launch/hlo_analysis.py``),
on the CPU.

* ``collective_stats`` is the reference's parser: on the reference
  test's HLO (``tests/test_distributed.py::test_collective_stats_parser``)
  and a few more lines it gives the reference's counts and bytes.
* ``program_cost`` counts the same step alike on meta tensors and on
  real CPU tensors: FLOPs, bytes, launches, argument, temporary, output
  and aliased bytes, for the decode step of every registered
  configuration (reduced, fp32).  deepseek's MoE is the exception, named
  here: ``one_hot`` decomposes into ``arange`` + ``eq`` on meta and into
  ``aminmax`` + ``zeros`` + ``scatter_`` on a real tensor.
* On a (2, 4) ("data", "model") mesh, reduced llama3-8b and gemma3-1b
  decode steps (B = 8, 64 slots, fp32, meta DTensors on torch's
  ``"fake"`` group) have the per-rank argument bytes of the reference's
  ``memory_analysis()`` (less its 4-byte int32 position, which the port
  passes as a Python int).  Their counted FLOPs stand to the reference's
  ``cost_analysis()["flops"]`` as measured: 0.947 for llama3-8b (the
  port counts matmuls only, XLA elementwise ops too) and 1.348 for
  gemma3-1b (DTensor gathers the sequence-sharded caches of its layers
  and runs each rank's attention over all 64 slots, where XLA keeps the
  scores sharded); both within 2% of those ratios.  ROADMAP §3 records
  the difference.

The port's mesh needs a process group and the reference 8 devices, so
each side runs in a subprocess of its own (the port's on a fake group
of 8 ranks), which writes JSON.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis as ref_hlo  # noqa: E402
from repro_torch.configs import all_configs, get_config  # noqa: E402
from repro_torch.core.hardware import H100, NVLINK_LINKS  # noqa: E402
from repro_torch.launch import step_cost  # noqa: E402
from repro_torch.launch.profile_gpu import decode_cost  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESH_CELLS = ("llama3-8b", "gemma3-1b")
# counted FLOPs over the reference's, measured (module docstring)
FLOP_RATIOS = {"llama3-8b": 0.947, "gemma3-1b": 1.348}
# ops that dispatch differently on meta than on a real tensor
META_DIFFERENT = {"deepseek-v2-236b", "deepseek-v3-671b"}

HLO_TEXTS = {
    "reference-test": """
  %all-reduce = f32[128,256]{1,0} all-reduce(%x), replica_groups={}
  %ag = (bf16[64]{0}, bf16[32]{0}) all-gather(%a, %b), dim=0
  %rs = f32[16,16]{1,0} reduce-scatter(%y), dimensions={0}
  %cp-start = bf16[8]{0} collective-permute-start(%z)
  %cp-done = bf16[8]{0} collective-permute-done(%cp-start)
  %fusion = f32[4]{0} fusion(%w), calls=%comp
""",
    "async-and-odd-dtypes": """
  %ags = (s8[4,4]{1,0}, s8[16,4]{1,0}) all-gather-start(%q), dim=0
  %agd = s8[16,4]{1,0} all-gather-done(%ags)
  %a2a = u4[64]{0} all-to-all(%p), dimensions={0}
  %ar = f8e4m3fn[10]{0} all-reduce(%m), to_apply=%add
  %scalar = pred[] all-reduce(%b), to_apply=%or
""",
    "none": "  %dot = f32[8,8]{1,0} dot(%a, %b)\n",
}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(HLO_TEXTS))
def test_collective_stats_matches_reference(name):
    got = step_cost.collective_stats(HLO_TEXTS[name])
    want = ref_hlo.collective_stats(HLO_TEXTS[name])
    assert got.bytes_by_op == want.bytes_by_op
    assert got.count_by_op == want.count_by_op
    if name == "reference-test":
        assert got.count_by_op["all-reduce"] == 1
        assert got.bytes_by_op["all-gather"] == (64 + 32) * 2
        assert got.total_count == 4


def test_program_cost_differences_as_the_reference():
    a = step_cost.ProgramCost(10.0, 20.0, step_cost.CollectiveStats(
        {"all-gather": 8}, {"all-gather": 2}), 5, 6, 7)
    b = step_cost.ProgramCost(4.0, 5.0, step_cost.CollectiveStats(
        {"all-gather": 3, "all-reduce": 1}, {"all-gather": 1,
                                             "all-reduce": 1}))
    want_a = ref_hlo.ProgramCost(10.0, 20.0, ref_hlo.CollectiveStats(
        {"all-gather": 8}, {"all-gather": 2}), 5, 6, 7)
    want_b = ref_hlo.ProgramCost(4.0, 5.0, ref_hlo.CollectiveStats(
        {"all-gather": 3, "all-reduce": 1}, {"all-gather": 1,
                                             "all-reduce": 1}))
    for got, want in ((a - b, want_a - want_b),
                      (a.scaled_add(b, 3), want_a.scaled_add(want_b, 3))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_roofline_from_cost_on_the_h100():
    cost = step_cost.ProgramCost(989e9, 3.35e9, step_cost.CollectiveStats(
        {"all-reduce": 450_000_000}, {"all-reduce": 1}))
    terms = step_cost.roofline_from_cost(cost, 4)
    assert terms.hw is H100 and terms.ici_links == NVLINK_LINKS == 18
    assert terms.flops == 4 * 989e9 and terms.chips == 4
    assert terms.compute_s == pytest.approx(1e-3)
    assert terms.memory_s == pytest.approx(1e-3)
    assert terms.collective_s == pytest.approx(1e-3)


def _fields(c):
    return (c.cost.flops, c.cost.hbm_bytes, c.launches, c.cost.argument_bytes,
            c.cost.temp_bytes, c.cost.output_bytes, c.alias_bytes)


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_meta_count_equals_the_real_tensors_count(arch):
    cfg = get_config(arch).reduced(dtype="float32")
    meta = decode_cost(cfg, 1, 4, 64, device="meta")
    real = decode_cost(cfg, 1, 4, 64, device="cpu")
    assert meta.launches > 0 and meta.cost.flops > 0
    assert meta.cost.argument_bytes > 0 and meta.alias_bytes > 0
    if arch not in META_DIFFERENT:
        assert _fields(meta) == _fields(real)
        assert meta.ops == real.ops
        return
    diff = {k: real.ops.get(k, 0) - meta.ops.get(k, 0)
            for k in set(real.ops) | set(meta.ops)}
    diff = {k: v for k, v in diff.items() if v}
    n_moe = sum(1 for k in cfg.layers if k == "mla_moe")
    assert diff == {"arange": -n_moe, "eq": -n_moe, "_to_copy": -n_moe,
                    "aminmax": n_moe, "zeros": n_moe, "scatter_": n_moe}
    assert meta.cost.flops == real.cost.flops
    assert meta.launches == real.launches
    assert _fields(meta)[3:] == _fields(real)[3:]


# --------------------------------------------------------------------- #
# a (2, 4) mesh: the port on a fake group, the reference on 8 devices
# --------------------------------------------------------------------- #
_PORT = r'''
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.dryrun import count_cell
from repro_torch.launch.mesh import fake_world, make_mesh
out = {}
with fake_world(8):
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    for arch in sys.argv[2:]:
        cfg = get_config(arch).reduced(dtype="float32")
        c = count_cell(cfg, ShapeConfig("d", 64, 8, "decode"), mesh)
        out[arch] = {"argument_bytes": c.cost.argument_bytes,
                     "flops": c.cost.flops, "launches": c.launches,
                     "collectives": c.cost.collectives.count_by_op}
open(sys.argv[1], "w").write(json.dumps(out))
'''

_REFERENCE = r'''
import json, sys
import repro.launch.dryrun as d
import jax
jax.config.update("jax_enable_compilation_cache", False)
from repro.configs import ShapeConfig, get_config
from repro.launch.mesh import make_mesh
mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for arch in sys.argv[2:]:
    cfg = get_config(arch).reduced(dtype="float32")
    lowered, _ = d.lower_cell(cfg, ShapeConfig("d", 64, 8, "decode"), mesh)
    comp = lowered.compile()
    out[arch] = {"argument_bytes": comp.memory_analysis().argument_size_in_bytes,
                 "flops": comp.cost_analysis()["flops"]}
open(sys.argv[1], "w").write(json.dumps(out))
'''


def _run(code, out, extra_env):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **extra_env)
    res = subprocess.run([sys.executable, "-c", code, str(out), *MESH_CELLS],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def mesh_counts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("step_cost")
    port = _run(_PORT, tmp / "port.json", {})
    ref = _run(_REFERENCE, tmp / "ref.json", {})
    return port, ref


@pytest.mark.parametrize("arch", MESH_CELLS)
def test_argument_bytes_match_reference(mesh_counts, arch):
    port, ref = mesh_counts
    assert port[arch]["argument_bytes"] + 4 == ref[arch]["argument_bytes"]


@pytest.mark.parametrize("arch", MESH_CELLS)
def test_flops_stand_to_the_reference_as_measured(mesh_counts, arch):
    port, ref = mesh_counts
    ratio = port[arch]["flops"] / ref[arch]["flops"]
    assert ratio == pytest.approx(FLOP_RATIOS[arch], rel=0.02), ratio
    # DTensor's redistributions ran, and CommDebugMode counted them as the
    # dispatch mode did (program_cost raises otherwise)
    assert sum(port[arch]["collectives"].values()) > 0
    assert port[arch]["launches"] > 0
