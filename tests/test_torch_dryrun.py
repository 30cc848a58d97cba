"""The port's analytic launchers (``repro_torch.launch.dryrun``,
``hillclimb``, ``report``, ``profile_gpu``) against the reference's
(``repro/launch/dryrun.py`` and its siblings), on the CPU.

* ``model_flops`` equals the reference's for every registered
  configuration and applicable shape (arithmetic on the parameter
  shapes, compared exactly).
* A dry-run record (reduced gemma3-1b, ``decode_32k``, the fake 16×16
  mesh) has the key tree of the reference's ``analyze_cell`` record for
  the same cell, and so do the port's prefill and train records;
  full-width gemma3-1b's ``decode_32k`` cell runs through ``main`` and
  fits one H100.
* ``hillclimb --opts`` counts one reduced cell and writes its record;
  ``report`` renders the port's records, "fits H100" in place of "fits
  v5e".
* ``GPUPackratProfiler`` gives L(t, b) for full-width gemma3-1b at t = 1
  (the plain step) and t = 2 (a two-rank submesh), with a dispatch term
  of its launches, as ``decode_terms`` does, and reads its disk cache
  back without counting.

The meshes need a process group of 256 ranks: the port's side runs in a
subprocess with its own fake group, the reference's in a JAX subprocess
with 512 fabricated devices; each writes JSON.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, all_configs, applicable_shapes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RECORD_CELL = ("gemma3-1b", "decode_32k")

_REFERENCE = r'''
import json, sys
import repro.launch.dryrun as d
import jax
jax.config.update("jax_enable_compilation_cache", False)
from repro.configs import SHAPES, all_configs, applicable_shapes, get_config
flops = {f"{a}:{s.name}": d.model_flops(c, s)
         for a, c in all_configs().items() for s in applicable_shapes(c)}
arch, shape = sys.argv[2], sys.argv[3]
cfg = get_config(arch).reduced(dtype="float32").with_overrides(
    attn_block_q=2048, attn_block_kv=4096)
rec = d.analyze_cell(arch, shape, cfg_override=cfg)
open(sys.argv[1], "w").write(json.dumps({"model_flops": flops,
                                         "record": rec}))
'''

_PORT = r'''
import json, sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, hillclimb, profile_gpu, report
out = Path(sys.argv[1])
arch = sys.argv[2]
res = {"records": {}}
cfg = get_config(arch).reduced(dtype="float32").with_overrides(
    attn_block_q=2048, attn_block_kv=4096)
for shape in ("decode_32k", "prefill_32k", "train_4k"):
    res["records"][shape] = dryrun.analyze_cell(
        arch, shape, cfg_override=cfg.with_overrides(
            remat=SHAPES[shape].kind == "train"))
# the full-width decode cell through the CLI
records = out / "records"
res["main_rc"] = dryrun.main(["--arch", arch, "--shape", "decode_32k",
                              "--out", str(records)])
# one reduced hillclimb cell
real_get_config = hillclimb.get_config
hillclimb.get_config = lambda a: real_get_config(a).reduced(dtype="float32")
hillclimb.RESULTS_DIR = records
res["hillclimb_rc"] = hillclimb.main(["--cell", f"{arch}:decode_32k",
                                      "--opts", "decode_seq_shard",
                                      "xent_chunk", "--tag", "opt1"])
report.RESULTS = records
res["report"] = {"dryrun": report.dryrun_table(),
                 "roofline": report.roofline_table(),
                 "perf": report.perf_table()}
prof_file = out / "profile.json"
prof = profile_gpu.GPUPackratProfiler(arch, seq_len=1024, cache_file=str(prof_file))
terms = {f"{t},{b}": prof.terms(t, b) for t in (1, 2) for b in (1, 4)}
res["profile"] = {k: {"latency": v.latency, "compute_s": v.compute_s,
                      "memory_s": v.memory_s,
                      "collective_s": v.collective_s, "chips": v.chips,
                      "ici_links": v.ici_links,
                      "dispatch": v.hw.dispatch_overhead}
                  for k, v in terms.items()}
res["profile_disk"] = json.loads(prof_file.read_text())
res["decode_terms"] = {k: profile_gpu.decode_terms(
    get_config(arch), *map(int, k.split(",")), 1024).latency for k in terms}
profile_gpu.decode_cost = None          # the cache must serve every term
again = profile_gpu.GPUPackratProfiler(arch, seq_len=1024,
                                       cache_file=str(prof_file))
res["profile_again"] = {k: again.terms(*map(int, k.split(","))).latency
                        for k in terms}
(out / "port.json").write_text(json.dumps(res))
'''


def _run(code, out, *argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code, str(out), *argv],
                         env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    _run(_REFERENCE, tmp / "ref.json", *RECORD_CELL)
    _run(_PORT, tmp, RECORD_CELL[0])
    return (json.loads((tmp / "ref.json").read_text()),
            json.loads((tmp / "port.json").read_text()), tmp)


# a record's values that are dicts of data: op name -> bytes
DATA_DICTS = ("collectives_by_op_per_layer",)


def _key_tree(rec):
    if isinstance(rec, dict):
        return {k: "dict" if k in DATA_DICTS else _key_tree(v)
                for k, v in rec.items()}
    return type(rec).__name__ if isinstance(rec, (bool, str)) else "number"


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_model_flops_matches_reference(runs, arch):
    ref = runs[0]["model_flops"]
    cfg = all_configs()[arch]
    for shape in applicable_shapes(cfg):
        assert dryrun.model_flops(cfg, shape) == ref[f"{arch}:{shape.name}"]


def test_record_keys_match_reference(runs):
    ref, port, _ = runs
    want = _key_tree(ref["record"])
    for shape, rec in port["records"].items():
        assert _key_tree(rec) == want, shape
        assert rec["mesh"] == "16x16" and rec["chips"] == 256
        assert rec["memory"]["peak_bytes_per_device"] > 0
        assert rec["roofline"]["hlo_flops_total"] > 0
    # the reduced decode cell's per-layer collectives are those of its
    # pattern: the reference's keys, the port's counts
    per_layer = port["records"]["decode_32k"]["roofline"][
        "collectives_by_op_per_layer"]
    assert set(per_layer) <= {"all-gather", "all-reduce", "reduce-scatter",
                              "all-to-all"} and sum(per_layer.values()) > 0


def test_full_width_decode_cell_through_main(runs):
    ref, _, tmp = runs
    rec = json.loads((tmp / "records" /
                      "gemma3-1b__decode_32k__single.json").read_text())
    assert runs[1]["main_rc"] == 0
    assert _key_tree(rec) == _key_tree(ref["record"])
    assert rec["fits_hbm"] is True
    assert rec["roofline"]["model_flops"] == dryrun.model_flops(
        all_configs()["gemma3-1b"], SHAPES["decode_32k"])
    # every layer counted: 2.787 GFLOP a rank (the per-rank vocab shard
    # of the head and the attention over a sixteenth of 32k slots)
    assert rec["validation_cost_analysis"]["flops"] == pytest.approx(
        2.787e9, rel=1e-3)


def test_hillclimb_writes_its_record(runs):
    _, port, tmp = runs
    assert port["hillclimb_rc"] == 0
    rec = json.loads((tmp / "records" /
                      "gemma3-1b__decode_32k__single__opt1.json").read_text())
    assert rec["tag"] == "opt1"
    assert rec["opts"] == ["decode_seq_shard", "xent_chunk"]
    assert rec["roofline"]["latency_s"] > 0


def test_report_renders_the_port_records(runs):
    report = runs[1]["report"]
    assert "fits H100" in report["dryrun"] and "v5e" not in report["dryrun"]
    assert "| gemma3-1b | decode_32k | 256 |" in report["dryrun"]
    assert "| gemma3-1b | decode_32k |" in report["roofline"]
    # the baseline and the hillclimb variant of one cell
    assert "| gemma3-1b:decode_32k | baseline |" in report["perf"]
    assert "| gemma3-1b:decode_32k | opt1 |" in report["perf"]


def test_profiler_terms_and_disk_cache(runs):
    port = runs[1]
    prof, disk = port["profile"], port["profile_disk"]
    from repro_torch.core.hardware import HOST_S_PER_LAUNCH
    for key, terms in prof.items():
        t, _ = map(int, key.split(","))
        assert terms["chips"] == t and terms["ici_links"] == 18
        assert terms["dispatch"] == pytest.approx(
            disk[key]["launches"] * HOST_S_PER_LAUNCH)
        assert terms["latency"] == pytest.approx(
            max(terms["compute_s"], terms["memory_s"],
                terms["collective_s"]) + terms["dispatch"])
        assert port["profile_again"][key] == terms["latency"]
        assert port["decode_terms"][key] == pytest.approx(terms["latency"])
    # one rank has no collectives; two ranks gather and reduce
    assert prof["1,1"]["collective_s"] == 0 < prof["2,1"]["collective_s"]
    # a larger batch moves more bytes
    assert prof["1,4"]["memory_s"] > prof["1,1"]["memory_s"]
