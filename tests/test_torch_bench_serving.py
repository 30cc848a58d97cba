"""The port's serving launcher against the reference's.

``repro_torch.launch.bench_serving`` runs the reference's framework-free
code on the port's byte-identical copies of ``core`` and ``serving``, so
every simulated mode (``sim``, ``fast``, the cluster fabric with and
without the fidelity ladder, the multi-model plane, the interference
model, ``--slo-ms``, trace replay) must write a report byte-identical to
the reference's for the same argv, and ``--list`` must print the same
lines.  The real micro path runs here with ``--device cpu`` and its
report has the reference's key tree.
"""

import contextlib
import io
import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import bench_serving as jbench  # noqa: E402
from repro_torch.launch import bench_serving as tbench  # noqa: E402

SHORT = ["--duration", "20", "--units", "8"]
SIM_ARGVS = {
    "sim-step": ["--execution", "sim", "--scenario", "step-up", *SHORT],
    "fast-diurnal": ["--execution", "fast", "--scenario", "diurnal", *SHORT],
    "fast-all": ["--execution", "fast", "--scenario", "all",
                 "--duration", "10", "--dispatch", "continuous"],
    "fabric-ladder": ["--nodes", "2", "--fidelity-ladder", "--scenario",
                      "flash-overload", *SHORT],
    "fabric-failure-fast": ["--nodes", "3", "--scenario", "node-failure",
                            "--execution", "fast", *SHORT],
    "models": ["--models", "resnet50,bert", "--scenario", "mixed-steady",
               *SHORT],
    "models-fast-dup": ["--models", "gpt2,bert,gpt2", "--scenario",
                        "mixed-burst", "--execution", "fast", *SHORT],
    "interference": ["--interference", "--scenario", "steady-poisson",
                     "--model", "resnet50", *SHORT],
    "slo-ms": ["--slo-ms", "200", "--scenario", "bursty", "--model", "gpt2",
               "--dispatch", "sync", *SHORT],
    "slo-ms-models": ["--slo-ms", "300", "--models", "resnet50,bert",
                      "--scenario", "mixed-diurnal", *SHORT],
    "reference-planner": ["--planner", "reference", "--scenario", "ramp",
                          *SHORT],
}


def _run(main, argv):
    """(exit code, stdout, stderr) of one launcher call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("case", sorted(SIM_ARGVS))
def test_simulated_reports_are_byte_identical(case, tmp_path):
    argv = SIM_ARGVS[case]
    got, want = tmp_path / "port.json", tmp_path / "ref.json"
    assert _run(tbench.main, [*argv, "--out", str(got)])[0] == 0
    assert _run(jbench.main, [*argv, "--out", str(want)])[0] == 0
    assert got.read_bytes() == want.read_bytes()


def test_trace_replay_report_is_byte_identical_on_stdout(tmp_path):
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps(
        {"arrivals": [0.013 * i + 0.002 * (i % 7) for i in range(800)]}))
    argv = ["--trace", str(trace), *SHORT]
    rc, got, got_err = _run(tbench.main, argv)
    ref_rc, want, want_err = _run(jbench.main, argv)
    assert rc == ref_rc == 0
    assert got == want and got_err == want_err
    assert json.loads(got)["scenarios"][f"trace:{trace}"]["offered"] == 800


def test_list_is_identical():
    rc, got, _ = _run(tbench.main, ["--list"])
    ref_rc, want, _ = _run(jbench.main, ["--list"])
    assert rc == ref_rc == 0 and got == want
    assert "[multi-model]" in got


def _key_tree(rep, depth=3):
    """The report's key structure, descending into fixed-schema dicts
    (maps keyed by data — profile cells, instance ids, histogram buckets,
    calibration cells — stop the walk)."""
    data_keyed = {"compile_ms", "instances", "reconfig_log",
                  "latency_histogram", "queue_depth", "cells",
                  "measured_profile_ms", "entries"}
    out = {}
    for k, v in rep.items():
        if isinstance(v, dict) and depth > 0 and k not in data_keyed:
            out[k] = _key_tree(v, depth - 1)
        else:
            out[k] = None
    return out


def test_real_micro_path_on_cpu_has_the_reference_key_tree(tmp_path):
    """``--execution real --real-model mlp-tiny --device cpu`` serves the
    whole (capped) trace under both policies, and its report has the
    keys the reference's report has for the same flags."""
    argv = ["--execution", "real", "--real-model", "mlp-tiny",
            "--scenario", "steady-poisson", "--duration", "1", "--units",
            "2", "--initial-batch", "2", "--max-batch", "4", "--dispatch",
            "sync", "--real-rate-cap", "100"]
    got, want = tmp_path / "port.json", tmp_path / "ref.json"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert _run(tbench.main, [*argv, "--device", "cpu", "--out",
                                  str(got)])[0] == 0
    finally:
        torch.set_num_threads(n)
    assert _run(jbench.main, [*argv, "--out", str(want)])[0] == 0
    port, ref = json.loads(got.read_text()), json.loads(want.read_text())
    assert _key_tree(port) == _key_tree(ref)
    sc = port["scenarios"]["steady-poisson"]
    assert sc["real_model"] == "mlp-tiny" and sc["offered"] == 100
    for key in ("static", "packrat"):
        assert sc[key]["completed"] == sc["offered"]
        assert sc[key]["latency_ms"]["p95"] > 0
        assert sc[key]["calibration"]["observations"] > 0
