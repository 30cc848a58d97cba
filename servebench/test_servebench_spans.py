"""The span log's eight readers on a hand-built export, with answers
counted by hand, on the CPU."""

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

from harness.trace import Kernel, TraceView  # noqa: E402

EPOCH = 100.0
READERS = ("prefill_hold_ms_mean", "prefill_coalesce_fire_pct",
           "prefill_start_wait_ms_mean", "idle_held_pct",
           "decode_hold_ms_p90", "decode_lock_wait_ms_mean",
           "decode_enqueue_share_pct", "reactor_lag_ms_p95")
REQUEST_FIELDS = ["id", "phase", "due", "submitted", "batch", "delivered",
                  "cause"]
BATCH_FIELDS = ["id", "phase", "trigger", "fired", "start", "gate",
                "locked", "enqueued", "run_end", "delivered", "requests"]
P, D = 0, 1                     # phases
FULL, COALESCE = 0, 1           # triggers
U = -1.0

# a 10 s window: prompts 0, 1 and 3 are due in it, prompt 2 after it; the
# decode steps 100-102 follow prompts 0 and 1, step 103 follows prompt 2
REQUESTS = [
    [0, P, 1.0, 1.001, 0, 1.6, -1],
    [1, P, 1.2, 1.203, 0, 1.6, -1],
    [2, P, 12.0, 12.0, 3, 12.5, -1],
    [3, P, 3.0, 3.0, 5, 3.5, -1],
    [100, D, 1.6, 1.65, 1, 2.0, 0],
    [101, D, 1.6, 1.6, 1, 2.0, 1],
    [102, D, 2.0, 2.0, 2, 2.6, 100],
    [103, D, 12.5, 12.5, 4, 13.0, 2],
]
BATCHES = [
    # id, phase, trigger, fired, start, gate, locked, enqueued, run_end,
    # delivered, requests
    [0, P, COALESCE, 1.401, 1.402, 1.411, U, 1.45, 1.59, 1.592, [0, 1]],
    [1, D, FULL, 1.7, 1.7, 1.71, 1.73, 1.83, 1.99, 1.995, [100, 101]],
    [2, D, COALESCE, 2.2, 2.2, 2.2, 2.21, 2.41, 2.51, 2.52, [102]],
    [3, P, FULL, 12.1, 12.1, 12.1, U, 12.2, 12.4, 12.41, [2]],
    [4, D, FULL, 12.6, 12.6, 12.6, 12.6, 12.7, 12.9, 12.91, [103]],
    [5, P, FULL, 3.0, 3.0, 3.05, U, 3.3, 3.4, 3.42, [3]],
]


def _readers():
    out = {}
    for name in READERS:
        spec = importlib.util.spec_from_file_location(
            f"servebench_metric_{name}", HERE / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.read
    return out


def _readings(spans=True):
    exported = {"clock": "perf_counter", "epoch": EPOCH,
                "phases": ["prefill", "decode"],
                "triggers": ["full", "coalesce", "redispatch"],
                "request_fields": REQUEST_FIELDS,
                "batch_fields": BATCH_FIELDS,
                "requests": REQUESTS, "batches": BATCHES,
                "dropped": 0}
    # a 2 s slice, [1, 3] on the plane's clock, with three kernels
    view = TraceView(EPOCH + 1.0, EPOCH + 3.0, [
        Kernel("gemm", EPOCH + 1.45, 0.14, None),
        Kernel("gemm", EPOCH + 1.83, 0.16, None),
        Kernel("gemm", EPOCH + 2.41, 0.10, None)], [], 0, {})
    report = {"spans": exported} if spans else {}
    return SimpleNamespace(report=report, seconds=10, view=view)


# each reader's answer, counted by hand from the records above
EXPECTED = {
    # prompts 0, 1, 3: fired - submitted = 0.400, 0.198, 0
    "prefill_hold_ms_mean": 1e3 * (0.400 + 0.198 + 0.0) / 3,
    # batches 0 (coalesce) and 5 (full)
    "prefill_coalesce_fire_pct": 50.0,
    # gate - fired: 0.010, 0.050
    "prefill_start_wait_ms_mean": 30.0,
    # held (submitted -> gate): [1.001, 1.411], [1.6, 1.71], [2.0, 2.2];
    # idle: [1, 1.45], [1.59, 1.83], [1.99, 2.41], [2.51, 3]; both: 0.41 +
    # 0.11 + 0.2 of the 2 s slice
    "idle_held_pct": 100.0 * (0.41 + 0.11 + 0.2) / 2.0,
    # fired - submitted: 0.05, 0.1, 0.2; the p90 of three is the largest
    "decode_hold_ms_p90": 200.0,
    # locked - gate: 0.02, 0.01
    "decode_lock_wait_ms_mean": 15.0,
    # (0.10 + 0.20) / (0.28 + 0.31)
    "decode_enqueue_share_pct": 100.0 * 0.3 / 0.59,
    # prompts: 0.001, 0.003, 0; batches 0, 1, 2, 5: 0.002, 0.005, 0.01,
    # 0.02; the p95 of seven is the largest
    "reactor_lag_ms_p95": 20.0,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_built_export(name):
    got = _readers()[name](_readings())
    assert got == pytest.approx(EXPECTED[name], rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_a_span_log_reports_nothing(name):
    r = _readings(spans=False)
    assert _readers()[name](r) is None
    r.report = None
    assert _readers()[name](r) is None


def test_window_takes_the_steps_of_its_prompts():
    from harness.spans import load
    s = load(_readings())
    assert s.window == {0, 1, 3, 100, 101, 102}
    assert {b["id"] for b in s.window_batches()} == {0, 1, 2, 5}


def test_readers_are_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = metrics[name]
        assert m["workloads"] == ["minitron-8b.longdoc-4k-poisson"]
        assert m["source"] == ("device_trace" if name == "idle_held_pct"
                               else "program_counter")


def test_program_export_has_the_fields_the_readers_take():
    pytest.importorskip("torch")
    from repro_torch.serving.spans import (BATCH_FIELDS as B,
                                           REQUEST_FIELDS as R, SpanLog)
    exported = SpanLog().export()
    assert exported["request_fields"] == list(R) == REQUEST_FIELDS
    assert exported["batch_fields"] == list(B) == BATCH_FIELDS
    assert exported["triggers"] == ["full", "coalesce", "redispatch"]


def test_span_log_bound_is_far_above_a_cells_requests():
    """A run of the cell makes a prompt and output_tokens - 1 decode
    steps for each arrival; the log's bound holds a hundred times that."""
    pytest.importorskip("torch")
    from repro_torch.serving.spans import MAX_RECORDS
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        tr = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                        .read_text())
        rate = max(ph["rate"] for ph in tr["phases"])
        requests = rate * bench["run_seconds"] * tr["output_tokens"]
        assert MAX_RECORDS >= 100 * requests
