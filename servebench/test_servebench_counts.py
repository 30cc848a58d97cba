"""The benchmark's arithmetic against hand counts, on the CPU."""

import math
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import cost, stats, traffic  # noqa: E402
from harness.trace import Kernel, TraceView, trace_tid, view  # noqa: E402
from harness.hooks import Call  # noqa: E402

TINY = dict(d_model=4, n_heads=2, n_kv_heads=1, head_dim=2, d_ff=8,
            vocab_size=10, n_layers=1, act="relu2", qk_norm=False,
            dtype="bfloat16")


def test_flash_and_decode_call_counts():
    c = dict(TINY, head_dim=8)
    got = cost.flash_call(c, B=1, S=4)
    # q and out (1·4·2·8 each), k and v (1·4·1·8 each), 2 bytes; 10 pairs
    assert got == {"bytes": 2 * (64 + 64 + 32 + 32),
                   "flops": 4 * 8 * 2 * 10}
    got = cost.decode_call(c, B=2, valid=3)
    # q and out 2·2·8 each; 3 valid K and V rows of 1·8 per sequence
    assert got == {"bytes": 2 * (32 + 32 + 48 + 48) + 4 * 2,
                   "flops": 4 * 8 * 2 * 2 * 3}


def test_model_flops_by_hand():
    # per token: q 4·2·2, k and v 4·1·2 each, o 2·2·4, up and down 4·8
    per_token = 2 * (16 + 8 + 8 + 16 + 32 + 32)
    assert cost.prefill_flops(TINY, 3) == 3 * per_token \
        + 4 * 2 * 2 * 6 + 2 * 4 * 10
    assert cost.decode_flops(TINY, 2) == per_token + 4 * 2 * 2 * 3 \
        + 2 * 4 * 10


def test_param_count_matches_the_weights():
    import torch
    from harness import weights
    c = dict(TINY, norm="layernorm")
    w = weights.make(c, 3, "cpu")
    assert sum(t.numel() for t in w.values()) == cost.param_count(c)
    assert w["embed"].dtype == torch.bfloat16
    assert w["final_norm.scale"].dtype == torch.float32


def test_bound_and_pairs():
    assert cost.bound_s(3.35e12, 0, "bfloat16") == pytest.approx(1.0)
    assert cost.bound_s(0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert cost.visible_pairs(4) == 10
    assert cost.visible_pairs(4, window=2) == 1 + 2 + 2 + 2
    assert cost.visible_pairs(2048) == 2048 * 2049 // 2


def test_percentile():
    assert stats.nearest_rank([1, 2, 3, 4], 50) == 2
    assert stats.nearest_rank(list(range(1, 101)), 95) == 95
    assert stats.percentile([5.0, 1.0, 3.0], 100) == 5.0
    assert math.isnan(stats.nearest_rank([], 95))
    with pytest.raises(ValueError):
        stats.nearest_rank([1], 0)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert stats.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


STEADY = {"phases": [{"seconds": None, "rate": 4.0}]}
SQUARE = {"phases": [{"seconds": 5, "rate": 2.0},
                     {"seconds": 5, "rate": 6.0}]}


@pytest.mark.parametrize("tr", [STEADY, SQUARE], ids=["steady", "square"])
def test_arrivals_same_work_every_seed(tr):
    a = traffic.arrivals(tr, 40, 2 ** 31 + 12345)
    assert a == traffic.arrivals(tr, 40, 2 ** 31 + 12345)
    b = traffic.arrivals(tr, 40, 7)
    assert a != b
    assert len(a) == len(b) == 160           # 4 prompts/s on average
    assert a == sorted(a) and 0 <= a[0] and a[-1] < 40


def test_arrivals_fixed_phase_boundaries_and_gaps():
    for seed in (1, 2, 3):
        a = traffic.arrivals(SQUARE, 20, seed)
        counts = [sum(lo <= t < lo + 5 for t in a) for lo in (0, 5, 10, 15)]
        assert counts == [10, 30, 10, 30]
    one = [traffic.arrivals(STEADY, 10, s) for s in (4, 5)]
    gaps = [sorted([x[0]] + [b - a for a, b in zip(x, x[1:])]
                   + [10 - x[-1]]) for x in one]
    assert gaps[0] == pytest.approx(gaps[1])


def test_backlog():
    assert traffic.backlog([0.0, 1.0, 2.0], [0.5, 2.5], 2.0) == 2


def test_trace_tid():
    # CUPTI's signed 32-bit pthread id, as the trace writes it
    assert trace_tid(140147693708992) == 1384126784
    assert trace_tid(0x7F0012345678) == 0x12345678


def _event(name, ts, dur, tid=0, cat="cuda_runtime", corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "tid": tid,
         "cat": cat}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_view_attributes_kernels_to_calls():
    ident = 0x7F00000000AB
    tid = trace_tid(ident)
    # the perf_counter clock sits 100 s behind the trace's µs
    calls = [Call("prefill", 4, 100.010, 100.020, ident),
             Call("decode", 2, 100.030, 100.040, ident, pos=7)]
    ev = [_event("servebench.mark", 1000.0, 1.0, cat="user_annotation"),
          _event("cudaLaunchKernel", 16000.0, 2.0, tid, corr=1),
          _event("cudaLaunchKernelExC", 36000.0, 2.0, tid, corr=2),
          _event("cudaLaunchKernel", 51000.0, 2.0, tid, corr=3),
          _event("flash_tc_pair_kernel<128>", 16500.0, 10.0, cat="kernel",
                 corr=1),
          _event("decode_tc_kernel<128, 8>", 36500.0, 4.0, cat="kernel",
                 corr=2),
          _event("gemm", 51500.0, 10.0, cat="kernel", corr=3)]
    tv = view(ev, [(100.0 - 1e-7, 100.0 + 1e-7)], (100.000, 100.100), calls)
    assert tv.attributed == 2
    k = {x.name: x for x in tv.device}
    assert k["flash_tc_pair_kernel<128>"].call is calls[0]
    assert k["decode_tc_kernel<128, 8>"].call is calls[1]
    assert k["gemm"].call is None
    assert tv.busy_s == pytest.approx(24e-6)
    assert tv.launches_in(calls[0]) == 1 and tv.launches_in(calls[1]) == 1
    assert [n for n, _ in tv.top_ops()] == [
        "flash_tc_pair_kernel<128>", "gemm", "decode_tc_kernel<128, 8>"]
    assert len(tv.idle_gaps(calls)) == 4


def test_roofline_readers():
    import importlib.util

    class R:
        conf = dict(TINY, n_heads=32, n_kv_heads=8, head_dim=128)
        traffic = {"prompt_tokens": 4096}

    def load(name):
        p = Path(__file__).resolve().parent / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(name, p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    c = Call("prefill", 2, 0.0, 1.0, 1)
    d = Call("decode", 4, 0.0, 1.0, 1, pos=4099)
    fl = cost.flash_call(R.conf, 2, 4096)
    dc = cost.decode_call(R.conf, 4, 4100)
    b_fl = cost.bound_s(fl["bytes"], fl["flops"], "bfloat16")
    b_dc = cost.bound_s(dc["bytes"], dc["flops"], "bfloat16")
    R.view = TraceView(0.0, 1.0, [
        Kernel("void flash_tc_pair_kernel<128>(x)", 0.1, 2 * b_fl, c),
        Kernel("void decode_tc_kernel<128, 4>(x)", 0.5, 4 * b_dc, d),
        Kernel("void flash_tc_pair_kernel<128>(x)", 0.9, 1.0, c)],
        [], 0, {})
    # the last record runs past the slice's end and is left out
    assert load("flash_roofline_pct")(R) == pytest.approx(50.0)
    assert load("decode_roofline_pct")(R) == pytest.approx(25.0)
    # busy: both whole records and the last one's part inside the slice
    assert load("device_idle_pct")(R) == pytest.approx(
        100.0 * (1.0 - (2 * b_fl + 4 * b_dc + 0.1)))
