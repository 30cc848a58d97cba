"""A slice of the window under ``torch.profiler``, and what it shows.

The profiler runs for a fixed slice from the middle of the window
(:data:`SLICE_S` seconds), started and stopped from a thread of the
benchmark.  CUPTI records every kernel, copy and fill on the device and
every launch call on the host with its thread; a marker on the
benchmark's thread ties the trace's clock to ``time.perf_counter``, so
each launch, and through its correlation id each kernel, falls inside
one runner call (:class:`~.hooks.Call`) of its thread.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import gzip
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from .stats import gaps, union_length

SLICE_S = 3.0
MARK = "servebench.mark"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def trace_tid(ident: int) -> int:
    """The trace's thread id of a Python thread: CUPTI keeps
    ``pthread_self()`` as a signed 32-bit number, and the trace writes
    its magnitude."""
    low = ident & 0xFFFFFFFF
    return abs(low - (1 << 32) if low >= 1 << 31 else low)


class SliceProfiler:
    """Profiles [start, start + SLICE_S) of ``time.perf_counter`` from a
    thread of its own; :meth:`join` waits for it."""

    def __init__(self, start: float) -> None:
        self.start_at = start
        self.marks: List[Tuple[float, float]] = []
        self.prof = None
        self.error: Optional[BaseException] = None
        self.bounds: Tuple[float, float] = (0.0, 0.0)
        self.blocked: Tuple[float, float] = (0.0, 0.0)   # start, stop
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="servebench-profiler")

    def begin(self) -> None:
        self._thread.start()

    def _mark(self) -> None:
        from torch.profiler import record_function
        a = time.perf_counter()
        with record_function(MARK):
            b = time.perf_counter()
        self.marks.append((a, b))

    def _run(self) -> None:
        try:
            from torch.profiler import ProfilerActivity, profile
            time.sleep(max(0.0, self.start_at - time.perf_counter()))
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            a = time.perf_counter()
            self.prof.start()
            t0 = time.perf_counter()
            self._mark()
            time.sleep(SLICE_S)
            self._mark()
            t1 = time.perf_counter()
            self.prof.stop()
            self.bounds = (t0, t1)
            self.blocked = (t0 - a, time.perf_counter() - t1)
        except BaseException as e:          # reported after the window
            self.error = e

    def join(self) -> None:
        self._thread.join()
        if self.error is not None:
            raise self.error

    def export(self, path: str) -> None:
        self.prof.export_chrome_trace(path)


def load(path: str) -> List[Dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


@dataclasses.dataclass
class Kernel:
    name: str
    ts: float                      # seconds, on time.perf_counter
    dur: float                     # seconds
    call: Optional[object]         # the runner call that launched it


@dataclasses.dataclass
class TraceView:
    """The slice's device records and launches on the benchmark's clock."""
    lo: float
    hi: float
    device: List[Kernel]
    launches: List[Tuple[float, int]]          # (ts, thread)
    attributed: int                            # launches found in a call
    threads: Dict[str, List[int]]              # diagnostics

    @property
    def busy_s(self) -> float:
        return union_length([(max(k.ts, self.lo), min(k.ts + k.dur, self.hi))
                             for k in self.device
                             if k.ts < self.hi and k.ts + k.dur > self.lo])

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def kernels(self, prefix: str) -> List[Kernel]:
        """Whole records in the slice whose name starts with ``prefix``."""
        return [k for k in self.device if k.name.startswith(prefix)
                and k.ts >= self.lo and k.ts + k.dur <= self.hi]

    def launches_in(self, call) -> int:
        """Launch calls on ``call``'s thread inside its interval."""
        ts = self._by_tid.get(trace_tid(call.ident), [])
        return bisect.bisect_right(ts, call.t1) - bisect.bisect_left(ts,
                                                                     call.t0)

    def __post_init__(self) -> None:
        by = collections.defaultdict(list)
        for t, tid in self.launches:
            by[tid].append(t)
        self._by_tid = {k: sorted(v) for k, v in by.items()}

    def top_ops(self) -> List[List]:
        by = collections.Counter()
        for k in self.device:
            by[k.name[:80]] += k.dur
        return [[n, s] for n, s in by.most_common(TOP)]

    def idle_gaps(self, calls) -> List[List]:
        """The longest idle stretches, named by the runner calls in flight
        on the host while the device waited."""
        out = []
        for a, b in gaps([(k.ts, k.ts + k.dur) for k in self.device],
                         self.lo, self.hi):
            mid = 0.5 * (a + b)
            live = sorted({f"{c.phase} b{c.b}" for c in calls
                           if c.t0 <= mid <= c.t1})
            name = (" + ".join(live) + " enqueueing") if live \
                else "no runner call"
            out.append([f"{name} at +{a - self.lo:.3f}s", b - a])
        out.sort(key=lambda x: -x[1])
        return out[:TOP]


def view(events: List[Dict], marks, bounds, calls) -> TraceView:
    """Map the trace onto the benchmark's clock and its runner calls."""
    mark_ts = sorted(e["ts"] for e in events if e.get("name") == MARK)
    if not mark_ts:
        raise RuntimeError("the trace holds no clock marker")
    # trace µs = perf_counter s · 1e6 + offset
    offset = mark_ts[0] - 0.5 * (marks[0][0] + marks[0][1]) * 1e6

    def clock(ts):
        return (ts - offset) * 1e-6

    by_thread = collections.defaultdict(list)
    for c in calls:
        by_thread[trace_tid(c.ident)].append(c)
    starts = {}
    for tid, lst in by_thread.items():
        lst.sort(key=lambda c: c.t0)
        starts[tid] = [c.t0 for c in lst]

    def call_at(tid, t):
        # one thread's calls do not overlap: the last to start before t
        i = bisect.bisect_right(starts.get(tid, ()), t) - 1
        if i < 0:
            return None
        c = by_thread[tid][i]
        return c if t <= c.t1 else None

    launch_of: Dict[int, object] = {}
    launches, attributed, tids = [], 0, set()
    for e in events:
        if e.get("ph") == "X" and e.get("name") in LAUNCH_CALLS:
            t, tid = clock(e["ts"]), e.get("tid")
            tids.add(tid)
            launches.append((t, tid))
            c = call_at(tid, t)
            attributed += c is not None
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_of[corr] = c
    device = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            corr = e.get("args", {}).get("correlation")
            device.append(Kernel(e["name"], clock(e["ts"]),
                                 e.get("dur", 0.0) * 1e-6,
                                 launch_of.get(corr)))
    return TraceView(bounds[0], bounds[1], device, launches, attributed,
                     {"trace": sorted(tids),
                      "calls": sorted({trace_tid(c.ident) for c in calls})})
