"""Worker instances and latency backends (paper §3.6).

A :class:`WorkerInstance` executes inference batches; its runtime comes
from a :class:`LatencyBackend`:

* :class:`TabulatedBackend` — profiled L[t,b] tables (+ optional
  interference model applied by live-instance count, §5.2.2).
* :class:`RooflineBackend` — the analytic TPU model (core.roofline).
* :class:`JaxBackend` — *real* execution: runs a jitted model
  ``decode_step``/``forward`` and measures wall-clock (micro models on
  CPU; the integration tests use this so the serving stack is exercised
  against genuine JAX inference, pre/post-processing included).

Workers can fail and be respawned (TorchServe respawns dead workers —
§4 Implementation); the dispatcher's straggler policy re-dispatches work
stuck on failed/slow instances.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, Mapping, Optional, Tuple

from ..core.interference import CPUInterferenceModel, TPUInterferenceModel
from ..core.knapsack import PackratConfig, next_power_of_two
from ..core.profiler import (measure_latency, profile_rows, row_latency,
                             thread_latency)
from .metrics import log2_ms_bucket


class LatencyBackend:
    def batch_latency(self, t: int, b: int, *, n_live_instances: int = 1,
                      total_units: int = 0) -> float:
        raise NotImplementedError


class TabulatedBackend(LatencyBackend):
    def __init__(self, table: Mapping[Tuple[int, int], float],
                 interference=None, total_units: int = 0) -> None:
        self.table = dict(table)
        self.interference = interference
        self.total_units = total_units
        # ⟨t,b⟩ lookups for a t outside the profiled grid (interpolated
        # or clamped), counted so reports can expose the substitution
        # instead of silently serving a different profile row
        self.fallback_lookups: Dict[Tuple[int, int], int] = {}
        self._rows = profile_rows(self.table)

    def set_profile(self, table: Mapping[Tuple[int, int], float]) -> None:
        """Swap the serving costs in place — a fidelity-rung transition
        (the node now executes a cheaper model variant) or a calibration
        refresh.  Batches dispatched after the swap price against the
        new table; in-flight batches keep the latency they were issued
        with, in both engines."""
        self.table = dict(table)
        self._rows = profile_rows(self.table)

    def _lookup(self, t: int, b: int) -> float:
        """Shared-rule lookup (``core.profiler.row_latency``): exact hit,
        round b up to the next profiled size, scale above the top; for an
        unprofiled thread count, linearly interpolate between the
        bracketing profiled rows (a sparse powers-of-two thread grid is
        common on TPU sub-meshes) instead of silently snapping to the
        nearest row, clamping outside the profiled range.  Every
        off-grid lookup is counted in ``fallback_lookups``."""
        if t in self._rows:
            return row_latency(self.table, self._rows, t, b)
        self.fallback_lookups[(t, b)] = self.fallback_lookups.get((t, b), 0) + 1
        return thread_latency(self.table, self._rows, t, b)

    def fallback_report(self) -> Dict[str, object]:
        """Summary of off-grid thread-count lookups (for bench reports)."""
        return {
            "count": sum(self.fallback_lookups.values()),
            "keys": [{"t": t, "b": b, "lookups": n}
                     for (t, b), n in sorted(self.fallback_lookups.items())],
        }

    def batch_latency(self, t, b, *, n_live_instances=1, total_units=0):
        base = self._lookup(t, b)
        if self.interference is None:
            return base
        # constant-factor multi-instance penalty (downclock + loaded DRAM)
        from ..core.knapsack import InstanceGroup
        cfg = PackratConfig(groups=(InstanceGroup(n_live_instances, t, b),),
                            latency=base)
        return self.interference.observed_latency(
            cfg, total_units or self.total_units)


class CalibratedBackend(LatencyBackend):
    """A latency backend corrected live by a
    :class:`~repro.core.profiler.ProfileCalibrator`.

    The real execution plane budgets watchdogs and provisional
    ``busy_until`` estimates from the worker's backend; wrapping the
    planning table with the calibrator's current correction keeps those
    expectations tracking what the hardware actually delivers — without
    it, a systematic expected-vs-observed gap turns the straggler
    watchdog into a redispatch storm (every batch "misses" a deadline
    computed from the uncalibrated profile).
    """

    def __init__(self, inner: LatencyBackend, calibrator) -> None:
        self.inner = inner
        self.calibrator = calibrator

    def batch_latency(self, t, b, *, n_live_instances=1, total_units=0):
        base = self.inner.batch_latency(
            t, b, n_live_instances=n_live_instances, total_units=total_units)
        return base * self.calibrator.correction_at(t, b)


class CallableBackend(LatencyBackend):
    def __init__(self, fn: Callable[[int, int], float]) -> None:
        self.fn = fn

    def batch_latency(self, t, b, *, n_live_instances=1, total_units=0):
        return self.fn(t, b)


class JaxBackend(LatencyBackend):
    """Measures real jitted execution of a model step for batch size b.

    ``make_runner(b)`` returns a zero-arg callable running one batch of
    size b to completion (``block_until_ready`` inside).  Thread count t
    is recorded but cannot vary on a single-device CPU container; the
    measured latency is per-instance ground truth for the e2e tests.

    Measurement shares :func:`repro.core.profiler.measure_latency` with
    :class:`~repro.core.profiler.MeasuredProfiler` — warmup iterations
    discarded, then the *median* of ``iters`` timed runs, so a single
    GC pause or page fault cannot become the probe's latency estimate
    (the old single-sample timing regularly did exactly that).
    """

    def __init__(self, make_runner: Callable[[int], Callable[[], None]],
                 warmup: int = 2, iters: int = 5,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self._runners: Dict[int, Callable[[], None]] = {}
        self._make = make_runner
        self._warmup = warmup
        self._iters = iters
        self._clock = clock
        self._measured: Dict[int, float] = {}

    @staticmethod
    def _round_batch(b: int) -> int:
        """Round partial batches up to the next power of two: real servers
        pad to compiled bucket sizes rather than recompiling per size."""
        return next_power_of_two(b)

    def batch_latency(self, t, b, *, n_live_instances=1, total_units=0):
        b = self._round_batch(b)
        if b not in self._measured:
            runner = self._runners.setdefault(b, self._make(b))
            self._measured[b] = measure_latency(
                runner, warmup=self._warmup, iters=self._iters,
                clock=self._clock, median=True)
        return self._measured[b]


@dataclasses.dataclass
class WorkerStats:
    batches: int = 0
    items: int = 0
    busy_time: float = 0.0
    idle_time: float = 0.0
    failures: int = 0


class WorkerInstance:
    """One model instance pinned to `threads` units, serving batches ≤ b.

    Each worker *owns* a bounded work queue (``queue``): under the
    continuous dispatch policy, the router moves requests into it and
    the worker is fed a ≤ b sub-batch the moment it goes idle.  The
    batch-synchronous policy leaves it empty.  Idle gaps (time between
    becoming free and starting the next batch) are recorded so the
    per-instance utilization win of continuous dispatch is measurable.
    """

    def __init__(self, instance_id: int, threads: int, batch: int,
                 backend: LatencyBackend, *, units: Tuple[int, ...] = (),
                 spawned_at: float = 0.0, model_id: str = "default"):
        self.id = instance_id
        self.threads = threads
        self.batch = batch
        self.backend = backend
        self.units = units
        self.model_id = model_id
        self.spawned_at = spawned_at
        self.released_at: Optional[float] = None  # set when swapped out
        self.busy_until = spawned_at
        self.failed = False
        self.stats = WorkerStats()
        self.queue: Deque = collections.deque()   # per-instance work queue
        self.coalesce_armed = False               # continuous-policy timer
        self.inflight = 0       # real-plane batches submitted, not finished
        # idle gaps as log₂-ms bucket counts: O(1) memory at any run length
        self.idle_gap_buckets: Dict[int, int] = {}

    def is_idle(self, now: float) -> bool:
        return not self.failed and self.busy_until <= now

    def utilization(self, now: float) -> float:
        """Fraction of this worker's *active* lifetime spent executing
        batches.  Swapped-out instances stop accruing lifetime once
        released and drained (a release mid-batch still counts the
        in-flight work's runtime), so utilization is not diluted by the
        rest of the run."""
        if self.released_at is None:
            end = now
        else:
            end = min(now, max(self.released_at, self.busy_until))
        alive = end - self.spawned_at
        return self.stats.busy_time / alive if alive > 0 else 0.0

    def process(self, n_items: int, now: float, *,
                n_live_instances: int = 1, total_units: int = 0) -> float:
        """Start a batch; returns its completion time."""
        if self.failed:
            raise RuntimeError(f"instance {self.id} is failed")
        lat = self.backend.batch_latency(
            self.threads, max(1, n_items),
            n_live_instances=n_live_instances, total_units=total_units)
        start = max(now, self.busy_until)
        gap = start - self.busy_until
        if gap > 0:
            self.stats.idle_time += gap
            k = log2_ms_bucket(gap)
            self.idle_gap_buckets[k] = self.idle_gap_buckets.get(k, 0) + 1
        self.busy_until = start + lat
        self.stats.batches += 1
        self.stats.items += n_items
        self.stats.busy_time += lat
        return self.busy_until

    # ------------------------------------------------------------------ #
    # real-execution bookkeeping (driven by RealPlane; the simulated
    # path uses process() above, whose latency is the backend's word)
    # ------------------------------------------------------------------ #
    def begin_batch(self, n_items: int, now: float, expected: float) -> None:
        """Record a real batch starting now: idle-gap accounting identical
        to process(), but ``busy_until`` is only a *provisional* estimate
        (the expected latency) — the wall clock has the last word."""
        if self.failed:
            raise RuntimeError(f"instance {self.id} is failed")
        start = max(now, self.busy_until)
        gap = start - self.busy_until
        if gap > 0:
            self.stats.idle_time += gap
            k = log2_ms_bucket(gap)
            self.idle_gap_buckets[k] = self.idle_gap_buckets.get(k, 0) + 1
        self.busy_until = start + expected
        self.inflight += 1
        self.stats.batches += 1
        self.stats.items += n_items

    def finish_batch(self, now: float, observed: float) -> None:
        """A real batch completed at wall time ``now`` after ``observed``
        seconds of execution; with nothing else in flight the worker is
        idle *now*, whatever the provisional estimate claimed."""
        self.inflight = max(0, self.inflight - 1)
        self.stats.busy_time += observed
        if self.inflight == 0:
            self.busy_until = now

    def fail(self) -> None:
        self.failed = True
        self.stats.failures += 1

    def respawn(self, now: float) -> None:
        self.failed = False
        self.busy_until = now
