"""Execution planes: one serving engine over virtual time or real JAX.

The plane owns the three things the rest of the serving stack must not
care about — **time**, **worker execution**, and **completion
delivery** — so :class:`~repro.serving.dispatcher.Dispatcher`,
:class:`~repro.serving.controller.PackratServer` and
:class:`~repro.serving.tenancy.MultiModelServer` are plane-agnostic:

* :class:`SimulatedPlane` — the discrete-event path: virtual clock
  (:class:`~repro.serving.simulator.EventLoop`), instance latencies from
  a :class:`~repro.serving.instance.LatencyBackend`.  Bit-identical to
  the pre-plane engine (pinned by the golden timeline hashes in
  tests/test_policy.py and tests/test_plane.py).
* :class:`RealPlane` — wall-clock execution: each batch runs a jitted
  JAX step on the worker's own single-thread executor (TorchServe-style
  worker serialization), per-instance intra-op thread *budgets* are
  enforced by a counted unit gate (concurrently running instances never
  claim more than T units — the machine constraint Packrat allocates
  against; a single-process JAX CPU device cannot repartition its
  intra-op pool per call, so the budget bounds co-running claims rather
  than pinning threads), timers fire on the wall clock, and completions
  are delivered back on the driving thread so controller state never
  needs locks.

Both planes expose the :class:`~repro.serving.simulator.EventLoop`
scheduling interface (``now``/``at``/``schedule``/``run_until``), so
every component that used to hold a loop now holds a plane without
noticing.  Profiling goes through the *same* plane runners
(:meth:`RealPlane.profiler` wraps the shared
:class:`~repro.core.profiler.MeasuredProfiler` measurement helper), so
profile-time and serve-time execution are one code path — the
precondition for the closed expected-vs-observed calibration loop
(:class:`~repro.core.profiler.ProfileCalibrator`).
"""

from __future__ import annotations

import collections
import heapq
import itertools
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..core.knapsack import next_power_of_two
from ..core.profiler import MeasuredProfiler, Profile, ProfileSpec
from .instance import WorkerInstance
from .simulator import EventLoop
from .spans import SpanLog

# a zero-arg callable that executes one batch to completion (blocking)
BatchRunner = Callable[[], None]
# factory: (threads, batch) -> BatchRunner
RunnerFactory = Callable[[int, int], BatchRunner]


class ExecutionPlane:
    """Owns time, worker execution, and completion delivery.

    The scheduling half mirrors :class:`EventLoop` so planes are drop-in
    loop replacements; the execution half is :meth:`execute_batch`,
    which starts ``n_items`` on a worker, promises to call
    ``on_complete(observed_latency_s)`` when the batch finishes, and
    returns the *expected* latency the caller should budget watchdogs
    against (in the simulated plane expectation and observation
    coincide; in the real plane the wall clock decides).
    """

    name = "abstract"
    fidelity = 0            # current fidelity rung (0 = full fidelity)
    # the span log (serving/spans.py); only RealPlane keeps one
    spans: Optional[SpanLog] = None

    # ------------------------------------------------------------------ #
    # time (EventLoop-compatible)
    # ------------------------------------------------------------------ #
    @property
    def now(self) -> float:
        raise NotImplementedError

    def at(self, time: float, fn: Callable[[], None]) -> None:
        raise NotImplementedError

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        self.at(self.now + delay, fn)

    def run_until(self, t_end: float) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def execute_batch(self, worker: WorkerInstance, n_items: int, *,
                      n_live_instances: int = 1, total_units: int = 0,
                      on_complete: Callable[[float], None],
                      span: Optional[list] = None) -> float:
        raise NotImplementedError

    def release_worker(self, worker: WorkerInstance) -> None:
        """The worker was swapped out and will receive no more batches;
        planes holding per-worker resources free them here (in-flight
        work still completes and delivers)."""

    def close(self) -> None:
        """Release plane resources (worker executors); idempotent."""

    # ------------------------------------------------------------------ #
    # runner warm-up (RealPlane compiles ahead; virtual-time planes have
    # nothing to compile, so the base plane accepts the same
    # ⟨fidelity, phase, t, b⟩-keyed call as a no-op)
    # ------------------------------------------------------------------ #
    def warm(self, cells: Iterable[Tuple[int, int]], phase: str = "",
             fidelity: int = 0) -> int:
        return 0

    def set_fidelity(self, fidelity: int) -> None:
        """Select the fidelity rung subsequent batches execute at
        (fidelity-aware real factories build the rung's cheaper variant;
        virtual-time planes model the rung through the backend profile
        swap instead, so this is a recorded no-op)."""
        self.fidelity = fidelity

    def __enter__(self) -> "ExecutionPlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # dispatcher factory
    # ------------------------------------------------------------------ #
    def make_dispatcher(self, config, instances, on_response, dcfg=None,
                        policy=None, model_id: str = "default",
                        peer_live=None):
        """Build the dispatcher a tenant on this plane should run.

        The default is the exact event-at-a-time
        :class:`~repro.serving.dispatcher.Dispatcher`; planes with a
        vectorized engine (``FastPlane``) override this to substitute
        their accelerated equivalent where it is proven bit-identical.
        """
        from .dispatcher import Dispatcher
        return Dispatcher(self, config, instances, on_response, dcfg,
                          policy=policy, model_id=model_id,
                          peer_live=peer_live)


class SimulatedPlane(ExecutionPlane):
    """The existing EventLoop + LatencyBackend path behind the plane
    interface — a pure delegation layer, so timelines are bit-identical
    to the pre-plane engine."""

    name = "sim"

    def __init__(self, loop: Optional[EventLoop] = None) -> None:
        self.loop = loop if loop is not None else EventLoop()

    @property
    def now(self) -> float:
        return self.loop.now

    def at(self, time: float, fn: Callable[[], None]) -> None:
        self.loop.at(time, fn)

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        self.loop.schedule(delay, fn)

    def run_until(self, t_end: float) -> None:
        self.loop.run_until(t_end)

    def run(self) -> None:
        self.loop.run()

    def execute_batch(self, worker: WorkerInstance, n_items: int, *,
                      n_live_instances: int = 1, total_units: int = 0,
                      on_complete: Callable[[float], None],
                      span: Optional[list] = None) -> float:
        now = self.loop.now
        busy_before = worker.busy_until
        done_t = worker.process(n_items, now,
                                n_live_instances=n_live_instances,
                                total_units=total_units)
        # execution latency excludes any queueing behind an earlier batch
        observed = done_t - max(now, busy_before)
        self.loop.at(done_t, lambda: on_complete(observed))
        return done_t - now


class RealPlane(ExecutionPlane):
    """Wall-clock plane: jitted model steps on worker thread executors.

    ``make_runner(t, b)`` returns a zero-arg callable executing one
    batch of ``b`` items to completion with a ``t``-unit budget (micro
    models from ``repro.models.micro``, or any jitted step).  Runners
    are cached per ⟨t, rounded-b⟩ — partial batches pad up to the next
    power of two, like a real server's compiled bucket sizes.

    Threading model: the *driving* thread (whoever calls
    :meth:`run_until`) executes every timer and completion callback, so
    dispatcher/controller state stays single-threaded; worker threads
    only run the jitted step and post the measured latency back through
    a queue.  Each :class:`WorkerInstance` gets its own single-thread
    executor, serializing its batches the way a TorchServe worker
    process would.
    """

    name = "real"

    def __init__(self, make_runner: RunnerFactory, total_units: int, *,
                 clock: Callable[[], float] = time.perf_counter,
                 max_runners: int = 32, spans: bool = False) -> None:
        if total_units < 1:
            raise ValueError(f"total_units must be >= 1, got {total_units}")
        if max_runners < 1:
            raise ValueError(f"max_runners must be >= 1, got {max_runners}")
        self._make = make_runner
        # factories marked ``phase_aware`` (repro.models.serve_lm) take a
        # third argument selecting the runner phase; the plane routes a
        # worker's batches by its model_id ("prefill" / "decode" pools)
        self._phase_aware = bool(getattr(make_runner, "phase_aware", False))
        # factories marked ``fidelity_aware`` accept a ``fidelity=``
        # keyword selecting the model's degrade rung; non-aware factories
        # only ever serve rung 0
        self._fidelity_aware = bool(getattr(make_runner, "fidelity_aware",
                                            False))
        self.total_units = total_units
        self._clock = clock
        self._epoch: Optional[float] = None
        self._timers: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self._completions: "queue.Queue[Callable[[], None]]" = queue.Queue()
        # LRU-bounded compiled-runner cache: long sweeps over batch sizes
        # (or phase × seq-bucket cells) must not accumulate executables
        # unboundedly.  Evicting an in-flight runner is safe — the
        # executing batch holds its own reference.
        self._runners: "collections.OrderedDict[Tuple[int, str, int, int], BatchRunner]" \
            = collections.OrderedDict()
        self._max_runners = max_runners
        self.runner_evictions = 0
        # first-touch build/compile wall time per cell, in ms — excluded
        # from every latency percentile (the factory compiles outside the
        # timed path), reported so drains aren't silently inflated
        self.compile_ms: Dict[str, float] = {}
        self._executors: Dict[int, ThreadPoolExecutor] = {}
        self._units_cv = threading.Condition()
        self._units_free = total_units
        self._closed = False
        # request and batch records on this plane's clock, if asked for
        self.spans = SpanLog(clock) if spans else None

    # ------------------------------------------------------------------ #
    # time
    # ------------------------------------------------------------------ #
    def _start(self) -> None:
        if self._epoch is None:
            self._epoch = self._clock()
            if self.spans is not None:
                self.spans.epoch = self._epoch

    @property
    def now(self) -> float:
        if self._epoch is None:
            return 0.0
        return self._clock() - self._epoch

    def at(self, time: float, fn: Callable[[], None]) -> None:
        # wall clocks drift past intended deadlines; clamp instead of
        # raising (the EventLoop's in-the-past check guards virtual-time
        # determinism, which has no analogue here)
        heapq.heappush(self._timers, (max(time, self.now),
                                      next(self._seq), fn))

    def _drain_completions(self) -> None:
        while True:
            try:
                fn = self._completions.get_nowait()
            except queue.Empty:
                return
            fn()

    def run_until(self, t_end: float) -> None:
        """Drive the reactor until wall time ``t_end`` (seconds since
        the plane first started running).  Timers due by ``t_end`` fire
        even if the wall clock has already passed them; completions are
        delivered as they arrive — and always *before* due timers, so a
        straggler watchdog observing the same wall instant as a posted
        completion cannot redispatch the already-finished batch."""
        self._start()
        while True:
            self._drain_completions()
            # fire every timer due by min(now, t_end)
            while self._timers and self._timers[0][0] <= min(self.now, t_end):
                _, _, fn = heapq.heappop(self._timers)
                fn()
                self._drain_completions()
            now = self.now
            if now >= t_end:
                return
            next_t = self._timers[0][0] if self._timers else t_end
            timeout = max(0.0, min(next_t, t_end) - now)
            try:
                fn = self._completions.get(timeout=min(timeout, 0.050))
            except queue.Empty:
                continue
            fn()
            self._drain_completions()

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def runner(self, t: int, b: int, phase: str = "",
               fidelity: int = 0) -> BatchRunner:
        """The cached jitted runner for a ⟨fidelity, phase, t, b⟩ cell
        (b rounds up to the next power of two — compiled bucket sizes).
        Cache hits refresh LRU order; misses build the runner (timing the
        cell's *first* compile into :attr:`compile_ms` — a re-warm of an
        evicted cell recompiles but is not double-counted) and may evict
        the least recently used cell."""
        f = fidelity if self._fidelity_aware else 0
        key = (f, phase, t, next_power_of_two(max(1, b)))
        run = self._runners.get(key)
        if run is None:
            t0 = self._clock()
            args = (key[2], key[3], phase) if self._phase_aware \
                else (key[2], key[3])
            if self._fidelity_aware:
                run = self._make(*args, fidelity=f)
            else:
                run = self._make(*args)
            elapsed_ms = (self._clock() - t0) * 1e3
            label = f"{phase}:{key[2]},{key[3]}" if phase \
                else f"{key[2]},{key[3]}"
            if f:
                label = f"f{f}:{label}"
            if label not in self.compile_ms:
                self.compile_ms[label] = elapsed_ms
            self._runners[key] = run
            while len(self._runners) > self._max_runners:
                self._runners.popitem(last=False)
                self.runner_evictions += 1
        else:
            self._runners.move_to_end(key)
        return run

    def _worker_phase(self, worker: WorkerInstance) -> str:
        """Phase-aware factories route by the worker's pool identity."""
        return worker.model_id if self._phase_aware else ""

    def warm(self, cells: Iterable[Tuple[int, int]], phase: str = "",
             fidelity: int = 0) -> int:
        """Compile-ahead: instantiate the runner for each ⟨t, b⟩ cell now
        (triggered from the controller's plan-apply hook during a
        reconfiguration, or a fidelity-rung transition) so the first
        request after a replan never eats a jit compile stall.  Returns
        the number of cells newly compiled."""
        f = fidelity if self._fidelity_aware else 0
        n = 0
        for t, b in cells:
            key = (f, phase, t, next_power_of_two(max(1, b)))
            n += key not in self._runners
            self.runner(t, b, phase, fidelity)
        return n

    def runner_report(self) -> Dict[str, object]:
        """Runner-cache accounting for bench reports: per-cell first-touch
        compile ms (excluded from latency percentiles), LRU evictions and
        current cache occupancy."""
        return {
            "cached": len(self._runners),
            "evictions": self.runner_evictions,
            "compile_ms": {k: round(v, 3)
                           for k, v in sorted(self.compile_ms.items())},
        }

    def _acquire_units(self, n: int) -> None:
        with self._units_cv:
            while self._units_free < n:
                self._units_cv.wait()
            self._units_free -= n

    def _release_units(self, n: int) -> None:
        with self._units_cv:
            self._units_free += n
            self._units_cv.notify_all()

    def _executor_for(self, worker: WorkerInstance) -> ThreadPoolExecutor:
        ex = self._executors.get(id(worker))
        if ex is None:
            ex = ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix=f"worker-{worker.model_id}-{worker.id}")
            self._executors[id(worker)] = ex
        return ex

    def execute_batch(self, worker: WorkerInstance, n_items: int, *,
                      n_live_instances: int = 1, total_units: int = 0,
                      on_complete: Callable[[float], None],
                      span: Optional[list] = None) -> float:
        if self._closed:
            raise RuntimeError("plane is closed")
        self._start()
        n_items = max(1, n_items)
        # the expectation comes from the worker's planning backend (the
        # measured profile) — the watchdog budget and the provisional
        # busy_until; the wall clock supplies the observation
        now = self.now
        expected = worker.backend.batch_latency(
            worker.threads, n_items, n_live_instances=n_live_instances,
            total_units=total_units or self.total_units)
        # mirror SimulatedPlane's contract: the returned expectation
        # includes the wait behind the worker's provisional backlog, so
        # watchdog deadlines are not systematically early for batches
        # queued behind this worker's executor
        busy_before = worker.busy_until
        worker.begin_batch(n_items, now, expected)
        expected_done = max(now, busy_before) + expected - now
        run = self.runner(worker.threads, n_items,
                          phase=self._worker_phase(worker),
                          fidelity=self.fidelity)
        claim = min(worker.threads, self.total_units)

        def job() -> None:
            if span is not None:
                self.spans.start(span)
            self._acquire_units(claim)
            try:
                t0 = self._clock()
                if span is not None:
                    self.spans.enter(span, t0)
                run()
                observed = self._clock() - t0
                if span is not None:
                    self.spans.leave(span, t0 + observed)
            finally:
                self._release_units(claim)
            self._completions.put(
                lambda: self._complete(worker, observed, on_complete,
                                       span=span))

        self._executor_for(worker).submit(job)
        return expected_done

    def _complete(self, worker: WorkerInstance, observed: float,
                  on_complete: Callable[[float], None],
                  span: Optional[list] = None) -> None:
        if span is not None:
            self.spans.batch_done(span, self.now)
        worker.finish_batch(self.now, observed)
        on_complete(observed)

    def release_worker(self, worker: WorkerInstance) -> None:
        """Shut down the retired worker's executor (non-blocking; a
        batch already submitted still runs to completion and posts its
        result).  Without this, every active-passive swap would leak one
        idle thread per retired instance — and ``id()`` reuse after
        garbage collection could hand a new worker a dead worker's
        executor."""
        ex = self._executors.pop(id(worker), None)
        if ex is not None:
            ex.shutdown(wait=False)

    # ------------------------------------------------------------------ #
    # profiling through the plane (one code path with serving)
    # ------------------------------------------------------------------ #
    def profiler(self, *, warmup: int = 2, iters: int = 5, phase: str = "",
                 fidelity: int = 0) -> MeasuredProfiler:
        """A :class:`MeasuredProfiler` over this plane's own runner
        cache: profile-time execution is the same jitted callable the
        serving path fires, measured with the shared helper
        (median-of-N — robust to scheduler noise).  ``phase`` selects
        the runner pool for phase-aware factories (per-phase profiles);
        ``fidelity`` selects the degrade rung for fidelity-aware ones
        (per-rung profiles for the ladder planner)."""
        return MeasuredProfiler(
            lambda t, b: self.runner(t, b, phase, fidelity)(),
            warmup=warmup, iters=iters, clock=self._clock, median=True)

    def profile(self, spec: ProfileSpec, *, warmup: int = 2,
                iters: int = 5, phase: str = "",
                fidelity: int = 0) -> Profile:
        return self.profiler(warmup=warmup, iters=iters, phase=phase,
                             fidelity=fidelity).profile(spec)

    # ------------------------------------------------------------------ #
    def close(self, wait: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        for ex in self._executors.values():
            ex.shutdown(wait=wait)
        self._executors.clear()


def as_plane(loop_or_plane) -> ExecutionPlane:
    """Adopt a raw :class:`EventLoop` into a :class:`SimulatedPlane`
    (a ``FastLoop`` into a ``FastPlane``); pass planes through untouched
    (idempotent)."""
    if isinstance(loop_or_plane, ExecutionPlane):
        return loop_or_plane
    if isinstance(loop_or_plane, EventLoop):
        # deferred import: fastsim builds on this module
        from .fastsim import FastLoop, FastPlane
        if isinstance(loop_or_plane, FastLoop):
            return FastPlane(loop_or_plane)
        return SimulatedPlane(loop_or_plane)
    raise TypeError(f"expected EventLoop or ExecutionPlane, "
                    f"got {type(loop_or_plane).__name__}")


__all__ = ["BatchRunner", "ExecutionPlane", "RealPlane", "RunnerFactory",
           "SimulatedPlane", "as_plane"]
