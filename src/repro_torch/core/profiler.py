"""Packrat's profiler (paper §3.2).

Profiles single-instance ⟨1,t,b⟩ configurations over the grid
``t ∈ thread_values × b ∈ {1,2,4,…,B_max}`` — the paper's (n+1)·T-point
grid instead of the exhaustive 2^n·T one — and records the average batch
latency ``L[t,b]`` used by the knapsack optimizer.

Two interchangeable backends:

* :class:`MeasuredProfiler` — times real callables (paper-faithful;
  used on CPU with micro models and by the event simulator).  Follows the
  paper's methodology: ``warmup`` iterations discarded, mean over
  ``iters`` runs.
* :class:`AnalyticProfiler` — derives ``L[t,b]`` from roofline terms
  produced by a compiled dry-run (TPU path; see launch/hlo_analysis.py),
  i.e. compile-time profiling instead of wall-clock profiling.

Profiling is offline and not on the inference critical path (§3.2) —
but it no longer has to stay offline-only: :class:`ProfileCalibrator`
closes the loop, folding *serve-time* observed batch latencies back
into a correction factor over the profiled ``L[t,b]`` table so the
knapsack re-solves against calibrated costs (the paper's Fig. 9
expected-vs-observed gap, corrected instead of merely reported).

All wall-clock timing — the profiler's, the serving backends', the real
execution plane's — goes through one :func:`measure_latency` helper so
profile-time and serve-time measurement can never drift apart
methodologically.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from .estimator import LatencyCorrectionSignal
from .knapsack import powers_of_two, profile_grid
from .roofline import RooflineTerms

Profile = Dict[Tuple[int, int], float]


def profile_rows(profile: Mapping[Tuple[int, int], float]
                 ) -> Dict[int, List[int]]:
    """Index a ``L[t,b]`` table by thread row: {t: sorted batch sizes}."""
    rows: Dict[int, List[int]] = {}
    for (t, b) in profile:
        rows.setdefault(t, []).append(b)
    for bs in rows.values():
        bs.sort()
    return rows


def row_latency(profile: Mapping[Tuple[int, int], float],
                rows: Mapping[int, Sequence[int]], t: int, b: int) -> float:
    """Lookup within one profiled thread row (``t`` must be in ``rows``):
    exact hit, else round b up to the next profiled size (a partial batch
    costs what its enclosing profiled batch costs), else scale linearly
    above the largest profiled batch.  The one row-lookup rule shared by
    the serving backend and the calibrator — the two must never drift."""
    if (t, b) in profile:
        return profile[(t, b)]
    bs = rows[t]
    for bb in bs:
        if bb >= b:
            return profile[(t, bb)]
    top = bs[-1]
    return profile[(t, top)] * (b / top)


def bracket_threads(rows: Mapping[int, Sequence[int]], t: int
                    ) -> Tuple[Optional[int], Optional[int]]:
    """The profiled thread rows bracketing an off-grid ``t`` (either side
    None when ``t`` lies outside the profiled range)."""
    ts = sorted(rows)
    lo = max((tt for tt in ts if tt < t), default=None)
    hi = min((tt for tt in ts if tt > t), default=None)
    return lo, hi


def thread_latency(profile: Mapping[Tuple[int, int], float],
                   rows: Mapping[int, Sequence[int]], t: int, b: int
                   ) -> float:
    """Row lookup for profiled t; linear interpolation between the
    bracketing rows for an off-grid t; clamp at the range ends."""
    if t in rows:
        return row_latency(profile, rows, t, b)
    lo, hi = bracket_threads(rows, t)
    if lo is not None and hi is not None:
        w = (t - lo) / (hi - lo)
        return ((1.0 - w) * row_latency(profile, rows, lo, b)
                + w * row_latency(profile, rows, hi, b))
    return row_latency(profile, rows, lo if lo is not None else hi, b)


def measure_latency(run: Callable[[], object], *, warmup: int, iters: int,
                    clock: Callable[[], float] = time.perf_counter,
                    median: bool = False) -> float:
    """Time ``run()``: ``warmup`` discarded iterations, then ``iters``
    measured ones.

    ``median=False`` (default) reproduces the paper's §5.1 methodology —
    one clock read around the whole measured block, mean per iteration.
    ``median=True`` times each iteration separately and returns the
    median, which is what serving probes want: a single GC pause or
    page-fault must not become the latency estimate the optimizer plans
    against.  Shared by :class:`MeasuredProfiler`, the serving
    ``JaxBackend`` probe, and the real execution plane's profiler.
    """
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    for _ in range(warmup):
        run()
    if median:
        samples = []
        for _ in range(iters):
            t0 = clock()
            run()
            samples.append(clock() - t0)
        return float(statistics.median(samples))
    start = clock()
    for _ in range(iters):
        run()
    return (clock() - start) / iters


@dataclasses.dataclass(frozen=True)
class ProfileSpec:
    """What to profile: the ⟨t,b⟩ grid for a ⟨T, B_max⟩ deployment."""

    total_threads: int
    max_batch: int
    thread_values: Optional[Tuple[int, ...]] = None  # default: 1..T

    def grid(self) -> List[Tuple[int, int]]:
        return profile_grid(self.total_threads, self.max_batch,
                            thread_values=self.thread_values)

    @property
    def n_configs(self) -> int:
        return len(self.grid())

    @property
    def n_exhaustive(self) -> int:
        """Size of the exhaustive grid the paper avoids (2^n · T)."""
        ts = (len(self.thread_values) if self.thread_values is not None
              else self.total_threads)
        return ts * self.max_batch


class MeasuredProfiler:
    """Wall-clock profiling of a user-supplied runner.

    ``runner(t, b)`` must execute one inference batch of size ``b`` with
    ``t``-way intra-op parallelism and block until complete (e.g. call a
    jitted function and ``block_until_ready``).
    """

    def __init__(self, runner: Callable[[int, int], None], *,
                 warmup: int = 10, iters: int = 100,
                 clock: Callable[[], float] = time.perf_counter,
                 median: bool = False) -> None:
        # warmup/iters defaults follow the paper's §5.1 methodology;
        # median=True switches to outlier-robust per-iteration timing
        # (the real execution plane's profiling mode).
        self.runner = runner
        self.warmup = warmup
        self.iters = iters
        self.clock = clock
        self.median = median

    def measure(self, t: int, b: int) -> float:
        return measure_latency(lambda: self.runner(t, b),
                               warmup=self.warmup, iters=self.iters,
                               clock=self.clock, median=self.median)

    def profile(self, spec: ProfileSpec,
                progress: Optional[Callable[[int, int, float], None]] = None
                ) -> Profile:
        table: Profile = {}
        for (t, b) in spec.grid():
            lat = self.measure(t, b)
            table[(t, b)] = lat
            if progress is not None:
                progress(t, b, lat)
        return table


class AnalyticProfiler:
    """Roofline-derived profiling from compiled dry-run artifacts.

    ``terms_fn(t, b)`` returns :class:`RooflineTerms` for a single
    instance on ``t`` chips serving batch ``b`` (typically by lowering
    ``serve_step`` on a t-chip sub-mesh; see launch/dryrun.py).  Results
    are memoised: compiling is expensive.
    """

    def __init__(self, terms_fn: Callable[[int, int], RooflineTerms], *,
                 overlap: bool = True) -> None:
        self.terms_fn = terms_fn
        self.overlap = overlap
        self._memo: Dict[Tuple[int, int], RooflineTerms] = {}

    def terms(self, t: int, b: int) -> RooflineTerms:
        key = (t, b)
        if key not in self._memo:
            self._memo[key] = self.terms_fn(t, b)
        return self._memo[key]

    def measure(self, t: int, b: int) -> float:
        terms = self.terms(t, b)
        return terms.latency if self.overlap else terms.latency_serial

    def profile(self, spec: ProfileSpec,
                progress: Optional[Callable[[int, int, float], None]] = None
                ) -> Profile:
        table: Profile = {}
        for (t, b) in spec.grid():
            lat = self.measure(t, b)
            table[(t, b)] = lat
            if progress is not None:
                progress(t, b, lat)
        return table


class TabulatedProfiler:
    """Profile backed by a precomputed table (paper-calibrated curves,
    simulator scenarios, and tests)."""

    def __init__(self, table: Mapping[Tuple[int, int], float]) -> None:
        self.table = dict(table)

    def measure(self, t: int, b: int) -> float:
        return self.table[(t, b)]

    def profile(self, spec: ProfileSpec, progress=None) -> Profile:
        out: Profile = {}
        for (t, b) in spec.grid():
            if (t, b) in self.table:
                out[(t, b)] = self.table[(t, b)]
                if progress is not None:
                    progress(t, b, out[(t, b)])
        return out


class ProfileCalibrator:
    """Online profile refinement: observed serve-time batch latencies
    flow back into per-⟨t,b⟩ correction factors over the planning table.

    The paper reports the expected-vs-observed gap (Fig. 9 — the
    optimizer plans against isolated single-instance profiles, but live
    instances share clocks and memory controllers) and leaves it open;
    InferBench argues a benchmarking system must measure it, InferLine
    exploits the analogous calibration for SLO-driven provisioning.
    Here the gap *closes*: each completed batch contributes an
    observed/expected ratio (EWMA per profiled cell,
    :class:`~repro.core.estimator.LatencyCorrectionSignal`), and once
    the correction has drifted past ``rel_threshold`` the serving
    controller rebuilds its optimizer from :meth:`calibrated_profile`
    so the knapsack re-solves against costs the hardware actually
    delivers.

    Cells never observed borrow the *global* ratio — interference is
    constant-factor to first order (§5.2.2), so one cell's gap is the
    best available estimate for its neighbours.  ``refresh_interval``
    rate-limits optimizer rebuilds; ``math.inf`` disables refresh while
    still collecting the expected-vs-observed report (the static
    baseline's mode).
    """

    def __init__(self, profile: Mapping[Tuple[int, int], float], *,
                 alpha: float = 0.25, rel_threshold: float = 0.10,
                 refresh_interval: float = 5.0,
                 min_samples: int = 3) -> None:
        if not profile:
            raise ValueError("empty profile")
        self.base: Profile = dict(profile)
        self.rel_threshold = rel_threshold
        self.refresh_interval = refresh_interval
        self.min_samples = min_samples
        self._alpha = alpha
        self._signals: Dict[Tuple[int, int], LatencyCorrectionSignal] = {}
        self._global = LatencyCorrectionSignal(alpha=alpha)
        self._applied: Dict[Tuple[int, int], float] = {}
        self._last_refresh: Optional[float] = None
        self.observations = 0
        self.refreshes = 0
        self.refreshes_skipped = 0
        self._rows = profile_rows(self.base)

    # ------------------------------------------------------------------ #
    # expected-latency lookup: the exact rules the serving backend
    # applies (shared row_latency/thread_latency helpers), so expected
    # values can never drift from what the dispatcher budgeted
    # ------------------------------------------------------------------ #
    def expected(self, t: int, b: int) -> Optional[float]:
        return thread_latency(self.base, self._rows, t, b)

    def _key(self, t: int, b: int) -> Tuple[int, int]:
        """The profiled cell an observation of ⟨t,b⟩ calibrates: the
        serving row (b rounded up / clamped), with an off-grid thread
        count attributed to the nearest profiled row."""
        if t not in self._rows:
            lo, hi = bracket_threads(self._rows, t)
            cands = [tt for tt in (lo, hi) if tt is not None]
            t = min(cands, key=lambda tt: (abs(tt - t), tt))
        bs = self._rows[t]
        for bb in bs:
            if bb >= b:
                return (t, bb)
        return (t, bs[-1])

    # ------------------------------------------------------------------ #
    # feeding + correction
    # ------------------------------------------------------------------ #
    def observe(self, t: int, b: int, observed_s: float) -> None:
        """Fold one measured batch latency into the correction state."""
        expected = self.expected(t, b)
        if expected is None or not (expected > 0.0) or not (observed_s > 0.0):
            return
        ratio = observed_s / expected
        key = self._key(t, b)
        sig = self._signals.setdefault(
            key, LatencyCorrectionSignal(alpha=self._alpha))
        sig.observe(ratio)
        self._global.observe(ratio)
        self.observations += 1

    def correction(self, t: int, b: int) -> float:
        """The calibrated/base ratio for one profiled cell."""
        sig = self._signals.get((t, b))
        if sig is not None and sig.samples >= self.min_samples:
            return sig.ratio
        return self.global_ratio

    def correction_at(self, t: int, b: int) -> float:
        """The correction for an arbitrary ⟨t,b⟩, mapped to the profiled
        cell that would serve it (what a calibrated backend applies)."""
        return self.correction(*self._key(t, b))

    @property
    def global_ratio(self) -> float:
        """Profile-wide observed/expected ratio (1.0 until samples)."""
        if self._global.samples < self.min_samples:
            return 1.0
        return self._global.ratio

    def calibrated_profile(self) -> Profile:
        """The base ``L[t,b]`` table with corrections applied — what the
        knapsack re-solves against after a refresh."""
        return {k: lat * self.correction(*k) for k, lat in self.base.items()}

    # ------------------------------------------------------------------ #
    # refresh gating (the controller asks, then marks)
    # ------------------------------------------------------------------ #
    def drift(self) -> float:
        """Largest relative change of any cell's correction since the
        last applied refresh (0.0 with no observations)."""
        if not self.observations:
            return 0.0
        worst = 0.0
        for key in self.base:
            cur = self.correction(*key)
            applied = self._applied.get(key, 1.0)
            worst = max(worst, abs(cur - applied) / applied)
        return worst

    def should_refresh(self, now: float) -> bool:
        if not math.isfinite(self.refresh_interval):
            return False
        if (self._last_refresh is not None
                and now - self._last_refresh < self.refresh_interval):
            return False
        return self.drift() > self.rel_threshold

    def mark_refreshed(self, now: float, *, applied: bool = True) -> None:
        """Record that the controller acted on (or, with
        ``applied=False``, deliberately skipped) this refresh window.

        A skipped refresh — the calibrated profile matched what the
        optimizer already plans against, so rebuilding the DP table
        would change nothing — still arms the refresh-interval timer
        and re-bases drift, but counts under ``refreshes_skipped``.
        """
        self._applied = {k: self.correction(*k) for k in self.base}
        self._last_refresh = now
        if applied:
            self.refreshes += 1
        else:
            self.refreshes_skipped += 1

    # ------------------------------------------------------------------ #
    def report(self) -> Dict[str, object]:
        """JSON-serializable expected-vs-observed summary (Fig. 9)."""
        entries = []
        for (t, b) in sorted(self._signals):
            sig = self._signals[(t, b)]
            exp = self.base[(t, b)]
            entries.append({
                "t": t, "b": b, "samples": sig.samples,
                "expected_ms": exp * 1e3,
                "observed_ms": exp * sig.ratio * 1e3,
                "ratio": sig.ratio,
            })
        return {
            "observations": self.observations,
            "refreshes": self.refreshes,
            "refreshes_skipped": self.refreshes_skipped,
            "global_ratio": self.global_ratio,
            "max_drift": self.drift(),
            "entries": entries,
        }


PhaseProfiles = Dict[str, Profile]


def phase_profiles(plane, spec: ProfileSpec, phases, *, warmup: int = 2,
                   iters: int = 5) -> PhaseProfiles:
    """One measured ``L[t,b]`` table per serving phase, through the
    plane's phase-routed runner cells.

    For an autoregressive model the two phases have opposite resource
    profiles — prefill latency scales with prompt tokens × batch
    (compute-bound), decode latency with the resident batch against the
    KV cache (memory-bound) — so the knapsack must plan each phase
    against its own table (``repro.core.knapsack.solve_phase_split``).
    """
    return {phase: plane.profile(spec, warmup=warmup, iters=iters,
                                 phase=phase)
            for phase in phases}


FidelityProfiles = Dict[int, Profile]


def fidelity_profiles(plane, spec: ProfileSpec, n_rungs: int, *,
                      phase: str = "", warmup: int = 2,
                      iters: int = 5) -> FidelityProfiles:
    """One measured ``L[t,b]`` table per fidelity rung, through the
    plane's ⟨fidelity, phase, t, b⟩-keyed runner cells.

    Each rung of a model's degrade ladder is a genuinely different
    compiled program (fewer layers / narrower widths), so the ladder
    planner (:class:`~repro.core.knapsack.FidelityLadder`) needs a
    measured table per rung — profiled through the same runner cache
    the serving path executes, like every other profile here.
    """
    return {rung: plane.profile(spec, warmup=warmup, iters=iters,
                                phase=phase, fidelity=rung)
            for rung in range(n_rungs)}


def profiling_cost_summary(spec: ProfileSpec,
                           seconds_per_config: float = 60.0) -> Dict[str, float]:
    """The paper's §3.2 profiling-cost argument, parameterized.

    For n=10, T=16: exhaustive 16 384 configs (~30 days at minutes each)
    vs the power-of-two grid's 176 (~hours).
    """
    return {
        "grid_configs": spec.n_configs,
        "exhaustive_configs": spec.n_exhaustive,
        "grid_hours": spec.n_configs * seconds_per_config / 3600.0,
        "exhaustive_hours": spec.n_exhaustive * seconds_per_config / 3600.0,
        "reduction": spec.n_exhaustive / max(1, spec.n_configs),
    }
