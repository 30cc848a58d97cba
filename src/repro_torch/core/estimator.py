"""Packrat's batch-size estimator (paper §3.8).

Two-level smoothing over the request queue depth:

1. EWMA of the observed queue depth  ``Q̃ₓ = α·Q̂ + (1-α)·Q̃ₓ₋₁``, floored
   to the *next lower power of two* → per-tick batch-size estimate B̂ₓ.
2. Mode over the last ``n`` estimates (B̂ₓ₋ₙ…B̂ₓ) → smoothed batch size B̃.

After each reconfiguration timeout, B̃ is compared with the currently
configured batch size B; a difference triggers reconfiguration (handled
by the controller, see serving/controller.py).  This deliberately avoids
"flip-flopping" between configurations (§3.8).

The Q̂ fed to :meth:`BatchSizeEstimator.observe` is a *signal source*
selectable per dispatch policy (serving/policy.py):

* batch-synchronous dispatch samples the queue highwater at dispatch
  instants — the paper's signal, since backlog accumulates while the
  instance set barriers on the previous aggregate batch;
* continuous per-instance dispatch drains the queue the moment any
  instance goes idle, so dispatch-instant highwater undersamples; it
  instead feeds max(outstanding work, λ̂·L) where λ̂ comes from
  :class:`ArrivalRateSignal` — Little's-law work-in-system.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional


def floor_power_of_two(x: float) -> int:
    """Largest power of two <= x (>= 1)."""
    if x < 1.0:
        return 1
    return 1 << (int(x).bit_length() - 1)


@dataclasses.dataclass
class EstimatorConfig:
    alpha: float = 0.25          # EWMA weight on the newest observation
    window: int = 8              # n, the mode window length
    reconfigure_timeout: float = 5.0  # seconds between reconfiguration checks
    min_batch: int = 1
    max_batch: int = 1 << 16
    # B̂ = floor_pow2(Q̃·(1+headroom)).  An EWMA converging to a power of
    # two *from below* (7.99 → floor 4) would otherwise halve the batch
    # forever; 25% headroom keeps the paper's next-lower-power-of-two rule
    # for any load not sitting exactly on a boundary.
    headroom: float = 0.25


class HysteresisGate:
    """Consecutive-calm-streak counter for reverse-order recovery.

    Overload entry is instantaneous (one hot observation engages the
    next degrade rung) but recovery must not be: a single calm tick
    after a flash crowd would re-enter the rung immediately and thrash.
    The gate opens only after ``required`` *consecutive* calm
    observations; any hot observation resets the streak.
    """

    def __init__(self, required: int = 3) -> None:
        if required < 1:
            raise ValueError(f"required calm streak must be >= 1, "
                             f"got {required}")
        self.required = required
        self.streak = 0
        self.opens = 0           # times the gate opened (recovery steps)
        self.resets = 0          # hot observations that reset a streak

    def observe(self, calm: bool) -> bool:
        """Feed one observation; returns True when the streak reaches
        ``required`` (and restarts the count for the next step up)."""
        if not calm:
            if self.streak:
                self.resets += 1
            self.streak = 0
            return False
        self.streak += 1
        if self.streak >= self.required:
            self.streak = 0
            self.opens += 1
            return True
        return False

    def reset(self) -> None:
        self.streak = 0


class ArrivalRateSignal:
    """EWMA arrival-rate tracker: the estimator signal source for
    continuous dispatch policies.

    Smooths the inter-arrival gap with an EWMA and reports the inverse
    as req/s; with ``now`` supplied, a growing silence since the last
    arrival decays the rate instead of freezing it at the last burst.
    """

    def __init__(self, alpha: float = 0.25) -> None:
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._last: Optional[float] = None
        self._mean_gap: Optional[float] = None

    def observe(self, now: float) -> None:
        """Record one arrival at virtual time ``now``."""
        if self._last is not None:
            gap = max(now - self._last, 1e-9)
            self._mean_gap = (
                gap if self._mean_gap is None
                else self.alpha * gap + (1.0 - self.alpha) * self._mean_gap)
        self._last = now

    def rate(self, now: Optional[float] = None) -> float:
        """Smoothed arrivals/sec (0.0 until two arrivals were seen)."""
        if self._mean_gap is None:
            return 0.0
        gap = self._mean_gap
        if now is not None and self._last is not None:
            gap = max(gap, now - self._last)
        return 1.0 / gap


class LatencyCorrectionSignal:
    """EWMA of observed/expected latency ratios — one cell of the online
    profile-refinement loop (paper Fig. 9's expected-vs-observed gap,
    tracked instead of merely reported).

    Ratios are clamped to ``[1/clamp, clamp]`` before smoothing so a
    single pathological measurement (a paused worker thread, a clock
    hiccup) cannot poison the correction factor.
    """

    def __init__(self, alpha: float = 0.25, clamp: float = 16.0) -> None:
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if clamp < 1.0:
            raise ValueError(f"clamp must be >= 1, got {clamp}")
        self.alpha = alpha
        self.clamp = clamp
        self.samples = 0
        self._ratio: Optional[float] = None

    def observe(self, ratio: float) -> None:
        """Fold one observed/expected ratio into the EWMA."""
        if not (ratio > 0.0):        # rejects NaN and non-positive ratios
            return
        ratio = min(max(ratio, 1.0 / self.clamp), self.clamp)
        self._ratio = (ratio if self._ratio is None
                       else self.alpha * ratio
                       + (1.0 - self.alpha) * self._ratio)
        self.samples += 1

    @property
    def ratio(self) -> float:
        """Smoothed observed/expected ratio (1.0 until any sample)."""
        return 1.0 if self._ratio is None else self._ratio


class BatchSizeEstimator:
    """Online batch-size estimation from queue-depth observations."""

    def __init__(self, config: Optional[EstimatorConfig] = None,
                 initial_batch: int = 1) -> None:
        self.config = config or EstimatorConfig()
        if not (0.0 < self.config.alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {self.config.alpha}")
        if self.config.window < 1:
            raise ValueError("window must be >= 1")
        # warm-start the EWMA at the configured batch so the start-up
        # transient (empty queue before traffic flows) cannot trigger an
        # immediate spurious scale-down
        self._ewma: Optional[float] = float(initial_batch)
        self._estimates: Deque[int] = collections.deque(maxlen=self.config.window)
        self._last_check_time: float = 0.0
        self.current_batch: int = initial_batch

    # ------------------------------------------------------------------ #
    def observe(self, queue_depth: float) -> int:
        """Feed one queue-depth sample Q̂; returns this tick's estimate B̂ₓ."""
        if queue_depth < 0:
            raise ValueError("queue depth must be >= 0")
        a = self.config.alpha
        self._ewma = (
            queue_depth if self._ewma is None
            else a * queue_depth + (1.0 - a) * self._ewma
        )
        est = floor_power_of_two(
            max(self._ewma * (1.0 + self.config.headroom),
                self.config.min_batch))
        est = max(self.config.min_batch, min(est, self.config.max_batch))
        self._estimates.append(est)
        return est

    @property
    def ewma(self) -> float:
        return 0.0 if self._ewma is None else self._ewma

    def smoothed_batch(self) -> int:
        """B̃ = mode of the last n per-tick estimates (ties → most recent)."""
        if not self._estimates:
            return self.current_batch
        counts = collections.Counter(self._estimates)
        top = max(counts.values())
        # ties broken toward the most recent estimate achieving the mode count
        for est in reversed(self._estimates):
            if counts[est] == top:
                return est
        raise AssertionError("unreachable")

    def should_reconfigure(self, now: float) -> Optional[int]:
        """Check (rate-limited by reconfigure_timeout) whether B̃ != B.

        Returns the new batch size if a reconfiguration should be
        triggered, else None.  Call from the controller's event loop.
        """
        if now - self._last_check_time < self.config.reconfigure_timeout:
            return None
        self._last_check_time = now
        smoothed = self.smoothed_batch()
        if smoothed != self.current_batch:
            return smoothed
        return None

    def commit(self, new_batch: int) -> None:
        """Record that the system reconfigured to ``new_batch``."""
        self.current_batch = new_batch


class PhaseEstimator:
    """Per-phase batch-size estimation for autoregressive serving.

    Prefill (compute-bound, demand ∝ arriving prompts) and decode
    (memory-bound, demand ∝ resident in-flight sequences) see different
    queue processes, so each phase gets its own
    :class:`BatchSizeEstimator` fed from its own dispatcher's signal;
    the joint estimate drives the phase-split planner
    (``repro.core.knapsack.solve_phase_split``).
    """

    def __init__(self, phases=("prefill", "decode"),
                 config: Optional[EstimatorConfig] = None,
                 initial_batch: int = 1) -> None:
        if not phases:
            raise ValueError("need at least one phase")
        self.estimators = {
            p: BatchSizeEstimator(config, initial_batch=initial_batch)
            for p in phases}

    def observe(self, phase: str, queue_depth: float) -> int:
        return self.estimators[phase].observe(queue_depth)

    def smoothed_batches(self):
        return {p: e.smoothed_batch() for p, e in self.estimators.items()}

    def current_batches(self):
        return {p: e.current_batch for p, e in self.estimators.items()}

    def should_reconfigure(self, now: float):
        """Phase → new batch for every phase whose B̃ ≠ B at this
        (rate-limited) check; None when no phase wants a change."""
        changed = {p: nb for p, e in self.estimators.items()
                   if (nb := e.should_reconfigure(now)) is not None}
        return changed or None

    def commit(self, batches) -> None:
        for p, b in batches.items():
            self.estimators[p].commit(b)
