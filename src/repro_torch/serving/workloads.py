"""Workload scenario engine: seeded, deterministic arrival processes.

Packrat's central claim is that the optimal ⟨i,t,b⟩ configuration is
*workload-dependent* and must be re-picked online as load shifts (§3.8,
Fig. 11).  Exercising that claim needs realistic, time-varying traffic —
the regime serving controllers are actually evaluated in (InferLine,
Harpagon).  This module provides the arrival-process generators:

* :class:`PoissonWorkload`       — homogeneous Poisson at a fixed rate;
* :class:`MMPPWorkload`          — Markov-modulated Poisson (bursty: the
  rate jumps between states with exponential dwell times);
* :class:`DiurnalWorkload`       — sinusoidal day/night rate curve;
* :class:`StepWorkload`          — Fig.-11 style step change in rate;
* :class:`RampWorkload`          — linear ramp between two rates;
* :class:`TraceWorkload`         — replay of a recorded trace, with
  JSON/CSV round-tripping so real traces can be checked in.

Every workload is **deterministic given a seed**: ``arrivals(duration,
seed=s)`` constructs its own ``numpy`` generator from ``s``, so the same
call always yields the same timestamp list and two policies can be
compared on *identical* traffic.  Non-homogeneous processes use Lewis &
Shedler thinning against ``max_rate``; the instantaneous expectation is
exposed via ``rate(t)`` for tests and plotting.

Nothing here touches the event loop or dispatcher: a workload produces
plain ``List[float]`` arrival times which the caller schedules (see
``repro.launch.bench_serving``).
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


class Workload:
    """Base arrival process.

    Subclasses define ``rate(t)`` (instantaneous expected request rate,
    req/s) and ``max_rate(duration)`` (a finite upper bound used for
    thinning); ``arrivals`` then samples a non-homogeneous Poisson
    process.  Subclasses with their own sampling structure (MMPP, trace
    replay) override ``arrivals`` directly.
    """

    name: str = "workload"

    def rate(self, t: float) -> float:
        raise NotImplementedError

    def max_rate(self, duration: float) -> float:
        raise NotImplementedError

    def mean_rate(self, duration: float, *, n: int = 512) -> float:
        """Trapezoidal estimate of the average of ``rate`` over the run."""
        ts = np.linspace(0.0, duration, n)
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid([self.rate(float(t)) for t in ts], ts)
                     / duration)

    def arrivals(self, duration: float, *, seed: int = 0) -> List[float]:
        """Sample arrival timestamps in ``[0, duration)`` (sorted).

        Lewis–Shedler thinning: candidate gaps at ``max_rate``, each kept
        with probability ``rate(t)/max_rate``.  Exact for any bounded
        rate function and trivially deterministic under a fixed seed.
        """
        rng = _rng(seed)
        lam = self.max_rate(duration)
        if lam <= 0:
            return []
        out: List[float] = []
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / lam))
            if t >= duration:
                return out
            if float(rng.random()) * lam <= self.rate(t):
                out.append(t)


@dataclasses.dataclass(frozen=True)
class PoissonWorkload(Workload):
    """Homogeneous Poisson arrivals at ``rate_rps`` requests/second."""

    rate_rps: float
    name: str = "poisson"

    def rate(self, t: float) -> float:
        return self.rate_rps

    def max_rate(self, duration: float) -> float:
        return self.rate_rps


@dataclasses.dataclass(frozen=True)
class StepWorkload(Workload):
    """Piecewise-constant rate: ``low`` before ``t_step``, ``high`` after.

    The stochastic analogue of the paper's Fig.-11 step load (the
    deterministic variant lives in ``simulator.step_rate``).
    """

    low: float
    high: float
    t_step: float
    name: str = "step"

    def rate(self, t: float) -> float:
        return self.low if t < self.t_step else self.high

    def max_rate(self, duration: float) -> float:
        return max(self.low, self.high)


@dataclasses.dataclass(frozen=True)
class RampWorkload(Workload):
    """Linear ramp from ``start_rps`` to ``end_rps`` over [t0, t1]."""

    start_rps: float
    end_rps: float
    t0: float = 0.0
    t1: float = float("inf")
    name: str = "ramp"

    def rate(self, t: float) -> float:
        if t <= self.t0:
            return self.start_rps
        if t >= self.t1:
            return self.end_rps
        frac = (t - self.t0) / (self.t1 - self.t0)
        return self.start_rps + frac * (self.end_rps - self.start_rps)

    def max_rate(self, duration: float) -> float:
        return max(self.rate(0.0), self.rate(duration),
                   self.start_rps, self.end_rps)


@dataclasses.dataclass(frozen=True)
class DiurnalWorkload(Workload):
    """Sinusoidal day/night load: ``base·(1 + amplitude·sin(2πt/period + φ))``.

    ``amplitude`` ∈ [0, 1] keeps the rate non-negative.  One ``period``
    is one compressed "day"; benchmarks default the period to the run
    duration so a single run sweeps trough → peak → trough.
    """

    base_rps: float
    amplitude: float = 0.6
    period: float = 60.0
    phase: float = 0.0
    name: str = "diurnal"

    def __post_init__(self) -> None:
        if not (0.0 <= self.amplitude <= 1.0):
            raise ValueError(f"amplitude must be in [0,1], got {self.amplitude}")

    def rate(self, t: float) -> float:
        return self.base_rps * (
            1.0 + self.amplitude * math.sin(2.0 * math.pi * t / self.period
                                            + self.phase))

    def max_rate(self, duration: float) -> float:
        return self.base_rps * (1.0 + self.amplitude)


@dataclasses.dataclass(frozen=True)
class MMPPWorkload(Workload):
    """Markov-modulated Poisson process — the classic bursty-traffic model.

    A continuous-time Markov chain over ``len(rates)`` states; in state
    ``k`` arrivals are Poisson at ``rates[k]``, and the chain dwells an
    ``Exp(mean_dwell[k])`` time before jumping to the next state (cyclic
    by default — low→high→low captures burst on/off).  ``rate(t)`` is
    the *stationary* mean rate (the path itself is random).
    """

    rates: Tuple[float, ...] = (5.0, 50.0)
    mean_dwell: Tuple[float, ...] = (8.0, 2.0)
    name: str = "mmpp"

    def __post_init__(self) -> None:
        if len(self.rates) != len(self.mean_dwell) or len(self.rates) < 2:
            raise ValueError("need >= 2 states with matching dwell times")

    def stationary_rate(self) -> float:
        """Dwell-weighted mean rate of the cyclic chain."""
        w = np.asarray(self.mean_dwell, dtype=float)
        r = np.asarray(self.rates, dtype=float)
        return float((w * r).sum() / w.sum())

    def rate(self, t: float) -> float:
        return self.stationary_rate()

    def max_rate(self, duration: float) -> float:
        return max(self.rates)

    def state_path(self, duration: float, *, seed: int = 0
                   ) -> List[Tuple[float, int]]:
        """[(enter_time, state), …] of the modulating chain (seeded)."""
        rng = _rng(seed)
        path: List[Tuple[float, int]] = [(0.0, 0)]
        t, k = 0.0, 0
        while t < duration:
            t += float(rng.exponential(self.mean_dwell[k]))
            k = (k + 1) % len(self.rates)
            if t < duration:
                path.append((t, k))
        return path

    def arrivals(self, duration: float, *, seed: int = 0) -> List[float]:
        """Poisson arrivals along ``state_path(duration, seed=seed)``.

        The chain and the arrivals draw from *separate* streams derived
        from the same seed, so overlaying ``state_path`` on ``arrivals``
        (same seed) shows exactly which bursts belong to which state.
        """
        path = self.state_path(duration, seed=seed)
        rng = np.random.default_rng([seed, 0x6d6d7070])  # independent stream
        out: List[float] = []
        for (t0, k), t1 in zip(path, [t for t, _ in path[1:]] + [duration]):
            lam = self.rates[k]
            tt = t0
            while lam > 0:
                tt += float(rng.exponential(1.0 / lam))
                if tt >= t1:
                    break
                out.append(tt)
        return out


@dataclasses.dataclass(frozen=True)
class TraceWorkload(Workload):
    """Replay of a recorded arrival trace.

    ``times`` are absolute offsets from trace start (seconds, sorted).
    ``arrivals`` ignores the seed — a trace is already a sample path —
    and clips to the requested duration.  Round-trips through JSON
    (``{"arrivals": [...]}``) and CSV (one ``arrival_s`` column), so
    production traces can be checked into ``benchmarks/traces/``.
    """

    times: Tuple[float, ...]
    name: str = "trace"

    def __post_init__(self) -> None:
        if any(b < a for a, b in zip(self.times, self.times[1:])):
            raise ValueError("trace timestamps must be sorted")
        if self.times and self.times[0] < 0:
            raise ValueError("trace timestamps must be >= 0")

    # ------------------------------------------------------------------ #
    def rate(self, t: float, *, window: float = 1.0) -> float:
        """Empirical rate: arrivals within ``window`` seconds around t."""
        lo, hi = t - window / 2.0, t + window / 2.0
        return sum(1 for x in self.times if lo <= x < hi) / window

    def max_rate(self, duration: float) -> float:
        if not self.times:
            return 0.0
        return max(self.rate(t) for t in self.times)

    def mean_rate(self, duration: float, *, n: int = 512) -> float:
        return len([t for t in self.times if t < duration]) / duration

    def arrivals(self, duration: float, *, seed: int = 0) -> List[float]:
        return [t for t in self.times if t < duration]

    # ------------------------------------------------------------------ #
    # persistence
    # ------------------------------------------------------------------ #
    def save_json(self, path) -> None:
        Path(path).write_text(json.dumps(
            {"arrivals": list(self.times)}, indent=None))

    def save_csv(self, path) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["arrival_s"])
            for t in self.times:
                w.writerow([repr(t)])

    @classmethod
    def from_json(cls, path) -> "TraceWorkload":
        data = json.loads(Path(path).read_text())
        times = data["arrivals"] if isinstance(data, dict) else data
        return cls(times=tuple(float(t) for t in times))

    @classmethod
    def from_csv(cls, path) -> "TraceWorkload":
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        if rows and rows[0] and not _is_float(rows[0][0]):
            rows = rows[1:]                      # header row
        return cls(times=tuple(float(r[0]) for r in rows if r))

    @classmethod
    def from_file(cls, path) -> "TraceWorkload":
        p = Path(path)
        if p.suffix.lower() == ".json":
            return cls.from_json(p)
        return cls.from_csv(p)

    @classmethod
    def record(cls, workload: Workload, duration: float, *, seed: int = 0
               ) -> "TraceWorkload":
        """Freeze any workload's sample path into a replayable trace."""
        return cls(times=tuple(workload.arrivals(duration, seed=seed)))


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


__all__ = [
    "DiurnalWorkload", "MMPPWorkload", "PoissonWorkload", "RampWorkload",
    "StepWorkload", "TraceWorkload", "Workload",
]
