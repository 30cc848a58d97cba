"""Discrete-event simulation core for serving experiments.

The end-to-end Packrat pipeline (estimator → optimizer → allocator →
dispatcher → workers, §3.1) is exercised against arrival processes on a
virtual clock, with instance latencies supplied by a pluggable backend
(paper-calibrated tables, roofline-derived models, or real measured JAX
execution).  This is how the Fig.-11 reconfiguration timeline and the
fault-tolerance behaviours are reproduced deterministically on CPU.

The :class:`EventLoop` here is the *time source* of the simulated
execution plane (``repro.serving.plane.SimulatedPlane``); the serving
engine itself only ever talks to an
:class:`~repro.serving.plane.ExecutionPlane`, so the same dispatcher,
controller and tenancy code also runs against real wall-clock JAX
execution (``RealPlane``) without change.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, List, Optional, Tuple


# Tolerance for scheduling "in the past": events up to this far behind
# the clock are accepted (and fire immediately at the current time, never
# rewinding it) so float round-off in deadline arithmetic cannot crash a
# run.  Part of the loop's public contract — the vectorized fast path
# (repro.serving.fastsim) must honour the identical epsilon, and
# tests/test_simulator_contract.py pins it.
PAST_EPSILON = 1e-12


class EventLoop:
    """Minimal deterministic event loop (heap of timestamped callbacks).

    Ordering contract (shared with the vectorized fast path): events are
    processed in ``(time, seq)`` order, where ``seq`` is the scheduling
    sequence number — same-timestamp events fire in the order they were
    scheduled, and ``run_until(t)`` includes events at exactly ``t``.
    The clock never rewinds: an event accepted up to ``PAST_EPSILON``
    behind ``now`` runs at ``now``.
    """

    def __init__(self) -> None:
        self.now = 0.0
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        self.at(self.now + delay, fn)

    def at(self, time: float, fn: Callable[[], None]) -> None:
        if time < self.now - PAST_EPSILON:
            raise ValueError(f"cannot schedule in the past ({time} < {self.now})")
        heapq.heappush(self._heap, (time, next(self._seq), fn))

    def run_until(self, t_end: float) -> None:
        while self._heap and self._heap[0][0] <= t_end:
            time, _, fn = heapq.heappop(self._heap)
            self.now = max(self.now, time)
            fn()
        self.now = max(self.now, t_end)

    def run(self) -> None:
        while self._heap:
            time, _, fn = heapq.heappop(self._heap)
            self.now = max(self.now, time)
            fn()


DEFAULT_MODEL = "default"   # the single-model (one-tenant) model id


@dataclasses.dataclass(frozen=True)
class Request:
    id: int
    arrival: float
    model_id: str = DEFAULT_MODEL
    # autoregressive serving (repro.models.serve_lm): which phase this
    # request's next batch runs ("prefill" | "decode"; "" = phaseless
    # one-shot inference — every pre-LM path), the pow2 prompt bucket,
    # and how many decode steps remain before EOS/max-len.  Defaults
    # keep the classic one-shot request representation unchanged.
    phase: str = ""
    seq_bucket: int = 0
    steps_left: int = 0


@dataclasses.dataclass
class Response:
    request: Request
    completion: float
    batch_size: int
    instance_id: int
    redispatched: bool = False
    model_id: str = DEFAULT_MODEL
    # set by the cluster fabric when the response crossed a router:
    # which node served the request (None on single-node paths)
    node_id: Optional[str] = None
    # fidelity rung the serving node was at when it delivered (None on
    # paths without a fidelity ladder; 0 = full fidelity)
    fidelity: Optional[int] = None

    @property
    def latency(self) -> float:
        return self.completion - self.request.arrival


@dataclasses.dataclass(frozen=True)
class Shed:
    """Terminal state for a request the serving fabric refused.

    A shed request will never produce a :class:`Response`: it was turned
    away at admission (token bucket empty), by queue-depth overload
    control, or because no routable node existed.  Metrics count sheds
    against offered load — goodput and SLO attainment treat them as
    violations — while latency percentiles remain admitted-only.
    """

    request: Request
    time: float                     # when the fabric refused it
    node_id: Optional[str] = None   # node that refused (None: no node)
    reason: str = "admission"       # "admission" | "queue" | "no-node"


class ArrivalProcess:
    """Deterministic arrival generators (Poisson available but seeded)."""

    @staticmethod
    def uniform(rate_fn: Callable[[float], float], t_end: float,
                start: float = 0.0) -> List[float]:
        """Evenly spaced arrivals whose instantaneous rate is rate_fn(t).

        Deterministic (integrates the rate function) so experiments are
        reproducible; rate changes take effect immediately — this is the
        'step function' load of the paper's Fig. 11.
        """
        times: List[float] = []
        t = start
        while t < t_end:
            r = max(rate_fn(t), 1e-9)
            t += 1.0 / r
            if t < t_end:
                times.append(t)
        return times

    @staticmethod
    def poisson(rng, rate_fn: Callable[[float], float], t_end: float,
                start: float = 0.0) -> List[float]:
        import numpy as np
        times: List[float] = []
        t = start
        while t < t_end:
            r = max(rate_fn(t), 1e-9)
            t += float(rng.exponential(1.0 / r))
            if t < t_end:
                times.append(t)
        return times


def step_rate(low: float, high: float, t_step: float) -> Callable[[float], float]:
    """Fig.-11 style step in request rate at time t_step."""
    return lambda t: low if t < t_step else high
