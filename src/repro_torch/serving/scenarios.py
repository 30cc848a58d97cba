"""Scenario registry: named, capacity-relative serving workloads.

A *scenario* pairs a workload shape (Poisson, bursty MMPP, diurnal,
step, ramp, trace replay) with rates expressed **relative to the served
model's capacity**, so the same scenario stresses ResNet-50 and GPT-2
equally hard.  Capacity comes from the Packrat optimizer itself: the
sustainable throughput at batch ``b`` is ``b / L*(T, b)`` where ``L*``
is the optimal makespan (:class:`ScenarioContext`).

Scenarios register by name (``@scenario``); the benchmark CLI
(``repro.launch.bench_serving``) looks them up and runs each through
the full controller under both a static baseline and the adaptive
Packrat policy.  Adding a scenario is one decorated function — see
``docs/ARCHITECTURE.md``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from ..core.knapsack import PackratOptimizer
from .workloads import (DiurnalWorkload, MMPPWorkload, PoissonWorkload,
                        RampWorkload, StepWorkload, TraceWorkload, Workload)


@dataclasses.dataclass(frozen=True)
class ScenarioContext:
    """What a scenario builder may depend on: capacity and run shape."""

    threads: int                  # T, total units on the server
    optimizer: PackratOptimizer   # solves ⟨T,B⟩ → optimal config
    duration: float               # seconds of offered load
    seed: int = 0
    max_total_batch: Optional[int] = None   # largest feasible aggregate B

    def capacity_rps(self, batch: int) -> float:
        """Sustainable throughput (req/s) at aggregate batch ``batch``.

        The built-in scenarios reference the paper's batch grid (B=8/32/
        64); under a small ``--max-batch`` those may exceed the largest
        servable aggregate batch, so clamp rather than crash the solve.
        """
        if self.max_total_batch is not None:
            batch = max(1, min(batch, self.max_total_batch))
        cfg = self.optimizer.solve(self.threads, batch)
        return batch / cfg.latency


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    build: Callable[[ScenarioContext], Workload]


_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(name: str, description: str,
                      build: Callable[[ScenarioContext], Workload]) -> Scenario:
    if name in _REGISTRY:
        raise ValueError(f"scenario {name!r} already registered")
    sc = Scenario(name=name, description=description, build=build)
    _REGISTRY[name] = sc
    return sc


def scenario(name: str, description: str):
    """Decorator form of :func:`register_scenario`."""

    def deco(fn: Callable[[ScenarioContext], Workload]):
        register_scenario(name, description, fn)
        return fn

    return deco


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def list_scenarios() -> List[Scenario]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


# --------------------------------------------------------------------- #
# built-in scenarios
#
# Rates are fractions of the capacity at a reference batch size, so
# every scenario is meaningful for any profiled model.  Batch sizes
# follow the paper's evaluation grid (B=8 "low", B=64 "high").
# --------------------------------------------------------------------- #
@scenario("steady-poisson",
          "steady Poisson load at 70% of the B=32 capacity")
def _steady(ctx: ScenarioContext) -> Workload:
    return PoissonWorkload(rate_rps=0.7 * ctx.capacity_rps(32))


@scenario("bursty",
          "MMPP on/off bursts: quiet at 30% of B=8 capacity, bursts to "
          "85% of B=64 capacity")
def _bursty(ctx: ScenarioContext) -> Workload:
    quiet = 0.3 * ctx.capacity_rps(8)
    burst = 0.85 * ctx.capacity_rps(64)
    # dwell times scaled to the run so several bursts land per run
    return MMPPWorkload(rates=(quiet, burst),
                        mean_dwell=(ctx.duration / 6.0, ctx.duration / 12.0))


@scenario("diurnal",
          "sinusoidal day/night curve around 55% of B=32 capacity "
          "(one period per run)")
def _diurnal(ctx: ScenarioContext) -> Workload:
    return DiurnalWorkload(base_rps=0.55 * ctx.capacity_rps(32),
                           amplitude=0.7, period=ctx.duration)


@scenario("step-up",
          "Fig.-11 step: B=8-matched load jumping to 90% of B=64 "
          "capacity at 30% of the run")
def _step_up(ctx: ScenarioContext) -> Workload:
    return StepWorkload(low=0.8 * ctx.capacity_rps(8),
                        high=0.9 * ctx.capacity_rps(64),
                        t_step=0.3 * ctx.duration)


@scenario("step-down",
          "load collapse: 90% of B=64 capacity dropping to B=8-matched "
          "load at 40% of the run")
def _step_down(ctx: ScenarioContext) -> Workload:
    return StepWorkload(low=0.9 * ctx.capacity_rps(64),
                        high=0.8 * ctx.capacity_rps(8),
                        t_step=0.4 * ctx.duration)


@scenario("ramp",
          "linear ramp from 20% to 90% of B=64 capacity across the run")
def _ramp(ctx: ScenarioContext) -> Workload:
    cap = ctx.capacity_rps(64)
    return RampWorkload(start_rps=0.2 * cap, end_rps=0.9 * cap,
                        t0=0.0, t1=ctx.duration)


@scenario("choppy",
          "fast on/off MMPP (~15 bursts/run): stresses dispatch "
          "granularity — instance-set barriers leave thin instances idle")
def _choppy(ctx: ScenarioContext) -> Workload:
    lo = 0.25 * ctx.capacity_rps(8)
    hi = 0.9 * ctx.capacity_rps(64)
    return MMPPWorkload(rates=(lo, hi),
                        mean_dwell=(ctx.duration / 10.0, ctx.duration / 20.0))


@scenario("flash-crowd",
          "trace replay: quiet Poisson interrupted by a 10x flash crowd "
          "for 15% of the run (exercises the trace pipeline)")
def _flash_crowd(ctx: ScenarioContext) -> Workload:
    quiet = 0.25 * ctx.capacity_rps(8)
    spike_start = 0.5 * ctx.duration
    spike_len = 0.15 * ctx.duration
    base = PoissonWorkload(rate_rps=quiet)
    spike = PoissonWorkload(rate_rps=min(10.0 * quiet,
                                         0.95 * ctx.capacity_rps(64)))
    times = [t for t in base.arrivals(ctx.duration, seed=ctx.seed)
             if not (spike_start <= t < spike_start + spike_len)]
    times += [spike_start + t for t in spike.arrivals(spike_len,
                                                      seed=ctx.seed + 1)]
    return TraceWorkload(times=tuple(sorted(times)), name="flash-crowd")


@scenario("overload",
          "sustained overload: steady Poisson at 140% of the B=64 "
          "capacity — no configuration keeps up; tests admission "
          "control, shedding and goodput under saturation")
def _overload(ctx: ScenarioContext) -> Workload:
    return PoissonWorkload(rate_rps=1.4 * ctx.capacity_rps(64))


@scenario("flash-overload",
          "flash crowd beyond capacity: quiet at 30% of B=32 capacity, "
          "spiking to 200% of B=64 capacity for 25% of the run — only "
          "shedding bounds the admitted tail")
def _flash_overload(ctx: ScenarioContext) -> Workload:
    quiet = 0.3 * ctx.capacity_rps(32)
    spike_start = 0.4 * ctx.duration
    spike_len = 0.25 * ctx.duration
    base = PoissonWorkload(rate_rps=quiet)
    spike = PoissonWorkload(rate_rps=2.0 * ctx.capacity_rps(64))
    times = [t for t in base.arrivals(ctx.duration, seed=ctx.seed)
             if not (spike_start <= t < spike_start + spike_len)]
    times += [spike_start + t for t in spike.arrivals(spike_len,
                                                      seed=ctx.seed + 1)]
    return TraceWorkload(times=tuple(sorted(times)), name="flash-overload")


@scenario("node-failure",
          "steady Poisson at 60% of B=32 capacity; under a multi-node "
          "fabric, node 1 is killed at 40% of the run (fabric event) — "
          "tests failover without duplicate delivery")
def _node_failure(ctx: ScenarioContext) -> Workload:
    return PoissonWorkload(rate_rps=0.6 * ctx.capacity_rps(32))


def fleet_overload_trace(*, optimizer: PackratOptimizer, total_units: int,
                         duration: float, seed: int = 0,
                         max_total_batch: Optional[int] = None,
                         name: str = "flash-overload") -> List[float]:
    """One seeded arrival trace of a registered scenario sized against
    *fleet* capacity — the identical trace both sides of an
    overload-control comparison (shed-only vs fidelity ladder) replay.
    Factoring it here keeps the benchmark emitter and the verification
    harness on literally the same arrivals."""
    ctx = ScenarioContext(threads=total_units, optimizer=optimizer,
                          duration=duration, seed=seed,
                          max_total_batch=max_total_batch)
    return list(get_scenario(name).build(ctx).arrivals(duration, seed=seed))


# --------------------------------------------------------------------- #
# fabric events: scheduled fleet actions attached to scenarios
#
# A scenario's workload describes *traffic*; some fabric behaviours are
# instead triggered by *operator/fault events* (a node dying, a planned
# drain).  Events are registered per scenario name and applied by the
# multi-node benchmark runner; single-node runs ignore them.
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FabricEvent:
    at_frac: float      # event time as a fraction of the run duration
    action: str         # "fail" | "drain"
    node: int           # node index within the fabric


FABRIC_EVENTS: Dict[str, Tuple[FabricEvent, ...]] = {
    "node-failure": (FabricEvent(at_frac=0.4, action="fail", node=1),),
}


def fabric_events(scenario_name: str) -> Tuple[FabricEvent, ...]:
    """Scheduled fleet events for a scenario (empty for most)."""
    return FABRIC_EVENTS.get(scenario_name, ())


# --------------------------------------------------------------------- #
# multi-model (mixed-traffic) scenarios
#
# A mixed scenario maps each model tenant to its own workload shape.
# Rates are expressed relative to the tenant's *even-split share* of the
# pod (T/n units): the static even-split baseline is then exactly at its
# provisioned capacity, and any win the adaptive resource plane reports
# comes from re-splitting units across tenants, not from slack in the
# scenario definition.
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MultiModelScenarioContext:
    """Per-tenant capacity contexts for a mixed-traffic scenario builder.

    ``contexts[model_id]`` is a :class:`ScenarioContext` whose
    ``threads`` is the tenant's even-split share, so
    ``capacity_rps(b)`` means "what this tenant could sustain if the
    pod were split evenly and never re-planned".
    """

    models: Tuple[str, ...]                   # tenant ids, fixed order
    contexts: Mapping[str, ScenarioContext]
    duration: float
    seed: int = 0

    def ctx(self, model_id: str) -> ScenarioContext:
        return self.contexts[model_id]


@dataclasses.dataclass(frozen=True)
class MultiModelScenario:
    name: str
    description: str
    build: Callable[[MultiModelScenarioContext], Dict[str, Workload]]


_MM_REGISTRY: Dict[str, MultiModelScenario] = {}


def register_mm_scenario(name: str, description: str,
                         build: Callable[[MultiModelScenarioContext],
                                         Dict[str, Workload]]
                         ) -> MultiModelScenario:
    if name in _MM_REGISTRY:
        raise ValueError(f"multi-model scenario {name!r} already registered")
    sc = MultiModelScenario(name=name, description=description, build=build)
    _MM_REGISTRY[name] = sc
    return sc


def mm_scenario(name: str, description: str):
    """Decorator form of :func:`register_mm_scenario`."""

    def deco(fn: Callable[[MultiModelScenarioContext], Dict[str, Workload]]):
        register_mm_scenario(name, description, fn)
        return fn

    return deco


def get_mm_scenario(name: str) -> MultiModelScenario:
    try:
        return _MM_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown multi-model scenario {name!r}; "
            f"registered: {sorted(_MM_REGISTRY)}") from None


def list_mm_scenarios() -> List[MultiModelScenario]:
    return [_MM_REGISTRY[k] for k in sorted(_MM_REGISTRY)]


@mm_scenario("mixed-steady",
             "every tenant at steady Poisson load, 65% of its even-split "
             "B=32 capacity (the friendly multi-tenant baseline)")
def _mixed_steady(mctx: MultiModelScenarioContext) -> Dict[str, Workload]:
    return {m: PoissonWorkload(rate_rps=0.65 * mctx.ctx(m).capacity_rps(32))
            for m in mctx.models}


@mm_scenario("mixed-diurnal",
             "anti-correlated diurnal pair: tenants peak half a period "
             "apart, each peaking ~5% above its even-split B=32 capacity "
             "— only re-splitting units serves both peaks")
def _mixed_diurnal(mctx: MultiModelScenarioContext) -> Dict[str, Workload]:
    out: Dict[str, Workload] = {}
    for k, m in enumerate(mctx.models):
        base = 0.55 * mctx.ctx(m).capacity_rps(32)
        out[m] = DiurnalWorkload(base_rps=base, amplitude=0.9,
                                 period=mctx.duration,
                                 phase=math.pi * k)
    return out


@mm_scenario("mixed-burst",
             "burst on one tenant: all tenants idle at 30% of even-split "
             "B=8 capacity, but the last tenant bursts to ~90% of its "
             "even-split B=64 capacity (MMPP on/off)")
def _mixed_burst(mctx: MultiModelScenarioContext) -> Dict[str, Workload]:
    out: Dict[str, Workload] = {}
    for k, m in enumerate(mctx.models):
        ctx = mctx.ctx(m)
        quiet = 0.3 * ctx.capacity_rps(8)
        if k == len(mctx.models) - 1:
            burst = 0.9 * ctx.capacity_rps(64)
            out[m] = MMPPWorkload(rates=(quiet, burst),
                                  mean_dwell=(mctx.duration / 6.0,
                                              mctx.duration / 12.0))
        else:
            out[m] = PoissonWorkload(rate_rps=quiet)
    return out


__all__ = [
    "FabricEvent", "MultiModelScenario", "MultiModelScenarioContext",
    "Scenario", "ScenarioContext", "fabric_events", "fleet_overload_trace",
    "get_mm_scenario",
    "get_scenario", "list_mm_scenarios", "list_scenarios", "mm_scenario",
    "register_mm_scenario", "register_scenario", "scenario",
]
