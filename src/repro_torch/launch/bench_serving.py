"""Trace-driven serving benchmark: scenarios × policy × dispatch axes.

A port of ``repro/launch/bench_serving.py`` that accepts every flag
combination the reference accepts, plus ``--device``.  The simulated
planes (``sim``, ``fast``), the cluster fabric and the multi-model plane
are framework-free and run the reference's code on the port's
byte-identical copies of ``core`` and ``serving``, so their reports are
byte-identical to the reference's.  ``--execution real`` runs the port's
micro models (``repro_torch.models.micro``) or its LM engine
(``repro_torch.models.serve_lm``) on a CUDA card, or with ``--device
cpu`` on their plain PyTorch versions.

Runs named workload scenarios (``repro.serving.scenarios``) through the
*full* Packrat controller — estimator → knapsack optimizer → allocator →
active-passive reconfiguration → dispatcher → simulated workers — and
compares configuration policies × dispatch policies on **identical
arrival traces**:

* ``static``  — the paper's baseline: one fat instance on all T units
  at a fixed batch size, never reconfigured;
* ``packrat`` — the adaptive policy: the batch-size estimator (§3.8)
  re-runs the 2-D knapsack (§3.3) online and swaps configurations via
  the active-passive controller (§3.7);

each under two dispatch policies (``serving/policy.py``):

* ``sync`` — paper-faithful batch-synchronous dispatch (the report keys
  are the bare policy names, ``static``/``packrat``, for continuity);
* ``continuous`` — per-instance queues, no instance-set barrier (report
  keys ``static+continuous``/``packrat+continuous``).

With ``--models a,b[,c…]`` the benchmark switches to the **multi-model
resource plane** (``serving/tenancy.py``): mixed-traffic scenarios
(``mixed-steady``, ``mixed-diurnal``, ``mixed-burst``) offer each model
tenant its own seeded trace, and the same policy axis becomes

* ``static``  — even unit split, each tenant one fat instance at a
  fixed batch, never re-planned;
* ``packrat`` — the live planner: per-model demand estimates →
  ``MultiModelAllocator`` re-splits units → each tenant's knapsack
  re-solves inside its lease;

with per-model p50/p95/p99 + goodput alongside the aggregate report.

``--interference`` applies the paper's CPU interference model
(§5.2.2 — licence downclock + loaded memory latency) to every simulated
instance, reproducing the Fig. 9 expected-vs-observed gap; the report's
``expected_latency_ms`` (the optimizer's isolated-profile makespan) can
then be compared against observed percentiles.  ``--slo-ms`` pins an
absolute SLO deadline and additionally reports the largest SLO-feasible
batch per model (``solve_with_slo``).

``--execution real`` switches the serving engine from the simulated
plane onto the **real execution plane** (``serving/plane.py``): the
same controller/dispatcher stack drives a micro model
(``repro_torch.models.micro``, selected with ``--real-model``) on
wall-clock time — the ⟨t,b⟩ profile is *measured* through the plane's
own runners, arrivals fire as wall-clock timers, worker batches execute on
per-instance threads under a T-unit concurrency budget, and the
report's latencies are wall-clock measurements.  A
:class:`~repro.core.profiler.ProfileCalibrator` closes the loop: each
batch's observed latency refines the expected-vs-observed correction,
the report gains a ``calibration`` section, and the packrat policy
re-solves its knapsack against the calibrated costs.  Offered rates
are derived from the measured capacity and then capped
(``--real-rate-cap``) so the Python-level event machinery is not the
bottleneck being measured.

``--execution real --real-model lm-tiny`` selects the **autoregressive
LM path** (``repro_torch.models.serve_lm``): a scaled-down gemma3-style
decoder served through the CUDA flash/decode attention kernels, split
into a prefill pool and a decode pool (two ``PackratServer``\\ s routing
runner cells by phase) with a decode-step continuation chain
(``--lm-decode-steps`` tokens per prompt).  ``static`` time-shares one
fat machine between the phases; ``packrat`` splits the unit budget with
``solve_phase_split`` against per-phase measured profiles.  Reports
gain ``phases``/``ttft_ms``/``tpot_ms`` and per-cell ``runner_cache``
compile accounting.

``--nodes N`` (N > 1) switches to the **cluster fabric**
(``serving/fabric.py``): N Packrat nodes of ``--units`` each behind a
:class:`~repro.serving.fabric.ClusterRouter` — power-of-two-choices
routing by least expected latency, per-node token-bucket admission,
batch-floor degradation and queue-depth shedding — compared on one
identical seeded trace against a single fat server holding the fleet's
total units (``single_fat``: static one-instance baseline;
``single_packrat``: the adaptive policy, still admission-free).  The
report adds shed accounting (``shed``/``shed_rate``/``admitted``; the
latency percentiles are admitted-only) and a per-node ``fleet``
section.  Scenarios may carry *fabric events* (``node-failure`` kills
node 1 mid-run) exercising failover with exactly-once delivery.
``--nodes 1`` is the unchanged single-node path, byte-for-byte.
``--fidelity-ladder`` additionally equips every node with the model's
reduced-rung ladder: overload first steps fidelity down (cheaper model
variants, re-planned per rung) before the batch-floor/shed ladder
engages, recovery climbs back rung by rung under hysteresis, and the
report gains ``fidelity_report``/``goodput_at_fidelity`` plus a
per-node ``fidelity`` fleet breakdown (schema v7).

Everything *simulated* is seeded and runs on the deterministic event
loop, so two invocations with the same flags produce byte-identical
JSON reports; real-execution reports are wall-clock measurements and
deterministic only in structure.  Every report carries a top-level
``schema_version`` so downstream consumers can detect format changes
(see docs/OPERATIONS.md for the full schema).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.bench_serving \
        --scenario diurnal --duration 60
    PYTHONPATH=src python -m repro_torch.launch.bench_serving \
        --scenario steady-poisson --duration 2 --units 4 \
        --execution real --real-model mlp-tiny          # on a CUDA card
    PYTHONPATH=src python -m repro_torch.launch.bench_serving \
        --scenario steady-poisson --duration 2 --units 4 \
        --execution real --real-model mlp-tiny --device cpu
    PYTHONPATH=src python -m repro_torch.launch.bench_serving --scenario all \
        --model gpt2 --out report.json
    PYTHONPATH=src python -m repro_torch.launch.bench_serving \
        --scenario bursty --dispatch continuous      # one dispatch mode only
    PYTHONPATH=src python -m repro_torch.launch.bench_serving \
        --models resnet50,bert --scenario mixed-diurnal --duration 60
    PYTHONPATH=src python -m repro_torch.launch.bench_serving \
        --nodes 3 --units 8 --scenario flash-overload --duration 30
    PYTHONPATH=src python -m repro_torch.launch.bench_serving --list
    PYTHONPATH=src python -m repro_torch.launch.bench_serving \
        --trace my_trace.json --duration 120        # replay a recorded trace
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import sys
from typing import Dict, List, Optional, Tuple

from ..core.interference import CPUInterferenceModel
from ..core.knapsack import (PLANNER_ENGINES, PackratOptimizer,
                             planning_report, set_default_engine)
from ..core.multimodel import solve_with_slo
from ..core.paper_profiles import PAPER_MODELS, ProfileModel
from ..serving import (ClusterRouter, ControllerConfig, EventLoop,
                       FabricConfig, FabricNodeSpec, MetricsCollector,
                       MultiModelServer, PackratServer, Request,
                       TabulatedBackend, TenantSpec, instance_report)
from ..serving.tenancy import even_shares
from ..serving.scenarios import (MultiModelScenario,
                                 MultiModelScenarioContext, Scenario,
                                 ScenarioContext, fabric_events,
                                 get_mm_scenario,
                                 get_scenario, list_mm_scenarios,
                                 list_scenarios)
from ..serving.fabric import feed_fabric_trace
from ..serving.fastsim import (FastLoop, feed_multi_model_trace,
                               feed_single_model_trace)
from ..serving.workloads import TraceWorkload

POLICIES = ("static", "packrat")
DISPATCHES = ("sync", "continuous")
# --nodes > 1 comparison rows: the same total units as one fat server
# (static and adaptive) vs the N-node fabric, on one identical trace
FABRIC_POLICIES = ("single_fat", "single_packrat", "fabric")

# bumped whenever a report key is added/renamed/removed, so downstream
# consumers detect format changes instead of silently misparsing.
# v1: implicit (PR 1-4 reports, no version key).
# v2: schema_version + shed accounting keys + the --nodes fabric axis.
# v3: per-run "engine" key + the --execution fast vectorized core
#     (byte-identical reports to --execution sim, only faster).
# v4: per-run "fastpath" coverage report, engine-tagged instance rows,
#     and fast-engine acceleration of continuous dispatch, multi-model
#     tenancy, and the --nodes fabric (still byte-identical).
# v5: top-level "planner" key + per-run "planning" solver counters
#     (solves, cache hits, table builds, SLO probes saved) for the
#     shared-table planning engine; --planner selects shared|reference
#     (plans bit-identical, only solve cost differs).  Real-execution
#     calibration gains "refreshes_skipped"/"optimizer_refreshes_skipped"
#     (identity corrections no longer rebuild and re-solve).
# v6: the autoregressive LM real-execution path (--real-model lm-tiny):
#     phase-tagged requests add "phases"/"ttft_ms"/"tpot_ms" to
#     phase-serving reports (absent from every one-shot report, which
#     stays byte-identical), per-phase "measured_profile_ms", the
#     "unit_split"/"planned_split" phase-plan keys, "decode_steps", and
#     the "runner_cache" compile/eviction accounting (compile_ms is
#     excluded from all latency percentiles).
# v7: the --fidelity-ladder overload axis (--nodes > 1): rung-tagged
#     responses add "fidelity_report"/"goodput_at_fidelity"/
#     "fidelity_weighted_attainment" to the fabric run report, the
#     fleet section gains a per-node "fidelity" breakdown (rung,
#     transitions, recovery counters), and the scenario row records
#     "fidelity_ladder"/"fidelity_rungs".  All of it absent with the
#     ladder off — ladder-off reports keep the v6 shape byte-for-byte.
SCHEMA_VERSION = 7

# simulation engines for the virtual-clock paths: the event-at-a-time
# oracle and the vectorized core (repro.serving.fastsim).  Reports are
# byte-identical between the two (tests/test_fast_plane.py).
ENGINES = ("event", "fast")


def _sim_loop(engine: str):
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    return FastLoop() if engine == "fast" else EventLoop()


def policy_key(policy: str, dispatch: str) -> str:
    """Report key for one (policy, dispatch) combination; sync keeps the
    bare policy name so pre-existing report consumers stay valid."""
    return policy if dispatch == "sync" else f"{policy}+{dispatch}"

# how long past the offered-load window the simulation keeps draining
# queued work before declaring the remainder incomplete
DRAIN_FACTOR = 1.0
DRAIN_MIN_S = 30.0
# real execution drains wall-clock seconds, so the floor is kept small
REAL_DRAIN_MIN_S = 2.0
REAL_DRAIN_FACTOR = 0.5


def _make_backend(profile, *, interference: bool, units: int
                  ) -> TabulatedBackend:
    """The simulated latency backend; ``--interference`` applies the
    paper's §5.2.2 model so observed latencies exceed the optimizer's
    isolated-profile expectation (Fig. 9)."""
    model = CPUInterferenceModel() if interference else None
    return TabulatedBackend(profile, interference=model, total_units=units)


def _controller_report_fields(rep: Dict[str, object], server,
                              now: float) -> None:
    """The per-run controller fields every single-model policy report
    carries (sim and real must stay one schema): reconfiguration
    count/log, the final config and its optimizer-expected makespan —
    the Fig. 9 "expected" line — and the per-instance breakdown."""
    rep["reconfigurations"] = len(server.reconfig_log) - 1
    rep["final_config"] = str(server.reconfig_log[-1][2])
    rep["expected_latency_ms"] = server.reconfig_log[-1][2].latency * 1e3
    rep["reconfig_log"] = [
        {"t": t, "batch": b, "config": str(cfg)}
        for t, b, cfg in server.reconfig_log
    ]
    rep["instances"] = instance_report(
        server.workers_ever, now, engine=server.dispatcher.engine_name)
    rep["fastpath"] = server.dispatcher.fastpath_report()


def _static_optimizer(model: ProfileModel, units: int, max_batch: int
                      ) -> PackratOptimizer:
    """An optimizer that can only produce the fat ⟨1,T,b⟩ configuration."""
    full = model.profile(units, max_batch)
    fat_only = {(t, b): lat for (t, b), lat in full.items() if t == units}
    return PackratOptimizer(fat_only)


def run_policy(policy: str, arrivals: List[float], *, model: ProfileModel,
               units: int, duration: float, initial_batch: int,
               max_batch: int, slo_deadline: float,
               reconfigure_timeout: float,
               dispatch: str = "sync",
               interference: bool = False,
               engine: str = "event") -> Dict[str, object]:
    """One (policy, dispatch) combination over one fixed trace → metrics."""
    if policy == "static":
        opt = _static_optimizer(model, units, max_batch)
        # one fat instance serves at most the largest profiled batch
        initial_batch = min(initial_batch, max_batch)
        # a reconfigure timeout beyond the run pins the initial config
        ccfg = ControllerConfig()
        ccfg.estimator.reconfigure_timeout = 10.0 * duration + 1e6
    elif policy == "packrat":
        opt = PackratOptimizer(model.profile(units, max_batch))
        ccfg = ControllerConfig()
        ccfg.estimator.reconfigure_timeout = reconfigure_timeout
        ccfg.estimator.max_batch = max_batch
    else:
        raise ValueError(f"unknown policy {policy!r}")
    ccfg.dispatch_policy = dispatch

    loop = _sim_loop(engine)
    server = PackratServer(loop, total_units=units, optimizer=opt,
                           backend=_make_backend(
                               model.profile(units, max_batch),
                               interference=interference, units=units),
                           initial_batch=initial_batch, config=ccfg)
    metrics = MetricsCollector(slo_deadline=slo_deadline)
    drain = max(DRAIN_MIN_S, DRAIN_FACTOR * duration)
    metrics.attach(server, sample_interval=min(0.25, duration / 100.0),
                   until=duration + drain)
    if engine == "fast":
        # bulk feed: arrivals stream through the vectorized trace path
        # (batch-sync and continuous dispatch both absorb columnar;
        # anything unprovable falls back to exact per-arrival replay)
        metrics.on_requests(len(arrivals))
        feed_single_model_trace(server, arrivals)
    else:
        for i, t in enumerate(arrivals):
            metrics.on_request(Request(i, t))
            loop.at(t, (lambda i=i, t=t: server.submit(Request(i, t))))
    loop.run_until(duration + drain)

    rep = metrics.report(duration=duration)
    rep["dispatch"] = dispatch
    rep["interference"] = interference
    rep["engine"] = engine
    _controller_report_fields(rep, server, loop.now)
    rep["planning"] = planning_report([server.optimizer])
    fallbacks = server.backend.fallback_report()
    if fallbacks["count"]:
        # off-grid thread-count lookups were interpolated/clamped — the
        # backend consulted a sparse profile outside its grid; surface
        # the substitution instead of letting it pass silently
        rep["profile_fallbacks"] = fallbacks
    return rep


# --------------------------------------------------------------------- #
# real-execution path (wall clock, micro models)
# --------------------------------------------------------------------- #
def _cap_rate(arrivals: List[float], duration: float,
              cap: Optional[float]) -> Tuple[List[float], bool]:
    """Thin a trace to at most ``cap`` req/s (evenly, deterministically).

    Micro-model capacities are tens of thousands of req/s; offering that
    to the wall-clock reactor would benchmark Python's event machinery,
    not the serving engine.  Thinning selects evenly spaced indices for
    exactly the target count — an integer stride would halve a trace
    that barely exceeds the cap."""
    if cap is None or cap <= 0:
        return arrivals, False
    target = int(cap * duration)
    if len(arrivals) <= target:
        return arrivals, False
    return [arrivals[i * len(arrivals) // target]
            for i in range(target)], True


def run_real_policy(policy: str, arrivals: List[float], *, factory,
                    profile: Dict[Tuple[int, int], float], units: int,
                    duration: float, initial_batch: int, max_batch: int,
                    slo_deadline: float, reconfigure_timeout: float,
                    dispatch: str = "sync",
                    real_model: str = "") -> Dict[str, object]:
    """One (policy, dispatch) combination on the real execution plane.

    The ⟨t,b⟩ planning table is the profile *measured through the same
    plane runners* the server then executes; a ProfileCalibrator folds
    every observed batch latency back into the expectations (watchdog
    budgets via CalibratedBackend, knapsack costs via the tenant's
    optimizer refresh) — the closed Fig. 9 loop.
    """
    from ..core.profiler import ProfileCalibrator
    from ..serving import CalibratedBackend, RealPlane
    if policy == "static":
        fat = {(t, b): lat for (t, b), lat in profile.items() if t == units}
        opt = PackratOptimizer(fat)
        initial_batch = min(initial_batch, max_batch)
        ccfg = ControllerConfig()
        ccfg.estimator.reconfigure_timeout = 10.0 * duration + 1e6
        # observes + reports the expected-vs-observed gap, never refreshes
        cal = ProfileCalibrator(fat, refresh_interval=math.inf)
    elif policy == "packrat":
        opt = PackratOptimizer(profile)
        ccfg = ControllerConfig()
        ccfg.estimator.reconfigure_timeout = reconfigure_timeout
        ccfg.estimator.max_batch = max_batch
        cal = ProfileCalibrator(profile, refresh_interval=reconfigure_timeout)
    else:
        raise ValueError(f"unknown policy {policy!r}")
    ccfg.dispatch_policy = dispatch

    plane = RealPlane(factory, units)
    server = PackratServer(
        plane, total_units=units, optimizer=opt,
        backend=CalibratedBackend(TabulatedBackend(profile), cal),
        initial_batch=initial_batch, config=ccfg, calibrator=cal)
    metrics = MetricsCollector(slo_deadline=slo_deadline)
    drain = max(REAL_DRAIN_MIN_S, REAL_DRAIN_FACTOR * duration)
    metrics.attach(server, sample_interval=min(0.25, duration / 100.0),
                   until=duration + drain)
    for i, t in enumerate(arrivals):
        metrics.on_request(Request(i, t))
        plane.at(t, (lambda i=i, t=t: server.submit(Request(i, t))))
    plane.run_until(duration + drain)
    plane.close()

    rep = metrics.report(duration=duration)
    rep["execution"] = "real"
    rep["real_model"] = real_model
    rep["dispatch"] = dispatch
    _controller_report_fields(rep, server, plane.now)
    calibration = cal.report()
    calibration["optimizer_refreshes"] = server.calibration_refreshes
    calibration["optimizer_refreshes_skipped"] = \
        server.calibration_refreshes_skipped
    rep["calibration"] = calibration
    rep["planning"] = planning_report([server.optimizer])
    return rep


def run_real_scenario(sc: Scenario, *, real_model: str, units: int,
                      duration: float, seed: int, initial_batch: int,
                      max_batch: int, slo_factor: float,
                      reconfigure_timeout: float,
                      policies: tuple = POLICIES,
                      dispatches: Tuple[str, ...] = ("sync",),
                      rate_cap: Optional[float] = 300.0,
                      slo_ms: Optional[float] = None,
                      device="cuda") -> Dict[str, object]:
    """Every policy × dispatch combo on the real plane, sharing one
    measured profile and one (capped) arrival trace; the micro model
    runs on ``device``."""
    from ..core.knapsack import powers_of_two
    from ..core.profiler import ProfileSpec
    from ..models.micro import make_micro_runner
    from ..serving import RealPlane
    factory = make_micro_runner(real_model, device=device)
    # profile through the plane: the same runners, the same
    # measurement helper the serving path uses (§3.2 grid, but a sparse
    # powers-of-two thread axis — the budget dimension on one device —
    # always including T itself so the static fat row exists)
    thread_values = tuple(sorted(set(powers_of_two(units)) | {units}))
    prof_plane = RealPlane(factory, units)
    profile = prof_plane.profile(
        ProfileSpec(units, max_batch, thread_values=thread_values),
        warmup=1, iters=3)
    prof_plane.close()
    opt = PackratOptimizer(profile)
    initial_batch = max(1, min(initial_batch, units * max_batch))
    ctx = ScenarioContext(threads=units, optimizer=opt, duration=duration,
                          seed=seed, max_total_batch=units * max_batch)
    workload = sc.build(ctx)
    arrivals = workload.arrivals(duration, seed=seed)
    arrivals, capped = _cap_rate(arrivals, duration, rate_cap)
    slo = (slo_ms * 1e-3 if slo_ms is not None
           else slo_factor * opt.solve(units, initial_batch).latency)
    out: Dict[str, object] = {
        "scenario": sc.name,
        "description": sc.description,
        "workload": workload.name,
        "execution": "real",
        "real_model": real_model,
        "offered": len(arrivals),
        "offered_rate_rps": len(arrivals) / duration,
        "rate_capped": capped,
        "measured_profile_ms": {f"{t},{b}": lat * 1e3
                                for (t, b), lat in sorted(profile.items())},
        "slo_deadline_ms": slo * 1e3,
        "policies": [policy_key(p, d) for p in policies for d in dispatches],
    }
    for policy in policies:
        for dispatch in dispatches:
            out[policy_key(policy, dispatch)] = run_real_policy(
                policy, arrivals, factory=factory, profile=profile,
                units=units, duration=duration,
                initial_batch=initial_batch, max_batch=max_batch,
                slo_deadline=slo, reconfigure_timeout=reconfigure_timeout,
                dispatch=dispatch, real_model=real_model)
    return out


# --------------------------------------------------------------------- #
# autoregressive LM path (--execution real --real-model lm-tiny)
# --------------------------------------------------------------------- #
def run_lm_policy(policy: str, arrivals: List[float], *, factory,
                  profiles: Dict[str, Dict[Tuple[int, int], float]],
                  units: int, duration: float, initial_batch: int,
                  max_batch: int, decode_steps: int,
                  slo_by_phase: Dict[str, float],
                  reconfigure_timeout: float, dispatch: str = "continuous",
                  real_model: str = "") -> Dict[str, object]:
    """One policy over one prompt trace on the real LM serving plane.

    Both policies run **two** :class:`PackratServer` pools — one per
    phase, named by ``model_id`` so the plane routes each pool's batches
    to its phase's runner cells — over one :class:`RealPlane` whose unit
    gate is the physical machine:

    * ``static`` — each phase pool is one fat ⟨1,T,b⟩ instance sized to
      the *whole* machine, so the gate time-shares the device between
      phases: decode steps stall behind prefill batches (and behind
      each other), the honest single-fat-server baseline;
    * ``packrat`` — :func:`~repro.core.knapsack.solve_phase_split`
      splits the unit budget across the phases against their own
      measured profiles; each pool's knapsack then plans inside its
      share, so prefill and decode execute concurrently.

    Requests flow prompt → prefill pool → (continuation) decode pool →
    ``decode_steps - 1`` same-pool re-enqueues: the prefill completion
    hook submits the first decode step on the *other* dispatcher, and
    the decode hook returns the next step's request for same-dispatcher
    re-enqueue until EOS.  Prefill request latency is TTFT, decode-step
    latency is TPOT (``phases``/``ttft_ms``/``tpot_ms`` report keys).
    """
    from ..core.knapsack import fat_config, solve_phase_split
    from ..core.profiler import ProfileCalibrator
    from ..serving import CalibratedBackend, RealPlane
    from ..models.serve_lm import PHASES, PHASE_DECODE, PHASE_PREFILL
    b0 = max(1, min(initial_batch, max_batch))
    split_rep: Optional[Dict[str, object]] = None
    if policy == "static":
        unit_share = {p: units for p in PHASES}
        phase_opts = {
            p: PackratOptimizer({(t, b): lat
                                 for (t, b), lat in profiles[p].items()
                                 if t == units})
            for p in PHASES}
        timeout = 10.0 * duration + 1e6
        refresh = math.inf
    elif policy == "packrat":
        phase_opts = {p: PackratOptimizer(profiles[p]) for p in PHASES}
        # decode demand: every prompt batch in flight fans out into
        # decode_steps sequential token steps, so the decode pool's
        # steady-state batch is ~decode_steps × the prompt batch — plan
        # it for the largest feasible such batch (halving until some
        # unit split can host it exactly)
        split = None
        b_dec = min(b0 * decode_steps, units * max_batch)
        while split is None and b_dec >= b0:
            split = solve_phase_split(
                phase_opts, {PHASE_PREFILL: b0, PHASE_DECODE: b_dec},
                units)
            if split is None:
                b_dec //= 2
        if split is None:
            raise ValueError(
                f"no feasible phase split of {units} units at batch {b0}")
        unit_share = dict(split["units"])
        split_rep = {
            "units": dict(split["units"]),
            "objective_ms": split["objective"] * 1e3,
            "configs": {p: str(c) for p, c in split["configs"].items()},
        }
        timeout = reconfigure_timeout
        refresh = reconfigure_timeout
    else:
        raise ValueError(f"unknown policy {policy!r}")

    plane = RealPlane(factory, units, spans=True)
    metrics = MetricsCollector(slo_by_model=slo_by_phase)
    drain = max(REAL_DRAIN_MIN_S, REAL_DRAIN_FACTOR * duration)
    servers: Dict[str, PackratServer] = {}
    cals: Dict[str, object] = {}
    # partial-batch coalesce window: the default 50 ms dispatcher timer
    # is sized for paper-scale (tens-of-ms) CNN batches; LM steps run in
    # ~1 ms, so a lone request waiting a full window would swamp TTFT
    # and TPOT tails under BOTH policies.  A few step-times of
    # coalescing keeps batches forming without dominating the latency.
    step_ms = {p: profiles[p][(units, 1)] for p in PHASES}
    batch_timeout = max(0.002, 4.0 * max(step_ms.values()))
    for p in PHASES:
        ccfg = ControllerConfig()
        ccfg.dispatch_policy = dispatch
        ccfg.dispatcher.batch_timeout = batch_timeout
        ccfg.estimator.reconfigure_timeout = timeout
        ccfg.estimator.max_batch = max_batch
        cal = ProfileCalibrator(phase_opts[p].profile,
                                refresh_interval=refresh)
        cals[p] = cal
        servers[p] = PackratServer(
            plane, total_units=unit_share[p], optimizer=phase_opts[p],
            backend=CalibratedBackend(
                TabulatedBackend(phase_opts[p].profile), cal),
            initial_batch=b0, config=ccfg, calibrator=cal, model_id=p,
            # compile-ahead: every plan application (initial spawn and
            # each reconfiguration's passive spawn) warms the plan's
            # ⟨t,b⟩ runner cells for this pool's phase
            on_plan_apply=(lambda cfg, p=p: plane.warm(
                [(g.t, g.b) for g in cfg.groups], p)))
        metrics.attach(servers[p],
                       sample_interval=min(0.25, duration / 100.0),
                       until=duration + drain)

    # decode-step continuation chain: ids disjoint from prompt ids
    rid = itertools.count(1_000_000_000)

    def _next_decode(steps_left: int, cause: int) -> Request:
        req = Request(next(rid), plane.now, model_id=PHASE_DECODE,
                      phase=PHASE_DECODE, steps_left=steps_left)
        if plane.spans is not None:
            # the step's span record names the request that made it
            plane.spans.open_request(req, cause)
        metrics.on_request(req)
        return req

    def prefill_done(resp) -> Optional[Request]:
        # cross-phase hand-off: submit on the decode dispatcher, return
        # None so nothing re-enters the prefill queue
        if decode_steps > 0:
            servers[PHASE_DECODE].submit(
                _next_decode(decode_steps, cause=resp.request.id))
        return None

    def decode_done(resp) -> Optional[Request]:
        # same-dispatcher re-enqueue until EOS/max-len
        if resp.request.steps_left > 1:
            return _next_decode(resp.request.steps_left - 1,
                                cause=resp.request.id)
        return None

    servers[PHASE_PREFILL].dispatcher.continuation = prefill_done
    servers[PHASE_DECODE].dispatcher.continuation = decode_done

    for i, t in enumerate(arrivals):
        req = Request(i, t, model_id=PHASE_PREFILL, phase=PHASE_PREFILL)
        metrics.on_request(req)
        plane.at(t, (lambda req=req: servers[PHASE_PREFILL].submit(req)))
    plane.run_until(duration + drain)
    plane.close()

    rep = metrics.report(duration=duration)
    rep["execution"] = "real"
    rep["real_model"] = real_model
    rep["dispatch"] = dispatch
    rep["decode_steps"] = decode_steps
    rep["unit_split"] = dict(unit_share)
    if split_rep is not None:
        rep["planned_split"] = split_rep
    rep["expected_latency_ms"] = {
        p: servers[p].reconfig_log[-1][2].latency * 1e3 for p in PHASES}
    rep["servers"] = {}
    for p in PHASES:
        srep: Dict[str, object] = {"units": unit_share[p]}
        _controller_report_fields(srep, servers[p], plane.now)
        calibration = cals[p].report()
        calibration["optimizer_refreshes"] = \
            servers[p].calibration_refreshes
        calibration["optimizer_refreshes_skipped"] = \
            servers[p].calibration_refreshes_skipped
        srep["calibration"] = calibration
        rep["servers"][p] = srep
    # first-touch compile accounting (excluded from every latency
    # percentile: the factory compiles outside the timed path)
    rep["runner_cache"] = plane.runner_report()
    rep["planning"] = planning_report(
        [servers[p].optimizer for p in PHASES])
    if plane.spans is not None:
        # the port's own key: every request's and batch's span record
        rep["spans"] = plane.spans.export()
    return rep


def run_lm_scenario(sc: Scenario, *, real_model: str, units: int,
                    duration: float, seed: int, initial_batch: int,
                    max_batch: int, decode_steps: int, slo_factor: float,
                    reconfigure_timeout: float,
                    policies: tuple = POLICIES,
                    dispatches: Tuple[str, ...] = ("continuous",),
                    rate_cap: Optional[float] = 300.0,
                    slo_ms: Optional[float] = None,
                    device="cuda") -> Dict[str, object]:
    """Every policy × dispatch combo for one LM serving scenario:
    shared per-phase measured profiles, one shared (capped) prompt
    trace, single-fat baseline vs phase-split packrat."""
    from ..core.knapsack import next_power_of_two, powers_of_two
    from ..core.profiler import ProfileSpec, phase_profiles
    from ..models.serve_lm import PHASES, PHASE_DECODE, PHASE_PREFILL, \
        make_lm_engine
    from ..serving import RealPlane
    if units < 2:
        raise ValueError("LM phase-split serving needs --units >= 2")
    engine = make_lm_engine(real_model, seed=seed, device=device)
    factory = engine.factory()
    # per-phase ⟨t,b⟩ tables through the same plane runners the servers
    # then execute (sparse pow2 thread axis, always including T); the
    # engine caches compiled cells, so serving planes reuse them
    thread_values = tuple(sorted(set(powers_of_two(units)) | {units}))
    prof_plane = RealPlane(factory, units)
    profiles = phase_profiles(
        prof_plane, ProfileSpec(units, max_batch,
                                thread_values=thread_values),
        PHASES, warmup=1, iters=3)
    prof_plane.close()
    b0 = max(1, min(initial_batch, max_batch))
    opt = PackratOptimizer(profiles[PHASE_PREFILL])
    ctx = ScenarioContext(threads=units, optimizer=opt, duration=duration,
                          seed=seed, max_total_batch=units * max_batch)
    workload = sc.build(ctx)
    arrivals = workload.arrivals(duration, seed=seed)
    # cap offered prompts against the *serial* per-prompt cost (prefill
    # + the whole decode chain on the fat machine): ~50% utilization of
    # one time-shared device, enough queueing to separate the policies
    # without overloading the Python reactor
    serial = (profiles[PHASE_PREFILL][(units, 1)]
              + decode_steps * profiles[PHASE_DECODE][(units, 1)])
    auto_cap = 0.5 / max(serial, 1e-9)
    cap = auto_cap if rate_cap is None or rate_cap <= 0 \
        else min(rate_cap, auto_cap)
    arrivals, capped = _cap_rate(arrivals, duration, cap)
    bq = next_power_of_two(b0)
    slo_by_phase = {
        p: (slo_ms * 1e-3 if slo_ms is not None
            else slo_factor * profiles[p][(units, bq)])
        for p in PHASES}
    out: Dict[str, object] = {
        "scenario": sc.name,
        "description": sc.description,
        "workload": workload.name,
        "execution": "real",
        "real_model": real_model,
        "decode_steps": decode_steps,
        "offered_prompts": len(arrivals),
        "offered_rate_rps": len(arrivals) / duration,
        "rate_capped": capped,
        "measured_profile_ms": {
            p: {f"{t},{b}": lat * 1e3
                for (t, b), lat in sorted(profiles[p].items())}
            for p in PHASES},
        "slo_deadline_ms": {p: s * 1e3 for p, s in slo_by_phase.items()},
        "policies": [policy_key(p, d) for p in policies for d in dispatches],
    }
    for policy in policies:
        for dispatch in dispatches:
            out[policy_key(policy, dispatch)] = run_lm_policy(
                policy, arrivals, factory=factory, profiles=profiles,
                units=units, duration=duration, initial_batch=b0,
                max_batch=max_batch, decode_steps=decode_steps,
                slo_by_phase=slo_by_phase,
                reconfigure_timeout=reconfigure_timeout,
                dispatch=dispatch, real_model=real_model)
    return out


def run_scenario(sc: Scenario, *, model: ProfileModel, units: int,
                 duration: float, seed: int, initial_batch: int,
                 max_batch: int, slo_factor: float,
                 reconfigure_timeout: float,
                 policies: tuple = POLICIES,
                 dispatches: Tuple[str, ...] = ("sync",),
                 interference: bool = False,
                 slo_ms: Optional[float] = None,
                 engine: str = "event") -> Dict[str, object]:
    """Every policy × dispatch combo on one (seeded, shared) trace."""
    opt = PackratOptimizer(model.profile(units, max_batch))
    # T instances at the largest profiled per-instance batch is the
    # biggest servable aggregate batch; clamp batch references into it
    initial_batch = max(1, min(initial_batch, units * max_batch))
    ctx = ScenarioContext(threads=units, optimizer=opt, duration=duration,
                          seed=seed, max_total_batch=units * max_batch)
    workload = sc.build(ctx)
    arrivals = workload.arrivals(duration, seed=seed)
    # SLO: --slo-ms absolute, else a multiple of the *optimal* latency at
    # the initial batch — model-relative, so the deadline is equally
    # tight for every model
    slo = (slo_ms * 1e-3 if slo_ms is not None
           else slo_factor * opt.solve(units, initial_batch).latency)
    out: Dict[str, object] = {
        "scenario": sc.name,
        "description": sc.description,
        "workload": workload.name,
        "offered": len(arrivals),
        "offered_rate_rps": len(arrivals) / duration,
        "slo_deadline_ms": slo * 1e3,
        "policies": [policy_key(p, d) for p in policies for d in dispatches],
    }
    if slo_ms is not None:
        out["slo_feasible"] = {model.name: _slo_feasible(opt, units, slo)}
    for policy in policies:
        for dispatch in dispatches:
            out[policy_key(policy, dispatch)] = run_policy(
                policy, arrivals, model=model, units=units,
                duration=duration, initial_batch=initial_batch,
                max_batch=max_batch, slo_deadline=slo,
                reconfigure_timeout=reconfigure_timeout, dispatch=dispatch,
                interference=interference, engine=engine)
    return out


def _slo_feasible(opt: PackratOptimizer, units: int, slo_s: float
                  ) -> Optional[Dict[str, object]]:
    """Largest SLO-feasible batch summary (``solve_with_slo``), or None."""
    got = solve_with_slo(opt, units, slo_s)
    if got is None:
        return None
    batch, cfg = got
    return {"batch": batch, "config": str(cfg),
            "latency_ms": cfg.latency * 1e3,
            "throughput_rps": cfg.throughput}


# --------------------------------------------------------------------- #
# multi-node fabric path (--nodes N)
# --------------------------------------------------------------------- #
def run_fabric_policy(arrivals: List[float], *, model: ProfileModel,
                      nodes: int, units_per_node: int, duration: float,
                      seed: int, initial_batch: int, max_batch: int,
                      slo_deadline: float, reconfigure_timeout: float,
                      dispatch: str = "sync", interference: bool = False,
                      events=(), engine: str = "event",
                      fidelity_ladder: bool = False) -> Dict[str, object]:
    """One fabric run: N Packrat nodes behind a :class:`ClusterRouter`
    on one shared simulated plane, with per-node admission control and
    the scenario's fabric events (node failures/drains) applied.

    ``fidelity_ladder`` equips every node with the model's reduced-rung
    ladder (``core.paper_profiles.fidelity_ladder``): overload steps
    down the fidelity rungs before the batch-floor/shed ladder engages,
    and the report gains the rung-tagged fidelity keys (schema v7).
    """
    from ..core.paper_profiles import fidelity_ladder as build_ladder
    ccfg = ControllerConfig()
    ccfg.estimator.reconfigure_timeout = reconfigure_timeout
    ccfg.estimator.max_batch = max_batch
    ccfg.dispatch_policy = dispatch
    fcfg = FabricConfig(controller=ccfg, p2c_seed=seed)
    profile = model.profile(units_per_node, max_batch)
    specs = [FabricNodeSpec(
        optimizer=PackratOptimizer(profile),
        backend=_make_backend(profile, interference=interference,
                              units=units_per_node),
        ladder=(build_ladder(model, units_per_node, max_batch)
                if fidelity_ladder else None))
        for _ in range(nodes)]
    loop = _sim_loop(engine)
    router = ClusterRouter(
        loop, units_per_node=units_per_node, specs=specs,
        initial_batch=max(1, min(initial_batch,
                                 units_per_node * max_batch)),
        slo_deadline=slo_deadline, config=fcfg)
    metrics = MetricsCollector(slo_deadline=slo_deadline)
    if fidelity_ladder:
        ladder = specs[0].ladder
        metrics.set_rung_qualities(
            [ladder.quality(r) for r in range(len(ladder))])
    drain = max(DRAIN_MIN_S, DRAIN_FACTOR * duration)
    metrics.attach_fabric(router, sample_interval=min(0.25, duration / 100.0),
                          until=duration + drain)
    if engine == "fast":
        # bulk feed: arrivals stream through the vectorized fabric path
        # (P2C routing + admission replayed on array slices between heap
        # events); fabric events still land as exact heap events below
        metrics.on_requests(len(arrivals))
        feed_fabric_trace(router, arrivals)
    else:
        for i, t in enumerate(arrivals):
            metrics.on_request(Request(i, t))
            loop.at(t, (lambda i=i, t=t: router.submit(Request(i, t))))
    for ev in events:
        action = {"fail": router.fail_node, "drain": router.drain_node}[ev.action]
        loop.at(ev.at_frac * duration,
                (lambda action=action, ev=ev: action(ev.node)))
    loop.run_until(duration + drain)

    rep = metrics.report(duration=duration)
    rep["dispatch"] = dispatch
    rep["interference"] = interference
    rep["engine"] = engine
    fleet = router.fleet_report(loop.now)
    fleet["events"] = [{"t": ev.at_frac * duration, "action": ev.action,
                        "node": ev.node} for ev in events]
    for node in router.nodes:
        fleet["per_node"][node.node_id]["instances"] = instance_report(
            node.server.workers_ever, loop.now,
            engine=node.server.dispatcher.engine_name)
    rep["fleet"] = fleet
    rep["fastpath"] = router.fastpath_report()
    rep["planning"] = router.planning_report()
    fallback_count = sum(spec.backend.fallback_report()["count"]
                         for spec in specs)
    if fallback_count:
        rep["profile_fallbacks"] = {"count": fallback_count}
    return rep


def run_fabric_scenario(sc: Scenario, *, model: ProfileModel, nodes: int,
                        units_per_node: int, duration: float, seed: int,
                        initial_batch: int, max_batch: int,
                        slo_factor: float, reconfigure_timeout: float,
                        dispatches: Tuple[str, ...] = ("sync",),
                        interference: bool = False,
                        slo_ms: Optional[float] = None,
                        engine: str = "event",
                        fidelity_ladder: bool = False) -> Dict[str, object]:
    """The --nodes comparison on one identical seeded trace: a single
    fat server with the fleet's total units (``single_fat`` — static
    one-instance baseline; ``single_packrat`` — the adaptive policy,
    still admission-free) vs the N-node ``fabric`` with admission
    control and overload degradation.

    The trace is generated against *fleet* capacity (N × units), so
    capacity-relative scenarios stress every row identically; the SLO
    is node-relative (``slo_factor ×`` the optimal makespan of one
    node at the initial batch) — the deadline an operator provisions a
    node size for.
    """
    total = nodes * units_per_node
    fleet_opt = PackratOptimizer(model.profile(total, max_batch))
    ctx = ScenarioContext(threads=total, optimizer=fleet_opt,
                          duration=duration, seed=seed,
                          max_total_batch=total * max_batch)
    workload = sc.build(ctx)
    arrivals = workload.arrivals(duration, seed=seed)
    node_opt = PackratOptimizer(model.profile(units_per_node, max_batch))
    b0 = max(1, min(initial_batch, units_per_node * max_batch))
    slo = (slo_ms * 1e-3 if slo_ms is not None
           else slo_factor * node_opt.solve(units_per_node, b0).latency)
    events = fabric_events(sc.name)
    out: Dict[str, object] = {
        "scenario": sc.name,
        "description": sc.description,
        "workload": workload.name,
        "nodes": nodes,
        "units_per_node": units_per_node,
        "total_units": total,
        "offered": len(arrivals),
        "offered_rate_rps": len(arrivals) / duration,
        "slo_deadline_ms": slo * 1e3,
        "fabric_events": [{"at_frac": ev.at_frac, "action": ev.action,
                           "node": ev.node} for ev in events],
        "policies": [policy_key(p, d)
                     for p in FABRIC_POLICIES for d in dispatches],
    }
    if fidelity_ladder:
        from ..core.paper_profiles import FIDELITY_RUNG_SCALES
        out["fidelity_ladder"] = True
        out["fidelity_rungs"] = [
            {"rung": r, "name": name, "quality": q}
            for r, (name, q, _, _) in enumerate(FIDELITY_RUNG_SCALES)]
    for dispatch in dispatches:
        out[policy_key("single_fat", dispatch)] = run_policy(
            "static", arrivals, model=model, units=total,
            duration=duration, initial_batch=initial_batch,
            max_batch=max_batch, slo_deadline=slo,
            reconfigure_timeout=reconfigure_timeout, dispatch=dispatch,
            interference=interference, engine=engine)
        out[policy_key("single_packrat", dispatch)] = run_policy(
            "packrat", arrivals, model=model, units=total,
            duration=duration, initial_batch=initial_batch,
            max_batch=max_batch, slo_deadline=slo,
            reconfigure_timeout=reconfigure_timeout, dispatch=dispatch,
            interference=interference, engine=engine)
        out[policy_key("fabric", dispatch)] = run_fabric_policy(
            arrivals, model=model, nodes=nodes,
            units_per_node=units_per_node, duration=duration, seed=seed,
            initial_batch=initial_batch, max_batch=max_batch,
            slo_deadline=slo, reconfigure_timeout=reconfigure_timeout,
            dispatch=dispatch, interference=interference, events=events,
            engine=engine, fidelity_ladder=fidelity_ladder)
    return out


# --------------------------------------------------------------------- #
# multi-model (mixed-traffic) path
# --------------------------------------------------------------------- #
def run_multimodel_policy(policy: str, traces: Dict[str, List[float]], *,
                          models: Dict[str, ProfileModel], units: int,
                          duration: float, initial_batch: int,
                          max_batch: int, slo_by_model: Dict[str, float],
                          reconfigure_timeout: float, dispatch: str = "sync",
                          interference: bool = False,
                          engine: str = "event") -> Dict[str, object]:
    """One (policy, dispatch) combination over fixed per-model traces."""
    tenant_ids = list(models)
    shares = even_shares(units, tenant_ids)
    ccfg = ControllerConfig()
    ccfg.dispatch_policy = dispatch
    ccfg.estimator.max_batch = max_batch
    specs: List[TenantSpec] = []
    for tid in tenant_ids:
        profile = models[tid].profile(units, max_batch)
        backend = _make_backend(profile, interference=interference,
                                units=units)
        if policy == "static":
            # one fat instance at the tenant's even-split share
            fat = {(t, b): lat for (t, b), lat in profile.items()
                   if t == shares[tid]}
            opt = PackratOptimizer(fat)
            batch = min(initial_batch, max_batch)
        elif policy == "packrat":
            opt = PackratOptimizer(profile, allow_unused_threads=True)
            batch = initial_batch
        else:
            raise ValueError(f"unknown policy {policy!r}")
        specs.append(TenantSpec(tid, profile, backend,
                                initial_batch=batch, optimizer=opt))

    loop = _sim_loop(engine)
    server = MultiModelServer(loop, total_units=units, tenants=specs,
                              config=ccfg, adaptive=(policy == "packrat"),
                              plan_interval=reconfigure_timeout)
    metrics = MetricsCollector(slo_by_model=slo_by_model)
    drain = max(DRAIN_MIN_S, DRAIN_FACTOR * duration)
    metrics.attach(server, sample_interval=min(0.25, duration / 100.0),
                   until=duration + drain)
    if engine == "fast":
        # bulk feed: per-tenant traces stream through the vectorized
        # multi-model path (offered counts are order-independent, so
        # per-tenant bulk accounting matches the merged-timeline walk)
        for tid in tenant_ids:
            metrics.on_requests(len(traces[tid]), model_id=tid)
        feed_multi_model_trace(server, traces)
    else:
        # merge the per-model traces into one deterministic arrival timeline
        merged = sorted((t, k, tid)
                        for k, tid in enumerate(tenant_ids)
                        for t in traces[tid])
        for i, (t, _, tid) in enumerate(merged):
            req = Request(i, t, model_id=tid)
            metrics.on_request(req)
            loop.at(t, (lambda req=req: server.submit(req)))
    loop.run_until(duration + drain)

    rep = metrics.report(duration=duration)
    rep["dispatch"] = dispatch
    rep["interference"] = interference
    rep["engine"] = engine
    rep["shares"] = server.shares()
    rep["plans"] = len(server.plan_log) - 1
    rep["plan_log"] = [
        {"t": t, "shares": s, "batches": b} for t, s, b in server.plan_log]
    worst = metrics.worst_model_p95()
    rep["worst_model_p95_ms"] = None if math.isnan(worst) else worst * 1e3
    rep["tenants"] = {
        tid: {
            "units": server.shares()[tid],
            "reconfigurations": len(server.tenants[tid].reconfig_log) - 1,
            "final_config": str(server.tenants[tid].reconfig_log[-1][2]),
            "expected_latency_ms":
                server.tenants[tid].reconfig_log[-1][2].latency * 1e3,
            "reconfig_log": [
                {"t": t, "batch": b, "config": str(cfg)}
                for t, b, cfg in server.tenants[tid].reconfig_log],
        }
        for tid in tenant_ids
    }
    rep["fastpath"] = server.fastpath_report()
    rep["planning"] = server.planning_report()
    rep["instances"] = instance_report(
        server.workers_ever, loop.now, engine=rep["fastpath"]["engine"])
    return rep


def run_mm_scenario(sc: MultiModelScenario, *,
                    models: Dict[str, ProfileModel], units: int,
                    duration: float, seed: int, initial_batch: int,
                    max_batch: int, slo_factor: float,
                    reconfigure_timeout: float,
                    policies: tuple = POLICIES,
                    dispatches: Tuple[str, ...] = ("sync",),
                    interference: bool = False,
                    slo_ms: Optional[float] = None,
                    engine: str = "event") -> Dict[str, object]:
    """Every policy × dispatch combo on identical per-model traces."""
    tenant_ids = list(models)
    shares = even_shares(units, tenant_ids)
    contexts: Dict[str, ScenarioContext] = {}
    for k, tid in enumerate(tenant_ids):
        share = shares[tid]
        opt = PackratOptimizer(models[tid].profile(share, max_batch))
        contexts[tid] = ScenarioContext(
            threads=share, optimizer=opt, duration=duration, seed=seed + k,
            max_total_batch=share * max_batch)
    mctx = MultiModelScenarioContext(models=tuple(tenant_ids),
                                     contexts=contexts, duration=duration,
                                     seed=seed)
    workloads = sc.build(mctx)
    # distinct per-tenant seed streams; identical across policies
    traces = {tid: workloads[tid].arrivals(duration, seed=seed + 101 * k)
              for k, tid in enumerate(tenant_ids)}
    slo_by_model: Dict[str, float] = {}
    for tid in tenant_ids:
        if slo_ms is not None:
            slo_by_model[tid] = slo_ms * 1e-3
        else:
            b0 = max(1, min(initial_batch, shares[tid] * max_batch))
            slo_by_model[tid] = slo_factor * contexts[tid].optimizer.solve(
                shares[tid], b0).latency
    out: Dict[str, object] = {
        "scenario": sc.name,
        "description": sc.description,
        "models": tenant_ids,
        "even_shares": shares,
        "offered": sum(len(v) for v in traces.values()),
        "offered_by_model": {tid: len(traces[tid]) for tid in tenant_ids},
        "slo_deadline_ms": {tid: slo_by_model[tid] * 1e3
                            for tid in tenant_ids},
        "policies": [policy_key(p, d) for p in policies for d in dispatches],
    }
    if slo_ms is not None:
        out["slo_feasible"] = {
            tid: _slo_feasible(contexts[tid].optimizer, shares[tid],
                               slo_ms * 1e-3)
            for tid in tenant_ids}
    for policy in policies:
        for dispatch in dispatches:
            out[policy_key(policy, dispatch)] = run_multimodel_policy(
                policy, traces, models=models, units=units,
                duration=duration, initial_batch=initial_batch,
                max_batch=max_batch, slo_by_model=slo_by_model,
                reconfigure_timeout=reconfigure_timeout, dispatch=dispatch,
                interference=interference, engine=engine)
    return out


def _parse_models(spec: str) -> Dict[str, ProfileModel]:
    """``--models a,b[,a]`` → {tenant_id: ProfileModel}; duplicate model
    names become distinct tenants (``name#2`` …)."""
    names = [s.strip() for s in spec.split(",") if s.strip()]
    if len(names) < 2:
        raise ValueError("--models needs at least two comma-separated models")
    out: Dict[str, ProfileModel] = {}
    seen: Dict[str, int] = {}
    for name in names:
        if name not in PAPER_MODELS:
            raise ValueError(f"unknown model {name!r}; "
                             f"choose from {sorted(PAPER_MODELS)}")
        seen[name] = seen.get(name, 0) + 1
        tid = name if seen[name] == 1 else f"{name}#{seen[name]}"
        out[tid] = PAPER_MODELS[name]
    return out


def _select_scenarios(args, ap) -> List[Scenario]:
    """Single-model scenario selection shared by the simulated and real
    execution paths: a ``--trace`` replay, ``all``, or one registered
    scenario (argparse error on anything unloadable/unknown)."""
    if args.trace:
        try:
            trace = TraceWorkload.from_file(args.trace)
        except (OSError, ValueError, KeyError) as e:
            ap.error(f"cannot load trace {args.trace!r}: {e}")
        return [Scenario(name=f"trace:{args.trace}",
                         description="user-supplied trace replay",
                         build=lambda ctx: trace)]
    if args.scenario == "all":
        return list_scenarios()
    try:
        return [get_scenario(args.scenario)]
    except KeyError as e:
        ap.error(e.args[0])


def _emit_report(report: Dict[str, object], out: Optional[str]) -> None:
    """Write the JSON report to ``out`` or stdout (every path emits
    identically: sorted keys, indent 2, trailing newline on file)."""
    text = json.dumps(report, indent=2, sort_keys=True)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
        print(f"[bench] report written to {out}", file=sys.stderr)
    else:
        print(text)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Scenario-driven serving benchmark "
                    "(static baseline vs adaptive Packrat), PyTorch/CUDA")
    ap.add_argument("--scenario", default="all",
                    help="registered scenario name, or 'all'")
    ap.add_argument("--trace", default=None,
                    help="JSON/CSV arrival trace to replay instead of a "
                         "registered scenario")
    ap.add_argument("--model", default=None,
                    choices=sorted(PAPER_MODELS),
                    help="simulated-plane profile model "
                         "(default: inception_v3)")
    ap.add_argument("--models", default=None,
                    help="comma-separated model list — switches to the "
                         "multi-model resource plane (mixed-* scenarios)")
    ap.add_argument("--units", type=int, default=16,
                    help="total threads/chips T (per node under "
                         "--nodes > 1)")
    ap.add_argument("--nodes", type=int, default=1,
                    help="number of Packrat nodes; > 1 switches to the "
                         "cluster fabric (single-fat-node vs fabric on "
                         "one identical trace), 1 is the unchanged "
                         "single-node path")
    ap.add_argument("--duration", type=float, default=60.0,
                    help="seconds of offered load")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--initial-batch", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--slo-factor", type=float, default=4.0,
                    help="SLO deadline as a multiple of the optimal "
                         "latency at --initial-batch")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="absolute SLO deadline (ms); overrides "
                         "--slo-factor and reports the largest "
                         "SLO-feasible batch per model")
    ap.add_argument("--interference", action="store_true",
                    help="apply the paper's §5.2.2 CPU interference model "
                         "(downclock + loaded DRAM) to simulated instances")
    ap.add_argument("--reconfigure-timeout", type=float, default=5.0,
                    help="estimator check period for the packrat policy "
                         "(and the multi-model plan interval)")
    ap.add_argument("--dispatch", default="both",
                    choices=("sync", "continuous", "both"),
                    help="dispatch policy axis: paper-faithful batch-sync, "
                         "continuous per-instance, or both")
    ap.add_argument("--execution", default="sim",
                    choices=("sim", "fast", "real"),
                    help="execution plane: deterministic virtual-clock "
                         "simulation (event-at-a-time), its vectorized "
                         "core ('fast' — byte-identical reports, large "
                         "traces finish orders of magnitude sooner), or "
                         "real wall-clock execution of a micro model or "
                         "an LM on --device")
    ap.add_argument("--planner", default="shared",
                    choices=PLANNER_ENGINES,
                    help="knapsack planning engine: the shared-DP-table "
                         "amortized solver (default) or the per-query "
                         "reference DP — plans are bit-identical, only "
                         "control-plane solve cost differs")
    ap.add_argument("--real-model", default="mlp-tiny",
                    help="model for --execution real: a micro model "
                         "(repro_torch.models.micro registry) or an "
                         "autoregressive LM (repro_torch.models.serve_lm, "
                         "e.g. lm-tiny — switches to phase-split "
                         "prefill/decode serving)")
    ap.add_argument("--lm-decode-steps", type=int, default=8,
                    help="decode steps per prompt before EOS for LM "
                         "real models (the decode continuation chain)")
    ap.add_argument("--fidelity-ladder", action="store_true",
                    help="equip every fabric node (--nodes > 1) with the "
                         "model's reduced-rung fidelity ladder: overload "
                         "steps fidelity down before the batch-floor/shed "
                         "ladder engages; adds the rung-tagged fidelity "
                         "keys to the report (schema v7)")
    ap.add_argument("--real-rate-cap", type=float, default=300.0,
                    help="cap offered load (req/s) under --execution real "
                         "so Python event overhead is not the bottleneck; "
                         "<= 0 disables")
    ap.add_argument("--device", default="cuda",
                    help="torch device of --execution real; 'cpu' runs "
                         "the kernels' plain versions")
    ap.add_argument("--out", default=None, help="write JSON report here "
                                                "(default: stdout)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    args = ap.parse_args(argv)

    if args.list:
        for sc in list_scenarios():
            print(f"{sc.name:16s} {sc.description}")
        for sc in list_mm_scenarios():
            print(f"{sc.name:16s} [multi-model] {sc.description}")
        return 0

    if args.duration <= 0:
        ap.error("--duration must be > 0")
    if args.units < 1 or args.initial_batch < 1 or args.max_batch < 1:
        ap.error("--units, --initial-batch and --max-batch must be >= 1")
    if args.slo_ms is not None and args.slo_ms <= 0:
        ap.error("--slo-ms must be > 0")
    if args.nodes < 1:
        ap.error("--nodes must be >= 1")
    if args.nodes > 1 and args.models:
        ap.error("--nodes > 1 is single-model per node for now; "
                 "drop --models")
    if args.nodes > 1 and args.execution == "real":
        ap.error("--nodes > 1 runs on the simulated plane; "
                 "drop --execution real")
    if args.fidelity_ladder and args.nodes < 2:
        ap.error("--fidelity-ladder is a cluster-fabric overload axis; "
                 "it needs --nodes > 1")

    dispatches = (DISPATCHES if args.dispatch == "both"
                  else (args.dispatch,))
    keys = [policy_key(p, d) for p in POLICIES for d in dispatches]
    engine = "fast" if args.execution == "fast" else "event"
    set_default_engine(args.planner)

    if args.execution == "real":
        if args.models:
            ap.error("--execution real is single-model for now; "
                     "drop --models")
        if args.model:
            ap.error("--model selects a simulated-plane profile and has "
                     "no effect under --execution real; use --real-model")
        if args.interference:
            ap.error("--interference is a simulated-plane model; real "
                     "execution measures interference instead of "
                     "modelling it")
        from ..models.micro import MICRO_MODELS
        from ..models.serve_lm import LM_MODELS
        if args.real_model not in MICRO_MODELS + LM_MODELS:
            ap.error(f"unknown --real-model {args.real_model!r}; "
                     f"choose from {sorted(MICRO_MODELS + LM_MODELS)}")
        if args.real_model in LM_MODELS:
            if args.lm_decode_steps < 1:
                ap.error("--lm-decode-steps must be >= 1")
            if args.units < 2:
                ap.error("LM phase-split serving needs --units >= 2")
            scenarios = _select_scenarios(args, ap)
            # decode KV-cache cells are memory-bound; keep the profiled
            # batch grid at serving scale rather than the one-shot 256
            lm_max_batch = min(args.max_batch, 8)
            report = {
                "schema_version": SCHEMA_VERSION,
                "planner": args.planner,
                "execution": "real",
                "real_model": args.real_model,
                "decode_steps": args.lm_decode_steps,
                "real_rate_cap_rps": args.real_rate_cap,
                "units": args.units,
                "duration_s": args.duration,
                "seed": args.seed,
                "initial_batch": args.initial_batch,
                "max_batch": lm_max_batch,
                "slo_factor": args.slo_factor,
                "slo_ms": args.slo_ms,
                "dispatches": list(dispatches),
                "policies": keys,
                "scenarios": {},
            }
            for sc in scenarios:
                result = run_lm_scenario(
                    sc, real_model=args.real_model, units=args.units,
                    duration=args.duration, seed=args.seed,
                    initial_batch=args.initial_batch,
                    max_batch=lm_max_batch,
                    decode_steps=args.lm_decode_steps,
                    slo_factor=args.slo_factor,
                    reconfigure_timeout=args.reconfigure_timeout,
                    dispatches=dispatches, rate_cap=args.real_rate_cap,
                    slo_ms=args.slo_ms, device=args.device)
                report["scenarios"][sc.name] = result
                parts = []
                for key in keys:
                    rep = result[key]
                    ttft = rep.get("ttft_ms", {}).get("p95")
                    tpot = rep.get("tpot_ms", {}).get("p95")
                    parts.append(
                        f"{key}: ttft95="
                        f"{'n/a' if ttft is None else f'{ttft:.1f}ms'} "
                        f"tpot95="
                        f"{'n/a' if tpot is None else f'{tpot:.1f}ms'}")
                print(f"[bench] {sc.name:16s} "
                      f"prompts={result['offered_prompts']:5d} "
                      f"[lm:{args.real_model}]  " + "  ".join(parts),
                      file=sys.stderr)
            _emit_report(report, args.out)
            return 0
        scenarios = _select_scenarios(args, ap)
        report: Dict[str, object] = {
            "schema_version": SCHEMA_VERSION,
            "planner": args.planner,
            "execution": "real",
            "real_model": args.real_model,
            "real_rate_cap_rps": args.real_rate_cap,
            "units": args.units,
            "duration_s": args.duration,
            "seed": args.seed,
            "initial_batch": args.initial_batch,
            "max_batch": args.max_batch,
            "slo_factor": args.slo_factor,
            "slo_ms": args.slo_ms,
            "dispatches": list(dispatches),
            "policies": keys,
            "scenarios": {},
        }
        for sc in scenarios:
            result = run_real_scenario(
                sc, real_model=args.real_model, units=args.units,
                duration=args.duration, seed=args.seed,
                initial_batch=args.initial_batch, max_batch=args.max_batch,
                slo_factor=args.slo_factor,
                reconfigure_timeout=args.reconfigure_timeout,
                dispatches=dispatches, rate_cap=args.real_rate_cap,
                slo_ms=args.slo_ms, device=args.device)
            report["scenarios"][sc.name] = result
            parts = []
            for key in keys:
                rep = result[key]
                p95 = rep["latency_ms"]["p95"]
                ratio = rep["calibration"]["global_ratio"]
                parts.append(
                    f"{key}: p95="
                    f"{'n/a' if p95 is None else f'{p95:.1f}ms'} "
                    f"obs/exp={ratio:.1f}x")
            print(f"[bench] {sc.name:16s} offered={result['offered']:6d} "
                  f"[real:{args.real_model}]  " + "  ".join(parts),
                  file=sys.stderr)
        _emit_report(report, args.out)
        return 0

    if args.models:
        if args.trace:
            ap.error("--trace is single-model; drop --models")
        try:
            models = _parse_models(args.models)
        except ValueError as e:
            ap.error(str(e))
        if args.units < len(models):
            ap.error(f"--units {args.units} cannot host "
                     f"{len(models)} tenants")
        if args.scenario == "all":
            mm_scenarios = list_mm_scenarios()
        else:
            try:
                mm_scenarios = [get_mm_scenario(args.scenario)]
            except KeyError as e:
                ap.error(e.args[0])
        report: Dict[str, object] = {
            "schema_version": SCHEMA_VERSION,
            "planner": args.planner,
            "models": list(models),
            "units": args.units,
            "duration_s": args.duration,
            "seed": args.seed,
            "initial_batch": args.initial_batch,
            "max_batch": args.max_batch,
            "slo_factor": args.slo_factor,
            "slo_ms": args.slo_ms,
            "interference": args.interference,
            "engine": engine,
            "dispatches": list(dispatches),
            "policies": keys,
            "scenarios": {},
        }
        for sc in mm_scenarios:
            result = run_mm_scenario(
                sc, models=models, units=args.units,
                duration=args.duration, seed=args.seed,
                initial_batch=args.initial_batch, max_batch=args.max_batch,
                slo_factor=args.slo_factor,
                reconfigure_timeout=args.reconfigure_timeout,
                dispatches=dispatches, interference=args.interference,
                slo_ms=args.slo_ms, engine=engine)
            report["scenarios"][sc.name] = result
            parts = []
            for key in keys:
                rep = result[key]
                worst = rep["worst_model_p95_ms"]
                parts.append(
                    f"{key}: worst-p95="
                    f"{'n/a' if worst is None else f'{worst:.0f}ms'} "
                    f"goodput={rep['goodput_rps']:.1f}/s")
            print(f"[bench] {sc.name:16s} offered={result['offered']:6d}  "
                  + "  ".join(parts), file=sys.stderr)
        _emit_report(report, args.out)
        return 0

    model_name = args.model or "inception_v3"
    model = PAPER_MODELS[model_name]
    scenarios = _select_scenarios(args, ap)

    if args.nodes > 1:
        keys = [policy_key(p, d) for p in FABRIC_POLICIES
                for d in dispatches]
        report = {
            "schema_version": SCHEMA_VERSION,
            "planner": args.planner,
            "model": model_name,
            "nodes": args.nodes,
            "units_per_node": args.units,
            "total_units": args.nodes * args.units,
            "duration_s": args.duration,
            "seed": args.seed,
            "initial_batch": args.initial_batch,
            "max_batch": args.max_batch,
            "slo_factor": args.slo_factor,
            "slo_ms": args.slo_ms,
            "interference": args.interference,
            "engine": engine,
            "dispatches": list(dispatches),
            "policies": keys,
            "scenarios": {},
        }
        for sc in scenarios:
            result = run_fabric_scenario(
                sc, model=model, nodes=args.nodes,
                units_per_node=args.units, duration=args.duration,
                seed=args.seed, initial_batch=args.initial_batch,
                max_batch=args.max_batch, slo_factor=args.slo_factor,
                reconfigure_timeout=args.reconfigure_timeout,
                dispatches=dispatches, interference=args.interference,
                slo_ms=args.slo_ms, engine=engine,
                fidelity_ladder=args.fidelity_ladder)
            report["scenarios"][sc.name] = result
            parts = []
            for key in keys:
                rep = result[key]
                p95 = rep["latency_ms"]["p95"]
                parts.append(
                    f"{key}: p95="
                    f"{'n/a' if p95 is None else f'{p95:.0f}ms'} "
                    f"shed={rep['shed_rate']:.0%}")
            print(f"[bench] {sc.name:16s} offered={result['offered']:6d} "
                  f"[{args.nodes}x{args.units}u]  " + "  ".join(parts),
                  file=sys.stderr)
        _emit_report(report, args.out)
        return 0

    report = {
        "schema_version": SCHEMA_VERSION,
        "planner": args.planner,
        "model": model_name,
        "units": args.units,
        "duration_s": args.duration,
        "seed": args.seed,
        "initial_batch": args.initial_batch,
        "max_batch": args.max_batch,
        "slo_factor": args.slo_factor,
        "slo_ms": args.slo_ms,
        "interference": args.interference,
        "engine": engine,
        "dispatches": list(dispatches),
        "policies": keys,
        "scenarios": {},
    }
    for sc in scenarios:
        result = run_scenario(
            sc, model=model, units=args.units, duration=args.duration,
            seed=args.seed, initial_batch=args.initial_batch,
            max_batch=args.max_batch, slo_factor=args.slo_factor,
            reconfigure_timeout=args.reconfigure_timeout,
            dispatches=dispatches, interference=args.interference,
            slo_ms=args.slo_ms, engine=engine)
        report["scenarios"][sc.name] = result

        def fmt(ms):
            return "n/a" if ms is None else f"{ms:.0f}ms"

        parts = []
        for key in keys:
            rep = result[key]
            parts.append(f"{key}: p95={fmt(rep['latency_ms']['p95'])} "
                         f"p99={fmt(rep['latency_ms']['p99'])} "
                         f"goodput={rep['goodput_rps']:.1f}/s")
        print(f"[bench] {sc.name:16s} offered={result['offered']:6d}  "
              + "  ".join(parts), file=sys.stderr)

    _emit_report(report, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
