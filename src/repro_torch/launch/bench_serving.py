"""Trace-driven LM serving benchmark on the real plane, in PyTorch.

A port of the autoregressive LM path of ``repro/launch/bench_serving.py``
(``--execution real --real-model lm-tiny``): a decoder served through
the CUDA flash-attention and flash-decode kernels, split into a prefill
pool and a decode pool (two ``PackratServer``\\ s routing runner cells by
phase) with a decode-step continuation chain (``--lm-decode-steps``
tokens per prompt).  ``static`` time-shares one fat machine between the
phases; ``packrat`` splits the unit budget with ``solve_phase_split``
against per-phase profiles measured through the same plane runners.
The report schema is the reference's.

The simulated planes, the micro models, the multi-model plane and the
cluster fabric are later slices of the port: those flags are accepted
for compatibility and rejected with ``not yet ported``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.bench_serving \\
        --execution real --real-model lm-tiny --scenario steady-poisson \\
        --duration 5 --units 4
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import sys
from typing import Dict, List, Optional, Tuple

from ..core.knapsack import (PLANNER_ENGINES, PackratOptimizer,
                             planning_report, set_default_engine)
from ..serving import (ControllerConfig, MetricsCollector, PackratServer,
                       Request, TabulatedBackend, instance_report)
from ..serving.scenarios import (Scenario, ScenarioContext, get_scenario,
                                 list_scenarios)
from ..serving.workloads import TraceWorkload

POLICIES = ("static", "packrat")
DISPATCHES = ("sync", "continuous")
# the reference's report schema version (v6 added the LM path's keys)
SCHEMA_VERSION = 7

# real execution drains wall-clock seconds past the offered-load window
REAL_DRAIN_MIN_S = 2.0
REAL_DRAIN_FACTOR = 0.5


def policy_key(policy: str, dispatch: str) -> str:
    """Report key for one (policy, dispatch) combination; sync keeps the
    bare policy name so pre-existing report consumers stay valid."""
    return policy if dispatch == "sync" else f"{policy}+{dispatch}"


def _cap_rate(arrivals: List[float], duration: float,
              cap: Optional[float]) -> Tuple[List[float], bool]:
    """Thin a trace to at most ``cap`` req/s (evenly, deterministically):
    evenly spaced indices for exactly the target count."""
    if cap is None or cap <= 0:
        return arrivals, False
    target = int(cap * duration)
    if len(arrivals) <= target:
        return arrivals, False
    return [arrivals[i * len(arrivals) // target]
            for i in range(target)], True


def _controller_report_fields(rep: Dict[str, object], server,
                              now: float) -> None:
    """The per-run controller fields every policy report carries:
    reconfiguration count/log, the final config and its expected
    makespan, and the per-instance breakdown."""
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
    gate is the device:

    * ``static`` — each phase pool is one fat ⟨1,T,b⟩ instance sized to
      the whole machine, so the gate time-shares the device between
      phases;
    * ``packrat`` — :func:`~repro_torch.core.knapsack.solve_phase_split`
      splits the unit budget across the phases against their own
      measured profiles; each pool's knapsack then plans inside its
      share, so prefill and decode execute concurrently.

    Requests flow prompt → prefill pool → (continuation) decode pool →
    ``decode_steps - 1`` same-pool re-enqueues.  Prefill request latency
    is TTFT, decode-step latency is TPOT.
    """
    from ..core.knapsack import solve_phase_split
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
        # decode_steps sequential token steps — plan the decode pool for
        # the largest feasible such batch (halving until a split hosts it)
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

    plane = RealPlane(factory, units)
    metrics = MetricsCollector(slo_by_model=slo_by_phase)
    drain = max(REAL_DRAIN_MIN_S, REAL_DRAIN_FACTOR * duration)
    servers: Dict[str, PackratServer] = {}
    cals: Dict[str, object] = {}
    # partial-batch coalesce window: a few step-times, so a lone request
    # does not wait out the default 50 ms dispatcher timer
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
            # compile-ahead: every plan application warms the plan's
            # ⟨t,b⟩ runner cells for this pool's phase
            on_plan_apply=(lambda cfg, p=p: plane.warm(
                [(g.t, g.b) for g in cfg.groups], p)))
        metrics.attach(servers[p],
                       sample_interval=min(0.25, duration / 100.0),
                       until=duration + drain)

    # decode-step continuation chain: ids disjoint from prompt ids
    rid = itertools.count(1_000_000_000)

    def _next_decode(steps_left: int) -> Request:
        req = Request(next(rid), plane.now, model_id=PHASE_DECODE,
                      phase=PHASE_DECODE, steps_left=steps_left)
        metrics.on_request(req)
        return req

    def prefill_done(resp) -> Optional[Request]:
        # cross-phase hand-off on the decode dispatcher
        if decode_steps > 0:
            servers[PHASE_DECODE].submit(_next_decode(decode_steps))
        return None

    def decode_done(resp) -> Optional[Request]:
        # same-dispatcher re-enqueue until EOS/max-len
        if resp.request.steps_left > 1:
            return _next_decode(resp.request.steps_left - 1)
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
    # first-touch build accounting (excluded from every latency
    # percentile: the factory builds outside the timed path)
    rep["runner_cache"] = plane.runner_report()
    rep["planning"] = planning_report(
        [servers[p].optimizer for p in PHASES])
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
    # engine caches built cells, so serving planes reuse them
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
    # cap offered prompts against the serial per-prompt cost (prefill +
    # the whole decode chain on the fat machine): ~50% utilization
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


def _select_scenarios(args, ap) -> List[Scenario]:
    """A ``--trace`` replay, ``all``, or one registered scenario
    (argparse error on anything unloadable/unknown)."""
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
    """Write the JSON report to ``out`` or stdout (sorted keys, indent 2,
    trailing newline on file)."""
    text = json.dumps(report, indent=2, sort_keys=True)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
        print(f"[bench] report written to {out}", file=sys.stderr)
    else:
        print(text)


def main(argv: Optional[List[str]] = None) -> int:
    from ..models.serve_lm import LM_MODELS
    ap = argparse.ArgumentParser(
        description="LM serving benchmark on the real plane "
                    "(static baseline vs adaptive Packrat), PyTorch/CUDA")
    ap.add_argument("--scenario", default="all",
                    help="registered scenario name, or 'all'")
    ap.add_argument("--trace", default=None,
                    help="JSON/CSV arrival trace to replay instead of a "
                         "registered scenario")
    ap.add_argument("--model", default=None,
                    help="simulated-plane profile model (not yet ported)")
    ap.add_argument("--models", default=None,
                    help="multi-model resource plane (not yet ported)")
    ap.add_argument("--units", type=int, default=16,
                    help="total concurrency units T on the device")
    ap.add_argument("--nodes", type=int, default=1,
                    help="cluster fabric nodes (> 1 not yet ported)")
    ap.add_argument("--duration", type=float, default=60.0,
                    help="seconds of offered load")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--initial-batch", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--slo-factor", type=float, default=4.0,
                    help="SLO deadline as a multiple of the measured "
                         "latency at --initial-batch")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="absolute SLO deadline (ms); overrides "
                         "--slo-factor")
    ap.add_argument("--interference", action="store_true",
                    help="simulated interference model (not yet ported)")
    ap.add_argument("--reconfigure-timeout", type=float, default=5.0,
                    help="estimator check period for the packrat policy")
    ap.add_argument("--dispatch", default="both",
                    choices=("sync", "continuous", "both"),
                    help="dispatch policy axis: paper-faithful batch-sync, "
                         "continuous per-instance, or both")
    ap.add_argument("--execution", default="sim",
                    choices=("sim", "fast", "real"),
                    help="execution plane; only 'real' is ported")
    ap.add_argument("--planner", default="shared",
                    choices=PLANNER_ENGINES,
                    help="knapsack planning engine (plans bit-identical)")
    ap.add_argument("--real-model", default="mlp-tiny",
                    help="model for --execution real; ported: "
                         f"{', '.join(LM_MODELS)}")
    ap.add_argument("--lm-decode-steps", type=int, default=8,
                    help="decode steps per prompt before EOS")
    ap.add_argument("--fidelity-ladder", action="store_true",
                    help="cluster-fabric fidelity ladder (not yet ported)")
    ap.add_argument("--real-rate-cap", type=float, default=300.0,
                    help="cap offered load (req/s); <= 0 disables")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    ap.add_argument("--out", default=None, help="write JSON report here "
                                                "(default: stdout)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    args = ap.parse_args(argv)

    if args.list:
        for sc in list_scenarios():
            print(f"{sc.name:16s} {sc.description}")
        return 0

    if args.execution != "real":
        ap.error(f"--execution {args.execution}: not yet ported "
                 "(use --execution real)")
    if args.models:
        ap.error("--models (multi-model plane): not yet ported")
    if args.nodes != 1:
        ap.error("--nodes (cluster fabric): not yet ported")
    if args.fidelity_ladder:
        ap.error("--fidelity-ladder: not yet ported")
    if args.model:
        ap.error("--model selects a simulated-plane profile and has "
                 "no effect under --execution real; use --real-model")
    if args.interference:
        ap.error("--interference is a simulated-plane model; real "
                 "execution measures interference instead of modelling it")
    if args.real_model not in LM_MODELS:
        ap.error(f"--real-model {args.real_model!r}: not yet ported; "
                 f"choose from {sorted(LM_MODELS)}")
    if args.duration <= 0:
        ap.error("--duration must be > 0")
    if args.units < 1 or args.initial_batch < 1 or args.max_batch < 1:
        ap.error("--units, --initial-batch and --max-batch must be >= 1")
    if args.slo_ms is not None and args.slo_ms <= 0:
        ap.error("--slo-ms must be > 0")
    if args.lm_decode_steps < 1:
        ap.error("--lm-decode-steps must be >= 1")
    if args.units < 2:
        ap.error("LM phase-split serving needs --units >= 2")

    dispatches = (DISPATCHES if args.dispatch == "both"
                  else (args.dispatch,))
    keys = [policy_key(p, d) for p in POLICIES for d in dispatches]
    set_default_engine(args.planner)
    scenarios = _select_scenarios(args, ap)
    # decode KV-cache cells are memory-bound; keep the profiled batch grid
    # at serving scale rather than the one-shot 256
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
            initial_batch=args.initial_batch, max_batch=lm_max_batch,
            decode_steps=args.lm_decode_steps, slo_factor=args.slo_factor,
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
                f"tpot95={'n/a' if tpot is None else f'{tpot:.1f}ms'}")
        print(f"[bench] {sc.name:16s} "
              f"prompts={result['offered_prompts']:5d} "
              f"[lm:{args.real_model}]  " + "  ".join(parts),
              file=sys.stderr)
    _emit_report(report, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
