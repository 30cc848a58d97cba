"""Scale-out serving fabric: a cluster router over N Packrat nodes.

Packrat picks the optimal ⟨i,t,b⟩ split *within* one server; this module
adds the fleet layer above it — the missing piece between "one tuned
node" and "heavy traffic from millions of users".  Following InferLine's
slow-planner / fast-reactive split and Harpagon's observation that
cross-replica dispatch is where serving cost and tail latency are won,
the fabric separates three concerns:

* **Routing** — :class:`ClusterRouter` fronts N nodes (each a full
  :class:`~repro.serving.controller.PackratServer` with its own unit
  pool and Packrat-planned configs, all driven by **one shared
  execution plane** so simulated runs stay deterministic).  Each
  request is routed by *least expected latency* — the node's calibrated
  expected batch latency scaled by its queue backlog — sampled with
  **power-of-two-choices**, so routing stays O(1) per request at any
  fleet size while still tracking load.

* **Admission** — a per-node :class:`TokenBucket` caps the admitted
  rate at what the node can serve *within the SLO* (the largest
  SLO-feasible batch's throughput, with headroom).  Requests beyond it
  are **shed** immediately: a :class:`~repro.serving.simulator.Shed`
  terminal state, reported separately so goodput and admitted-only
  percentiles stay honest under overload.

* **Overload degradation** — before dropping anything for queue depth,
  the router walks a *degrade ladder*: with a
  :class:`~repro.core.knapsack.FidelityLadder` attached, an overloaded
  node first steps down fidelity rungs (cheaper model variants, each
  replanned against its own profile — quality of the *model* degrades
  before quality of *delivery*); then it *degrades batch-size floors* —
  the estimator is pinned to the largest SLO-feasible batch (maximum
  throughput that still honours the deadline); and only once the node
  is fully degraded **and** its queue would blow the remaining SLO
  budget do queue-depth sheds start.  Recovery runs the ladder in
  reverse — floors released first, then one rung up per
  consecutive-calm-tick streak (:class:`~repro.core.estimator
  .HysteresisGate`) — so bursts neither flap the mode nor thrash rungs.

Fault handling preserves exactly-once delivery: the router keeps a
per-node map of undelivered routed requests and a fleet-wide delivered
set.  Draining a node re-routes its *undispatched* requests and lets
in-flight batches finish and deliver from the draining node; failing a
node halts its control loop, fails its workers (in-flight completions
on failed workers never deliver), and re-routes every undelivered
request — a late duplicate from any path is suppressed by the delivered
set (``duplicates_suppressed`` counts them, normally 0).

Per-node arrival rates reuse :class:`~repro.core.estimator
.ArrivalRateSignal` (λ̂ per node), which both feeds the overload
detector and appears in the fleet report.
"""

from __future__ import annotations

import copy
import dataclasses
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.estimator import ArrivalRateSignal, HysteresisGate
from ..core.knapsack import (FidelityLadder, PackratOptimizer,
                             PlanTableRegistry, planning_report)
from ..core.multimodel import solve_with_slo
from ..core.profiler import ProfileCalibrator
from .controller import ControllerConfig, PackratServer
from .instance import LatencyBackend, WorkerInstance
from .plane import ExecutionPlane, as_plane
from .simulator import EventLoop, Request, Response, Shed


class TokenBucket:
    """Deterministic token bucket: ``rate_rps`` tokens/s, ``burst`` cap.

    Refill is computed lazily from the clock handed to :meth:`take`, so
    the bucket is exact on the virtual clock and needs no timers.  A
    non-positive ``rate_rps`` disables admission control (every take
    succeeds).
    """

    def __init__(self, rate_rps: float, burst: float) -> None:
        self.rate = rate_rps
        self.burst = max(1.0, burst)
        self.tokens = self.burst
        self._last = 0.0

    def take(self, now: float) -> bool:
        """Consume one token if available; refills for elapsed time first."""
        if self.rate <= 0.0:
            return True
        elapsed = max(0.0, now - self._last)
        self._last = now
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclasses.dataclass
class FabricConfig:
    """Fleet-level knobs; per-node controller config is deep-copied per
    node so degrade-mode floor changes never leak across nodes."""

    controller: ControllerConfig = dataclasses.field(
        default_factory=ControllerConfig)
    # token rate = factor × throughput of the node's degrade-batch config
    admission_rate_factor: float = 1.1
    admission_burst_batches: float = 2.0   # burst = factor × degrade batch
    # queue depth (in degrade-batch multiples) that engages degrade mode
    degrade_queue_batches: float = 2.0
    # queue-shed depth without an SLO (with one, the wait budget decides)
    shed_queue_batches: float = 8.0
    # SLO budget split: service time gets `slo_latency_share`, queueing
    # gets `slo_wait_share` (sizes the shed depth); the remainder is
    # slack for dispatch overheads and in-flight batches
    slo_latency_share: float = 0.4
    slo_wait_share: float = 0.45
    router_tick_interval: float = 0.1      # degrade enter/exit checks
    p2c_seed: int = 0                      # power-of-two-choices sampling
    # fidelity-ladder recovery hysteresis: a node steps one rung back up
    # only after `fidelity_recovery_ticks` *consecutive* calm router
    # ticks whose λ̂ also fits under `fidelity_recovery_margin` × the
    # next-higher rung's sustainable throughput (raise the tick count /
    # lower the margin if rungs thrash under oscillating load)
    fidelity_recovery_ticks: int = 3
    fidelity_recovery_margin: float = 0.9


@dataclasses.dataclass
class FabricNodeSpec:
    """What the fabric needs to stand up one Packrat node."""

    optimizer: PackratOptimizer
    backend: LatencyBackend
    node_id: str = ""                      # default: "node<k>"
    calibrator: Optional[ProfileCalibrator] = None
    # optional fidelity ladder: cheaper model variants the router may
    # degrade to before touching batch floors or shedding; rung 0 must
    # carry exactly the optimizer's own profile
    ladder: Optional[FidelityLadder] = None


class FabricNodeServer(PackratServer):
    """A :class:`PackratServer` whose control loop can be halted
    permanently — the fabric's model of node death.  A halted server
    never ticks again: no estimator samples, no reconfigurations, and
    crucially no heartbeat respawn of its failed workers."""

    def __init__(self, *args, **kwargs) -> None:
        self.halted = False
        super().__init__(*args, **kwargs)

    def _tick(self) -> None:
        if self.halted:
            return
        super()._tick()


class FabricNode:
    """One node's fleet-side state: the server plus the router's view of
    it (admission bucket, λ̂ signal, degrade plan, undelivered map)."""

    def __init__(self, index: int, node_id: str,
                 server: FabricNodeServer) -> None:
        self.index = index
        self.node_id = node_id
        self.server = server
        self.rate = ArrivalRateSignal()     # per-node λ̂ (estimator reuse)
        self.pending: Dict[int, Request] = {}   # routed, not yet delivered
        self.routed = 0
        self.delivered = 0
        self.shed_counts: Dict[str, int] = {}
        self.draining = False
        self.dead = False
        self.degraded = False
        self.degrade_engagements = 0
        # fidelity-ladder state (router-managed; ladder None = disabled)
        self.ladder: Optional[FidelityLadder] = None
        self.backend: Optional[LatencyBackend] = None
        self.rung = 0                   # current fidelity rung (0 = full)
        self.fidelity_transitions = 0
        self.recovery_gate = HysteresisGate()
        # filled by the router's planning pass
        self.b_deg = 1                  # degrade-mode batch floor/ceiling
        self.thr_deg = 0.0              # its sustainable throughput
        self.admission_rps = 0.0
        self.degrade_depth = 1
        self.shed_depth = 2
        self.bucket = TokenBucket(0.0, 1.0)
        self.base_min_batch = 1
        self.base_max_batch = 1

    @property
    def routable(self) -> bool:
        return not (self.dead or self.draining)


class ClusterRouter:
    """Least-expected-latency router + overload control over N nodes.

    All nodes share one execution plane (``loop`` may be a raw
    :class:`~repro.serving.simulator.EventLoop`), so a simulated fleet
    is exactly as deterministic as a single simulated node.  Submit
    requests with :meth:`submit`; delivered responses arrive on
    :attr:`on_response` (exactly once per request id, fleet-wide) and
    shed requests on :attr:`on_shed` as
    :class:`~repro.serving.simulator.Shed` records.

    The router schedules a periodic self-tick for degrade-mode
    enter/exit, so drive the loop with ``run_until`` (``run()`` would
    never terminate).
    """

    def __init__(self, loop, *, units_per_node: int,
                 specs: Sequence[FabricNodeSpec], initial_batch: int,
                 slo_deadline: Optional[float] = None,
                 config: Optional[FabricConfig] = None,
                 domain_size: Optional[int] = None) -> None:
        if not specs:
            raise ValueError("need at least one node")
        if units_per_node < 1:
            raise ValueError(f"units_per_node must be >= 1, "
                             f"got {units_per_node}")
        self.plane: ExecutionPlane = as_plane(loop)
        self.loop = self.plane
        self.fcfg = config or FabricConfig()
        self.units_per_node = units_per_node
        self.slo_deadline = slo_deadline
        self._rng = random.Random(self.fcfg.p2c_seed)
        self.on_response: Optional[Callable[[Response], None]] = None
        self.on_response_block = None       # block twin (fast plane)
        self.on_shed: Optional[Callable[[Shed], None]] = None
        self.responses: List[Response] = []
        self.sheds: List[Shed] = []
        self.offered = 0
        self.rerouted = 0
        self.drains = 0
        self.failovers = 0
        self.duplicates_suppressed = 0
        self.fast_absorbed = 0          # trace arrivals routed passively
        self.fast_one_by_one = 0        # trace arrivals via submit()
        self._delivered: set = set()
        self.degrade_log: List[Tuple[float, str, str]] = []
        # homogeneous fleets re-derive the same overload plan per node;
        # memoise by the optimizer's plan_key (table fingerprint +
        # dispatch overhead) so N identical nodes solve once
        self._plan_memo: Dict[tuple, Tuple[int, float]] = {}
        # ...and share one DP table + ⟨T,B⟩ plan cache across those
        # nodes' optimizers, so even the single solve is amortized
        self.plan_registry = PlanTableRegistry()

        self.nodes: List[FabricNode] = []
        for k, spec in enumerate(specs):
            node_id = spec.node_id or f"node{k}"
            if any(n.node_id == node_id for n in self.nodes):
                raise ValueError(f"duplicate node_id {node_id!r}")
            spec.optimizer.adopt_registry(self.plan_registry)
            if spec.ladder is not None:
                if dict(spec.ladder.rungs[0].profile) != spec.optimizer.profile:
                    raise ValueError(
                        f"{node_id}: ladder rung 0 must carry the "
                        f"optimizer's own profile (full fidelity)")
                spec.ladder.adopt_registry(self.plan_registry)
            ccfg = copy.deepcopy(self.fcfg.controller)
            server = FabricNodeServer(
                self.plane, total_units=units_per_node,
                optimizer=spec.optimizer, backend=spec.backend,
                initial_batch=initial_batch, config=ccfg,
                domain_size=domain_size, calibrator=spec.calibrator,
                on_response=(lambda resp, k=k:
                             self._on_node_response(self.nodes[k], resp)))
            node = FabricNode(k, node_id, server)
            node.ladder = spec.ladder
            node.backend = spec.backend
            node.recovery_gate = HysteresisGate(
                self.fcfg.fidelity_recovery_ticks)
            self._plan_node(node, spec.optimizer)
            self.nodes.append(node)
        self._adopt_block_sinks()
        self.loop.schedule(self.fcfg.router_tick_interval, self._tick)

    def _adopt_block_sinks(self) -> None:
        """When every node's dispatcher is block-capable (fast plane),
        switch fleet delivery to block granularity: each node's tenant
        adopts its block log and chains whole blocks into the router's
        exactly-once handler, which checks the fleet delivered-set per
        block and falls back to the per-response path the moment any id
        in a block has already been delivered elsewhere (failover
        duplicates)."""
        if not all(getattr(n.server.dispatcher, "supports_blocks", False)
                   for n in self.nodes):
            return
        from .fastsim import ResponseLog    # deferred: fastsim is optional
        self.responses = ResponseLog()
        for n in self.nodes:
            n.server.adopt_block_sink(
                lambda block, node=n:
                self._on_node_response_block(node, block))

    # ------------------------------------------------------------------ #
    # per-node overload plan (computed once, from the planning profile)
    # ------------------------------------------------------------------ #
    def _derive_plan(self, opt: PackratOptimizer) -> Tuple[int, float]:
        """Degrade batch + sustainable throughput for one planning
        profile, memoised by the optimizer's plan key — homogeneous
        fleets (and every node sharing a ladder rung) solve once.  With
        an SLO, the degrade batch is the largest batch whose optimal
        makespan fits in ``slo_latency_share`` of the deadline; without
        one, it is the throughput-optimal feasible batch."""
        units = self.units_per_node
        memo_key = (units, opt.plan_key())
        memo = self._plan_memo.get(memo_key)
        if memo is not None:
            return memo
        best_b, best_thr = 1, 0.0
        b = 1
        while True:
            try:
                cfg = opt.solve(units, b)
            except ValueError:
                break
            if cfg.throughput > best_thr:
                best_thr, best_b = cfg.throughput, b
            b *= 2
        if self.slo_deadline is not None:
            budget = self.fcfg.slo_latency_share * self.slo_deadline
            got = solve_with_slo(opt, units, budget)
            if got is not None:
                plan = (got[0], got[1].throughput)
            else:
                # even B=1 misses the service budget: admit at the
                # B=1 rate and let the wait budget (possibly
                # negative-free) shed the rest
                plan = (1, opt.solve(units, 1).throughput)
        else:
            plan = (best_b, best_thr)
        self._plan_memo[memo_key] = plan
        return plan

    def _apply_plan(self, node: FabricNode, *, fresh_bucket: bool) -> None:
        """Size the node's admission bucket and overload depths from its
        current ⟨b_deg, thr_deg⟩ plan.  At construction the bucket is
        fresh; on a fidelity-rung transition the live bucket is resized
        in place (rate/burst move to the rung's plan, accumulated tokens
        clamped) so a transition never mints a free admission burst."""
        fcfg = self.fcfg
        node.admission_rps = fcfg.admission_rate_factor * node.thr_deg
        burst = fcfg.admission_burst_batches * node.b_deg
        if fresh_bucket:
            node.bucket = TokenBucket(node.admission_rps, burst)
        else:
            bk = node.bucket
            bk.rate = node.admission_rps
            bk.burst = max(1.0, burst)
            if bk.tokens > bk.burst:
                bk.tokens = bk.burst
        node.degrade_depth = max(1, int(fcfg.degrade_queue_batches
                                        * node.b_deg))
        if self.slo_deadline is not None:
            wait_budget = fcfg.slo_wait_share * self.slo_deadline
            node.shed_depth = int(wait_budget * node.thr_deg)
        else:
            node.shed_depth = int(fcfg.shed_queue_batches * node.b_deg)
        node.shed_depth = max(node.shed_depth, node.degrade_depth + 1)

    def _plan_node(self, node: FabricNode, opt: PackratOptimizer) -> None:
        """Derive and apply the node's overload plan (the rest of the
        SLO budget bounds queueing, which sizes the shed depth)."""
        node.b_deg, node.thr_deg = self._derive_plan(opt)
        self._apply_plan(node, fresh_bucket=True)
        est = node.server.estimator.config
        node.base_min_batch = est.min_batch
        node.base_max_batch = est.max_batch

    # ------------------------------------------------------------------ #
    # request path
    # ------------------------------------------------------------------ #
    def _score(self, node: FabricNode) -> float:
        """Expected completion for one more request on ``node``: the
        active config's (calibration-corrected) makespan scaled by the
        node's queue backlog in aggregate-batch units."""
        d = node.server.dispatcher
        lat = d.config.latency
        cal = node.server.calibrator
        if cal is not None:
            lat *= cal.global_ratio
        backlog = d.queue_depth / max(1, d.config.total_batch)
        return lat * (1.0 + backlog)

    def _pick(self) -> Optional[FabricNode]:
        """Power-of-two-choices: sample two routable nodes, keep the one
        with the lower expected latency — O(1) per request, ties broken
        by node index for determinism."""
        cands = [n for n in self.nodes if n.routable]
        if not cands:
            return None
        pair = cands if len(cands) <= 2 else self._rng.sample(cands, 2)
        return min(pair, key=lambda n: (self._score(n), n.index))

    def submit(self, req: Request) -> None:
        """Route one request: pick a node (P2C), charge its admission
        bucket, then apply queue-depth overload control — step the
        node's degrade ladder first (fidelity rungs, then batch floors),
        shed only once fully degraded *and* past the wait budget."""
        now = self.loop.now
        self.offered += 1
        node = self._pick()
        if node is None:
            self._shed(req, None, "no-node", now)
            return
        node.rate.observe(now)
        if not node.bucket.take(now):
            self._shed(req, node, "admission", now)
            return
        depth = node.server.dispatcher.queue_depth
        if depth >= node.degrade_depth:
            self._degrade_step(node, now)
        if node.degraded and depth >= node.shed_depth:
            self._shed(req, node, "queue", now)
            return
        self._deliver_to(node, req)

    def _deliver_to(self, node: FabricNode, req: Request) -> None:
        node.routed += 1
        node.pending[req.id] = req
        node.server.submit(req)

    def _route_admitted(self, req: Request) -> None:
        """Re-route an already-admitted request (drain/failure) without
        charging admission again; sheds only if no node is routable."""
        node = self._pick()
        if node is None:
            self._shed(req, None, "no-node", self.loop.now)
            return
        self.rerouted += 1
        self._deliver_to(node, req)

    def _shed(self, req: Request, node: Optional[FabricNode], reason: str,
              now: float) -> None:
        shed = Shed(request=req, time=now,
                    node_id=node.node_id if node is not None else None,
                    reason=reason)
        self.sheds.append(shed)
        if node is not None:
            node.shed_counts[reason] = node.shed_counts.get(reason, 0) + 1
        if self.on_shed is not None:
            self.on_shed(shed)

    def _on_node_response(self, node: FabricNode, resp: Response) -> None:
        node.pending.pop(resp.request.id, None)
        if resp.request.id in self._delivered:
            # a failed-over request delivered from two paths; first wins
            self.duplicates_suppressed += 1
            return
        self._delivered.add(resp.request.id)
        node.delivered += 1
        resp.node_id = node.node_id
        if node.ladder is not None:
            resp.fidelity = node.rung
        self.responses.append(resp)
        if self.on_response is not None:
            self.on_response(resp)

    def _on_node_response_block(self, node: FabricNode, block) -> None:
        """Block-granular exactly-once delivery (fast plane): the whole
        sub-batch clears the per-node pending map and joins the fleet
        delivered-set in one pass.  Any already-delivered id in the
        block (a failed-over request completing on two paths) drops the
        block to the exact per-response handler, so duplicate accounting
        is byte-identical to the event engine."""
        ids = block.ids.tolist()
        if not self._delivered.isdisjoint(ids):
            for resp in block.responses():
                self._on_node_response(node, resp)
            return
        pending = node.pending
        for rid in ids:
            pending.pop(rid, None)
        self._delivered.update(ids)
        node.delivered += len(ids)
        block.node_id = node.node_id
        if node.ladder is not None:
            block.fidelity = node.rung
        self.responses.append_block(block)
        if self.on_response_block is not None:
            self.on_response_block(block)
        elif self.on_response is not None:
            for resp in block.responses():
                self.on_response(resp)

    @property
    def queue_depth(self) -> int:
        """Aggregate undispatched requests across live nodes (metrics
        queue sampler)."""
        return sum(n.server.dispatcher.queue_depth
                   for n in self.nodes if not n.dead)

    @property
    def workers_ever(self) -> List[WorkerInstance]:
        out: List[WorkerInstance] = []
        for n in self.nodes:
            out.extend(n.server.workers_ever)
        return out

    # ------------------------------------------------------------------ #
    # overload mode
    # ------------------------------------------------------------------ #
    def _degrade_step(self, node: FabricNode, now: float) -> None:
        """One step down the degrade ladder: fidelity rungs first (the
        node swaps to a cheaper model variant and replans against the
        rung's own profile), the batch floor only once the cheapest rung
        is already serving — and :meth:`submit` sheds only once the
        floor is pinned, so no request is ever shed while a lower rung
        remains feasible.  Without a ladder this is exactly the original
        batch-floor engagement."""
        if node.degraded or node.dead:
            return
        if node.ladder is not None and node.rung + 1 < len(node.ladder):
            self._set_rung(node, node.rung + 1, now)
            return
        self._engage_degrade(node, now)

    def _set_rung(self, node: FabricNode, rung: int, now: float) -> None:
        """Move the node to fidelity rung ``rung`` (either direction):
        swap the serving backend's cost table and the planning profile
        to the rung's variant, re-derive the overload plan against it
        (memoised fleet-wide by profile fingerprint — the PlanTable's
        fidelity axis), resize the admission bucket in place, and
        re-solve the node's configuration."""
        node.rung = rung
        node.fidelity_transitions += 1
        node.recovery_gate.reset()
        self.degrade_log.append((now, node.node_id, f"rung{rung}"))
        profile = node.ladder.rungs[rung].profile
        node.backend.set_profile(profile)
        node.server.optimizer.update_profile(profile)
        node.b_deg, node.thr_deg = self._derive_plan(node.server.optimizer)
        self._apply_plan(node, fresh_bucket=False)
        node.server.reconfigure(node.server.estimator.current_batch)

    def _engage_degrade(self, node: FabricNode, now: float) -> None:
        """Pin the node's estimator to the degrade batch: floors *and*
        ceiling move to the largest SLO-feasible batch, so the node
        serves at maximum SLO-honouring throughput instead of chasing
        queue depth into deadline-blowing batches."""
        if node.degraded or node.dead:
            return
        node.degraded = True
        node.degrade_engagements += 1
        self.degrade_log.append((now, node.node_id, "enter"))
        est = node.server.estimator.config
        est.min_batch = node.b_deg
        est.max_batch = node.b_deg
        node.server.reconfigure(node.b_deg)

    def _exit_degrade(self, node: FabricNode, now: float) -> None:
        if not node.degraded:
            return
        node.degraded = False
        self.degrade_log.append((now, node.node_id, "exit"))
        est = node.server.estimator.config
        est.min_batch = node.base_min_batch
        est.max_batch = node.base_max_batch

    def _tick(self) -> None:
        """Periodic overload check: step the degrade ladder on queue
        depth or a per-node λ̂ above the admission rate; recover in the
        *reverse* order — release the batch floor first (hysteresis: a
        quarter of the enter depth, λ̂ back under the degrade-batch
        throughput), then climb fidelity rungs one at a time, each step
        gated on a consecutive-calm-tick streak whose λ̂ also fits under
        the next-higher rung's sustainable throughput (with margin), so
        bursts neither flap the mode nor thrash rungs."""
        now = self.loop.now
        for node in self.nodes:
            if node.dead:
                continue
            depth = node.server.dispatcher.queue_depth
            lam = node.rate.rate(now)
            if not node.degraded and (depth >= node.degrade_depth
                                      or lam > node.admission_rps):
                self._degrade_step(node, now)
            elif node.degraded and (depth <= node.degrade_depth // 4
                                    and lam <= node.thr_deg):
                self._exit_degrade(node, now)
                node.recovery_gate.reset()
            elif (node.ladder is not None and not node.degraded
                  and node.rung > 0):
                target = node.rung - 1
                thr_up = self._derive_plan(
                    node.ladder.optimizer(target))[1]
                calm = (depth <= node.degrade_depth // 4
                        and lam <= self.fcfg.fidelity_recovery_margin
                        * thr_up)
                if node.recovery_gate.observe(calm):
                    self._set_rung(node, target, now)
        self.loop.schedule(self.fcfg.router_tick_interval, self._tick)

    # ------------------------------------------------------------------ #
    # drain / failure
    # ------------------------------------------------------------------ #
    def drain_node(self, index: int) -> int:
        """Stop routing to a node and re-route its *undispatched*
        requests; in-flight batches finish and deliver from the
        draining node.  Returns the number of requests moved."""
        node = self.nodes[index]
        if node.dead or node.draining:
            return 0
        node.draining = True
        self.drains += 1
        moved = node.server.dispatcher.reclaim_undispatched()
        for req in moved:
            node.pending.pop(req.id, None)
            self._route_admitted(req)
        return len(moved)

    def fail_node(self, index: int) -> int:
        """Kill a node: halt its control loop (no heartbeat respawns),
        fail its workers (in-flight completions on failed workers never
        deliver), and re-route every undelivered request it held.  The
        fleet-wide delivered set keeps delivery exactly-once even if a
        straggling path later produces a duplicate.  Returns the number
        of requests failed over."""
        node = self.nodes[index]
        if node.dead:
            return 0
        node.dead = True
        node.draining = False
        node.server.halted = True
        for w in node.server.dispatcher.instances:
            if not w.failed:
                w.fail()
        node.server.dispatcher.reclaim_undispatched()   # clear dead queues
        # the fast trace feed stores bare arrival times in the pending
        # map; requests are frozen value types, so rebuilding them here
        # is identity-free and the (arrival, id) order is unchanged
        orphans = sorted(
            (req if isinstance(req, Request) else Request(rid, req)
             for rid, req in node.pending.items()),
            key=lambda r: (r.arrival, r.id))
        node.pending.clear()
        self.failovers += len(orphans)
        for req in orphans:
            self._route_admitted(req)
        return len(orphans)

    # ------------------------------------------------------------------ #
    # reporting
    # ------------------------------------------------------------------ #
    def fastpath_report(self) -> Dict[str, object]:
        """Fleet-level fast-engine coverage: router trace counters plus
        every node dispatcher's own :meth:`fastpath_report`.  ``engine``
        is ``"fast"`` only when every node runs a vectorized dispatcher
        — a silent legacy fallback on any node shows up here."""
        per_node = {n.node_id: n.server.dispatcher.fastpath_report()
                    for n in self.nodes}
        fast = all(r["engine"] == "fast" for r in per_node.values())
        return {"engine": "fast" if fast else "event",
                "accelerated": fast,
                "absorbed": self.fast_absorbed,
                "one_by_one": self.fast_one_by_one,
                "per_node": per_node}

    def planning_report(self) -> Dict[str, object]:
        """Aggregated solver counters across all node optimizers —
        homogeneous fleets show one shared table (bench ``planning``
        section)."""
        return planning_report(n.server.optimizer for n in self.nodes)

    def fleet_report(self, now: float) -> Dict[str, object]:
        """JSON-serializable fleet section: routing/overload counters
        plus a per-node breakdown (the per-instance report is appended
        by the benchmark, which owns the metrics convention)."""
        per_node: Dict[str, Dict[str, object]] = {}
        for n in self.nodes:
            rlog = n.server.reconfig_log
            per_node[n.node_id] = {
                "routed": n.routed,
                "delivered": n.delivered,
                "shed": dict(sorted(n.shed_counts.items())),
                "pending": len(n.pending),
                "dead": n.dead,
                "draining": n.draining,
                "degraded": n.degraded,
                "degrade_engagements": n.degrade_engagements,
                "degrade_batch": n.b_deg,
                "admission_rate_rps": n.admission_rps,
                "arrival_rate_rps": n.rate.rate(now),
                "reconfigurations": len(rlog) - 1,
                "final_config": str(rlog[-1][2]),
                "expected_latency_ms": rlog[-1][2].latency * 1e3,
            }
            if n.ladder is not None:
                per_node[n.node_id]["fidelity_rung"] = n.rung
                per_node[n.node_id]["fidelity_transitions"] = \
                    n.fidelity_transitions
        fidelity: Optional[Dict[str, object]] = None
        if any(n.ladder is not None for n in self.nodes):
            fidelity = {
                n.node_id: {
                    "rungs": len(n.ladder),
                    "qualities": [r.quality for r in n.ladder.rungs],
                    "rung": n.rung,
                    "transitions": n.fidelity_transitions,
                    "recovery_steps": n.recovery_gate.opens,
                    "recovery_resets": n.recovery_gate.resets,
                }
                for n in self.nodes if n.ladder is not None
            }
        return {
            "nodes": len(self.nodes),
            "units_per_node": self.units_per_node,
            "offered": self.offered,
            "shed": len(self.sheds),
            "shed_rate": (len(self.sheds) / self.offered
                          if self.offered else 0.0),
            "rerouted": self.rerouted,
            "drains": self.drains,
            "failovers": self.failovers,
            "duplicates_suppressed": self.duplicates_suppressed,
            "degrade_log": [{"t": t, "node": nid, "event": ev}
                            for t, nid, ev in self.degrade_log],
            "per_node": per_node,
            **({"fidelity": fidelity} if fidelity is not None else {}),
        }


# --------------------------------------------------------------------- #
# fast trace feeding
# --------------------------------------------------------------------- #
def feed_fabric_trace(router: ClusterRouter, arrivals, *,
                      id_offset: int = 0) -> int:
    """Attach an arrival trace to a :class:`ClusterRouter` on a
    :class:`~repro.serving.fastsim.FastLoop` (ids in trace order, the
    legacy driver's ``enumerate``).

    Between heap events the absorber replays the router's per-request
    pipeline — the power-of-two-choices sample (the real RNG draw, so
    the Mersenne stream stays byte-identical), the picked node's λ̂
    observation and admission-token charge (both inlined into local
    floats and flushed on every window exit), then the degrade/shed
    checks — and delivers passive arrivals straight into the picked
    node's absorption window.  Only the *picked* node ever matters: an
    arrival the picked node must observe (a full batch meeting an idle
    worker, a degrade-mode engagement) is completed inline through the
    exact :meth:`FabricNodeServer.submit` machinery and ends the window,
    so one loaded node never forces the whole fleet onto the per-event
    path.  Degrade/shed/drain/fail transitions happen in heap events,
    which bound every window.  Returns the number of arrivals fed.
    """
    from .fastsim import (FastLoop,     # deferred: fastsim is optional
                          _SyncAbsorbWindow)
    loop = router.plane.loop
    if not isinstance(loop, FastLoop):
        raise TypeError("feed_fabric_trace needs a FastLoop router")
    times = np.ascontiguousarray(arrivals, dtype=np.float64)
    n = int(times.size)
    rng = router._rng
    sample = rng.sample
    # a plain Random's sample(seq, 2) consumes exactly _randbelow(n)
    # then _randbelow(n-1) from getrandbits — replay that inline (a
    # subclass could override the internals, so gate on the exact type)
    grb = rng.getrandbits if type(rng) is random.Random else None
    submit = router.submit
    shed = router._shed

    def arrive_one(i, t):
        router.fast_one_by_one += 1
        submit(Request(id_offset + i, t))

    def absorber(ts, cur, k_bound):
        cands = [nd for nd in router.nodes if nd.routable]
        ts_l = ts[cur:k_bound].tolist()
        consumed = 0
        if not cands:
            # every arrival in the window is a deterministic no-node
            # shed — Shed records carry the arrival time, exactly what
            # the per-event path would have stamped
            for t in ts_l:
                router.offered += 1
                shed(Request(id_offset + cur + consumed, t), None,
                     "no-node", t)
                consumed += 1
            router.fast_absorbed += consumed
            return consumed
        n_cands = len(cands)
        wins = []
        depths = []
        lat_eff = []
        tbs = []
        routed_add = []
        pendings = []
        dg_dep, sh_dep, dg_on = [], [], []
        # λ̂ / bucket state as locals; `flush` writes them back on every
        # window exit (heap events and the exact paths read the objects)
        r_last, r_mg, r_alpha = [], [], []
        b_tok, b_last, b_rate, b_burst = [], [], [], []
        # batch-sync windows get fully inlined: frozen policy state as
        # parallel lists, absorbed ids/arrivals buffered per node and
        # bulk-appended on window exit; any other window type keeps the
        # generic peek_one/absorb_one protocol
        w_sync = []
        w_qlen, w_B, w_ta, w_wa = [], [], [], []
        w_live, w_maxb, w_busys, w_pol, w_to = [], [], [], [], []
        buf_i, buf_t = [], []
        for nd in cands:
            d = nd.server.dispatcher
            begin = getattr(d, "begin_absorb_window", None)
            win = begin() if begin is not None else None
            if win is None:
                return 0        # legacy dispatcher / unusable state
            wins.append(win)
            depths.append(d.queue_depth)
            lat = d.config.latency
            cal = nd.server.calibrator
            if cal is not None:
                lat *= cal.global_ratio
            lat_eff.append(lat)
            tbs.append(max(1, d.config.total_batch))
            routed_add.append(0)
            pendings.append(nd.pending)
            dg_dep.append(nd.degrade_depth)
            sh_dep.append(nd.shed_depth)
            dg_on.append(nd.degraded)
            sig = nd.rate
            r_last.append(sig._last)
            r_mg.append(sig._mean_gap)
            r_alpha.append(sig.alpha)
            bk = nd.bucket
            b_tok.append(bk.tokens)
            b_last.append(bk._last)
            b_rate.append(bk.rate)
            b_burst.append(bk.burst)
            sync = type(win) is _SyncAbsorbWindow
            w_sync.append(sync)
            w_qlen.append(win.qlen if sync else 0)
            w_B.append(win.B if sync else 0)
            w_ta.append(win.timeout_armed if sync else False)
            w_wa.append(win.wakeup_armed if sync else False)
            w_live.append(win.has_live if sync else False)
            w_maxb.append(win.max_busy if sync else 0.0)
            w_busys.append(win.busys if sync else ())
            w_pol.append(d.policy)
            w_to.append(d.dcfg.batch_timeout if sync else 0.0)
            buf_i.append([])
            buf_t.append([])
        indices = {nd.index: m for m, nd in enumerate(cands)}
        if grb is not None and n_cands > 2:
            kb1 = n_cands.bit_length()
            ncm1 = n_cands - 1
            kb2 = ncm1.bit_length()
        loop_at = loop.at

        def flush():
            for m, nd in enumerate(cands):
                sig = nd.rate
                sig._last = r_last[m]
                sig._mean_gap = r_mg[m]
                bk = nd.bucket
                bk.tokens = b_tok[m]
                bk._last = b_last[m]
                nd.routed += routed_add[m]
                bi = buf_i[m]
                if bi:
                    d = nd.server.dispatcher
                    d.queue.extend_arrays(
                        np.array(bi, dtype=np.int64),
                        np.array(buf_t[m], dtype=np.float64))
                    d.fast_absorbed += len(bi)
                    buf_i[m] = []
                    buf_t[m] = []

        rid = id_offset + cur
        for t in ts_l:
            # replay submit() exactly: offered, P2C, λ̂, admission,
            # overload checks, then delivery — passive into the window,
            # or exact through the node server when it must observe
            if n_cands > 2:
                if grb is not None:
                    # random.sample(cands, 2): pool pick via
                    # _randbelow(n) then _randbelow(n - 1)
                    j1 = grb(kb1)
                    while j1 >= n_cands:
                        j1 = grb(kb1)
                    j2 = grb(kb2)
                    while j2 >= ncm1:
                        j2 = grb(kb2)
                    m2 = ncm1 if j2 == j1 else j2
                    s1 = lat_eff[j1] * (1.0 + depths[j1] / tbs[j1])
                    s2 = lat_eff[m2] * (1.0 + depths[m2] / tbs[m2])
                    # cands is in node-index order: ties break low-m
                    if s2 < s1 or (s2 == s1 and m2 < j1):
                        bm = m2
                    else:
                        bm = j1
                else:
                    pair = sample(cands, 2)
                    m1 = indices[pair[0].index]
                    m2 = indices[pair[1].index]
                    s1 = lat_eff[m1] * (1.0 + depths[m1] / tbs[m1])
                    s2 = lat_eff[m2] * (1.0 + depths[m2] / tbs[m2])
                    if s2 < s1 or (s2 == s1 and m2 < m1):
                        bm = m2
                    else:
                        bm = m1
            else:
                bm = 0
                bscore = lat_eff[0] * (1.0 + depths[0] / tbs[0])
                for m in range(1, n_cands):
                    score = lat_eff[m] * (1.0 + depths[m] / tbs[m])
                    if score < bscore:
                        bm, bscore = m, score
            # ArrivalRateSignal.observe(t), inlined
            last = r_last[bm]
            if last is not None:
                gap = t - last
                if gap < 1e-9:
                    gap = 1e-9
                mg = r_mg[bm]
                if mg is None:
                    r_mg[bm] = gap
                else:
                    a = r_alpha[bm]
                    r_mg[bm] = a * gap + (1.0 - a) * mg
            r_last[bm] = t
            # TokenBucket.take(t), inlined
            brate = b_rate[bm]
            if brate > 0.0:
                el = t - b_last[bm]
                if el < 0.0:
                    el = 0.0
                b_last[bm] = t
                tok = b_tok[bm] + el * brate
                burst = b_burst[bm]
                if tok > burst:
                    tok = burst
                if tok >= 1.0:
                    b_tok[bm] = tok - 1.0
                else:
                    b_tok[bm] = tok
                    shed(Request(rid, t), cands[bm], "admission", t)
                    rid += 1
                    consumed += 1
                    continue
            depth = depths[bm]
            if depth >= dg_dep[bm] and not dg_on[bm]:
                # stepping the degrade ladder (a fidelity rung or the
                # batch floor) reconfigures the node: flush, advance
                # the clock to the arrival (the oracle runs this inside
                # the arrival event), run submit()'s tail exactly, and
                # end the window
                best = cands[bm]
                flush()
                router.offered += consumed + 1
                if t > loop.now:
                    loop.now = t
                router._degrade_step(best, t)
                if best.degraded and depth >= best.shed_depth:
                    shed(Request(rid, t), best, "queue", t)
                else:
                    best.routed += 1
                    best.pending[rid] = t
                    best.server.submit(Request(rid, t))
                consumed += 1
                router.fast_absorbed += consumed
                return consumed
            if dg_on[bm] and depth >= sh_dep[bm]:
                shed(Request(rid, t), cands[bm], "queue", t)
                rid += 1
                consumed += 1
                continue
            if w_sync[bm]:
                ql = w_qlen[bm]
                armed = False
                if ql + 1 < w_B[bm]:
                    if not w_ta[bm]:
                        # on_arrival's timeout-arming branch, now == t
                        pol = w_pol[bm]
                        pol._timeout_armed = True
                        loop_at(t + w_to[bm], pol._on_timeout)
                        w_ta[bm] = True
                        armed = True
                elif (not w_live[bm]) or t < w_maxb[bm]:
                    if not w_wa[bm]:
                        # _try_dispatch's wake-up branch, now == t
                        pol = w_pol[bm]
                        if not w_live[bm]:
                            pol._wakeup_at(t + w_to[bm])
                        else:
                            pol._wakeup_at(min(b for b in w_busys[bm]
                                               if b > t))
                        w_wa[bm] = True
                        armed = True
                else:
                    # the picked node observes this arrival (a dispatch
                    # fires): advance the clock and deliver through the
                    # exact machinery — the heap changes, window ends
                    best = cands[bm]
                    flush()
                    router.offered += consumed + 1
                    if t > loop.now:
                        loop.now = t
                    best.routed += 1
                    best.pending[rid] = t
                    best.server.submit(Request(rid, t))
                    consumed += 1
                    router.fast_absorbed += consumed
                    return consumed
                routed_add[bm] += 1
                pendings[bm][rid] = t
                buf_i[bm].append(rid)
                buf_t[bm].append(t)
                w_qlen[bm] = ql + 1
                depths[bm] = depth + 1
                rid += 1
                consumed += 1
                if armed:
                    # the node armed a timer: this window's bound may
                    # be stale — stop and let the merge loop re-order
                    flush()
                    router.offered += consumed
                    router.fast_absorbed += consumed
                    return consumed
            else:
                win = wins[bm]
                if win.peek_one(t):
                    routed_add[bm] += 1
                    pendings[bm][rid] = t
                    win.absorb_one(rid, t)      # True: peek held
                    depths[bm] = depth + 1
                    rid += 1
                    consumed += 1
                    if win.armed_stop:
                        flush()
                        router.offered += consumed
                        router.fast_absorbed += consumed
                        return consumed
                else:
                    best = cands[bm]
                    flush()
                    router.offered += consumed + 1
                    if t > loop.now:
                        loop.now = t
                    best.routed += 1
                    best.pending[rid] = t
                    best.server.submit(Request(rid, t))
                    consumed += 1
                    router.fast_absorbed += consumed
                    return consumed
        flush()
        router.offered += consumed
        router.fast_absorbed += consumed
        return consumed

    loop.add_trace(times, arrive_one, absorber=absorber)
    return n


__all__ = ["ClusterRouter", "FabricConfig", "FabricNode",
           "FabricNodeServer", "FabricNodeSpec", "TokenBucket",
           "feed_fabric_trace"]
