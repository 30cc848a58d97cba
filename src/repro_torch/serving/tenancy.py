"""Multi-model resource plane: live tenants over a shared unit pool.

The paper contrasts Packrat with Clipper/Nexus-style systems that pack
multiple models onto shared resources (§6), and ``core/multimodel.py``
shows the ⟨i,t,b⟩ knapsack doubles as a placement policy across models.
This module lifts that from an offline helper into the live controller:

* a :class:`~repro.serving.allocator.ResourcePool` owns the T units and
  grants each model a disjoint :class:`~repro.serving.allocator.UnitLease`;
* each model runs a full :class:`~repro.serving.controller.ModelTenant`
  (estimator → knapsack → active-passive swaps → dispatcher → workers)
  *inside* its lease;
* the :class:`MultiModelServer` planning step re-runs
  :class:`~repro.core.multimodel.MultiModelAllocator` (binary search on
  the worst per-model latency) on every stable planning tick, using
  per-model demand estimates — the tenant's own smoothed batch B̃_m
  combined with a per-model :class:`~repro.core.estimator.ArrivalRateSignal`
  λ̂_m via Little's law — then resizes leases and lets each tenant's own
  knapsack re-solve within its new share.

A tenant mid-transition defers the plan to the next stable tick, the
same rule the single-model controller applies to overlapping
reconfigurations; a re-plan therefore never strands a passive worker
set.  With one tenant the plane degenerates to exactly the single-model
:class:`~repro.serving.controller.PackratServer` loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..core.estimator import ArrivalRateSignal
from ..core.knapsack import (PackratOptimizer, PlanTableRegistry, Profile,
                             planning_report)
from ..core.multimodel import ModelWorkload, MultiModelAllocator
from .allocator import ResourcePool
from .controller import ControllerConfig, ModelTenant
from .instance import LatencyBackend, WorkerInstance
from .plane import ExecutionPlane, as_plane
from .simulator import EventLoop, Request, Response


@dataclasses.dataclass
class TenantSpec:
    """What the resource plane needs to host one model."""

    model_id: str
    profile: Profile                    # L[t,b] planning table
    backend: LatencyBackend
    initial_batch: int = 8
    optimizer: Optional[PackratOptimizer] = None   # default: ≤-units relaxed

    def build_optimizer(self) -> PackratOptimizer:
        if self.optimizer is not None:
            return self.optimizer
        # the planner's share may strand threads (Σ T_m < T per model);
        # the ≤-units relaxation keeps every share size solvable and the
        # per-model latency monotone in the share — the property the
        # λ-binary-search depends on
        return PackratOptimizer(self.profile, allow_unused_threads=True)


def even_shares(total_units: int, tenant_ids: Sequence[str]
                ) -> Dict[str, int]:
    """The info-free unit split: ``total // n`` each, remainder to the
    earliest tenants.  Shared by the server's initial grant and the
    benchmark's static even-split baseline so the two never drift."""
    base, extra = divmod(total_units, len(tenant_ids))
    return {m: base + (1 if k < extra else 0)
            for k, m in enumerate(tenant_ids)}


class MultiModelServer:
    """Several model tenants sharing one pod's units, re-split live.

    Build it from one :class:`TenantSpec` per model and submit requests
    tagged with a ``model_id``; the server routes each to its tenant's
    own controller and re-plans the unit split on a periodic tick:

    >>> server = MultiModelServer(loop, total_units=16, tenants=[
    ...     TenantSpec("resnet50", profile_r, TabulatedBackend(profile_r)),
    ...     TenantSpec("bert", profile_b, TabulatedBackend(profile_b))])
    >>> server.submit(Request(0, 0.0, model_id="bert"))

    Aggregated state: ``responses`` (all tenants, delivery order),
    ``queue_depth`` (fleet queue sampler hook), ``shares()`` (current
    per-model unit split), ``plan_log`` (every executed re-plan).
    ``adaptive=False`` freezes the initial even split and never re-plans
    — the static even-split baseline the benchmark compares against.
    """

    def __init__(self, loop: EventLoop, *, total_units: int,
                 tenants: Sequence[TenantSpec],
                 config: Optional[ControllerConfig] = None,
                 domain_size: Optional[int] = None,
                 adaptive: bool = True,
                 plan_interval: Optional[float] = None,
                 replan_margin: float = 0.3,
                 peak_windows: int = 3) -> None:
        if not tenants:
            raise ValueError("need at least one tenant")
        ids = [s.model_id for s in tenants]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate tenant model_ids: {ids}")
        if total_units < len(tenants):
            raise ValueError(
                f"{total_units} units cannot host {len(tenants)} tenants")
        # one plane instance is shared by every tenant — a single time
        # source and (for RealPlane) a single unit gate; tenants see it
        # through the EventLoop-compatible interface
        self.plane: ExecutionPlane = as_plane(loop)
        self.loop = self.plane
        self.total_units = total_units
        self.ccfg = config or ControllerConfig()
        self.adaptive = adaptive
        self.replan_margin = replan_margin
        self.plan_interval = (plan_interval if plan_interval is not None
                              else self.ccfg.estimator.reconfigure_timeout)
        self.pool = ResourcePool(total_units, domain_size)
        self._specs: Dict[str, TenantSpec] = {s.model_id: s for s in tenants}
        self._order: List[str] = list(ids)
        self._opts: Dict[str, PackratOptimizer] = {
            s.model_id: s.build_optimizer() for s in tenants}
        # one plan-table registry per server: tenants serving the same
        # profile (replicas of one model under different ids) share one
        # DP table and its ⟨T,B⟩ plan cache across every re-plan
        self.plan_registry = PlanTableRegistry()
        for opt in self._opts.values():
            opt.adopt_registry(self.plan_registry)
        self.rates: Dict[str, ArrivalRateSignal] = {
            m: ArrivalRateSignal(alpha=self.ccfg.estimator.alpha)
            for m in self._order}
        # windowed arrival counts: the planner's λ̂_m.  The per-gap EWMA
        # above is the *instantaneous* per-tenant telemetry (its memory
        # is a handful of inter-arrival gaps — milliseconds at high
        # request rates — so a plan keyed on it starves a tenant
        # whenever the estimate happens to dip); a count over the whole
        # plan window is stable (±√N) at exactly the cadence plans are
        # made, and is what the planner consumes.
        self._counts: Dict[str, int] = {m: 0 for m in self._order}
        self._win_counts: Dict[str, int] = dict(self._counts)
        self._win_start: float = self.plane.now
        # peak-hold over the last `peak_windows` plan windows: a bursty
        # tenant keeps the units its recent peak needed instead of being
        # shrunk the moment a quiet dwell starts (and re-grown a full
        # reconfiguration too late into the next burst)
        self.peak_windows = max(1, peak_windows)
        self._recent_rates: Dict[str, List[float]] = {
            m: [] for m in self._order}
        self.responses: List[Response] = []
        self.plan_log: List[Tuple[float, Dict[str, int], Dict[str, int]]] = []
        self._last_plan = self.plane.now

        shares = self._initial_shares()
        self.tenants: Dict[str, ModelTenant] = {}
        for spec in tenants:
            lease = self.pool.grant(spec.model_id, shares[spec.model_id])
            batch = self._feasible_batch(self._opts[spec.model_id],
                                         lease.n_units, spec.initial_batch)
            self.tenants[spec.model_id] = ModelTenant(
                self.plane, total_units=lease.n_units,
                optimizer=self._opts[spec.model_id], backend=spec.backend,
                initial_batch=batch, allocator=lease.allocator,
                config=self.ccfg, model_id=spec.model_id,
                on_response=self._record_response,
                peer_live=self._peer_live_fn(spec.model_id))
        self._adopt_block_sinks()
        self.plan_log.append((self.plane.now, dict(shares), {
            m: self.tenants[m].estimator.current_batch for m in self._order}))
        self._schedule_tick()

    # ------------------------------------------------------------------ #
    # initial split
    # ------------------------------------------------------------------ #
    def _initial_shares(self) -> Dict[str, int]:
        # no traffic has been observed yet, so the even split is the only
        # defensible prior — a latency-balanced split at the initial
        # batches would starve a fast-but-popular model until the first
        # plan corrects it
        return even_shares(self.total_units, self._order)

    @staticmethod
    def _feasible_batch(opt: PackratOptimizer, units: int, batch: int) -> int:
        """Halve ``batch`` until the knapsack is solvable in ``units``."""
        while batch > 1:
            try:
                opt.solve(units, batch)
                return batch
            except ValueError:
                batch //= 2
        return 1

    def _peer_live_fn(self, model_id: str):
        """Live workers of every *other* tenant: interference backends
        must see the pod-wide instance count — the tenants share the
        machine's clocks and memory controllers even though their unit
        leases are disjoint."""

        def peer_live() -> int:
            return sum(
                sum(1 for w in t.dispatcher.instances if not w.failed)
                for m, t in self.tenants.items() if m != model_id)

        return peer_live

    def _record_response(self, resp: Response) -> None:
        """Per-response aggregation sink (legacy engine).  Indirect so
        block adoption can replace ``self.responses`` wholesale without
        stranding a bound method on the old list."""
        self.responses.append(resp)

    def _adopt_block_sinks(self) -> None:
        """When every tenant's dispatcher is block-capable (fast plane),
        switch the aggregate response stream to block granularity: each
        tenant adopts its own block log and chains every block into one
        shared :class:`~repro.serving.fastsim.ResponseLog`.  Blocks land
        at the same completion events, in the same order, as the legacy
        per-response appends — the aggregate materializes byte-identical
        ``Response`` sequences across both engines."""
        if not all(getattr(t.dispatcher, "supports_blocks", False)
                   for t in self.tenants.values()):
            return
        from .fastsim import ResponseLog   # deferred: fastsim is optional
        agg = ResponseLog()
        for m in self._order:
            self.tenants[m].adopt_block_sink(agg.append_block)
        self.responses = agg

    # ------------------------------------------------------------------ #
    # request path
    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        tenant = self.tenants.get(req.model_id)
        if tenant is None:
            raise KeyError(f"no tenant for model {req.model_id!r}; "
                           f"serving {self._order}")
        self.rates[req.model_id].observe(self.loop.now)
        self._counts[req.model_id] += 1
        tenant.submit(req)

    @property
    def queue_depth(self) -> int:
        """Aggregate undispatched requests (metrics queue sampler)."""
        return sum(t.dispatcher.queue_depth for t in self.tenants.values())

    @property
    def workers_ever(self) -> List[WorkerInstance]:
        out: List[WorkerInstance] = []
        for m in self._order:
            out.extend(self.tenants[m].workers_ever)
        return out

    def shares(self) -> Dict[str, int]:
        return {m: self.pool.lease_of(m).n_units for m in self._order}

    def planning_report(self) -> Dict[str, object]:
        """Aggregated solver counters across all tenants' optimizers —
        shared tables deduplicated, so same-profile tenants show one
        table with a plan-cache hit rate (bench ``planning`` section)."""
        return planning_report(self._opts.values())

    def fastpath_report(self) -> Dict[str, object]:
        """Per-tenant fast-engine coverage (see
        :meth:`~repro.serving.dispatcher.Dispatcher.fastpath_report`):
        a silent legacy fallback on any tenant shows up here."""
        per_model = {m: self.tenants[m].dispatcher.fastpath_report()
                     for m in self._order}
        fast = all(r["engine"] == "fast" for r in per_model.values())
        return {"engine": "fast" if fast else "event",
                "accelerated": fast,
                "absorbed": sum(r["absorbed"] for r in per_model.values()),
                "one_by_one": sum(r["one_by_one"]
                                  for r in per_model.values()),
                "per_model": per_model}

    # ------------------------------------------------------------------ #
    # control loop
    # ------------------------------------------------------------------ #
    def _schedule_tick(self) -> None:
        self.loop.schedule(self.ccfg.tick_interval, self._tick)

    def _tick(self) -> None:
        # the planner owns batch adaptation: tenants tick with their own
        # estimator-triggered reconfiguration disabled
        for m in self._order:
            self.tenants[m].tick(adapt_batch=False)
        if self.adaptive:
            self._maybe_plan()
        self._schedule_tick()

    # ------------------------------------------------------------------ #
    # planning step
    # ------------------------------------------------------------------ #
    def _rate_matched_batch(self, model_id: str, rate: float) -> int:
        """Smallest power-of-two batch whose optimal configuration
        *within the tenant's current share* sustains λ̂_m.

        Throughput matching, not Little's-law sizing: ``B = λ̂·L(B_cur)``
        inflates the demand estimate precisely when the current batch is
        already too large (bigger batch → longer makespan → even bigger
        estimate), a positive feedback loop that pins every tenant at
        ``max_batch``.  If even the largest feasible batch cannot keep
        up inside the share, that batch is returned — its ballooning
        latency is what makes the planner grant the tenant more units.
        """
        opt = self._opts[model_id]
        units = self.tenants[model_id].total_units
        ecfg = self.ccfg.estimator
        best = ecfg.min_batch
        b = max(1, ecfg.min_batch)
        while b <= ecfg.max_batch:
            try:
                cfg = opt.solve(units, b)
            except ValueError:
                break
            best = b
            if cfg.throughput >= rate:
                return b
            b *= 2
        return best

    def _window_rates(self, now: float) -> Dict[str, float]:
        """Per-model λ̂ over the window since the last executed plan.

        The :class:`ArrivalRateSignal` EWMA is only a defensive fallback
        for a zero-length window (unreachable under the tick scheduler,
        possible if a caller drives plans manually at one timestamp)."""
        window = now - self._win_start
        out: Dict[str, float] = {}
        for m in self._order:
            if window > 0.0:
                out[m] = (self._counts[m] - self._win_counts[m]) / window
            else:
                out[m] = self.rates[m].rate(now)
        return out

    def _update_peaks(self, current: Mapping[str, float]
                      ) -> Dict[str, float]:
        """Fold the current window into the peak-hold history and return
        the per-model peak rate over the last ``peak_windows`` plans."""
        out: Dict[str, float] = {}
        for m in self._order:
            recent = self._recent_rates[m]
            recent.append(current[m])
            del recent[:-self.peak_windows]
            out[m] = max(recent)
        return out

    def _snapshot_window(self, now: float) -> None:
        self._win_start = now
        self._win_counts = dict(self._counts)

    def _desired_batch(self, model_id: str, rate: float) -> int:
        """Per-model demand estimate B̃_m: the max of the tenant's
        smoothed queue-depth batch (§3.8, scoped to its own dispatcher)
        and the throughput-matched batch for the arrival rate λ̂_m — the
        latter catches a tenant whose lease is so small its queue signal
        saturates at the lease's servable batch."""
        tenant = self.tenants[model_id]
        ecfg = self.ccfg.estimator
        b = tenant.estimator.smoothed_batch()
        if rate > 0.0:
            b = max(b, self._rate_matched_batch(model_id, rate))
        b = max(ecfg.min_batch, min(b, ecfg.max_batch))
        return self._feasible_batch(self._opts[model_id],
                                    self.total_units, b)

    def _share_latency(self, model_id: str, units: int, batch: int,
                       min_rate: float = 0.0) -> float:
        """Optimal makespan of ``batch`` inside ``units`` — inf when
        infeasible *or* unable to sustain ``min_rate`` (an undersized
        share serving fast batches it cannot keep up with is not
        better than a relocation)."""
        try:
            cfg = self._opts[model_id].solve(units, batch)
        except ValueError:
            return float("inf")
        if min_rate > 0.0 and cfg.throughput < min_rate:
            return float("inf")
        return cfg.latency

    def _plan_shares(self, desired: Mapping[str, int],
                     floors: Mapping[str, float]) -> Dict[str, int]:
        workloads = [ModelWorkload(m, self._specs[m].profile,
                                   batch=desired[m], min_rate=floors[m])
                     for m in self._order]
        mma = MultiModelAllocator(workloads, optimizers=self._opts)
        placements = mma.allocate(self.total_units, prior=self.shares())
        return {p.name: p.units for p in placements}

    def _maybe_plan(self) -> None:
        now = self.loop.now
        if now - self._last_plan < self.plan_interval:
            return
        if not all(t.stable for t in self.tenants.values()):
            return   # retry on the next tick once transitions settle
        self._last_plan = now
        current_rates = self._window_rates(now)
        self._snapshot_window(now)
        peak_rates = self._update_peaks(current_rates)
        headroom = 1.0 + self.ccfg.estimator.headroom
        current_b = {m: self.tenants[m].estimator.current_batch
                     for m in self._order}
        current_s = self.shares()
        # plan against the peak-hold rates first (shrink resistance for
        # bursty tenants); if the recent peaks are *jointly* infeasible —
        # anti-correlated tenants whose peaks never coincide — fall back
        # to the current-window rates so the tenant peaking right now
        # can still claim units from the one that has gone quiet
        shares = desired = floors = None
        for lam in ((peak_rates, current_rates)
                    if peak_rates != current_rates else (current_rates,)):
            desired = {m: self._desired_batch(m, lam[m])
                       for m in self._order}
            floors = {m: lam[m] * headroom for m in self._order}
            try:
                shares = self._plan_shares(desired, floors)
            except ValueError:
                shares = None
                continue
            if all(self._share_latency(m, shares[m], desired[m], floors[m])
                   < float("inf") for m in self._order):
                break
            shares = None
        if shares is None:
            return   # jointly infeasible demand; keep the current split
        if shares != current_s:
            # hysteresis: moving units costs each relocated tenant an
            # active-passive transition, so only re-split when the planned
            # worst per-model latency improves by a real margin — noisy
            # demand estimates otherwise thrash ±1 unit every plan
            cur_worst = max(self._share_latency(m, current_s[m], desired[m],
                                                floors[m])
                            for m in self._order)
            new_worst = max(self._share_latency(m, shares[m], desired[m],
                                                floors[m])
                            for m in self._order)
            if new_worst >= (1.0 - self.replan_margin) * cur_worst:
                shares = current_s
        if shares == current_s and desired == current_b:
            return
        self.plan_log.append((now, dict(shares), dict(desired)))
        leases = self.pool.split(shares)
        for m in self._order:
            tenant, lease = self.tenants[m], leases[m]
            if lease.allocator is not tenant.allocator:
                # resized or span-moved lease: workers must move onto the
                # new units even if the ⟨i,t,b⟩ shape ends up identical
                tenant.relocate(lease, desired[m])
            elif desired[m] != tenant.estimator.current_batch:
                tenant.reconfigure(desired[m])


__all__ = ["MultiModelServer", "TenantSpec", "even_shares"]
