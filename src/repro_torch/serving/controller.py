"""The Packrat serving controller (paper §3.1 architecture, Fig. 3).

Ties every component together on the event loop:

  requests → Dispatcher (aggregate B, partition per ⟨i,t,b⟩)
           → WorkerInstances (latency backend)
  queue depth → BatchSizeEstimator (EWMA + mode, §3.8)
              → PackratOptimizer (2-D knapsack, §3.3) when B̃ ≠ B
              → ResourceAllocator (§3.4)
              → ActivePassiveController (zero-downtime swap, §3.7)

The per-model machinery lives in :class:`ModelTenant`: one model's
estimator, optimizer, dispatcher, worker sets and active-passive state,
operating inside whatever unit allocator it is handed.  A
:class:`PackratServer` is the single-model special case — one tenant
owning the whole pool, driven by the server's periodic tick — and its
behaviour is bit-identical to the pre-tenant controller (pinned by the
golden-timeline hash in tests/test_policy.py).  The multi-model plane
(``serving/tenancy.py``) instead runs several tenants against leases
granted by a shared :class:`~repro.serving.allocator.ResourcePool`.

Fault tolerance: worker failures are detected by heartbeat ticks and the
worker is respawned (TorchServe behaviour, §4); elastic scaling re-runs
the optimizer with the surviving unit count T′ — on TPU this is exactly
how Packrat doubles as an elastic-scaling policy (DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from ..core.estimator import BatchSizeEstimator, EstimatorConfig
from ..core.knapsack import PackratConfig, PackratOptimizer
from ..core.profiler import ProfileCalibrator
from ..core.reconfig import (ActivePassiveController, Phase,
                             needs_active_passive)
from .allocator import ResourceAllocator, UnitLease
from .dispatcher import Dispatcher, DispatcherConfig
from .instance import LatencyBackend, WorkerInstance
from .plane import ExecutionPlane, as_plane
from .policy import make_policy
from .simulator import DEFAULT_MODEL, EventLoop, Request, Response


@dataclasses.dataclass
class ControllerConfig:
    estimator: EstimatorConfig = dataclasses.field(default_factory=EstimatorConfig)
    dispatcher: DispatcherConfig = dataclasses.field(default_factory=DispatcherConfig)
    tick_interval: float = 0.100          # queue-depth sampling period
    worker_spawn_time: float = 0.600      # per-worker start+load cost (§5.3.2)
    worker_respawn_time: float = 0.600
    drain_time: float = 0.250
    dispatch_policy: str = "sync"         # "sync" (paper) or "continuous"


class ModelTenant:
    """One model's serving plane inside a unit allocation.

    Owns the §3.1 loop for a single model: estimator → knapsack →
    active-passive swaps → dispatcher → workers.  The allocator it
    places instances on is injected — the whole pool for a
    :class:`PackratServer`, a :class:`~repro.serving.allocator.UnitLease`
    allocator under the multi-model resource plane — and can be swapped
    at a stable point via :meth:`relocate`.
    """

    def __init__(self, loop: EventLoop, *, total_units: int,
                 optimizer: PackratOptimizer, backend: LatencyBackend,
                 initial_batch: int, allocator: ResourceAllocator,
                 config: Optional[ControllerConfig] = None,
                 model_id: str = DEFAULT_MODEL,
                 on_response: Optional[Callable[[Response], None]] = None,
                 peer_live: Optional[Callable[[], int]] = None,
                 calibrator: Optional[ProfileCalibrator] = None,
                 on_plan_apply: Optional[Callable[[PackratConfig], None]]
                 = None) -> None:
        """``loop`` may be a raw :class:`EventLoop` or any
        :class:`~repro.serving.plane.ExecutionPlane` — the tenant is
        plane-agnostic.  ``calibrator`` enables the closed profile-
        refinement loop: every completed batch's observed latency feeds
        it, and once the expected-vs-observed correction drifts past
        its threshold the optimizer is rebuilt from the calibrated
        ``L[t,b]`` table and the knapsack re-solves (Fig. 9, closed).
        ``on_plan_apply`` is called with each newly spawned plan's
        :class:`PackratConfig` (initial spawn and every reconfiguration,
        at passive-spawn time for active-passive swaps) — the real
        plane's compile-ahead warm-up hook, so the first request after a
        replan never eats a jit compile stall."""
        self.plane: ExecutionPlane = as_plane(loop)
        self.loop = self.plane          # plane is EventLoop-compatible
        self.model_id = model_id
        self.total_units = total_units
        self.optimizer = optimizer
        self.backend = backend
        self.ccfg = config or ControllerConfig()
        self.allocator = allocator
        self._next_worker_id = 0   # tenant-owned: survives lease changes
        self.estimator = BatchSizeEstimator(self.ccfg.estimator,
                                            initial_batch=initial_batch)
        self.responses: List[Response] = []
        self._extra_on_response = on_response
        self.reconfig_log: List[Tuple[float, int, PackratConfig]] = []
        self._placements: Dict[int, Tuple[ResourceAllocator, list]] = {}
        self._workers_by_cfg: Dict[int, List[WorkerInstance]] = {}
        self._pending_workers: Optional[List[WorkerInstance]] = None
        self._deferred_batch: Optional[int] = None
        self._draining_cfg: Optional[PackratConfig] = None
        self.workers_ever: List[WorkerInstance] = []   # for metrics reports

        self.on_plan_apply = on_plan_apply
        first = self.optimizer.solve(total_units, initial_batch)
        self.apc = ActivePassiveController(
            spawn_cost=self._spawn_cost, drain_cost=self._drain_cost,
            on_swap=self._on_swap)
        self.apc.start(first, now=self.plane.now)
        workers = self._spawn_workers(first)
        self._plan_applied(first)
        self.dispatcher = self.plane.make_dispatcher(
            first, workers, self._on_response, self.ccfg.dispatcher,
            policy=make_policy(self.ccfg.dispatch_policy),
            model_id=model_id, peer_live=peer_live)
        # a block-capable dispatcher (fast plane) delivers completions as
        # per-sub-batch blocks; adopt its block log as the response sink.
        # Callers that installed their own per-response hook (the cluster
        # fabric, the multi-model server) keep the exact per-item path
        # unless they opt into blocks via :meth:`adopt_block_sink`.
        if self._extra_on_response is None:
            self.adopt_block_sink()
        self.calibrator = calibrator
        self.calibration_refreshes = 0
        self.calibration_refreshes_skipped = 0
        if calibrator is not None:
            self.dispatcher.on_measure = calibrator.observe
        self.reconfig_log.append((self.plane.now, initial_batch, first))

    # ------------------------------------------------------------------ #
    # workers
    # ------------------------------------------------------------------ #
    def _spawn_cost(self, config: PackratConfig) -> float:
        # workers start concurrently; cost ≈ slowest worker + const (the
        # paper measures ~5 s for a full reconfiguration on TorchServe)
        return self.ccfg.worker_spawn_time * max(
            1.0, 1.0 + 0.1 * config.n_instances)

    def _drain_cost(self, config: PackratConfig) -> float:
        # under continuous dispatch the outgoing instance set may still
        # hold queued work in per-instance queues — drain waits on that,
        # not just on busy_until (extra is 0 for batch-sync)
        extra = 0.0
        dispatcher = getattr(self, "dispatcher", None)
        if dispatcher is not None:
            extra = dispatcher.estimated_extra_drain(self.loop.now)
        return self.ccfg.drain_time + extra

    def _spawn_workers(self, config: PackratConfig) -> List[WorkerInstance]:
        allocator = self.allocator
        placements = allocator.allocate(config)
        workers = []
        for p in placements:
            # ids come from the tenant, not the placing allocator: a
            # relocation hands the tenant a fresh lease allocator whose
            # counter restarts, and (model_id, id) must stay unique
            # across the tenant's whole worker history
            w = WorkerInstance(self._next_worker_id, p.threads, p.batch,
                               self.backend, units=p.units,
                               spawned_at=self.loop.now,
                               model_id=self.model_id)
            self._next_worker_id += 1
            workers.append(w)
        # releases must target the allocator that placed the workers —
        # the tenant may have adopted a new lease by drain time
        self._placements[id(config)] = (allocator, placements)
        self._workers_by_cfg[id(config)] = workers
        self.workers_ever.extend(workers)
        return workers

    def _plan_applied(self, config: PackratConfig) -> None:
        """Notify the plan-apply hook (compile-ahead warm-up)."""
        if self.on_plan_apply is not None:
            self.on_plan_apply(config)

    def _release_workers(self, config: PackratConfig) -> None:
        entry = self._placements.pop(id(config), None)
        if entry:
            allocator, placements = entry
            allocator.release(placements)
        for w in self._workers_by_cfg.pop(id(config), ()):
            w.released_at = self.loop.now   # bounds utilization accounting
            self.plane.release_worker(w)    # frees per-worker resources

    # ------------------------------------------------------------------ #
    # request/response path
    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        self.dispatcher.on_request(req)

    def _on_response(self, resp: Response) -> None:
        self.responses.append(resp)
        if self._extra_on_response is not None:
            self._extra_on_response(resp)

    def adopt_block_sink(self, on_block=None) -> bool:
        """Switch a block-capable dispatcher to block-granular delivery.

        The dispatcher's fresh :class:`~repro.serving.fastsim.ResponseLog`
        becomes this tenant's ``responses`` sink (list-compatible, so all
        report code runs unchanged).  ``on_block``, when given, is called
        with every delivered block *after* it lands in the tenant log —
        the aggregation hook for the multi-model server and the cluster
        fabric, which replace their per-response ``on_response`` chains
        with a block chain of identical delivery order.  Returns False
        (and changes nothing) when the dispatcher has no block surface
        (legacy engine), letting callers fall back to the per-item path.
        """
        attach = getattr(self.dispatcher, "attach_block_log", None)
        if attach is None:
            return False
        log = attach()
        self.responses = log
        if on_block is not None:
            def chained(block, _log=log, _cb=on_block):
                _log.append_block(block)
                _cb(block)
            self.dispatcher.on_response_block = chained
        return True

    # ------------------------------------------------------------------ #
    # control loop (driven by the owning server's periodic tick)
    # ------------------------------------------------------------------ #
    def tick(self, *, adapt_batch: bool = True) -> None:
        """One control-loop step: estimator sample, APC progress, drained
        set release, deferred reconfigure, and (``adapt_batch``) the
        estimator-triggered reconfiguration check.  The multi-model
        planner disables ``adapt_batch`` and drives batch changes itself."""
        self.estimator.observe(self.dispatcher.take_signal())
        self.apc.tick(self.loop.now)
        if self.apc.phase is Phase.STABLE:
            # the drained set is released on the APC's own transition to
            # STABLE (never from a pre-computed completion estimate, which
            # can lag it when drain cost is re-evaluated over a different
            # instance set) so a follow-up reconfigure can always allocate
            if self._draining_cfg is not None:
                self._release_workers(self._draining_cfg)
                self._draining_cfg = None
            if self._deferred_batch is not None:
                deferred, self._deferred_batch = self._deferred_batch, None
                self.reconfigure(deferred)
        if adapt_batch and self.apc.phase is Phase.STABLE:
            new_b = self.estimator.should_reconfigure(self.loop.now)
            if new_b is not None:
                self.reconfigure(new_b)
        if (adapt_batch and self.calibrator is not None
                and self.apc.phase is Phase.STABLE
                and self.calibrator.should_refresh(self.loop.now)):
            self._refresh_optimizer()
        self._check_workers()

    @property
    def stable(self) -> bool:
        return self.apc.phase is Phase.STABLE

    def _refresh_optimizer(self) -> None:
        """Close the profile-refinement loop: apply the calibrated
        ``L[t,b]`` table to the optimizer as a new planning epoch
        (:meth:`PackratOptimizer.update_profile` — one table rebuild,
        not a fresh optimizer) and re-solve at the current batch.  If
        the calibrated costs pick the same ⟨i,t,b⟩ partition the
        identical-configuration shortcut makes this free; when they do
        not, the active-passive machinery swaps as usual.

        Identity corrections are gated out entirely: when the calibrated
        profile equals what the optimizer already plans against (the
        drift the calibrator saw cancelled back out by refresh time),
        rebuilding and re-solving would change nothing — skip the epoch,
        re-arm the calibrator window, and count the skip.
        """
        cal = self.calibrator
        calibrated = cal.calibrated_profile()
        if calibrated == self.optimizer.profile:
            cal.mark_refreshed(self.loop.now, applied=False)
            self.calibration_refreshes_skipped += 1
            return
        self.optimizer.update_profile(calibrated)
        cal.mark_refreshed(self.loop.now)
        self.calibration_refreshes += 1
        self.reconfigure(self.estimator.current_batch)

    def reconfigure(self, new_batch: int, *,
                    force_respawn: bool = False) -> None:
        """Run the optimizer for B̃ and transition via active-passive.

        An over-estimated B̃ (queue backlog during overload can exceed
        the largest servable batch T×b_max) is halved until feasible —
        the largest feasible batch is also the throughput-optimal
        response to overload.

        A reconfiguration requested while a transition is already in
        flight is *deferred* (latest request wins, applied on the next
        stable tick) — spawning a second passive set mid-swap would
        clobber ``_pending_workers`` and strand the first passive set's
        allocator units.

        ``force_respawn`` disables the identical-configuration shortcut:
        a lease relocation must move workers onto the new units even
        when the ⟨i,t,b⟩ shape is unchanged, else they keep running on
        units that now belong to another tenant.
        """
        if self.apc.phase is not Phase.STABLE:
            self._deferred_batch = new_batch
            return
        new_cfg = None
        while new_batch >= 1:
            try:
                new_cfg = self.optimizer.solve(self.total_units, new_batch)
                break
            except ValueError:
                new_batch //= 2
        if new_cfg is None:
            return
        self.estimator.commit(new_batch)
        old_cfg = self.apc.active
        if (old_cfg is not None and new_cfg.groups == old_cfg.groups
                and not force_respawn):
            return
        if old_cfg is not None and not needs_active_passive(old_cfg, new_cfg):
            # paper case 1: same per-worker thread counts — plain worker
            # scaling, no active-passive transition needed.
            self._release_workers(old_cfg)
            workers = self._spawn_workers(new_cfg)
            self._plan_applied(new_cfg)
            self.dispatcher.set_config(new_cfg, workers)
            self.apc.start(new_cfg, now=self.loop.now)
            self.reconfig_log.append((self.loop.now, new_batch, new_cfg))
            return
        # paper case 2: thread counts change — spawn the passive set now
        # (resources oversubscribe transiently), swap when ready; the old
        # set is released when the APC finishes draining (see tick).
        new_workers = self._spawn_workers(new_cfg)
        self._plan_applied(new_cfg)
        self.apc.request_reconfig(new_cfg, self.loop.now)
        self.reconfig_log.append((self.loop.now, new_batch, new_cfg))
        self._pending_workers = new_workers
        self._draining_cfg = old_cfg

    def _on_swap(self, new_cfg: PackratConfig) -> None:
        self.dispatcher.set_config(new_cfg, self._pending_workers)

    # ------------------------------------------------------------------ #
    # lease relocation (multi-model resource plane)
    # ------------------------------------------------------------------ #
    def relocate(self, lease: UnitLease, batch: int) -> bool:
        """Re-solve the knapsack inside a new lease and move onto it.

        Worker respawn is forced even when the resulting ⟨i,t,b⟩ shape
        is unchanged (a same-size span move): the tenant's workers must
        vacate units that may now belong to another tenant's lease.
        Draining sets keep releasing against the allocator that placed
        them.  Returns False (and changes nothing) while a transition
        is in flight — the planner retries on its next stable tick.
        """
        if self.apc.phase is not Phase.STABLE:
            return False
        self.allocator = lease.allocator
        self.total_units = lease.n_units
        self.reconfigure(batch, force_respawn=True)
        return True

    # ------------------------------------------------------------------ #
    # fault tolerance
    # ------------------------------------------------------------------ #
    def inject_failure(self, instance_idx: int = 0) -> None:
        """Kill a live worker (tests/benchmarks call this)."""
        live = [w for w in self.dispatcher.instances if not w.failed]
        if live:
            live[instance_idx % len(live)].fail()

    def _check_workers(self) -> None:
        """Heartbeat: respawn dead workers (TorchServe §4 behaviour)."""

        def respawn(w):
            if not w.failed:
                return   # an earlier heartbeat's respawn already landed
            w.respawn(self.loop.now)
            self.dispatcher.notify_respawn(w)

        for w in self.dispatcher.instances:
            if w.failed:
                self.loop.schedule(self.ccfg.worker_respawn_time,
                                   lambda w=w: respawn(w))

class PackratServer(ModelTenant):
    """A single-model Packrat serving endpoint on one server/pod.

    The one-tenant special case of the resource plane: the tenant owns
    an allocator over the whole pool and the server's periodic tick
    drives its control loop directly.  Everything the paper's §3.1
    controller does happens behind :meth:`submit`:

    >>> loop = EventLoop()
    >>> server = PackratServer(loop, total_units=16, optimizer=opt,
    ...                        backend=TabulatedBackend(profile),
    ...                        initial_batch=8)
    >>> server.submit(Request(0, 0.0))
    >>> loop.run_until(30.0)
    >>> server.responses[0].latency        # doctest: +SKIP

    ``loop`` may be a raw :class:`~repro.serving.simulator.EventLoop`
    (deterministic simulation) or any
    :class:`~repro.serving.plane.ExecutionPlane` (e.g. a ``RealPlane``
    for wall-clock JAX execution).  Delivered responses accumulate in
    ``responses`` and fan out through ``on_response``; reconfiguration
    history is in ``reconfig_log``; fleets of these servers are fronted
    by :class:`~repro.serving.fabric.ClusterRouter`.
    """

    def __init__(self, loop: EventLoop, *, total_units: int,
                 optimizer: PackratOptimizer, backend: LatencyBackend,
                 initial_batch: int, config: Optional[ControllerConfig] = None,
                 domain_size: Optional[int] = None,
                 calibrator: Optional[ProfileCalibrator] = None,
                 on_response: Optional[Callable[[Response], None]] = None,
                 model_id: str = DEFAULT_MODEL,
                 on_plan_apply: Optional[Callable[[PackratConfig], None]]
                 = None) -> None:
        """``on_response`` (optional) is invoked for every delivered
        response in addition to the ``responses`` log — the cluster
        fabric chains its exactly-once delivery handler here.
        ``model_id`` names the pool (the LM serving path runs one server
        per phase, "prefill"/"decode", and the real plane routes runner
        cells by the workers' model_id)."""
        super().__init__(loop, total_units=total_units, optimizer=optimizer,
                         backend=backend, initial_batch=initial_batch,
                         allocator=ResourceAllocator(total_units, domain_size),
                         config=config, calibrator=calibrator,
                         on_response=on_response, model_id=model_id,
                         on_plan_apply=on_plan_apply)
        self._schedule_tick()

    def _schedule_tick(self) -> None:
        self.loop.schedule(self.ccfg.tick_interval, self._tick)

    def _tick(self) -> None:
        self.tick()
        self._schedule_tick()

    # ------------------------------------------------------------------ #
    # elastic scaling (beyond paper; DESIGN.md §2)
    # ------------------------------------------------------------------ #
    def scale_units(self, new_total_units: int) -> None:
        """Re-run Packrat for a changed unit count (nodes joined/left).

        Lives on the single-model server, not on :class:`ModelTenant`:
        it rebuilds an allocator over global units ``0..T'-1``, which is
        only valid when this tenant owns the whole pool — under the
        multi-model plane the pool is resized by re-granting leases.
        """
        self.total_units = new_total_units
        self.allocator = ResourceAllocator(new_total_units,
                                           min(self.allocator.domain_size,
                                               new_total_units))
        if self.apc.phase is Phase.STABLE:
            cfg = self.optimizer.solve(new_total_units,
                                       self.estimator.current_batch)
            if cfg.groups != (self.apc.active.groups
                              if self.apc.active else None):
                old_cfg = self.apc.active
                new_workers = self._spawn_workers(cfg)
                self._plan_applied(cfg)
                self._pending_workers = new_workers
                self.apc.request_reconfig(cfg, self.loop.now)
                self.reconfig_log.append(
                    (self.loop.now, self.estimator.current_batch, cfg))
                self._draining_cfg = old_cfg
