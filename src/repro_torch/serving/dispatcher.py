"""Dispatch router (paper §3.5): queueing, execution, fault handling.

The dispatcher owns the *mechanics* of serving — the central arrival
queue, sub-batch execution on workers, straggler watchdogs, duplicate
suppression, and completed-id retirement — while the *decision* of when
work moves and which instance runs it lives in a pluggable
:class:`~repro.serving.policy.DispatchPolicy`:

* ``BatchSyncPolicy`` (default) — the paper's batch-synchronous model:
  aggregate up to ``B`` with a user-provided batch timeout (§2, §3.5),
  partition each aggregate batch per the active ⟨i,t,b⟩ configuration,
  and barrier on the instance set ("process a batch of requests to
  completion up to some batch size B", §6).
* ``ContinuousPolicy`` — per-instance bounded queues; any instance is
  fed a ≤ b_j sub-batch the moment it goes idle (no barrier).

Beyond-paper fault tolerance (needed at cluster scale):
* straggler re-dispatch — a sub-batch that has not completed by
  ``straggler_factor ×`` its expected latency is re-issued to an idle
  instance (first completion wins);
* failed instances never receive work; their in-flight sub-batches are
  re-dispatched by the watchdog.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, Dict, List, Optional, Sequence

from ..core.knapsack import PackratConfig
from .instance import WorkerInstance
from .plane import ExecutionPlane, as_plane
from .policy import BatchSyncPolicy, DispatchPolicy
from .simulator import EventLoop, Request, Response


_INF = float("inf")


@dataclasses.dataclass
class DispatcherConfig:
    batch_timeout: float = 0.050      # paper's user-provided batch timeout
    straggler_factor: float = 3.0     # re-dispatch threshold multiplier
    max_redispatch: int = 2


class Dispatcher:
    """Routes requests onto the active instance set via a dispatch policy.

    The dispatcher is the per-request engine of one serving endpoint.
    It owns the *mechanics* every policy shares — the central arrival
    queue, sub-batch execution through the execution plane, straggler
    watchdogs, duplicate suppression and completed-id retirement — and
    delegates the *decisions* (when a batch forms, which instance runs
    it) to its :class:`~repro.serving.policy.DispatchPolicy`.

    Public surface (everything else is engine internals):

    * :meth:`on_request` — enqueue one request;
    * :attr:`on_response` — delivery callback, safe to chain mid-run
      (:meth:`MetricsCollector.attach <repro.serving.metrics
      .MetricsCollector.attach>` does exactly that);
    * :attr:`on_measure` — optional observed-latency hook feeding the
      calibration loop;
    * :meth:`set_config` — atomically swap the active ⟨i,t,b⟩
      configuration and instance set (called by the controller);
    * :attr:`queue_depth` / :meth:`take_signal` — the batch-size
      estimator's inputs;
    * :meth:`reclaim_undispatched` — pull back requests that have not
      reached a worker (cluster-fabric drain/failover).

    Delivery is exactly-once per request id: re-dispatched stragglers
    race, the first completion wins, and ids are retired only once no
    in-flight copy could still deliver them.
    """

    # which simulation core runs this dispatcher: "event" for the
    # event-at-a-time oracle, "fast" for the vectorized engines in
    # repro.serving.fastsim — surfaced per instance/tenant/node by
    # MetricsCollector.instance_report and fastpath_report so a silent
    # legacy fallback is visible to operators
    engine_name = "event"
    # whether completions can be delivered as ResponseBlocks
    supports_blocks = False

    def __init__(self, loop: EventLoop, config: PackratConfig,
                 instances: Sequence[WorkerInstance],
                 on_response: Callable[[Response], None],
                 dcfg: Optional[DispatcherConfig] = None,
                 policy: Optional[DispatchPolicy] = None,
                 model_id: str = "default",
                 peer_live: Optional[Callable[[], int]] = None) -> None:
        """``loop`` may be a raw :class:`EventLoop` (adopted into a
        :class:`~repro.serving.plane.SimulatedPlane`) or any
        :class:`~repro.serving.plane.ExecutionPlane` — the dispatcher
        is plane-agnostic.  ``peer_live`` reports live workers *outside*
        this dispatcher (other tenants sharing the pod) so interference
        backends see the pod-wide instance count, not just this
        model's."""
        self.plane: ExecutionPlane = as_plane(loop)
        self.loop = self.plane          # plane is EventLoop-compatible
        self.dcfg = dcfg or DispatcherConfig()
        self.model_id = model_id
        self.peer_live = peer_live
        self.on_response = on_response
        # observed per-batch latencies for the calibration loop:
        # on_measure(threads, n_items, observed_latency_s)
        self.on_measure: Optional[Callable[[int, int, float], None]] = None
        # decode-step continuation (autoregressive serving): called once
        # per delivered response; a returned Request is re-enqueued on
        # *this* dispatcher (a completed decode step re-enters the queue
        # until EOS/max-len, so continuous dispatch coalesces decode
        # batches across in-flight sequences).  Cross-phase hand-off
        # (prefill → decode pool) is done by the hook itself enqueueing
        # on the other dispatcher and returning None.  Default None:
        # classic one-shot serving is untouched.
        self.continuation: Optional[Callable[[Response],
                                             Optional[Request]]] = None
        self.queue: Deque[Request] = collections.deque()
        self.batch_size = 0
        self.instances: List[WorkerInstance] = []
        self._done_requests: set = set()
        self._retire_at: Dict[int, float] = {}
        self._inflight_ids: Dict[int, int] = {}   # submitted, not completed
        self._deferred_ids: set = set()   # awaiting a live worker
        self._queue_highwater = 0
        self.timeouts_fired = 0
        self.redispatches = 0
        self.batches_dispatched = 0
        # fast-path accounting (always present so reports are uniform):
        # arrivals bulk-absorbed by a trace feed vs. delivered through
        # the one-at-a-time exact path.  The event engine never absorbs.
        self.fast_absorbed = 0
        self.fast_one_by_one = 0
        self.policy = policy or BatchSyncPolicy()
        self.policy.bind(self)
        self.set_config(config, instances)

    # ------------------------------------------------------------------ #
    # configuration (atomically swapped by active-passive scaling)
    # ------------------------------------------------------------------ #
    def set_config(self, config: PackratConfig,
                   instances: Sequence[WorkerInstance]) -> None:
        old = self.instances
        self.config = config
        self.instances = list(instances)
        self.batch_size = config.total_batch
        self.policy.on_config_change(old)

    # ------------------------------------------------------------------ #
    # request path
    # ------------------------------------------------------------------ #
    def on_request(self, req: Request) -> None:
        if self.plane.spans is not None:
            self.plane.spans.submitted(req, self.loop.now)
        self.queue.append(req)
        self.policy.on_arrival(req)

    @property
    def queue_depth(self) -> int:
        """Undispatched requests: central queue + per-instance queues."""
        return len(self.queue) + self.policy.queued_in_instances()

    def take_signal(self) -> float:
        """The estimator's Q̂ for this tick — policy-defined (§3.8)."""
        return self.policy.take_signal(self.loop.now)

    # back-compat name from the pre-policy dispatcher
    take_queue_highwater = take_signal

    def notify_respawn(self, worker: WorkerInstance) -> None:
        self.policy.on_respawn(worker)

    def reclaim_undispatched(self) -> List[Request]:
        """Remove and return every request not yet submitted to a worker
        (central queue + per-instance queues), in arrival order.

        The cluster fabric uses this to drain or fail over a node:
        undispatched requests can be re-routed with no duplicate-delivery
        risk because no watchdog or completion path holds a copy — only
        ``_execute`` registers those, and these never reached it.
        """
        out: List[Request] = list(self.queue)
        self.queue.clear()
        for w in self.instances:
            if w.queue:
                out.extend(w.queue)
                w.queue.clear()
        out.sort(key=lambda r: (r.arrival, r.id))
        return out

    def estimated_extra_drain(self, now: float) -> float:
        """Extra drain time for queued per-instance work (0 for sync)."""
        return self.policy.extra_drain(now)

    def fastpath_report(self) -> Dict[str, object]:
        """Which engine served this tenant and how much of the trace the
        fast path absorbed in bulk — the operator's check that a mode is
        actually accelerated (a fast engine whose every arrival went
        one-by-one is running at oracle speed)."""
        return {
            "engine": self.engine_name,
            "accelerated": self.engine_name == "fast",
            "absorbed": self.fast_absorbed,
            "one_by_one": self.fast_one_by_one,
        }

    # ------------------------------------------------------------------ #
    # execution (shared by all policies)
    # ------------------------------------------------------------------ #
    def _live(self) -> List[WorkerInstance]:
        return [w for w in self.instances if not w.failed]

    def _pick_instance(self, threads: int) -> Optional[WorkerInstance]:
        """Least-loaded live instance, preferring the matching thread count."""
        live = [w for w in self._live() if w.threads == threads] or self._live()
        if not live:
            return None
        return min(live, key=lambda w: w.busy_until)

    def _submit(self, sub: List[Request], threads: int, redispatch: int,
                trigger: str = "full") -> None:
        worker = self._pick_instance(threads)
        if worker is None:
            # no live worker: retry after a timeout.  The ids are marked
            # deferred so retirement doesn't count them abandoned while
            # this retry loop still owns a deliverable copy.
            self._deferred_ids.update(r.id for r in sub)
            self.loop.schedule(self.dcfg.batch_timeout,
                               lambda: self._submit(sub, threads, redispatch,
                                                    trigger=trigger))
            return
        self._deferred_ids.difference_update(r.id for r in sub)
        self._execute(worker, sub, threads, redispatch, trigger=trigger)

    def _execute(self, worker: WorkerInstance, sub: List[Request],
                 threads: int, redispatch: int, trigger: str = "full"
                 ) -> None:
        """Run one sub-batch on ``worker`` via the execution plane: the
        plane delivers the completion callback (virtual-time event or
        wall-clock thread completion) and the dispatcher schedules a
        watchdog that re-dispatches stragglers and retires completed ids
        once no copy can still deliver them."""
        n_live = len(self._live())
        if self.peer_live is not None:
            n_live += self.peer_live()
        # the batch's span record: fired now, why ("full", "coalesce" or
        # "redispatch"), and which requests it carries
        span = None
        if self.plane.spans is not None:
            span = self.plane.spans.open_batch(
                sub, "redispatch" if redispatch > 0 else trigger,
                self.loop.now)

        def complete(observed, worker=worker, sub=sub, redispatch=redispatch):
            for r in sub:
                n = self._inflight_ids.get(r.id, 0) - 1
                if n > 0:
                    self._inflight_ids[r.id] = n
                else:
                    self._inflight_ids.pop(r.id, None)
            if worker.failed:
                # the watchdog re-dispatches; but a *late* completion on
                # a failed worker (real plane) may be the last event for
                # these ids — retire now or the _retire_at entries leak
                # and abandoned requests go unreported
                self._retire([r for r in sub
                              if self._retire_at.get(r.id, _INF)
                              < self.loop.now])
                return
            if self.on_measure is not None:
                self.on_measure(worker.threads, len(sub), observed)
            delivered = 0
            followups: List[Request] = []
            for r in sub:
                if r.id in self._done_requests:
                    continue
                self._done_requests.add(r.id)
                delivered += 1
                resp = Response(
                    request=r, completion=self.loop.now,
                    batch_size=len(sub), instance_id=worker.id,
                    redispatched=redispatch > 0,
                    model_id=worker.model_id)
                if span is not None:
                    self.plane.spans.delivered(r, span, resp.completion)
                self.on_response(resp)
                if self.continuation is not None:
                    nxt = self.continuation(resp)
                    if nxt is not None:
                        followups.append(nxt)
            # real-plane late completion: the watchdog deadline may have
            # passed while the batch was still executing (its retire pass
            # skipped the in-flight ids) — retire here, the last event
            # that can touch these ids.  Unreachable on the virtual clock
            # with straggler_factor >= 1, where completion never trails
            # its own watchdog.
            late = [r for r in sub
                    if self._retire_at.get(r.id, _INF) < self.loop.now]
            if late:
                self._retire(late)
            # re-enqueue continuations before on_batch_done so the worker
            # this batch just freed can immediately coalesce the next
            # decode sub-batch across the in-flight sequences
            for nxt in followups:
                self.on_request(nxt)
            self.policy.on_batch_done(worker, delivered)

        for r in sub:
            self._inflight_ids[r.id] = self._inflight_ids.get(r.id, 0) + 1
        expected = self.plane.execute_batch(
            worker, len(sub), n_live_instances=n_live, on_complete=complete,
            span=span)
        deadline = self.loop.now + expected * self.dcfg.straggler_factor
        for r in sub:
            self._retire_at[r.id] = max(self._retire_at.get(r.id, 0.0),
                                        deadline)

        def watchdog(sub=sub, threads=threads, redispatch=redispatch):
            if redispatch < self.dcfg.max_redispatch:
                # only ids still tracked are redispatchable: an id absent
                # from _retire_at was delivered *and* retired — on the
                # real plane a watchdog timer can fire after the late
                # completion that retired it, and must not resurrect it
                missing = [r for r in sub
                           if r.id not in self._done_requests
                           and r.id in self._retire_at]
                if missing:
                    self.redispatches += 1
                    self._submit(missing, threads, redispatch + 1)
            self._retire(sub)

        self.loop.at(deadline, watchdog)

    def _retire(self, sub: List[Request]) -> None:
        """Prune completed ids whose last watchdog deadline has passed.

        On the virtual clock every delivery attempt for a request fires
        no later than its submission's watchdog deadline (completion is
        scheduled at ``done_t`` < deadline, and a failed worker's
        completion never delivers), so once the *latest* deadline across
        all copies is in the past the id can no longer be
        double-delivered — dropping it bounds ``_done_requests`` at
        millions of requests.  On the real plane a batch can outlive its
        watchdog, so ids with submissions still in flight are skipped
        here and retired by the late completion itself.
        """
        now = self.loop.now + 1e-12
        abandoned = 0
        for r in sub:
            if self._inflight_ids.get(r.id, 0) > 0:
                continue       # a live copy can still deliver; retire later
            if self._retire_at.get(r.id, 0.0) <= now:
                # undelivered ids (watchdog exhausted on dead workers) are
                # dropped too — a later deferred re-submit re-registers them
                if (r.id in self._retire_at
                        and r.id not in self._done_requests
                        and r.id not in self._deferred_ids):
                    abandoned += 1
                self._retire_at.pop(r.id, None)
                self._done_requests.discard(r.id)
        if abandoned:
            self.policy.on_abandoned(abandoned)
