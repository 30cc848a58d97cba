"""Pluggable dispatch policies: the serving engine's decision layer.

The router (:class:`~repro.serving.dispatcher.Dispatcher`) owns the
mechanics — the central arrival queue, sub-batch execution, straggler
watchdogs, duplicate suppression — while a :class:`DispatchPolicy`
decides *when* work moves and *which* instance runs it:

* :class:`BatchSyncPolicy` — the paper's execution model ("process a
  batch of requests to completion up to some batch size B", §6): an
  aggregate batch ≤ B is issued only when the whole live instance set
  is idle, then partitioned per the active ⟨i,t,b⟩ configuration.
  This is the default and reproduces the pre-refactor dispatcher's
  response timeline exactly (pinned by tests/test_policy.py).

* :class:`ContinuousPolicy` — per-instance dispatch in the style of
  InferLine's fast plane / Harpagon's fine-grained scheduling: every
  worker owns a bounded queue and receives a group-shaped sub-batch
  (size ≤ its b_j) the moment it goes idle — no instance-set barrier,
  so thin instances never wait for the slowest sub-batch.  Partial
  batches coalesce per instance under the batch timeout; straggler
  re-dispatch operates on the shared watchdog machinery.

Policies also own the estimator signal (§3.8): batch-sync reports the
queue highwater sampled at dispatch instants; continuous dispatch
drains the central queue eagerly (highwater would undersample), so it
reports max(outstanding-work highwater, λ̂·L) using the arrival-rate
EWMA source from core.estimator.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Iterable, List, Sequence

from ..core.estimator import ArrivalRateSignal
from .instance import WorkerInstance
from .simulator import Request


class DispatchPolicy:
    """Strategy hooks invoked by the dispatch router.

    ``bind`` is called once with the owning dispatcher; hooks may use
    its public state (``loop``, ``queue``, ``config``, ``instances``,
    ``dcfg``) and submit work via ``_execute``/``_submit``.

    Lifecycle: ``bind`` → ``on_arrival`` per request →
    ``on_batch_done`` per completed sub-batch, with
    ``on_config_change`` at every instance-set swap and ``on_respawn``
    / ``on_abandoned`` on the fault paths.  ``take_signal`` is polled
    by the controller tick and must *consume* whatever window the
    policy accumulates (it is the estimator's Q̂, §3.8).  Implement a
    subclass and pass it as ``Dispatcher(policy=...)`` — or register a
    name in :func:`make_policy` to select it from
    ``ControllerConfig(dispatch_policy=...)``.
    """

    name = "abstract"
    # the owning tenant's model id, mirrored from the dispatcher at bind
    # time — not consulted by the built-in policies (each dispatcher is
    # single-tenant, so routing needs no filter) but part of the policy
    # contract so subclasses can tag diagnostics or specialise per model
    model_id = "default"

    def bind(self, dispatcher) -> None:
        self.d = dispatcher
        self.model_id = getattr(dispatcher, "model_id", "default")

    # ------------------------------------------------------------------ #
    # hooks
    # ------------------------------------------------------------------ #
    def on_arrival(self, req: Request) -> None:
        """A request was appended to the central queue."""
        raise NotImplementedError

    def on_config_change(self, old_instances: Sequence[WorkerInstance]
                         ) -> None:
        """The active ⟨i,t,b⟩ configuration / instance set was swapped."""
        raise NotImplementedError

    def on_batch_done(self, worker: WorkerInstance, delivered: int) -> None:
        """A sub-batch completed on ``worker`` (``delivered`` responses)."""
        raise NotImplementedError

    def on_respawn(self, worker: WorkerInstance) -> None:
        """A failed worker came back (heartbeat respawn)."""

    def on_abandoned(self, count: int) -> None:
        """``count`` requests were given up on (every re-dispatch level
        exhausted on dead workers) — they will never deliver."""

    def take_signal(self, now: float) -> float:
        """The estimator's Q̂ for this tick (consumes internal state)."""
        raise NotImplementedError

    def queued_in_instances(self) -> int:
        """Requests parked in per-instance queues (0 for batch-sync)."""
        return 0

    def extra_drain(self, now: float) -> float:
        """Extra time beyond the constant drain cost needed to finish
        queued per-instance work (active-passive transitions wait on
        this, not just on ``busy_until``)."""
        return 0.0


# --------------------------------------------------------------------- #
# paper-faithful batch-synchronous dispatch
# --------------------------------------------------------------------- #
class BatchSyncPolicy(DispatchPolicy):
    """Aggregate ≤ B with timeout, partition per ⟨i,t,b⟩, barrier on the
    instance set (paper §3.5/§6)."""

    name = "sync"

    def __init__(self) -> None:
        self._timeout_armed = False
        self._wakeup_armed = False

    # ------------------------------------------------------------------ #
    def on_arrival(self, req: Request) -> None:
        d = self.d
        if len(d.queue) >= d.batch_size:
            self._try_dispatch()
        elif not self._timeout_armed:
            self._timeout_armed = True
            d.loop.at(d.loop.now + d.dcfg.batch_timeout, self._on_timeout)

    def on_config_change(self, old_instances) -> None:
        self._try_dispatch()

    def on_batch_done(self, worker, delivered) -> None:
        self._try_dispatch()

    def take_signal(self, now: float) -> float:
        """The estimator's Q̂: max queue depth observed *at dispatch
        instants* since the last call (falling back to the live depth).
        Sampling at dispatch time is the batch-synchronous analogue of
        the paper's queue-depth tracking — fixed-tick sampling would
        undersample a queue that drains exactly at B each batch.
        """
        d = self.d
        hw = max(d._queue_highwater, len(d.queue))
        d._queue_highwater = len(d.queue)
        return hw

    # ------------------------------------------------------------------ #
    def _on_timeout(self) -> None:
        d = self.d
        self._timeout_armed = False
        if d.queue:
            d.timeouts_fired += 1
            self._try_dispatch(force_partial=True)
            if d.queue and not self._timeout_armed:
                self._timeout_armed = True
                d.loop.at(d.loop.now + d.dcfg.batch_timeout, self._on_timeout)

    def _wakeup_at(self, t: float) -> None:
        if not self._wakeup_armed:
            self._wakeup_armed = True

            def wake():
                self._wakeup_armed = False
                self._try_dispatch()

            self.d.loop.at(max(t, self.d.loop.now), wake)

    def _try_dispatch(self, force_partial: bool = False) -> None:
        """Issue the next aggregate batch if instances are free.

        Dispatches when (queue ≥ B) or (timeout expired with a partial
        batch), and the active instance set is idle.  Otherwise arms a
        wake-up at the earliest instance completion.
        """
        d = self.d
        while d.queue:
            live = d._live()
            if not live:
                self._wakeup_at(d.loop.now + d.dcfg.batch_timeout)
                return
            if len(d.queue) < d.batch_size and not force_partial:
                return
            busy = [w for w in live if not w.is_idle(d.loop.now)]
            if busy:
                self._wakeup_at(min(w.busy_until for w in busy))
                return
            d._queue_highwater = max(d._queue_highwater, len(d.queue))
            n = min(len(d.queue), d.batch_size)
            items = [d.queue.popleft() for _ in range(n)]
            # a partial batch goes out because the timeout expired
            self._partition_and_submit(
                items, trigger="full" if n >= d.batch_size else "coalesce")
            d.batches_dispatched += 1
            force_partial = False

    def _partition_and_submit(self, items: List[Request],
                              trigger: str = "full") -> None:
        """Split one aggregate batch across instances per the ⟨i,t,b⟩ config."""
        d = self.d
        cursor = 0
        for group in d.config.groups:
            for _ in range(group.i):
                if cursor >= len(items):
                    return
                sub = items[cursor:cursor + group.b]
                cursor += group.b
                d._submit(sub, group.t, redispatch=0, trigger=trigger)
        while cursor < len(items):
            # oversized leftovers: slice with the group whose b best fits
            # the remainder (smallest b covering it, else the largest b)
            remaining = len(items) - cursor
            fits = [g for g in d.config.groups if g.b >= remaining]
            group = (min(fits, key=lambda g: g.b) if fits
                     else max(d.config.groups, key=lambda g: g.b))
            sub = items[cursor:cursor + group.b]
            cursor += group.b
            d._submit(sub, group.t, redispatch=0, trigger=trigger)


# --------------------------------------------------------------------- #
# continuous per-instance dispatch
# --------------------------------------------------------------------- #
class ContinuousPolicy(DispatchPolicy):
    """Feed any idle instance a ≤ b_j sub-batch immediately; no barrier.

    Requests flow: central queue → the live instance with the smallest
    expected start time (bounded per-instance queues give backpressure)
    → fired as a full batch immediately, or as a partial batch once the
    batch timeout expires with the instance still idle (per-instance
    coalescing).  Work stranded on failed or swapped-out instances is
    reclaimed into the central queue in arrival order.
    """

    name = "continuous"

    def __init__(self, queue_factor: int = 2,
                 rate_alpha: float = 0.25) -> None:
        self.queue_factor = queue_factor        # per-instance bound: f × b_j
        self.rate = ArrivalRateSignal(alpha=rate_alpha)
        self._outstanding = 0                   # accepted − delivered
        self._outstanding_hw = 0
        self._wakeup_armed = False              # poll while no live workers

    # ------------------------------------------------------------------ #
    # hooks
    # ------------------------------------------------------------------ #
    def on_arrival(self, req: Request) -> None:
        self.rate.observe(self.d.loop.now)
        self._outstanding += 1
        self._outstanding_hw = max(self._outstanding_hw, self._outstanding)
        self._route()

    def on_config_change(self, old_instances) -> None:
        current = {id(w) for w in self.d.instances}
        self._reclaim(w for w in old_instances if id(w) not in current)
        self._route()

    def on_batch_done(self, worker, delivered) -> None:
        self._outstanding = max(0, self._outstanding - delivered)
        self._route()
        self._feed(worker)

    def on_respawn(self, worker) -> None:
        self._route()
        self._feed(worker)

    def on_abandoned(self, count) -> None:
        # permanently-lost requests must not inflate the signal forever
        self._outstanding = max(0, self._outstanding - count)

    def take_signal(self, now: float) -> float:
        """max(outstanding-work highwater, λ̂·L): continuous dispatch
        drains the central queue eagerly, so the sync policy's dispatch-
        instant highwater would undersample; outstanding work (Little's
        law) is the policy-appropriate batch-size signal."""
        hw = max(self._outstanding_hw, self._outstanding, 0)
        self._outstanding_hw = self._outstanding
        little = self.rate.rate(now) * self.d.config.latency
        return float(max(hw, little))

    def queued_in_instances(self) -> int:
        return sum(len(w.queue) for w in self.d.instances)

    def extra_drain(self, now: float) -> float:
        """Worst-case time to finish queued + in-flight per-instance work."""
        drain = 0.0
        for w in self.d.instances:
            if w.failed:
                continue
            backlog = math.ceil(len(w.queue) / max(1, w.batch))
            drain = max(drain, max(0.0, w.busy_until - now)
                        + backlog * self._per_batch_latency(w))
        if self.d.queue and self.d.batch_size:
            drain = max(drain, math.ceil(len(self.d.queue) / self.d.batch_size)
                        * self.d.config.latency)
        return drain

    # ------------------------------------------------------------------ #
    # internals
    # ------------------------------------------------------------------ #
    def _capacity(self, w: WorkerInstance) -> int:
        return self.queue_factor * max(1, w.batch) - len(w.queue)

    def _per_batch_latency(self, w: WorkerInstance) -> float:
        if w.stats.batches:
            return w.stats.busy_time / w.stats.batches
        return self.d.config.latency

    def _expected_wait(self, w: WorkerInstance, now: float) -> float:
        backlog = len(w.queue) / max(1, w.batch)
        return max(0.0, w.busy_until - now) + backlog * self._per_batch_latency(w)

    def _reclaim(self, workers: Iterable[WorkerInstance]) -> None:
        moved: List[Request] = []
        for w in workers:
            if w.queue:
                moved.extend(w.queue)
                w.queue.clear()
        if moved:
            merged = sorted(list(self.d.queue) + moved,
                            key=lambda r: (r.arrival, r.id))
            self.d.queue.clear()
            self.d.queue.extend(merged)

    def _route(self) -> None:
        d = self.d
        failed = [w for w in d.instances if w.failed and w.queue]
        if failed:
            self._reclaim(failed)
        live = d._live()
        if not live:
            # mirror the sync policy's self-polling: without it, requests
            # strand forever if workers respawn without notify_respawn
            if d.queue and not self._wakeup_armed:
                self._wakeup_armed = True

                def wake():
                    self._wakeup_armed = False
                    self._route()

                d.loop.at(d.loop.now + d.dcfg.batch_timeout, wake)
            return
        touched: Dict[int, WorkerInstance] = {}
        now = d.loop.now
        while d.queue:
            cands = [w for w in live if self._capacity(w) > 0]
            if not cands:
                break   # backpressure: all bounded queues are full
            w = min(cands, key=lambda w: (self._expected_wait(w, now), w.id))
            take = min(len(d.queue), self._capacity(w), max(1, w.batch))
            for _ in range(take):
                w.queue.append(d.queue.popleft())
            touched[w.id] = w
        for wid in sorted(touched):
            self._feed(touched[wid])

    def _feed(self, worker: WorkerInstance) -> None:
        d = self.d
        now = d.loop.now
        if worker.failed or not worker.queue or not worker.is_idle(now):
            return
        b = max(1, worker.batch)
        if len(worker.queue) >= b:
            self._fire(worker, b)
        elif not worker.coalesce_armed:
            worker.coalesce_armed = True
            d.loop.at(now + d.dcfg.batch_timeout,
                      lambda w=worker: self._coalesce_fire(w))

    def _coalesce_fire(self, worker: WorkerInstance) -> None:
        worker.coalesce_armed = False
        d = self.d
        if worker.failed or not worker.queue or not worker.is_idle(d.loop.now):
            return   # went busy meanwhile; the completion hook re-feeds
        d.timeouts_fired += 1
        self._fire(worker, min(len(worker.queue), max(1, worker.batch)),
                   trigger="coalesce")

    def _fire(self, worker: WorkerInstance, n: int,
              trigger: str = "full") -> None:
        d = self.d
        sub = [worker.queue.popleft() for _ in range(min(n, len(worker.queue)))]
        d.batches_dispatched += 1
        d._execute(worker, sub, worker.threads, redispatch=0, trigger=trigger)


POLICY_NAMES = ("sync", "continuous")


def make_policy(name: str) -> DispatchPolicy:
    """Policy factory used by ControllerConfig.dispatch_policy."""
    if name in ("sync", "batch-sync"):
        return BatchSyncPolicy()
    if name == "continuous":
        return ContinuousPolicy()
    raise ValueError(f"unknown dispatch policy {name!r}; "
                     f"choose from {POLICY_NAMES}")


__all__ = ["BatchSyncPolicy", "ContinuousPolicy", "DispatchPolicy",
           "POLICY_NAMES", "make_policy"]
