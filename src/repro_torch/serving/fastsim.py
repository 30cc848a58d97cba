"""Vectorized simulation core: the batched-event fast path.

The legacy :class:`~repro.serving.simulator.EventLoop` pipeline spends
~40 µs of Python per request — one heap event per arrival, one
:class:`Request` object per enqueue, one :class:`Response` object plus
several dict/set operations per delivery.  At fleet scale (10⁶–10⁷
requests) that is minutes of pure interpreter overhead for a run whose
*decisions* (dispatches, reconfigurations, ticks) number only in the
thousands.

This module rebuilds the hot paths on numpy arrays while keeping every
decision point byte-identical to the event-loop oracle:

* :class:`FastLoop` — an :class:`EventLoop` that can carry one sorted
  arrival *trace* as an array.  ``add_trace`` reserves a contiguous
  sequence-number block (one per arrival — exactly what the legacy
  driver consumed by pre-scheduling each arrival with ``at()``), and
  ``run_until`` merges the heap against the trace cursor by exact
  ``(time, seq)`` order, so ties between arrivals and timers resolve
  the same way they always did.
* :class:`ColumnQueue` — the dispatcher's central queue as id/arrival
  columns with deque-compatible access for the slow paths.
* :class:`FastSyncDispatcher` / :class:`FastBatchSyncPolicy` — the
  batch-synchronous engine operating on array slices.  Arrivals that
  are provably unobservable (they neither arm a timer nor unblock a
  dispatch — see :meth:`FastSyncDispatcher.absorption_capacity`) are
  absorbed in bulk; every arrival that *could* change behaviour is
  processed one-at-a-time through the unmodified policy code.  Worker
  failure drops the affected flight back onto the inherited legacy
  per-id bookkeeping (watchdogs, redispatch, retirement), so the fault
  paths are literally the same code as the oracle.
* :class:`FastContinuousDispatcher` / :class:`FastContinuousPolicy` —
  the continuous-dispatch engine with its own absorption rule: an
  arrival is passive when it routes to a *busy* worker's bounded queue
  (a pure append), when an idle worker's coalesce timer is already
  armed and the append stays under the fire threshold, or when every
  bounded queue is full (the append stays central).  Timer arming is
  replayed inline; an arrival that reaches the fire threshold on an
  idle worker completes through the exact per-arrival code.
* :class:`ResponseBlock` / :class:`ResponseLog` — completions delivered
  as one record per sub-batch instead of one object per request, with
  lazy materialization for consumers that want ``Response`` objects.
* :class:`FastPlane` — a :class:`~repro.serving.plane.SimulatedPlane`
  over a :class:`FastLoop` whose ``make_dispatcher`` hook picks the
  fast engine for batch-synchronous *and* continuous-dispatch tenants
  (custom policy subclasses get the legacy dispatcher and stay exact
  by construction).

Trace feeds cover every serving topology: single-model
(:func:`feed_single_model_trace`), multi-tenant
(:func:`feed_multi_model_trace`, per-tenant absorption windows over a
merged columnar trace) and the cluster fabric
(:func:`~repro.serving.fabric.feed_fabric_trace`, which replays the
router's P2C/admission/degrade pipeline inline).

Equivalence is enforced by tests/test_fast_plane.py: every registered
scenario × dispatch policy × node count replays through both cores and
must produce byte-identical response timelines, and the pinned golden
hashes must reproduce through :class:`FastPlane`.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, List, Optional, Sequence

import numpy as np

from .dispatcher import Dispatcher, DispatcherConfig
from .plane import SimulatedPlane
from .policy import BatchSyncPolicy, ContinuousPolicy
from .simulator import DEFAULT_MODEL, EventLoop, Request, Response


# --------------------------------------------------------------------- #
# block-structured responses
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class ResponseBlock:
    """One sub-batch worth of deliveries: the columnar dual of a list of
    :class:`~repro.serving.simulator.Response` objects.  ``completion``,
    ``batch_size``, ``instance_id`` and the flags are scalars because a
    sub-batch completes as a unit; latencies are
    ``completion - arrivals`` (float64 arithmetic is bit-identical to
    the per-object Python subtraction)."""

    ids: np.ndarray          # int64 request ids, delivery order
    arrivals: np.ndarray     # float64 arrival times, same order
    completion: float
    batch_size: int
    instance_id: int
    redispatched: bool = False
    model_id: str = DEFAULT_MODEL
    # set by the cluster fabric when the block crossed a router (mirrors
    # Response.node_id); None on single-node paths
    node_id: Optional[str] = None
    # fidelity rung at delivery (mirrors Response.fidelity); None on
    # paths without a fidelity ladder
    fidelity: Optional[int] = None

    def __len__(self) -> int:
        return len(self.ids)

    def latencies(self) -> np.ndarray:
        return self.completion - self.arrivals

    def responses(self) -> List[Response]:
        """Materialize the per-request objects (value-identical to what
        the legacy dispatcher would have delivered)."""
        comp, bs, wid = self.completion, self.batch_size, self.instance_id
        rd, mid, nid = self.redispatched, self.model_id, self.node_id
        fid = self.fidelity
        return [Response(request=Request(rid, arr, model_id=mid),
                         completion=comp, batch_size=bs, instance_id=wid,
                         redispatched=rd, model_id=mid, node_id=nid,
                         fidelity=fid)
                for rid, arr in zip(self.ids.tolist(), self.arrivals.tolist())]

    @classmethod
    def from_response(cls, resp: Response) -> "ResponseBlock":
        return cls(ids=np.array([resp.request.id], dtype=np.int64),
                   arrivals=np.array([resp.request.arrival],
                                     dtype=np.float64),
                   completion=resp.completion, batch_size=resp.batch_size,
                   instance_id=resp.instance_id,
                   redispatched=resp.redispatched, model_id=resp.model_id,
                   node_id=resp.node_id, fidelity=resp.fidelity)


class ResponseLog:
    """A list-compatible response sink that accepts whole blocks.

    Drop-in for the ``ModelTenant.responses`` list: ``len``, iteration
    and indexing all work, materializing :class:`Response` objects
    lazily (and caching them), so test and report code written against
    the legacy list runs unchanged on the fast path."""

    def __init__(self) -> None:
        self._entries: List[object] = []    # ResponseBlock | Response
        self._flat: Optional[List[Response]] = None
        self._n = 0

    def append_block(self, block: ResponseBlock) -> None:
        self._entries.append(block)
        self._flat = None
        self._n += len(block)

    def append(self, resp: Response) -> None:
        self._entries.append(resp)
        self._flat = None
        self._n += 1

    def blocks(self) -> List[object]:
        return list(self._entries)

    def __len__(self) -> int:
        return self._n

    def _materialize(self) -> List[Response]:
        if self._flat is None:
            out: List[Response] = []
            for e in self._entries:
                if isinstance(e, ResponseBlock):
                    out.extend(e.responses())
                else:
                    out.append(e)
            self._flat = out
        return self._flat

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, idx):
        return self._materialize()[idx]


# --------------------------------------------------------------------- #
# columnar central queue
# --------------------------------------------------------------------- #
class ColumnQueue:
    """The dispatcher's central queue as id/arrival columns.

    Bulk appends and slice pops are O(1)-amortized array copies; the
    deque surface (``len``/``append``/``popleft``/``clear``/iteration)
    stays available for the exact-fidelity slow paths, materializing
    :class:`Request` objects on demand (requests are frozen value
    types, so reconstruction is identity-free)."""

    __slots__ = ("model_id", "_ids", "_arr", "_head", "_tail", "_cap")

    def __init__(self, model_id: str = DEFAULT_MODEL) -> None:
        self.model_id = model_id
        self._cap = 1024
        self._ids = np.empty(self._cap, dtype=np.int64)
        self._arr = np.empty(self._cap, dtype=np.float64)
        self._head = 0
        self._tail = 0

    def __len__(self) -> int:
        return self._tail - self._head

    def __bool__(self) -> bool:
        return self._tail > self._head

    def _make_room(self, need: int) -> None:
        n = self._tail - self._head
        if n + need > self._cap:
            while self._cap < n + need:
                self._cap *= 2
            ids = np.empty(self._cap, dtype=np.int64)
            arr = np.empty(self._cap, dtype=np.float64)
            ids[:n] = self._ids[self._head:self._tail]
            arr[:n] = self._arr[self._head:self._tail]
            self._ids, self._arr = ids, arr
        else:   # compact the live region to the front
            self._ids[:n] = self._ids[self._head:self._tail]
            self._arr[:n] = self._arr[self._head:self._tail]
        self._head, self._tail = 0, n

    def append(self, req: Request) -> None:
        if self._tail == self._cap:
            self._make_room(1)
        self._ids[self._tail] = req.id
        self._arr[self._tail] = req.arrival
        self._tail += 1

    def push(self, rid: int, arrival: float) -> None:
        """Scalar append without materializing a :class:`Request` —
        the per-arrival absorption paths' enqueue."""
        if self._tail == self._cap:
            self._make_room(1)
        self._ids[self._tail] = rid
        self._arr[self._tail] = arrival
        self._tail += 1

    def extend(self, reqs) -> None:
        for r in reqs:
            self.append(r)

    def extend_arrays(self, ids: np.ndarray, arrivals: np.ndarray) -> None:
        k = len(ids)
        if self._tail + k > self._cap:
            self._make_room(k)
        self._ids[self._tail:self._tail + k] = ids
        self._arr[self._tail:self._tail + k] = arrivals
        self._tail += k

    def popleft(self) -> Request:
        if self._head == self._tail:
            raise IndexError("pop from an empty ColumnQueue")
        i = self._head
        self._head = i + 1
        return Request(int(self._ids[i]), float(self._arr[i]),
                       model_id=self.model_id)

    def pop_slice(self, n: int):
        """Remove and return the first ``n`` entries as (ids, arrivals)
        array copies (callers own them past future queue growth)."""
        i = self._head
        j = i + n
        self._head = j
        return self._ids[i:j].copy(), self._arr[i:j].copy()

    def clear(self) -> None:
        self._head = self._tail = 0

    def __iter__(self):
        mid = self.model_id
        ids = self._ids[self._head:self._tail].tolist()
        arr = self._arr[self._head:self._tail].tolist()
        return iter([Request(i, t, model_id=mid)
                     for i, t in zip(ids, arr)])


# --------------------------------------------------------------------- #
# the fast event loop: heap merged with an array-backed arrival trace
# --------------------------------------------------------------------- #
class _Trace:
    __slots__ = ("times", "n", "cursor", "base", "arrive_one", "absorber")


class FastLoop(EventLoop):
    """An :class:`EventLoop` that merges one sorted arrival trace with
    the heap by exact ``(time, seq)`` order.

    ``add_trace(times, arrive_one, absorber)`` reserves one sequence
    number per arrival — the same numbers the legacy driver consumed by
    pre-scheduling every arrival with ``at()`` — so same-timestamp
    ordering against heap events is bit-identical to the oracle.  The
    optional ``absorber(times, cur, bound) -> k`` callback may consume
    ``k`` leading arrivals in bulk; it must only do so when those
    arrivals are *unobservable* (no timer armed, no dispatch unblocked,
    no clock read) — every arrival it declines is delivered through
    ``arrive_one(index, time)`` with the clock advanced, exactly like a
    popped heap event.
    """

    def __init__(self) -> None:
        super().__init__()
        self._trace: Optional[_Trace] = None

    # ------------------------------------------------------------------ #
    def add_trace(self, times, arrive_one: Callable[[int, float], None],
                  absorber: Optional[Callable] = None) -> None:
        if self._trace is not None and self._trace.cursor < self._trace.n:
            raise ValueError("a trace is already pending on this loop")
        arr = np.ascontiguousarray(times, dtype=np.float64)
        if arr.size and np.any(np.diff(arr) < 0.0):
            raise ValueError("trace times must be sorted")
        tr = _Trace()
        tr.times = arr
        tr.n = int(arr.size)
        tr.cursor = 0
        tr.arrive_one = arrive_one
        tr.absorber = absorber
        # reserve seqs base..base+n-1 for the arrivals (one each, just
        # as n legacy at() calls would have consumed); the next runtime
        # event picks up at base+n
        tr.base = next(self._seq)
        self._seq = itertools.count(tr.base + tr.n)
        self._trace = tr

    @property
    def pending_arrivals(self) -> int:
        tr = self._trace
        return 0 if tr is None else tr.n - tr.cursor

    # ------------------------------------------------------------------ #
    def run_until(self, t_end: float) -> None:
        heap = self._heap
        while True:
            tr = self._trace
            have_t = (tr is not None and tr.cursor < tr.n
                      and tr.times[tr.cursor] <= t_end)
            have_h = bool(heap) and heap[0][0] <= t_end
            if not have_h and not have_t:
                break
            if have_t:
                t0 = tr.times[tr.cursor]
                s0 = tr.base + tr.cursor
                if not have_h or (t0, s0) < (heap[0][0], heap[0][1]):
                    if have_h:
                        # bound the arrival window by the heap head in
                        # merged (time, seq) order: heap events created
                        # before the trace have lower seqs and win ties,
                        # runtime events have higher seqs and lose them
                        bound = heap[0][0]
                        side = "right" if heap[0][1] > s0 else "left"
                    else:
                        bound, side = t_end, "right"
                    self._consume_arrivals(tr, bound, side)
                    continue
            time, _, fn = heapq.heappop(heap)
            if time > self.now:
                self.now = time
            fn()
        if self.now < t_end:
            self.now = t_end
        if self._trace is not None and self._trace.cursor >= self._trace.n:
            self._trace = None

    def run(self) -> None:
        while True:
            tr = self._trace
            have_t = tr is not None and tr.cursor < tr.n
            if not self._heap and not have_t:
                return
            bound = self._heap[0][0] if self._heap else 0.0
            if have_t:
                bound = max(bound, float(tr.times[-1]))
            self.run_until(bound)

    # ------------------------------------------------------------------ #
    def _consume_arrivals(self, tr: _Trace, bound: float, side: str) -> None:
        k_bound = int(np.searchsorted(tr.times, bound, side=side))
        heap = self._heap
        head = heap[0][:2] if heap else None
        while tr.cursor < k_bound:
            if heap and (head is None or heap[0][:2] != head):
                # an absorber armed a timer ahead of the old bound: the
                # window is stale — re-merge against the new heap head
                return
            k = 0
            if tr.absorber is not None:
                k = tr.absorber(tr.times, tr.cursor, k_bound)
            if k > 0:
                # absorbed arrivals are unobservable: the clock need not
                # advance — the next processed event max()es past them
                tr.cursor += k
                continue
            i = tr.cursor
            t = float(tr.times[i])
            if t > self.now:
                self.now = t
            tr.cursor = i + 1
            tr.arrive_one(i, t)
            # the handler may have scheduled events inside the window;
            # fall back to the merge loop to re-establish ordering
            return


# --------------------------------------------------------------------- #
# the fast batch-synchronous engine
# --------------------------------------------------------------------- #
class _Flight:
    """One in-flight sub-batch on the fast path.  A flight that
    completes on a live worker delivers all its ids as a block and its
    watchdog is a no-op; a flight whose worker died is *chained* — its
    ids are registered in the inherited legacy per-id bookkeeping and
    every subsequent event (watchdog, redispatch, retirement) runs the
    unmodified oracle code."""

    __slots__ = ("ids", "arrivals", "worker", "threads", "redispatch",
                 "deadline", "chained")

    def __init__(self, ids, arrivals, worker, threads, redispatch):
        self.ids = ids
        self.arrivals = arrivals
        self.worker = worker
        self.threads = threads
        self.redispatch = redispatch
        self.deadline = 0.0
        self.chained = False

    def materialize(self, model_id: str) -> List[Request]:
        return [Request(i, t, model_id=model_id)
                for i, t in zip(self.ids.tolist(), self.arrivals.tolist())]


class FastBatchSyncPolicy(BatchSyncPolicy):
    """The batch-synchronous policy dispatching array slices.

    Decision logic (idle barrier, partial-batch timeout, wake-ups,
    queue-highwater sampling) is inherited unchanged; only the act of
    popping an aggregate batch and partitioning it per ⟨i,t,b⟩ moves to
    slices, feeding :meth:`FastSyncDispatcher._submit_block`."""

    def _try_dispatch(self, force_partial: bool = False) -> None:
        d = self.d
        queue = d.queue
        while queue:
            live = d._live()
            if not live:
                self._wakeup_at(d.loop.now + d.dcfg.batch_timeout)
                return
            if len(queue) < d.batch_size and not force_partial:
                return
            busy = [w for w in live if not w.is_idle(d.loop.now)]
            if busy:
                self._wakeup_at(min(w.busy_until for w in busy))
                return
            d._queue_highwater = max(d._queue_highwater, len(queue))
            n = min(len(queue), d.batch_size)
            ids, arrs = queue.pop_slice(n)
            self._partition_and_submit_arrays(ids, arrs)
            d.batches_dispatched += 1
            force_partial = False

    def _partition_and_submit_arrays(self, ids: np.ndarray,
                                     arrs: np.ndarray) -> None:
        d = self.d
        n = len(ids)
        cursor = 0
        for group in d.config.groups:
            for _ in range(group.i):
                if cursor >= n:
                    return
                end = cursor + group.b
                d._submit_block(ids[cursor:end], arrs[cursor:end],
                                group.t, 0)
                cursor = end
        while cursor < n:
            remaining = n - cursor
            fits = [g for g in d.config.groups if g.b >= remaining]
            group = (min(fits, key=lambda g: g.b) if fits
                     else max(d.config.groups, key=lambda g: g.b))
            end = cursor + group.b
            d._submit_block(ids[cursor:end], arrs[cursor:end], group.t, 0)
            cursor = end


class _FastBlockDispatcher(Dispatcher):
    """Shared core of the vectorized dispatchers: columnar central
    queue, flight-based execution and block delivery.

    The external surface (``on_request``/``set_config``/``take_signal``
    /``queue_depth``/``reclaim_undispatched``/counters) is inherited, so
    the controller, tenancy plane and cluster fabric run unchanged.
    Failure paths are the inherited legacy machinery: a flight whose
    worker died converts to per-id bookkeeping and redispatches through
    the unmodified ``_submit``/``_execute``/``_retire`` chain.
    """

    supports_blocks = True
    engine_name = "fast"
    _policy_cls: type = None        # set by subclasses

    def __init__(self, loop, config, instances,
                 on_response: Callable[[Response], None],
                 dcfg: Optional[DispatcherConfig] = None,
                 policy=None, model_id: str = DEFAULT_MODEL,
                 peer_live=None) -> None:
        self.on_response_block = None
        if policy is None:
            policy = self._policy_cls()
        if not isinstance(policy, self._policy_cls):
            raise TypeError(f"{type(self).__name__} requires a "
                            f"{self._policy_cls.__name__} (other policies "
                            f"use the legacy Dispatcher)")
        super().__init__(loop, config, instances, on_response, dcfg,
                         policy=policy, model_id=model_id,
                         peer_live=peer_live)
        # the deque installed by the base constructor is empty at this
        # point (set_config dispatches nothing from an empty queue)
        self.queue = ColumnQueue(model_id)

    # ------------------------------------------------------------------ #
    # block delivery
    # ------------------------------------------------------------------ #
    def attach_block_log(self) -> ResponseLog:
        """Switch this dispatcher to block delivery into a fresh
        :class:`ResponseLog` (which is returned — the tenant adopts it
        as its ``responses`` sink).  Per-request deliveries from the
        legacy fault paths are wrapped into single-item blocks so every
        consumer sees one stream."""
        log = ResponseLog()
        self.on_response_block = log.append_block
        self.on_response = self._single_as_block
        return log

    def _single_as_block(self, resp: Response) -> None:
        self.on_response_block(ResponseBlock.from_response(resp))

    def _deliver_block(self, flight: _Flight) -> None:
        worker = flight.worker
        comp = self.loop.now
        bs = len(flight.ids)
        rd = flight.redispatch > 0
        if self.on_response_block is not None:
            self.on_response_block(ResponseBlock(
                ids=flight.ids, arrivals=flight.arrivals, completion=comp,
                batch_size=bs, instance_id=worker.id, redispatched=rd,
                model_id=worker.model_id))
            return
        on_r = self.on_response
        wid = worker.id
        wmid = worker.model_id
        mid = self.model_id
        for rid, arr in zip(flight.ids.tolist(), flight.arrivals.tolist()):
            on_r(Response(request=Request(rid, arr, model_id=mid),
                          completion=comp, batch_size=bs, instance_id=wid,
                          redispatched=rd, model_id=wmid))

    # ------------------------------------------------------------------ #
    # flight execution
    # ------------------------------------------------------------------ #
    def _submit_block(self, ids: np.ndarray, arrs: np.ndarray,
                      threads: int, redispatch: int) -> None:
        worker = self._pick_instance(threads)
        if worker is None:
            # defensive parity with the legacy deferral (unreachable from
            # _try_dispatch, which checked for live workers): retry after
            # a timeout with the same single scheduled event
            self.loop.schedule(
                self.dcfg.batch_timeout,
                lambda: self._submit_block(ids, arrs, threads, redispatch))
            return
        self._execute_block(worker, ids, arrs, threads, redispatch)

    def _execute_block(self, worker, ids: np.ndarray, arrs: np.ndarray,
                       threads: int, redispatch: int) -> None:
        n_live = len(self._live())
        if self.peer_live is not None:
            n_live += self.peer_live()
        flight = _Flight(ids, arrs, worker, threads, redispatch)
        n_items = len(ids)

        def complete(observed):
            if worker.failed:
                # the worker died mid-flight: hand these ids to the
                # legacy per-id machinery; the watchdog redispatches
                self._chain_flight(flight)
                return
            if self.on_measure is not None:
                self.on_measure(worker.threads, n_items, observed)
            self._deliver_block(flight)
            self.policy.on_batch_done(worker, n_items)

        expected = self.plane.execute_batch(
            worker, n_items, n_live_instances=n_live, on_complete=complete)
        deadline = self.loop.now + expected * self.dcfg.straggler_factor
        flight.deadline = deadline

        def watchdog():
            if not flight.chained:
                return      # delivered in full; nothing to redispatch
            sub = flight.materialize(self.model_id)
            if redispatch < self.dcfg.max_redispatch:
                missing = [r for r in sub
                           if r.id not in self._done_requests
                           and r.id in self._retire_at]
                if missing:
                    self.redispatches += 1
                    self._submit(missing, threads, redispatch + 1)
            self._retire(sub)

        self.loop.at(deadline, watchdog)

    def _chain_flight(self, flight: _Flight) -> None:
        """Register a failed flight's ids in the legacy bookkeeping with
        exactly the state the oracle would hold at this point: the
        in-flight count decremented back to zero and the retire deadline
        pinned at the flight's watchdog (the failed completion's own
        retire pass is empty — on the virtual clock a completion always
        precedes its watchdog deadline)."""
        flight.chained = True
        deadline = flight.deadline
        ra = self._retire_at
        for rid in flight.ids.tolist():
            prev = ra.get(rid, 0.0)
            ra[rid] = deadline if deadline > prev else prev


class FastSyncDispatcher(_FastBlockDispatcher):
    """The batch-synchronous vectorized dispatcher (PR 6): columnar
    queueing plus the sync-policy absorption rule below."""

    _policy_cls = FastBatchSyncPolicy

    # ------------------------------------------------------------------ #
    # bulk-arrival absorption
    # ------------------------------------------------------------------ #
    def absorption_capacity(self, times: np.ndarray, cur: int,
                            k_bound: int) -> int:
        """How many leading arrivals of ``times[cur:k_bound]`` are
        unobservable and may be absorbed as pure queue appends.

        An arrival is passive iff its ``on_arrival`` provably does
        nothing beyond the append:

        * queue below ``B - 1`` with the partial-batch timer already
          armed → up to ``B - 1 - q`` arrivals stay under the dispatch
          threshold;
        * queue at/above ``B - 1`` → the arrival calls ``_try_dispatch``,
          which is a no-op only while a wake-up is already armed and
          either no live worker exists, or some live worker is still
          busy at the arrival time (the instance-set barrier).  Worker
          state only changes inside heap events, which bound the window,
          so the busy test reduces to ``t < max(live busy_until)``.

        Everything else returns 0 and the arrival runs through the
        unmodified policy code.
        """
        pol = self.policy
        q = len(self.queue)
        B = self.batch_size
        avail = k_bound - cur
        if q + 1 < B:
            if not pol._timeout_armed:
                return 0
            cap = B - 1 - q
            return cap if cap < avail else avail
        if not pol._wakeup_armed:
            return 0
        live = self._live()
        if not live:
            return avail
        max_busy = max(w.busy_until for w in live)
        if times[cur] >= max_busy:
            return 0
        return int(np.searchsorted(times[cur:k_bound], max_busy,
                                   side="left"))

    # ------------------------------------------------------------------ #
    def arm_and_absorb_one(self, times: np.ndarray, cur: int) -> int:
        """When :meth:`absorption_capacity` declines only because a
        timer is unarmed, arm it exactly as the policy would (identical
        event time and callback, one heap push) and absorb the arming
        arrival.  The caller's window may now be bounded by the new
        timer — :meth:`FastLoop._consume_arrivals` re-merges when the
        heap head changes, and the per-arrival windows set
        ``armed_stop`` so multi-tenant feeds stop theirs.  Returns 1 if
        the arrival was armed-and-absorbed, else 0 (a genuine dispatch:
        the arrival must run exact)."""
        pol = self.policy
        t0 = float(times[cur])
        if len(self.queue) + 1 < self.batch_size:
            if pol._timeout_armed:
                return 0
            pol._timeout_armed = True
            self.loop.at(t0 + self.dcfg.batch_timeout, pol._on_timeout)
            return 1
        if pol._wakeup_armed:
            return 0            # an idle instance set: dispatch fires
        live = self._live()
        if not live:
            pol._wakeup_at(t0 + self.dcfg.batch_timeout)
            return 1
        busy = [w.busy_until for w in live if w.busy_until > t0]
        if len(busy) < len(live):
            return 0            # an idle worker: dispatch fires
        pol._wakeup_at(min(busy))
        return 1

    def trace_absorber(self, ids: np.ndarray):
        """The bulk absorber closure for a single-tenant trace feed
        (``ids`` are this dispatcher's request ids in trace order)."""
        def absorber(ts, cur, k_bound, _self=self, _ids=ids):
            k = _self.absorption_capacity(ts, cur, k_bound)
            if k == 0:
                k = _self.arm_and_absorb_one(ts, cur)
            if k:
                _self.queue.extend_arrays(_ids[cur:cur + k],
                                          ts[cur:cur + k])
                _self.fast_absorbed += k
            return k
        return absorber

    def begin_absorb_window(self):
        """A per-arrival absorption view valid until the next heap
        event (the multi-tenant/fabric feeds interleave arrivals across
        dispatchers, so they absorb one arrival at a time)."""
        return _SyncAbsorbWindow(self)


class _SyncAbsorbWindow:
    """Per-arrival form of :meth:`FastSyncDispatcher.absorption_capacity`
    over a window in which worker/timer state is frozen (both only
    change inside heap events, which bound every window).

    An arrival that would only *arm* a timer (the partial-batch timeout,
    or the all-busy wake-up) is absorbed too: the arming is a single
    deterministic heap push at a time derived from the arrival and the
    frozen worker state, so the window replays it exactly and flags
    ``armed_stop`` — the feed must stop this window (its bound may now
    be stale) and let the merge loop re-establish ordering."""

    __slots__ = ("d", "pol", "queue", "qlen", "B", "timeout_armed",
                 "wakeup_armed", "has_live", "max_busy", "busys",
                 "armed_stop")

    def __init__(self, d: FastSyncDispatcher) -> None:
        pol = d.policy
        self.d = d
        self.pol = pol
        self.queue = d.queue
        self.qlen = len(d.queue)
        self.B = d.batch_size
        self.timeout_armed = pol._timeout_armed
        self.wakeup_armed = pol._wakeup_armed
        live = d._live()
        self.has_live = bool(live)
        self.busys = [w.busy_until for w in live]
        self.max_busy = max(self.busys) if live else 0.0
        self.armed_stop = False

    def peek_one(self, t: float) -> bool:
        """Would an arrival at ``t`` be absorbable (no mutation; an
        arm-only arrival counts — :meth:`absorb_one` replays the arm)?"""
        if self.qlen + 1 < self.B:
            return True
        return (not self.has_live) or t < self.max_busy

    def absorb_one(self, rid: int, t: float) -> bool:
        if self.qlen + 1 < self.B:
            if not self.timeout_armed:
                # on_arrival's arming branch, with now == t
                self.pol._timeout_armed = True
                self.d.loop.at(t + self.d.dcfg.batch_timeout,
                               self.pol._on_timeout)
                self.timeout_armed = True
                self.armed_stop = True
        elif (not self.has_live) or t < self.max_busy:
            if not self.wakeup_armed:
                # _try_dispatch's wake-up branch, with now == t
                if not self.has_live:
                    self.pol._wakeup_at(t + self.d.dcfg.batch_timeout)
                else:
                    self.pol._wakeup_at(min(b for b in self.busys
                                            if b > t))
                self.wakeup_armed = True
                self.armed_stop = True
        else:
            return False
        self.queue.push(rid, t)
        self.qlen += 1
        self.d.fast_absorbed += 1
        return True


# --------------------------------------------------------------------- #
# the fast continuous engine
# --------------------------------------------------------------------- #
class FastContinuousPolicy(ContinuousPolicy):
    """:class:`~repro.serving.policy.ContinuousPolicy` moving requests
    as array slices.

    Decision logic (candidate choice by expected wait, per-instance
    bounds, coalescing, reclaim, the Little's-law signal) is inherited
    unchanged; per-instance queues become :class:`ColumnQueue`s (adopted
    at every config change), the central→instance move is a slice copy,
    and firing goes through ``_execute_block``."""

    def _adopt_queues(self) -> None:
        for w in self.d.instances:
            if not isinstance(w.queue, ColumnQueue):
                cq = ColumnQueue(self.model_id)
                if w.queue:
                    cq.extend(w.queue)
                w.queue = cq

    def on_config_change(self, old_instances) -> None:
        self._adopt_queues()
        super().on_config_change(old_instances)

    def _route(self) -> None:
        d = self.d
        failed = [w for w in d.instances if w.failed and w.queue]
        if failed:
            self._reclaim(failed)
        live = d._live()
        if not live:
            if d.queue and not self._wakeup_armed:
                self._wakeup_armed = True

                def wake():
                    self._wakeup_armed = False
                    self._route()

                d.loop.at(d.loop.now + d.dcfg.batch_timeout, wake)
            return
        touched = {}
        now = d.loop.now
        queue = d.queue
        while queue:
            cands = [w for w in live if self._capacity(w) > 0]
            if not cands:
                break   # backpressure: all bounded queues are full
            w = min(cands, key=lambda w: (self._expected_wait(w, now), w.id))
            take = min(len(queue), self._capacity(w), max(1, w.batch))
            ids, arrs = queue.pop_slice(take)
            w.queue.extend_arrays(ids, arrs)
            touched[w.id] = w
        for wid in sorted(touched):
            self._feed(touched[wid])

    def _fire(self, worker, n: int, trigger: str = "full") -> None:
        d = self.d
        wq = worker.queue
        ids, arrs = wq.pop_slice(min(n, len(wq)))
        d.batches_dispatched += 1
        d._execute_block(worker, ids, arrs, worker.threads, 0)

    # ------------------------------------------------------------------ #
    def _absorb_signal(self, times: np.ndarray, cur: int,
                       k_bound: int) -> None:
        """Replay the per-arrival rate/outstanding bookkeeping for a
        bulk-absorbed slice — the identical scalar recurrence
        :meth:`~repro.core.estimator.ArrivalRateSignal.observe` runs, so
        the EWMA state is bit-equal to the oracle's."""
        rate = self.rate
        alpha = rate.alpha
        one_minus = 1.0 - alpha
        last = rate._last
        mg = rate._mean_gap
        for t in times[cur:k_bound].tolist():
            if last is not None:
                gap = t - last
                if gap < 1e-9:
                    gap = 1e-9
                mg = gap if mg is None else alpha * gap + one_minus * mg
            last = t
        rate._last = last
        rate._mean_gap = mg
        self._outstanding += k_bound - cur
        if self._outstanding > self._outstanding_hw:
            self._outstanding_hw = self._outstanding


class _ContinuousAbsorbWindow:
    """Per-arrival absorption view of a continuous-dispatch tenant.

    The continuous rule (tentpole invariant): an arrival is passive only
    when **no worker is idle** — an idle worker would fire or arm a
    coalesce timer the moment the arrival routes to it — and, for the
    backpressured tail, when **no bounded per-worker queue can accept
    it** (then the append stays in the central queue and ``_route``
    breaks without touching a worker).  Everything else (idle worker
    chosen, reclaimable failed-worker work, a central queue that
    contradicts the all-full invariant) declines and runs the exact
    per-arrival code.

    Candidate choice replays ``_route`` exactly: first live worker with
    spare capacity minimizing ``(expected_wait, id)`` with strict-``<``
    first-wins tie-breaking, expected wait computed with the same float
    expression over worker state frozen inside the window.
    """

    __slots__ = ("d", "pol", "queue", "central", "has_live",
                 "wakeup_armed", "wids", "busys", "batches", "pbls",
                 "qlens", "caps", "wqs", "n_live", "usable",
                 "armed_stop")

    def __init__(self, d: "FastContinuousDispatcher") -> None:
        self.d = d
        self.pol = pol = d.policy
        self.queue = d.queue
        self.usable = False
        self.armed_stop = False     # continuous absorption never arms
        for w in d.instances:
            if w.failed and w.queue:
                return      # reclaim pending: exact path only
        live = d._live()
        self.has_live = bool(live)
        self.wakeup_armed = pol._wakeup_armed
        qf = pol.queue_factor
        lat = d.config.latency
        self.wids = [w.id for w in live]
        self.busys = [w.busy_until for w in live]
        self.batches = [max(1, w.batch) for w in live]
        self.pbls = [(w.stats.busy_time / w.stats.batches)
                     if w.stats.batches else lat for w in live]
        self.qlens = [len(w.queue) for w in live]
        self.caps = [qf * b - q
                     for b, q in zip(self.batches, self.qlens)]
        self.wqs = [w.queue for w in live]
        self.n_live = len(live)
        self.central = bool(d.queue)
        if self.central and any(c > 0 for c in self.caps):
            return          # violates the post-event invariant: stay exact
        self.usable = True

    def _best(self, t: float) -> int:
        """Index of the candidate ``_route`` would pick for an arrival
        at ``t`` (−1: no capacity anywhere — the arrival stays central)."""
        best = -1
        bw = 0.0
        bid = 0
        busys, caps, qlens = self.busys, self.caps, self.qlens
        batches, pbls, wids = self.batches, self.pbls, self.wids
        for m in range(self.n_live):
            if caps[m] <= 0:
                continue
            wait = busys[m] - t
            if wait < 0.0:
                wait = 0.0
            wait = wait + (qlens[m] / batches[m]) * pbls[m]
            if best < 0 or wait < bw or (wait == bw and wids[m] < bid):
                best = m
                bw = wait
                bid = wids[m]
        return best

    def _signal(self, t: float) -> None:
        pol = self.pol
        pol.rate.observe(t)
        pol._outstanding += 1
        if pol._outstanding > pol._outstanding_hw:
            pol._outstanding_hw = pol._outstanding

    def peek_one(self, t: float) -> bool:
        """Would an arrival at ``t`` be absorbable (no mutation)?"""
        if self.central:
            return True
        if not self.has_live:
            return self.wakeup_armed
        best = self._best(t)
        if best < 0:
            return True
        return self.busys[best] > t

    def absorb_one(self, rid: int, t: float) -> bool:
        if self.central:
            self.queue.push(rid, t)
        elif not self.has_live:
            if not self.wakeup_armed:
                return False
            self.queue.push(rid, t)
        else:
            best = self._best(t)
            if best < 0:
                # backpressure: every bounded queue is full, the append
                # stays central — and stays there for the whole window
                self.central = True
                self.queue.push(rid, t)
            elif self.busys[best] <= t:
                return False    # idle worker: would fire/arm a coalesce
            else:
                self.wqs[best].push(rid, t)
                self.qlens[best] += 1
                self.caps[best] -= 1
        self._signal(t)
        self.d.fast_absorbed += 1
        return True


class FastContinuousDispatcher(_FastBlockDispatcher):
    """The continuous-dispatch vectorized dispatcher: the shared block
    core plus the continuous absorption rule (see
    :class:`_ContinuousAbsorbWindow`)."""

    _policy_cls = FastContinuousPolicy

    # ------------------------------------------------------------------ #
    def _absorb_run(self, ids: np.ndarray, times: np.ndarray, cur: int,
                    k_bound: int) -> int:
        """Absorb leading arrivals of ``times[cur:k_bound]``; two tiers:

        * whole-window bulk when no worker can receive work at all (no
          live worker with a wake-up armed, or every bounded queue full
          — arrivals are then pure central appends);
        * otherwise a tight per-arrival loop replaying the routing
          decision over local parallel lists: the exact ``_best``
          expected-wait expression, the exact EWMA/outstanding
          recurrence replayed on locals, and per-worker pushes buffered
          into plain lists.  Locals flush back to the real policy/queue
          state at every exit, so heap events and the exact path always
          see oracle state.

        An arrival an idle worker would serve — the event the window
        must not paper over — is completed *inline* through the exact
        per-arrival machinery (``on_request`` with the merge loop's
        clock advance), ending the window; the merge loop then re-orders
        against whatever the dispatch scheduled.
        """
        pol = self.policy
        queue = self.queue
        for w in self.instances:
            if w.failed and w.queue:
                return 0        # reclaim pending: exact path only
        live = self._live()
        has_live = bool(live)
        central = bool(queue)
        qf = pol.queue_factor
        batches = [max(1, w.batch) for w in live]
        qlens = [len(w.queue) for w in live]
        caps = [qf * b - q for b, q in zip(batches, qlens)]
        any_cap = False
        for c in caps:
            if c > 0:
                any_cap = True
                break
        if central and any_cap:
            return 0            # violates the post-event invariant
        if central or (not has_live and pol._wakeup_armed) \
                or (has_live and not any_cap):
            k = k_bound - cur
            queue.extend_arrays(ids[cur:k_bound], times[cur:k_bound])
            pol._absorb_signal(times, cur, k_bound)
            self.fast_absorbed += k
            return k
        if not has_live:
            return 0            # first arrival must arm the wake-up
        n_live = len(live)
        lat = self.config.latency
        wids = [w.id for w in live]
        busys = [w.busy_until for w in live]
        pbls = [(w.stats.busy_time / w.stats.batches)
                if w.stats.batches else lat for w in live]
        wqs = [w.queue for w in live]
        coal = [w.coalesce_armed for w in live]
        timeout = self.dcfg.batch_timeout
        buf_i: List[list] = [[] for _ in range(n_live)]
        buf_t: List[list] = [[] for _ in range(n_live)]
        # the exact EWMA / outstanding recurrences, replayed on locals
        rate = pol.rate
        alpha = rate.alpha
        one_minus = 1.0 - alpha
        r_last = rate._last
        r_mg = rate._mean_gap
        outstanding = pol._outstanding
        hw = pol._outstanding_hw

        def flush():
            rate._last = r_last
            rate._mean_gap = r_mg
            pol._outstanding = outstanding
            pol._outstanding_hw = hw
            for m in range(n_live):
                bi = buf_i[m]
                if bi:
                    wqs[m].extend_arrays(
                        np.array(bi, dtype=np.int64),
                        np.array(buf_t[m], dtype=np.float64))

        ts = times[cur:k_bound].tolist()
        rl = ids[cur:k_bound].tolist()
        consumed = 0
        for j in range(len(ts)):
            t = ts[j]
            # inline _ContinuousAbsorbWindow._best: first live worker
            # with spare capacity minimizing (expected_wait, id)
            best = -1
            bw = 0.0
            bid = 0
            for m in range(n_live):
                if caps[m] <= 0:
                    continue
                wait = busys[m] - t
                if wait < 0.0:
                    wait = 0.0
                wait = wait + (qlens[m] / batches[m]) * pbls[m]
                if best < 0 or wait < bw or (wait == bw and wids[m] < bid):
                    best = m
                    bw = wait
                    bid = wids[m]
            if best < 0:
                # backpressure: every bounded queue is full — the rest
                # of the window is pure central appends, finish in bulk
                flush()
                rem = k_bound - (cur + j)
                queue.extend_arrays(ids[cur + j:k_bound],
                                    times[cur + j:k_bound])
                pol._absorb_signal(times, cur + j, k_bound)
                self.fast_absorbed += consumed + rem
                return consumed + rem
            if busys[best] <= t:
                # idle worker — three exact outcomes:
                if coal[best] and qlens[best] + 1 < batches[best]:
                    # coalesce timer already armed and the append stays
                    # below the fire threshold: _feed is a no-op, the
                    # arrival is a pure worker-queue append — absorbable
                    pass
                elif qlens[best] + 1 < batches[best]:
                    # the append would arm the coalesce timer: arm it
                    # exactly (same fire time, same callback), absorb
                    # the arrival, and end the window so the merge loop
                    # re-orders against the new timer
                    w = live[best]
                    w.coalesce_armed = True
                    self.loop.at(t + timeout,
                                 lambda w=w: pol._coalesce_fire(w))
                    bi = buf_i[best]
                    bi.append(rl[j])
                    buf_t[best].append(t)
                    if r_last is not None:
                        gap = t - r_last
                        if gap < 1e-9:
                            gap = 1e-9
                        r_mg = (gap if r_mg is None
                                else alpha * gap + one_minus * r_mg)
                    r_last = t
                    outstanding += 1
                    if outstanding > hw:
                        hw = outstanding
                    consumed += 1
                    flush()
                    self.fast_absorbed += consumed
                    return consumed
                else:
                    # the append reaches the fire threshold: complete
                    # the arrival inline through the exact per-arrival
                    # code with the merge loop's clock advance, then
                    # end the window (the dispatch schedules events
                    # that re-order against later arrivals)
                    flush()
                    self.fast_absorbed += consumed
                    self.fast_one_by_one += 1
                    loop = self.plane.loop
                    if t > loop.now:
                        loop.now = t
                    self.on_request(Request(rl[j], t))
                    return consumed + 1
            bi = buf_i[best]
            bi.append(rl[j])
            buf_t[best].append(t)
            qlens[best] += 1
            caps[best] -= 1
            if r_last is not None:
                gap = t - r_last
                if gap < 1e-9:
                    gap = 1e-9
                r_mg = gap if r_mg is None else alpha * gap + one_minus * r_mg
            r_last = t
            outstanding += 1
            if outstanding > hw:
                hw = outstanding
            consumed += 1
        flush()
        self.fast_absorbed += consumed
        return consumed

    def trace_absorber(self, ids: np.ndarray):
        def absorber(ts, cur, k_bound, _self=self, _ids=ids):
            return _self._absorb_run(_ids, ts, cur, k_bound)
        return absorber

    def begin_absorb_window(self) -> Optional[_ContinuousAbsorbWindow]:
        win = _ContinuousAbsorbWindow(self)
        return win if win.usable else None


# --------------------------------------------------------------------- #
# the plane
# --------------------------------------------------------------------- #
class FastPlane(SimulatedPlane):
    """A :class:`~repro.serving.plane.SimulatedPlane` over a
    :class:`FastLoop` whose dispatcher factory selects the vectorized
    engine for batch-synchronous *and* continuous-dispatch tenants.
    Custom policy subclasses get the legacy dispatcher (exact by
    construction, unaccelerated)."""

    name = "fast"

    def __init__(self, loop: Optional[FastLoop] = None) -> None:
        if loop is None:
            loop = FastLoop()
        if not isinstance(loop, FastLoop):
            raise TypeError(f"FastPlane needs a FastLoop, got {type(loop)}")
        super().__init__(loop)

    def make_dispatcher(self, config, instances, on_response, dcfg=None,
                        policy=None, model_id: str = DEFAULT_MODEL,
                        peer_live=None):
        if policy is None or type(policy) is BatchSyncPolicy:
            return FastSyncDispatcher(
                self, config, instances, on_response, dcfg,
                policy=FastBatchSyncPolicy(), model_id=model_id,
                peer_live=peer_live)
        if type(policy) is ContinuousPolicy:
            # mirror the caller-supplied tuning knobs onto the fast twin
            return FastContinuousDispatcher(
                self, config, instances, on_response, dcfg,
                policy=FastContinuousPolicy(
                    queue_factor=policy.queue_factor,
                    rate_alpha=policy.rate.alpha),
                model_id=model_id, peer_live=peer_live)
        return Dispatcher(self, config, instances, on_response, dcfg,
                          policy=policy, model_id=model_id,
                          peer_live=peer_live)


# --------------------------------------------------------------------- #
# trace feeding
# --------------------------------------------------------------------- #
def feed_single_model_trace(server, arrivals: Sequence[float], *,
                            id_offset: int = 0) -> int:
    """Attach a single-model arrival trace to a server on a
    :class:`FastLoop` (ids ``offset..offset+n-1`` in trace order — what
    the legacy driver's ``enumerate`` produced).

    When the server's dispatcher is a :class:`FastSyncDispatcher`,
    passive arrivals are absorbed straight into its columnar queue;
    otherwise every arrival is delivered one-at-a-time (identical
    behaviour, unaccelerated).  Returns the number of arrivals fed.
    """
    loop = server.plane.loop
    if not isinstance(loop, FastLoop):
        raise TypeError("feed_single_model_trace needs a FastLoop server")
    times = np.ascontiguousarray(arrivals, dtype=np.float64)
    n = int(times.size)
    ids = np.arange(id_offset, id_offset + n, dtype=np.int64)
    disp = server.dispatcher

    make_absorber = getattr(disp, "trace_absorber", None)
    absorber = make_absorber(ids) if make_absorber is not None else None

    def arrive_one(i, t, _submit=server.submit, _disp=disp):
        _disp.fast_one_by_one += 1
        _submit(Request(id_offset + i, t))

    loop.add_trace(times, arrive_one, absorber=absorber)
    return n


def feed_multi_model_trace(server, traces) -> int:
    """Attach merged per-model arrival arrays to a
    :class:`~repro.serving.tenancy.MultiModelServer` on a
    :class:`FastLoop`.

    ``traces`` maps tenant id → sorted arrival times.  The per-model
    arrays merge into one ``(time, seq, model)`` columnar trace — ids
    are assigned in merged ``(time, tenant-index)`` order, exactly the
    enumeration the legacy driver produced with ``sorted()`` +
    ``enumerate`` — and passive arrivals absorb straight into the
    owning tenant's :class:`ColumnQueue` (per-tenant absorption windows
    re-open after every heap event).  Every declined arrival goes
    through ``server.submit`` one-at-a-time, identical to the oracle.
    Returns the number of arrivals fed.
    """
    loop = server.plane.loop
    if not isinstance(loop, FastLoop):
        raise TypeError("feed_multi_model_trace needs a FastLoop server")
    order = [tid for tid in server._order if tid in traces]
    unknown = set(traces) - set(order)
    if unknown:
        raise KeyError(f"unknown tenant ids in traces: {sorted(unknown)}")
    parts_t = [np.ascontiguousarray(traces[tid], dtype=np.float64)
               for tid in order]
    parts_c = [np.full(p.size, k, dtype=np.int64)
               for k, p in enumerate(parts_t)]
    if parts_t:
        times = np.concatenate(parts_t)
        codes = np.concatenate(parts_c)
    else:
        times = np.empty(0, dtype=np.float64)
        codes = np.empty(0, dtype=np.int64)
    # stable (time, tenant-index) merge == sorted((t, k, tid) ...)
    idx = np.lexsort((codes, times))
    times = np.ascontiguousarray(times[idx])
    codes = codes[idx]
    n = int(times.size)
    times_l = times.tolist()
    codes_l = codes.tolist()
    disps = [server.tenants[tid].dispatcher for tid in order]
    rates = [server.rates[tid] for tid in order]
    counts = server._counts
    submit = server.submit

    def arrive_one(i, t):
        c = codes_l[i]
        disps[c].fast_one_by_one += 1
        submit(Request(i, t, model_id=order[c]))

    K = len(order)
    _SW = _SyncAbsorbWindow

    def absorber(ts, cur, k_bound):
        # Per-tenant absorption state, opened lazily on first arrival.
        # Sync-window tenants (kind 1) run inline over locals: queue
        # pushes buffered into plain lists, the tenant rate EWMA and
        # admission count replayed on locals, the exact arming calls
        # issued in place.  Other window types (kind 2) go through the
        # generic absorb_one; an absorption-incapable tenant (kind 3)
        # ends the window.  Locals flush back before every return.
        kind = [0] * K
        wins = [None] * K
        w_qlen = [0] * K
        w_B = [0] * K
        w_ta = [False] * K
        w_wa = [False] * K
        w_live = [False] * K
        w_maxb = [0.0] * K
        w_busys = [None] * K
        w_pol = [None] * K
        w_to = [0.0] * K
        buf_i = [None] * K
        buf_t = [None] * K
        r_alpha = [0.0] * K
        r_om = [0.0] * K
        r_last: list = [None] * K
        r_mg: list = [None] * K
        c_add = [0] * K
        touched = [False] * K
        consumed = 0

        def flush():
            for c in range(K):
                if not touched[c]:
                    continue
                sig = rates[c]
                sig._last = r_last[c]
                sig._mean_gap = r_mg[c]
                if c_add[c]:
                    counts[order[c]] += c_add[c]
                bi = buf_i[c]
                if bi:
                    d = disps[c]
                    d.queue.extend_arrays(
                        np.array(bi, dtype=np.int64),
                        np.array(buf_t[c], dtype=np.float64))
                    d.fast_absorbed += len(bi)

        i = cur
        while i < k_bound:
            c = codes_l[i]
            k = kind[c]
            if k == 0:
                d = disps[c]
                begin = getattr(d, "begin_absorb_window", None)
                win = begin() if begin is not None else None
                if win is None:
                    kind[c] = k = 3
                elif type(win) is _SW:
                    kind[c] = k = 1
                    w_qlen[c] = win.qlen
                    w_B[c] = win.B
                    w_ta[c] = win.timeout_armed
                    w_wa[c] = win.wakeup_armed
                    w_live[c] = win.has_live
                    w_maxb[c] = win.max_busy
                    w_busys[c] = win.busys
                    w_pol[c] = win.pol
                    w_to[c] = d.dcfg.batch_timeout
                    buf_i[c] = []
                    buf_t[c] = []
                    sig = rates[c]
                    r_alpha[c] = sig.alpha
                    r_om[c] = 1.0 - sig.alpha
                    r_last[c] = sig._last
                    r_mg[c] = sig._mean_gap
                    touched[c] = True
                else:
                    kind[c] = k = 2
                    wins[c] = win
            if k == 3:
                break
            t = times_l[i]
            if k == 1:
                armed = False
                if w_qlen[c] + 1 < w_B[c]:
                    if not w_ta[c]:
                        # on_arrival's arming branch, with now == t
                        pol = w_pol[c]
                        pol._timeout_armed = True
                        disps[c].loop.at(t + w_to[c], pol._on_timeout)
                        w_ta[c] = True
                        armed = True
                elif (not w_live[c]) or t < w_maxb[c]:
                    if not w_wa[c]:
                        # _try_dispatch's wake-up branch, with now == t
                        pol = w_pol[c]
                        if not w_live[c]:
                            pol._wakeup_at(t + w_to[c])
                        else:
                            pol._wakeup_at(min(b for b in w_busys[c]
                                               if b > t))
                        w_wa[c] = True
                        armed = True
                else:
                    break   # arrival must be observed: exact path
                buf_i[c].append(i)
                buf_t[c].append(t)
                w_qlen[c] += 1
                # MultiModelServer.submit's accounting, on locals
                last = r_last[c]
                if last is not None:
                    gap = t - last
                    if gap < 1e-9:
                        gap = 1e-9
                    mg = r_mg[c]
                    r_mg[c] = (gap if mg is None
                               else r_alpha[c] * gap + r_om[c] * mg)
                r_last[c] = t
                c_add[c] += 1
                consumed += 1
                i += 1
                if armed:
                    break   # the tenant armed a timer: bound stale
            else:
                win = wins[c]
                if not win.absorb_one(i, t):
                    break
                # replay MultiModelServer.submit's per-arrival accounting
                rates[c].observe(t)
                counts[order[c]] += 1
                consumed += 1
                i += 1
                if win.armed_stop:
                    break   # the tenant armed a timer: bound stale
        flush()
        return consumed

    loop.add_trace(times, arrive_one, absorber=absorber)
    return n


__all__ = [
    "ColumnQueue", "FastBatchSyncPolicy", "FastContinuousDispatcher",
    "FastContinuousPolicy", "FastLoop", "FastPlane", "FastSyncDispatcher",
    "ResponseBlock", "ResponseLog", "feed_multi_model_trace",
    "feed_single_model_trace",
]
