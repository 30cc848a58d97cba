"""SLO metrics collection for serving runs.

A :class:`MetricsCollector` observes a live :class:`PackratServer`
without touching the dispatcher/event-loop hot paths:

* **responses** are captured by chaining the dispatcher's existing
  ``on_response`` callback (``attach``) or fed after the run
  (``ingest``);
* **queue depth** is sampled by a periodic event scheduled on the same
  virtual clock, reading the dispatcher's public ``queue_depth``.

It produces the quantities serving papers report: per-request latency
histogram (log₂ buckets), p50/p95/p99 (nearest-rank), goodput against
an SLO deadline (completed-within-deadline per second of offered load —
requests that never complete count against goodput, which is what makes
it an honest overload metric), and the queue-depth timeline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .simulator import EventLoop, Request, Response, Shed


def nearest_rank(sorted_values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in (0, 100]) of pre-sorted values."""
    if not sorted_values:
        return float("nan")
    if not (0.0 < q <= 100.0):
        raise ValueError(f"q must be in (0, 100], got {q}")
    rank = max(1, math.ceil(q / 100.0 * len(sorted_values)))
    return sorted_values[rank - 1]


# --------------------------------------------------------------------- #
# vectorized aggregation kernels
#
# Column duals of the per-record reference implementations above/below.
# Each is value-identical to its scalar counterpart on float64 inputs
# (no re-summation or fused arithmetic that could round differently);
# tests/test_metrics_properties.py checks them property-style against
# the per-record reference on random streams.
# --------------------------------------------------------------------- #
def vector_percentiles(values: Sequence[float],
                       qs: Sequence[float]) -> List[float]:
    """Nearest-rank percentiles of an unsorted sample in one sort."""
    arr = np.sort(np.asarray(values, dtype=np.float64))
    n = int(arr.size)
    out = []
    for q in qs:
        if not (0.0 < q <= 100.0):
            raise ValueError(f"q must be in (0, 100], got {q}")
        if n == 0:
            out.append(float("nan"))
        else:
            rank = max(1, math.ceil(q / 100.0 * n))
            out.append(float(arr[rank - 1]))
    return out


def vector_within_slo(values: Sequence[float],
                      slo: Optional[float]) -> int:
    """Count of samples at or under the deadline (all, if no SLO)."""
    arr = np.asarray(values, dtype=np.float64)
    if slo is None:
        return int(arr.size)
    return int(np.count_nonzero(arr <= slo))


def vector_log2_ms_buckets(values_s: Sequence[float]) -> Dict[int, int]:
    """{bucket index: count} of durations under the log₂-ms scheme.

    ``frexp`` decomposes ms = m·2^e with m ∈ [0.5, 1), so the bucket
    ``floor(log2(ms)) + 1`` is exactly ``e`` — integer arithmetic,
    bit-identical to the scalar :func:`log2_ms_bucket` on every input.
    """
    ms = np.asarray(values_s, dtype=np.float64) * 1e3
    if ms.size == 0:
        return {}
    _, exps = np.frexp(ms)
    exps = np.where(ms < 1.0, 0, exps)
    idx, counts = np.unique(exps, return_counts=True)
    return {int(k): int(c) for k, c in zip(idx, counts)}


@dataclasses.dataclass(frozen=True)
class LatencyBucket:
    lo_ms: float          # inclusive
    hi_ms: float          # exclusive
    count: int


def log2_ms_bucket(value_s: float) -> int:
    """Bucket index of a duration (seconds) in the log₂-ms scheme.

    Computed via ``frexp`` (ms = m·2^e, m ∈ [0.5, 1) → bucket is exactly
    ``e`` = floor(log₂ ms) + 1): pure integer extraction, so the scalar
    and vectorized (:func:`vector_log2_ms_buckets`) paths agree on every
    float, including values one ulp under a power of two where a rounded
    ``log2`` could land in the wrong bucket.
    """
    ms = value_s * 1e3
    if ms < 1.0:
        return 0
    return math.frexp(ms)[1]


def buckets_to_histogram(buckets: Dict[int, int]) -> List[LatencyBucket]:
    """Materialize {bucket index: count} into ordered LatencyBuckets."""
    out = []
    for k in sorted(buckets):
        lo = 0.0 if k == 0 else 2.0 ** (k - 1)
        out.append(LatencyBucket(lo_ms=lo, hi_ms=2.0 ** k, count=buckets[k]))
    return out


def log2_ms_histogram(values_s: Sequence[float]) -> List[LatencyBucket]:
    """Log₂ millisecond buckets from 1 ms up, covering every sample."""
    buckets: Dict[int, int] = {}
    for v in values_s:
        k = log2_ms_bucket(v)
        buckets[k] = buckets.get(k, 0) + 1
    return buckets_to_histogram(buckets)


def instance_report(workers, now: float, *,
                    model_id: Optional[str] = None,
                    engine: Optional[str] = None
                    ) -> List[Dict[str, object]]:
    """Per-instance utilization + idle-gap summary (JSON-serializable).

    ``workers`` is any iterable of :class:`WorkerInstance` — e.g. a
    ``PackratServer.workers_ever`` log, so swapped-out instance sets are
    included.  The idle-gap histogram is what makes the dispatch-policy
    comparison measurable: batch-synchronous dispatch barriers the whole
    set on the slowest sub-batch, which shows up as wide idle gaps on
    thin instances; continuous dispatch collapses them.

    Rows carry the worker's ``model_id`` (instance ids are only unique
    *within* a tenant); ``model_id=`` filters to one tenant's workers.
    ``engine`` (the owning dispatcher's ``engine_name``, ``"fast"`` or
    ``"event"``) tags every row so operators can see which simulation
    core produced the numbers — benchmark comparisons strip the tag
    before diffing reports across engines.
    """
    out = []
    if model_id is not None:
        workers = [w for w in workers if w.model_id == model_id]
    for w in sorted(workers, key=lambda w: (w.model_id, w.id)):
        out.append({
            "id": w.id,
            "model_id": w.model_id,
            **({"engine": engine} if engine is not None else {}),
            "threads": w.threads,
            "batch": w.batch,
            "batches": w.stats.batches,
            "items": w.stats.items,
            "busy_time_s": w.stats.busy_time,
            "idle_time_s": w.stats.idle_time,
            "utilization": w.utilization(now),
            "failures": w.stats.failures,
            "idle_gap_hist": [
                {"lo_ms": b.lo_ms, "hi_ms": b.hi_ms, "count": b.count}
                for b in buckets_to_histogram(w.idle_gap_buckets)
            ],
        })
    return out


class MetricsCollector:
    """Per-request latency + SLO accounting for one serving run.

    Every sample is additionally keyed by ``model_id`` so multi-model
    runs get a per-tenant breakdown (``models_report`` / the ``models``
    key of :meth:`report`); a single-model run degenerates to one
    ``"default"`` entry that matches the aggregate numbers exactly.
    ``slo_by_model`` overrides the global SLO deadline per tenant.

    Fabric runs additionally feed :meth:`on_shed` (a request refused by
    admission or overload control — a terminal state: it never
    completes) and tag responses with ``node_id``; the report then
    carries shed counts and a per-node breakdown.  Latency percentiles
    are **admitted-only by construction** — a shed request contributes
    no latency sample — while goodput and SLO attainment divide by
    *offered* load, so sheds count against both.
    """

    def __init__(self, *, slo_deadline: Optional[float] = None,
                 slo_by_model: Optional[Dict[str, float]] = None) -> None:
        self.slo_deadline = slo_deadline     # seconds, None = no SLO
        self.slo_by_model = dict(slo_by_model or {})
        self.offered = 0
        self.latencies: List[float] = []     # seconds, completion order
        self.redispatched = 0
        self.queue_timeline: List[Tuple[float, int]] = []
        self._batch_sizes: List[int] = []
        self.offered_by_model: Dict[str, int] = {}
        self.latencies_by_model: Dict[str, List[float]] = {}
        self.shed = 0
        self.shed_by_model: Dict[str, int] = {}
        self.shed_by_node: Dict[str, int] = {}
        self.latencies_by_node: Dict[str, List[float]] = {}
        # autoregressive runs tag requests with a phase ("prefill" /
        # "decode"); one-shot requests carry "" and land in no phase
        # bucket, keeping their report schema byte-identical
        self.latencies_by_phase: Dict[str, List[float]] = {}
        # fidelity-ladder runs tag responses with the serving rung;
        # ladder-off responses carry None and land in no rung bucket,
        # keeping their report schema byte-identical
        self.latencies_by_fidelity: Dict[int, List[float]] = {}
        self.rung_qualities: Optional[List[float]] = None

    def set_rung_qualities(self, qualities: Sequence[float]) -> None:
        """Per-rung quality weights (rung index → quality in (0,1]) for
        the fidelity-weighted metrics; without them every rung weighs
        1.0 and goodput-at-fidelity degenerates to plain goodput."""
        self.rung_qualities = list(qualities)

    def _rung_quality(self, rung: int) -> float:
        if self.rung_qualities is not None and rung < len(self.rung_qualities):
            return self.rung_qualities[rung]
        return 1.0

    def slo_for(self, model_id: str) -> Optional[float]:
        return self.slo_by_model.get(model_id, self.slo_deadline)

    # ------------------------------------------------------------------ #
    # feeding
    # ------------------------------------------------------------------ #
    def on_request(self, req: Request) -> None:
        self.offered += 1
        model = getattr(req, "model_id", "default")
        self.offered_by_model[model] = self.offered_by_model.get(model, 0) + 1

    def on_requests(self, n: int, model_id: str = "default") -> None:
        """Bulk-count offered load: equivalent to ``n`` calls of
        :meth:`on_request` with the same model (offered counts are
        order-independent), without materializing request objects."""
        if n <= 0:
            return
        self.offered += n
        self.offered_by_model[model_id] = (
            self.offered_by_model.get(model_id, 0) + n)

    def on_response(self, resp: Response) -> None:
        self.latencies.append(resp.latency)
        self._batch_sizes.append(resp.batch_size)
        model = getattr(resp.request, "model_id", "default")
        self.latencies_by_model.setdefault(model, []).append(resp.latency)
        node = getattr(resp, "node_id", None)
        if node is not None:
            self.latencies_by_node.setdefault(node, []).append(resp.latency)
        phase = getattr(resp.request, "phase", "")
        if phase:
            self.latencies_by_phase.setdefault(phase, []).append(resp.latency)
        fid = getattr(resp, "fidelity", None)
        if fid is not None:
            self.latencies_by_fidelity.setdefault(fid, []).append(resp.latency)
        if resp.redispatched:
            self.redispatched += 1

    def on_response_block(self, block) -> None:
        """Ingest one :class:`~repro.serving.fastsim.ResponseBlock`.

        The latency column is ``completion - arrivals`` in float64 —
        bit-identical to the per-object ``resp.latency`` subtraction —
        so every derived quantity matches the per-record path exactly.
        A block that crossed the cluster fabric carries the router's
        ``node_id`` tag and lands in the per-node breakdown, same as a
        tagged per-object response.
        """
        lats = (block.completion - block.arrivals).tolist()
        n = len(lats)
        self.latencies.extend(lats)
        self._batch_sizes.extend([block.batch_size] * n)
        self.latencies_by_model.setdefault(block.model_id, []).extend(lats)
        if block.node_id is not None:
            self.latencies_by_node.setdefault(block.node_id,
                                              []).extend(lats)
        fid = getattr(block, "fidelity", None)
        if fid is not None:
            self.latencies_by_fidelity.setdefault(fid, []).extend(lats)
        if block.redispatched:
            self.redispatched += n

    def on_shed(self, shed: Shed) -> None:
        """Record a terminal shed: counted against offered load (goodput
        and attainment) but never in the latency percentiles."""
        self.shed += 1
        model = getattr(shed.request, "model_id", "default")
        self.shed_by_model[model] = self.shed_by_model.get(model, 0) + 1
        node = shed.node_id or "unrouted"
        self.shed_by_node[node] = self.shed_by_node.get(node, 0) + 1

    def ingest(self, responses: Sequence[Response], *,
               offered: Optional[int] = None) -> None:
        """Post-hoc feeding from ``server.responses``."""
        for r in responses:
            self.on_response(r)
        if offered is not None:
            self.offered = offered

    def attach(self, server, *, sample_interval: float = 0.1,
               until: Optional[float] = None) -> None:
        """Hook a live server without modifying its hot path.

        Chains each dispatcher's ``on_response`` (the dispatcher already
        calls through an attribute, so swapping the attribute is safe
        mid-run) and schedules a queue-depth sampler on the server's
        event loop.  ``until`` bounds the sampler so ``loop.run()``
        still terminates.  Works on a single-model ``PackratServer``
        (one dispatcher) and a ``MultiModelServer`` (one dispatcher per
        tenant; the sampler reads the aggregate ``queue_depth``).
        """
        tenants = getattr(server, "tenants", None)
        if tenants is not None:
            dispatchers = [t.dispatcher for t in tenants.values()]
            sampled = server            # aggregate queue_depth property
        else:
            dispatchers = [server.dispatcher]
            sampled = server.dispatcher
        for disp in dispatchers:
            block_prev = getattr(disp, "on_response_block", None)
            if block_prev is not None:
                # block-delivering dispatcher: chain the block hook only
                # (its per-item fault path feeds the same hook as
                # single-item blocks, so chaining on_response too would
                # double-count)
                def chained_block(block, prev=block_prev) -> None:
                    prev(block)
                    self.on_response_block(block)

                disp.on_response_block = chained_block
                continue
            prev = disp.on_response

            def chained(resp: Response, prev=prev) -> None:
                prev(resp)
                self.on_response(resp)

            disp.on_response = chained
        self.attach_queue_sampler(server.loop, sampled,
                                  interval=sample_interval, until=until)

    def attach_fabric(self, router, *, sample_interval: float = 0.1,
                      until: Optional[float] = None) -> None:
        """Hook a live :class:`~repro.serving.fabric.ClusterRouter`:
        chains its ``on_response``/``on_shed`` callbacks and samples the
        fleet-aggregate ``queue_depth`` on the shared clock.  A
        block-delivering router (fast plane) additionally gets its
        ``on_response_block`` chained — non-duplicate blocks bypass the
        per-response hook, while the duplicate-suppression fallback
        still delivers per response, so both chains together see each
        delivery exactly once."""
        prev_resp = router.on_response

        def chained_resp(resp: Response) -> None:
            if prev_resp is not None:
                prev_resp(resp)
            self.on_response(resp)

        router.on_response = chained_resp
        if hasattr(router, "on_response_block"):
            prev_block = router.on_response_block

            def chained_block(block) -> None:
                if prev_block is not None:
                    prev_block(block)
                self.on_response_block(block)

            router.on_response_block = chained_block
        prev_shed = router.on_shed

        def chained_shed(shed: Shed) -> None:
            if prev_shed is not None:
                prev_shed(shed)
            self.on_shed(shed)

        router.on_shed = chained_shed
        self.attach_queue_sampler(router.loop, router,
                                  interval=sample_interval, until=until)

    def attach_queue_sampler(self, loop: EventLoop, dispatcher, *,
                             interval: float = 0.1,
                             until: Optional[float] = None) -> None:
        def sample() -> None:
            self.queue_timeline.append((loop.now, dispatcher.queue_depth))
            if until is None or loop.now + interval <= until:
                loop.schedule(interval, sample)

        loop.schedule(interval, sample)

    # ------------------------------------------------------------------ #
    # derived metrics
    # ------------------------------------------------------------------ #
    @property
    def completed(self) -> int:
        return len(self.latencies)

    def percentile(self, q: float) -> float:
        return vector_percentiles(self.latencies, (q,))[0]

    def within_slo(self) -> int:
        if not self.slo_by_model:
            return vector_within_slo(self.latencies, self.slo_deadline)
        return sum(self.within_slo_model(m) for m in self.latencies_by_model)

    def within_slo_model(self, model_id: str) -> int:
        lats = self.latencies_by_model.get(model_id, [])
        slo = self.slo_for(model_id)
        if slo is None:
            return len(lats)
        return sum(1 for lat in lats if lat <= slo)

    def goodput(self, duration: float) -> float:
        """Requests completed within the SLO per second of offered load."""
        if duration <= 0:
            raise ValueError("duration must be > 0")
        return self.within_slo() / duration

    def slo_attainment(self) -> float:
        """Fraction of *offered* requests that completed within the SLO.

        Dividing by offered (not completed) makes dropped/never-finished
        requests SLO violations rather than silently vanishing.
        """
        denom = max(self.offered, self.completed)
        return self.within_slo() / denom if denom else 1.0

    def queue_peak(self) -> int:
        return max((d for _, d in self.queue_timeline), default=0)

    def queue_mean(self) -> float:
        if not self.queue_timeline:
            return 0.0
        return sum(d for _, d in self.queue_timeline) / len(self.queue_timeline)

    def histogram(self) -> List[LatencyBucket]:
        """Log₂ latency buckets from 1 ms up, covering every sample
        (vectorized; bucket-identical to :func:`log2_ms_histogram`)."""
        return buckets_to_histogram(vector_log2_ms_buckets(self.latencies))

    # ------------------------------------------------------------------ #
    def models_report(self, *, duration: float) -> Dict[str, Dict[str, object]]:
        """Per-model breakdown: the same headline quantities as the
        aggregate report, keyed by ``model_id``.  Models that were
        offered traffic but never completed a request still appear."""
        models = sorted(set(self.offered_by_model)
                        | set(self.latencies_by_model)
                        | set(self.shed_by_model))
        out: Dict[str, Dict[str, object]] = {}
        for m in models:
            lats = sorted(self.latencies_by_model.get(m, []))
            n = len(lats)
            offered = max(self.offered_by_model.get(m, 0), n)
            within = self.within_slo_model(m)
            slo = self.slo_for(m)
            shed = self.shed_by_model.get(m, 0)
            out[m] = {
                "offered": offered,
                "completed": n,
                "shed": shed,
                "incomplete": max(offered - n - shed, 0),
                "latency_ms": {
                    "mean": (sum(lats) / n * 1e3) if n else None,
                    "p50": nearest_rank(lats, 50) * 1e3 if n else None,
                    "p95": nearest_rank(lats, 95) * 1e3 if n else None,
                    "p99": nearest_rank(lats, 99) * 1e3 if n else None,
                    "max": lats[-1] * 1e3 if n else None,
                },
                "slo_deadline_ms": slo * 1e3 if slo is not None else None,
                "within_slo": within,
                "goodput_rps": within / duration,
                "slo_attainment": within / offered if offered else 1.0,
            }
        return out

    def nodes_report(self, *, duration: float) -> Dict[str, Dict[str, object]]:
        """Per-node breakdown for fabric runs: completions, admitted-only
        percentiles, shed count and goodput, keyed by ``node_id``
        (sheds that never reached a node appear under ``"unrouted"``).
        Empty for single-node runs (no response carries a node tag)."""
        node_ids = sorted(set(self.latencies_by_node)
                          | set(self.shed_by_node))
        out: Dict[str, Dict[str, object]] = {}
        for nid in node_ids:
            lats = sorted(self.latencies_by_node.get(nid, []))
            n = len(lats)
            slo = self.slo_deadline
            within = (n if slo is None
                      else sum(1 for lat in lats if lat <= slo))
            out[nid] = {
                "completed": n,
                "shed": self.shed_by_node.get(nid, 0),
                "latency_ms": {
                    "mean": (sum(lats) / n * 1e3) if n else None,
                    "p50": nearest_rank(lats, 50) * 1e3 if n else None,
                    "p95": nearest_rank(lats, 95) * 1e3 if n else None,
                    "p99": nearest_rank(lats, 99) * 1e3 if n else None,
                    "max": lats[-1] * 1e3 if n else None,
                },
                "within_slo": within,
                "goodput_rps": within / duration,
            }
        return out

    def phases_report(self) -> Dict[str, Dict[str, object]]:
        """Per-phase latency breakdown for autoregressive runs.

        The prefill bucket's request latency is **TTFT** (arrival →
        first token); the decode bucket's is **TPOT** (decode-step
        re-enqueue → token delivery).  Empty for one-shot runs — no
        request carries a phase tag — so non-LM reports keep their
        schema unchanged."""
        out: Dict[str, Dict[str, object]] = {}
        for phase in sorted(self.latencies_by_phase):
            lats = sorted(self.latencies_by_phase[phase])
            n = len(lats)
            out[phase] = {
                "completed": n,
                "latency_ms": {
                    "mean": (sum(lats) / n * 1e3) if n else None,
                    "p50": nearest_rank(lats, 50) * 1e3 if n else None,
                    "p95": nearest_rank(lats, 95) * 1e3 if n else None,
                    "p99": nearest_rank(lats, 99) * 1e3 if n else None,
                    "max": lats[-1] * 1e3 if n else None,
                },
            }
        return out

    def fidelity_report(self, *, duration: float) -> Dict[str, Dict[str, object]]:
        """Per-rung breakdown for fidelity-ladder runs: completions,
        admitted-only percentiles, within-SLO count, goodput and the
        rung's quality weight, keyed by rung index (as a string for
        JSON round-tripping).  Empty when no response carries a
        fidelity tag — ladder-off reports keep their schema unchanged."""
        out: Dict[str, Dict[str, object]] = {}
        for rung in sorted(self.latencies_by_fidelity):
            lats = sorted(self.latencies_by_fidelity[rung])
            n = len(lats)
            slo = self.slo_deadline
            within = (n if slo is None
                      else sum(1 for lat in lats if lat <= slo))
            out[str(rung)] = {
                "completed": n,
                "quality": self._rung_quality(rung),
                "latency_ms": {
                    "mean": (sum(lats) / n * 1e3) if n else None,
                    "p50": nearest_rank(lats, 50) * 1e3 if n else None,
                    "p95": nearest_rank(lats, 95) * 1e3 if n else None,
                    "p99": nearest_rank(lats, 99) * 1e3 if n else None,
                    "max": lats[-1] * 1e3 if n else None,
                },
                "within_slo": within,
                "goodput_rps": within / duration,
            }
        return out

    def goodput_at_fidelity(self, duration: float) -> float:
        """Quality-weighted goodput: Σ_r quality_r · within_slo_r per
        second.  A request served at a degraded rung still counts, but
        only for its rung's quality — shedding it would count zero, so
        this is the quantity the degrade ladder is designed to maximize
        under overload."""
        if duration <= 0:
            raise ValueError("duration must be > 0")
        slo = self.slo_deadline
        total = 0.0
        for rung, lats in self.latencies_by_fidelity.items():
            within = vector_within_slo(lats, slo)
            total += self._rung_quality(rung) * within
        return total / duration

    def fidelity_weighted_attainment(self) -> float:
        """Quality-weighted SLO attainment: Σ_r quality_r · within_slo_r
        over *offered* load — sheds and never-finished requests count
        zero, degraded completions count their rung's quality."""
        slo = self.slo_deadline
        total = 0.0
        for rung, lats in self.latencies_by_fidelity.items():
            total += self._rung_quality(rung) * vector_within_slo(lats, slo)
        denom = max(self.offered, self.completed)
        return total / denom if denom else 1.0

    def worst_model_p95(self) -> float:
        """max over models of p95 latency — the multi-model makespan
        analogue the planner minimizes (NaN with no completions)."""
        p95s = [nearest_rank(sorted(lats), 95)
                for lats in self.latencies_by_model.values() if lats]
        return max(p95s) if p95s else float("nan")

    def report(self, *, duration: float) -> Dict[str, object]:
        """The JSON-serializable summary the benchmark CLI emits."""
        lats = sorted(self.latencies)
        n = len(lats)
        rep: Dict[str, object] = {
            "offered": max(self.offered, n),
            "completed": n,
            "admitted": max(self.offered, n) - self.shed,
            "shed": self.shed,
            "shed_rate": (self.shed / max(self.offered, n)
                          if max(self.offered, n) else 0.0),
            "incomplete": max(self.offered - n - self.shed, 0),
            "redispatched": self.redispatched,
            "latency_ms": {
                "mean": (sum(lats) / n * 1e3) if n else None,
                "p50": nearest_rank(lats, 50) * 1e3 if n else None,
                "p95": nearest_rank(lats, 95) * 1e3 if n else None,
                "p99": nearest_rank(lats, 99) * 1e3 if n else None,
                "max": lats[-1] * 1e3 if n else None,
            },
            "slo_deadline_ms": (self.slo_deadline * 1e3
                                if self.slo_deadline is not None else None),
            "within_slo": self.within_slo(),
            "goodput_rps": self.within_slo() / duration,
            "slo_attainment": self.slo_attainment(),
            "queue_depth": {
                "peak": self.queue_peak(),
                "mean": self.queue_mean(),
                "samples": len(self.queue_timeline),
            },
            "latency_histogram": [
                {"lo_ms": b.lo_ms, "hi_ms": b.hi_ms, "count": b.count}
                for b in self.histogram()
            ],
            "models": self.models_report(duration=duration),
        }
        nodes = self.nodes_report(duration=duration)
        if nodes:
            # only fabric runs produce node-tagged samples; single-node
            # reports keep their schema unchanged
            rep["nodes"] = nodes
        phases = self.phases_report()
        if phases:
            # only autoregressive runs produce phase-tagged samples;
            # one-shot reports keep their schema unchanged.  TTFT/TPOT
            # are aliases of the prefill/decode latency summaries — the
            # headline numbers an LLM-serving comparison reads.
            rep["phases"] = phases
            if "prefill" in phases:
                rep["ttft_ms"] = phases["prefill"]["latency_ms"]
            if "decode" in phases:
                rep["tpot_ms"] = phases["decode"]["latency_ms"]
        fidelity = self.fidelity_report(duration=duration)
        if fidelity:
            # only fidelity-ladder runs produce rung-tagged samples;
            # ladder-off reports keep their schema unchanged
            rep["fidelity_report"] = fidelity
            rep["goodput_at_fidelity"] = self.goodput_at_fidelity(duration)
            rep["fidelity_weighted_attainment"] = (
                self.fidelity_weighted_attainment())
        return rep


__all__ = ["LatencyBucket", "MetricsCollector", "instance_report",
           "log2_ms_histogram", "nearest_rank", "vector_log2_ms_buckets",
           "vector_percentiles", "vector_within_slo"]
