"""The real plane's span log: where each request and batch spent its time.

:class:`~repro_torch.serving.plane.RealPlane` owns time, so it owns the
log (``plane.spans``) when its caller asks for one
(``RealPlane(..., spans=True)``; ``run_lm_policy`` does).  The log keeps
two bounded, append-only tables of plain records:

* a **request** record per request the dispatcher accepts —
  ``id, phase, due, submitted, batch, delivered, cause``: ``due`` is the
  request's ``arrival``, ``submitted`` when the dispatcher took it,
  ``batch`` the id of the batch that delivered it, ``delivered`` its
  ``Response.completion``, and ``cause`` the request whose completion
  made it (a decode step's previous step or prompt; -1 for a prompt);
* a **batch** record per sub-batch the dispatcher fires —
  ``id, phase, trigger, fired, start, gate, locked, enqueued, run_end,
  delivered, requests``: ``fired`` when the dispatcher handed it to the
  plane, ``start`` when its worker's executor picked it up, ``gate`` when
  the unit gate let it run, ``locked`` and ``enqueued`` as the runner
  cell marks them (the decode cell holds its lock; the last launch is
  enqueued and the stream wait begins), ``run_end`` when the runner
  returned and ``delivered`` when the driving thread took its
  completion.
  ``trigger`` indexes :data:`TRIGGERS`: why the batch fired.

Times are seconds on the plane's clock since its epoch (the values of
``plane.now``); a field never stamped holds -1.  A phase is an index
into the export's ``phases``.  So for a delivered request

    delivered - due = (submitted - due) + (fired - submitted)
                      + (gate - fired) + (run_end - gate)
                      + (delivered - run_end)

over its record and its batch's.  Stamps on the driving thread take the
plane's ``now``; stamps on a worker thread read the clock.  A stamp is
a clock read and a store: no lock, no device synchronisation, and one
allocation a record.  Once a table holds :data:`MAX_RECORDS` the log
counts what it turns away in ``dropped``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

# request record fields
REQUEST_FIELDS = ("id", "phase", "due", "submitted", "batch", "delivered",
                  "cause")
# batch record fields
BATCH_FIELDS = ("id", "phase", "trigger", "fired", "start", "gate",
                "locked", "enqueued", "run_end", "delivered", "requests")
TRIGGERS = ("full", "coalesce", "redispatch")
# far above the ~1,000 requests and batches a 51 s benchmark window makes
MAX_RECORDS = 1 << 17

_R = {name: i for i, name in enumerate(REQUEST_FIELDS)}
_B = {name: i for i, name in enumerate(BATCH_FIELDS)}
_TRIGGER = {name: i for i, name in enumerate(TRIGGERS)}
# the fields a runner cell may stamp through :func:`mark`
_MARKS = {name: _B[name] for name in ("locked", "enqueued")}
_UNSET = -1.0

# the batch record (and its log) of the batch this thread is running
_running = threading.local()


def mark(name: str) -> None:
    """Stamp ``name`` ("locked" or "enqueued") on the batch the calling
    thread runs for the plane; outside a plane's batch (profiling,
    warm-up, a direct call) nothing happens."""
    i = _MARKS[name]
    span = getattr(_running, "span", None)
    if span is not None:
        log = _running.log
        span[i] = log.clock() - log.epoch


class SpanLog:
    """Request and batch records on one plane's clock (see the module
    docstring for the fields)."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter
                 ) -> None:
        self.clock = clock
        self.epoch = 0.0            # the plane's epoch, set when it starts
        self.requests: List[list] = []
        self.batches: List[list] = []
        self.dropped = 0
        self.phases: List[str] = []
        self._phase: Dict[str, int] = {}
        self._open: Dict[int, list] = {}     # request id -> undelivered record

    def _phase_index(self, phase: str) -> int:
        i = self._phase.get(phase)
        if i is None:
            i = self._phase[phase] = len(self.phases)
            self.phases.append(phase)
        return i

    # ------------------------------------------------------------------ #
    # driving thread
    # ------------------------------------------------------------------ #
    def open_request(self, req, cause: int = -1) -> Optional[list]:
        """The record of ``req`` (due at its arrival), caused by request
        ``cause``; None once the table is full."""
        if len(self.requests) >= MAX_RECORDS:
            self.dropped += 1
            return None
        rec = [req.id, self._phase_index(req.phase), req.arrival, _UNSET,
               -1, _UNSET, cause]
        self.requests.append(rec)
        self._open[req.id] = rec
        return rec

    def submitted(self, req, t: float) -> None:
        rec = self._open.get(req.id)
        if rec is None:
            rec = self.open_request(req)
        if rec is not None:
            rec[_R["submitted"]] = t

    def open_batch(self, sub, trigger: str, t: float) -> Optional[list]:
        """The record of a batch of ``sub`` fired at ``t``; None once the
        table is full."""
        if len(self.batches) >= MAX_RECORDS:
            self.dropped += 1
            return None
        rec = [len(self.batches), self._phase_index(sub[0].phase if sub
                                                    else ""),
               _TRIGGER[trigger], t, _UNSET, _UNSET, _UNSET, _UNSET, _UNSET,
               _UNSET, tuple(r.id for r in sub)]
        self.batches.append(rec)
        return rec

    def batch_done(self, span: list, t: float) -> None:
        """The driving thread took the batch's completion at ``t``."""
        span[_B["delivered"]] = t

    def delivered(self, req, span: list, t: float) -> None:
        """``req`` was delivered by batch ``span`` at ``t`` (its
        ``Response.completion``)."""
        rec = self._open.pop(req.id, None)
        if rec is not None:
            rec[_R["batch"]] = span[_B["id"]]
            rec[_R["delivered"]] = t

    # ------------------------------------------------------------------ #
    # worker threads
    # ------------------------------------------------------------------ #
    def start(self, span: list) -> None:
        """The worker's executor picked the batch up."""
        span[_B["start"]] = self.clock() - self.epoch

    def enter(self, span: list, t0: float) -> None:
        """The unit gate let the batch run at clock time ``t0``; until
        :meth:`leave`, :func:`mark` on this thread stamps ``span``."""
        span[_B["gate"]] = t0 - self.epoch
        _running.log = self
        _running.span = span

    def leave(self, span: list, t1: float) -> None:
        """The runner returned at clock time ``t1``."""
        span[_B["run_end"]] = t1 - self.epoch
        _running.span = None

    # ------------------------------------------------------------------ #
    def export(self) -> Dict[str, object]:
        """Plain lists for a report, with the plane's epoch (on
        ``clock``) and the field names."""
        batches = [rec[:-1] + [list(rec[-1])] for rec in self.batches]
        return {"clock": getattr(self.clock, "__name__", repr(self.clock)),
                "epoch": self.epoch,
                "phases": list(self.phases),
                "triggers": list(TRIGGERS),
                "request_fields": list(REQUEST_FIELDS),
                "batch_fields": list(BATCH_FIELDS),
                "requests": [list(rec) for rec in self.requests],
                "batches": batches,
                "dropped": self.dropped}


__all__ = ["BATCH_FIELDS", "MAX_RECORDS", "REQUEST_FIELDS", "SpanLog",
           "TRIGGERS", "mark"]
