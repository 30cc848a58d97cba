"""Hooks at the program's boundaries, owned by the benchmark.

The program's runner cells (``repro_torch.models.serve_lm.LmEngine``)
draw their own prompts, feed zeros to decode and drop every output, and
``run_lm_policy`` reports percentiles but no request.  The benchmark
needs the inputs to be its own, the outputs to be read, and every
request's times, so it hooks three boundaries without editing a file of
the program:

* :class:`Recorder` wraps the engine's functional surface
  (``LmEngine.prefill`` and ``LmEngine.decode_step``, which the runner
  cells call through the instance): a prefill call takes the next rows
  of the benchmark's prompt pool in place of the cell's own batch and
  records the greedy first token of each row; a decode call feeds each
  resident sequence its previous greedy token in place of zeros and
  records the new one.  The runner cells, their streams, locks and
  positions stay the program's.
* :meth:`Recorder.factory` wraps the runner factory handed to
  ``run_lm_policy``: each runner call's phase, batch cell, threads and
  wall interval (the call blocks until its stream is done).
* :class:`RecordingCollector` stands in for ``MetricsCollector`` inside
  the launcher while the window runs: every request's arrival and
  completion, on the plane's clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class Call:
    """One runner call: the cell's phase and batch, its thread, and its
    wall interval on ``time.perf_counter``."""
    phase: str
    b: int
    t0: float
    t1: float
    ident: int                    # threading.get_ident()
    pos: int = -1                 # decode: the write position


@dataclasses.dataclass
class Prefill:
    """One prefill call: rows [start, start + b) of the pool, their first
    tokens (device tensor) and when the call was enqueued."""
    start: int
    b: int
    first: torch.Tensor
    t: float


@dataclasses.dataclass
class Resident:
    """A decode cell's resident sequences: the prefill that built them,
    then per decode step its position and greedy tokens (b, 1)."""
    prefill: Prefill
    pos0: int
    positions: List[int] = dataclasses.field(default_factory=list)
    tokens: List[torch.Tensor] = dataclasses.field(default_factory=list)
    broken: bool = False          # a position jumped (the cell wrapped)


class Recorder:
    def __init__(self, engine, pool: torch.Tensor,
                 clock=time.perf_counter) -> None:
        self.pool = pool
        self.clock = clock
        self.calls: List[Call] = []
        self.prefills: List[Prefill] = []
        self.resident: Dict[int, Resident] = {}
        self._next = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._decode_pos = threading.local()
        self._prefill = engine.prefill
        self._decode = engine.decode_step
        engine.prefill = self.prefill
        engine.decode_step = self.decode_step

    def release(self) -> None:
        """Drop the engine's methods (and with them the engine)."""
        self._prefill = self._decode = None

    # ------------------------------------------------------------------ #
    def _rows(self, b: int) -> int:
        """Start of the next b pool rows (aligned, wrapping)."""
        with self._lock:
            k = self._next
            self._next += 1
        return (k % (self.pool.shape[0] // b)) * b

    def prefill(self, tokens, **inputs):
        b, s = tokens.shape
        if s != self.pool.shape[1]:
            raise ValueError(f"prefill of {s} positions; the pool holds "
                             f"{self.pool.shape[1]}")
        start = self._rows(b)
        logits, cache = self._prefill(self.pool[start:start + b], **inputs)
        rec = Prefill(start, b, logits[:, -1].argmax(-1), self.clock())
        self.prefills.append(rec)
        self._local.last = (id(cache), rec)
        return logits, cache

    def decode_step(self, cache, tokens, pos):
        seq = self.resident.get(id(cache))
        if seq is None:
            # a decode cell's first step follows, on the same thread, the
            # prefill that built its resident cache
            built, rec = getattr(self._local, "last", (None, None))
            if built != id(cache):
                raise RuntimeError("a decode cache the recorder did not "
                                   "see built")
            seq = self.resident[id(cache)] = Resident(rec, int(pos))
        expect = seq.pos0 + len(seq.positions)
        if int(pos) != expect:
            seq.broken = True
        fed = seq.tokens[-1] if seq.tokens else seq.prefill.first[:, None]
        logits, cache = self._decode(cache, fed, pos)
        if not seq.broken:
            seq.positions.append(int(pos))
            seq.tokens.append(logits[:, -1:].argmax(-1))
        self._decode_pos.pos = int(pos)
        return logits, cache

    # ------------------------------------------------------------------ #
    def factory(self, inner):
        """``inner`` (a phase-aware runner factory) with each runner call
        recorded."""
        calls = self.calls

        def make(t: int, b: int, phase: str = "decode"):
            run = inner(t, b, phase)
            local = self._decode_pos

            def timed() -> None:
                t0 = time.perf_counter()
                run()
                t1 = time.perf_counter()
                calls.append(Call(phase, b, t0, t1, threading.get_ident(),
                                  getattr(local, "pos", -1)
                                  if phase == "decode" else -1))
            return timed

        make.phase_aware = True
        return make


class RecordingCollector:
    """A factory of ``MetricsCollector`` subclasses that keep every
    request; the launcher builds one per window."""

    def __init__(self, base) -> None:
        self.instances: List = []
        outer = self

        class Collector(base):
            def __init__(self, *a, **kw) -> None:
                super().__init__(*a, **kw)
                self.offered_at: Dict[int, float] = {}
                self.done: List = []
                self.epoch: Optional[float] = None
                self.plane = None
                outer.instances.append(self)

            def attach(self, server, **kw) -> None:
                self.plane = server.loop
                super().attach(server, **kw)

            def on_request(self, req) -> None:
                super().on_request(req)
                if req.phase == "prefill":
                    self.offered_at[req.id] = req.arrival

            def on_response(self, resp) -> None:
                super().on_response(resp)
                if self.epoch is None:
                    self.epoch = time.perf_counter() - self.plane.now
                r = resp.request
                self.done.append((r.id, r.phase, r.arrival, resp.completion,
                                  resp.batch_size, r.steps_left))

        self.cls = Collector

    @contextlib.contextmanager
    def installed(self, module):
        """``module.MetricsCollector`` is the recording class inside."""
        saved = module.MetricsCollector
        module.MetricsCollector = self.cls
        try:
            yield self
        finally:
            module.MetricsCollector = saved
