"""The program's span log, as the benchmark's readers read it.

``run_lm_policy`` exports ``RealPlane``'s span log as ``report["spans"]``
(``repro_torch.serving.spans``): a record per request (``due``,
``submitted``, the ``batch`` that delivered it, ``delivered``, its
``cause``) and per batch (``trigger``, ``fired``, ``start``, ``gate``,
``locked``, ``enqueued``, ``run_end``, ``delivered``, its requests), in
seconds on the plane's clock since ``epoch``; -1 where a field was never
stamped.  The readers take the prompts due in the window and the decode
steps each of them caused.  A program without the log (no ``spans`` in
the report) gives :func:`load` None, and the readers then report
nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

UNSET = -1.0


class Spans:
    """One window's span log: records as dicts keyed by field name."""

    def __init__(self, exported: Dict, seconds: float) -> None:
        self.epoch = exported["epoch"]
        self.phases = exported["phases"]
        self.triggers = exported["triggers"]
        rf, bf = exported["request_fields"], exported["batch_fields"]
        self.requests = {rec[0]: dict(zip(rf, rec))
                         for rec in exported["requests"]}
        self.batches = [dict(zip(bf, rec)) for rec in exported["batches"]]
        self.by_id = {b["id"]: b for b in self.batches}
        # the prompts due in the window, and the steps each caused
        root: Dict[int, int] = {}
        for i, q in self.requests.items():
            if q["cause"] == -1:
                root[i] = i if q["due"] < seconds else -1
        for i in self.requests:
            if i not in root:
                self._root(i, root)
        self.window = {i for i, r in root.items() if r != -1}

    def _root(self, i: int, root: Dict[int, int]) -> int:
        chain = []
        while i not in root:
            chain.append(i)
            cause = self.requests[i]["cause"]
            if cause not in self.requests:
                root[i] = -1          # its cause's record was dropped
                break
            i = cause
        r = root[i]
        for j in chain:
            root[j] = r
        return r

    def phase(self, rec: Dict) -> str:
        return self.phases[rec["phase"]]

    def served(self, phase: str) -> List[Dict]:
        """The window's requests of ``phase`` that were delivered, each
        with its delivering batch under ``"b"``."""
        out = []
        for i in self.window:
            q = self.requests[i]
            b = self.by_id.get(q["batch"])
            if self.phase(q) == phase and b is not None:
                out.append(dict(q, b=b))
        return out

    def taken(self, phase: str) -> List[Dict]:
        """The window's requests of ``phase`` that a dispatcher took."""
        return [q for i in self.window for q in (self.requests[i],)
                if self.phase(q) == phase and q["submitted"] != UNSET]

    def phase_batches(self, phase: str) -> List[Dict]:
        """Batches of ``phase`` that carried a request of the window."""
        return [b for b in self.batches if self.phase(b) == phase
                and any(i in self.window for i in b["requests"])]

    def window_batches(self) -> List[Dict]:
        return [b for b in self.batches
                if any(i in self.window for i in b["requests"])]

    def held(self, hi: float) -> List[tuple]:
        """(submitted, gate) on the plane's clock for every request: the
        stretch in which it waited for its batch to reach the unit gate
        (to ``hi`` if it never did)."""
        out = []
        for q in self.requests.values():
            if q["submitted"] == UNSET:
                continue
            b = self.by_id.get(q["batch"])
            gate = b["gate"] if b is not None and b["gate"] != UNSET else hi
            out.append((q["submitted"], gate))
        return out


def load(r) -> Optional[Spans]:
    """The window's span log from the program's report, or None."""
    exported = (r.report or {}).get("spans")
    if not exported:
        return None
    return Spans(exported, r.seconds)


def stamped(*values: float) -> bool:
    return all(v != UNSET for v in values)


def mean_ms(values: List[float]) -> Optional[float]:
    return 1e3 * sum(values) / len(values) if values else None
