"""The one traffic generator: open-loop arrivals from a traffic file.

A traffic file (``servebench/traffic/<name>.json``) gives the requests'
sizes and a schedule of phases, each ``{"seconds": s, "rate": r}`` in
prompts a second (``seconds`` null: the whole window).  The phases
repeat over the window at fixed boundaries.  Each phase instance gets
``round(r * s)`` arrivals whose gaps are the quantiles of an exponential
distribution at (i + 0.5) / (n + 1), scaled to fill the phase, in an
order drawn from the seed.  Every seed therefore offers the same number
of prompts and the same multiset of gaps, only in another order: the
work of a run does not change with its seed, while the arrivals stay as
bursty as a Poisson process's of that rate.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def phase_plan(traffic: Dict, seconds: float):
    """(start, length, rate) of each phase instance inside the window."""
    phases = traffic["phases"]
    out, t = [], 0.0
    while t < seconds:
        for ph in phases:
            length = seconds - t if ph["seconds"] is None else ph["seconds"]
            length = min(length, seconds - t)
            if length <= 0:
                break
            out.append((t, length, float(ph["rate"])))
            t += length
        if all(ph["seconds"] is None for ph in phases):
            break
    return out


def arrivals(traffic: Dict, seconds: float, seed: int) -> List[float]:
    """Sorted arrival times in [0, seconds) for this seed."""
    rng = np.random.default_rng([seed, 1])
    out: List[float] = []
    for start, length, rate in phase_plan(traffic, seconds):
        n = int(round(rate * length))
        if n == 0:
            continue
        u = (np.arange(n + 1) + 0.5) / (n + 1)
        gaps = -np.log1p(-u)
        gaps = gaps[rng.permutation(n + 1)]
        times = np.cumsum(gaps[:-1]) * (length / gaps.sum())
        out.extend(float(start + x) for x in times)
    return out


def backlog(arrival_times, done_times, t: float) -> int:
    """Prompts that had arrived by ``t`` and had no first token yet."""
    return (sum(1 for a in arrival_times if a <= t)
            - sum(1 for d in done_times if d <= t))


__all__ = ["arrivals", "backlog", "phase_plan"]
