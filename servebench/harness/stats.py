"""Percentiles and spreads, as the benchmark reads them."""

from __future__ import annotations

import math
from typing import Sequence


def nearest_rank(sorted_values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in (0, 100]) of pre-sorted values (a
    copy of ``repro_torch.serving.metrics.nearest_rank``)."""
    if not sorted_values:
        return float("nan")
    if not (0.0 < q <= 100.0):
        raise ValueError(f"q must be in (0, 100], got {q}")
    rank = max(1, math.ceil(q / 100.0 * len(sorted_values)))
    return sorted_values[rank - 1]


def percentile(values: Sequence[float], q: float) -> float:
    return nearest_rank(sorted(values), q)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] no interval covers."""
    out, cursor = [], lo
    for a, b in sorted(intervals):
        if a > cursor:
            out.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]
