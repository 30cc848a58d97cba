"""Median wall ms of a decode runner call (one token for every resident
sequence of the cell) in the window and drain."""
from harness.stats import percentile


def read(r):
    walls = [c.t1 - c.t0 for c in r.phase_calls("decode")]
    return percentile(walls, 50) * 1e3 if walls else None
