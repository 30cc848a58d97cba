"""95th percentile of the gap between output tokens, ms: each decode
step from its creation (the previous token's completion) to its
completion, over every decode step served."""
from harness.stats import percentile


def read(r):
    return percentile(r.tpot_s, 95) * 1e3 if r.tpot_s else None
