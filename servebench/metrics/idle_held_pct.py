"""Share of the traced slice in which the device ran nothing (no kernel,
copy or fill) while some request had been taken by a dispatcher
(span ``submitted``) and its batch had not reached the unit gate
(``gate``): device idle that work was waiting through, %."""
from harness.spans import load
from harness.stats import gaps, union_length


def read(r):
    s, v = load(r), r.view
    if s is None or v is None or v.window_s <= 0:
        return None
    # the span log's clock is the trace's: perf_counter = epoch + plane time
    lo, hi = v.lo - s.epoch, v.hi - s.epoch
    held = [(max(a, lo), min(b, hi)) for a, b in s.held(hi)
            if a < hi and b > lo]
    idle = gaps([(k.ts - s.epoch, k.ts + k.dur - s.epoch)
                 for k in v.device], lo, hi)
    both = [(max(a, c), min(b, d)) for a, b in idle for c, d in held
            if max(a, c) < min(b, d)]
    return 100.0 * union_length(both) / v.window_s
