"""Model operations of the decode tokens served, over the union of the
wall intervals in which a decode call ran, as a share of the H100's
bf16 peak, %.  A call computes every row of its cell at the call's
position; the rows that served a request are counted, pro rata."""
from harness.cost import PEAK_FLOPS, decode_flops
from harness.stats import union_length


def read(r):
    calls = r.phase_calls("decode")
    served = len(r.items("decode"))
    busy = union_length([(c.t0, c.t1) for c in calls])
    rows = sum(c.b for c in calls)
    if not served or busy <= 0 or not rows:
        return None
    flops = sum(c.b * decode_flops(r.conf, c.pos) for c in calls) \
        * served / rows
    return 100.0 * flops / busy / PEAK_FLOPS[r.conf["dtype"]]
