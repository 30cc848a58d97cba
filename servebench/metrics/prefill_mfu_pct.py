"""Model operations of the prompts served (not the padding up to the
batch cell), over the union of the wall intervals in which a prefill
call ran, as a share of the H100's bf16 peak, %."""
from harness.cost import PEAK_FLOPS, prefill_flops
from harness.stats import union_length


def read(r):
    served = len(r.items("prefill"))
    busy = union_length([(c.t0, c.t1) for c in r.phase_calls("prefill")])
    if not served or busy <= 0:
        return None
    flops = served * prefill_flops(r.conf, r.traffic["prompt_tokens"])
    return 100.0 * flops / busy / PEAK_FLOPS[r.conf["dtype"]]
