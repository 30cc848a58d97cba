"""``flash_tc_pair_kernel``'s share of its roofline in the traced slice,
%: the summed bound over the summed kernel time of its records, each
record's bound from its prefill call's batch cell at the cell's prompt
length (bytes of q, k, v and the output once; 4·D operations a visible
pair and head)."""
from harness.cost import bound_s, flash_call

KERNEL = "flash_tc_pair_kernel"


def read(r):
    if r.view is None:
        return None
    bound = spent = 0.0
    for k in r.view.kernels(""):
        if KERNEL not in k.name or k.call is None \
                or k.call.phase != "prefill":
            continue
        c = flash_call(r.conf, k.call.b, r.traffic["prompt_tokens"])
        bound += bound_s(c["bytes"], c["flops"], r.conf["dtype"])
        spent += k.dur
    return 100.0 * bound / spent if spent else None
