"""``decode_tc_kernel``'s share of its roofline in the traced slice, %:
the summed bound over the summed kernel time of its records, each
record's bound from its decode call's batch cell and valid cache rows
(position + 1): q, the valid K and V rows and the output once."""
from harness.cost import bound_s, decode_call

KERNEL = "decode_tc_kernel"


def read(r):
    if r.view is None:
        return None
    bound = spent = 0.0
    for k in r.view.kernels(""):
        if KERNEL not in k.name or k.call is None \
                or k.call.phase != "decode" or k.call.pos < 0:
            continue
        c = decode_call(r.conf, k.call.b, k.call.pos + 1)
        bound += bound_s(c["bytes"], c["flops"], r.conf["dtype"])
        spent += k.dur
    return 100.0 * bound / spent if spent else None
