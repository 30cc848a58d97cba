"""Wall ms of the prefill runner calls (enqueue to their stream's end)
in the window and drain, summed, over the prompts they served."""


def read(r):
    served = len(r.items("prefill"))
    if not served:
        return None
    return sum(c.t1 - c.t0 for c in r.phase_calls("prefill")) * 1e3 / served
