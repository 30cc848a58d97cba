"""Kernel launch calls a decode runner call makes on its thread, over
the decode calls wholly inside the traced slice."""


def read(r):
    v = r.view
    calls = [c for c in r.phase_calls("decode")
             if v is not None and c.t0 >= v.lo and c.t1 <= v.hi]
    if not calls:
        return None
    n = sum(v.launches_in(c) for c in calls)
    return n / len(calls) if n else None
