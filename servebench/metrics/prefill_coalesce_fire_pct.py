"""Share of the window's prefill batches that the coalesce timer fired
(span ``trigger`` = ``coalesce``: the batch went out part-full when the
window expired), %."""
from harness.spans import load


def read(r):
    s = load(r)
    if s is None:
        return None
    batches = s.phase_batches("prefill")
    if not batches:
        return None
    coalesce = s.triggers.index("coalesce")
    return 100.0 * sum(b["trigger"] == coalesce for b in batches) \
        / len(batches)
