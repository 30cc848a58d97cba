"""Share of decode runner time spent enqueueing on the host: the sum of
(span ``enqueued`` - ``locked``) over the sum of (``run_end`` - ``gate``),
over the window's decode batches, %.  The rest is the lock wait and the
stream wait."""
from harness.spans import load, stamped


def read(r):
    s = load(r)
    if s is None:
        return None
    batches = [b for b in s.phase_batches("decode")
               if stamped(b["gate"], b["locked"], b["enqueued"],
                          b["run_end"])]
    run = sum(b["run_end"] - b["gate"] for b in batches)
    if run <= 0:
        return None
    return 100.0 * sum(b["enqueued"] - b["locked"] for b in batches) / run
