"""Mean ms from a prefill batch's firing (span ``fired``) to the unit
gate letting it run (``gate``): its worker's executor backlog and the
plane's unit gate, over the window's prefill batches."""
from harness.spans import load, mean_ms, stamped


def read(r):
    s = load(r)
    if s is None:
        return None
    return mean_ms([b["gate"] - b["fired"] for b in s.phase_batches("prefill")
                    if stamped(b["gate"])])
