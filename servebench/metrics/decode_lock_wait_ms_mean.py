"""Mean ms a decode batch waits for its runner cell's lock once the unit
gate let it run (span ``gate`` to ``locked``), over the window's decode
batches."""
from harness.spans import load, mean_ms, stamped


def read(r):
    s = load(r)
    if s is None:
        return None
    return mean_ms([b["locked"] - b["gate"] for b in s.phase_batches("decode")
                    if stamped(b["gate"], b["locked"])])
