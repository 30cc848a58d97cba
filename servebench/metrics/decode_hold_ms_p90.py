"""90th percentile (nearest rank) ms a decode step waits in the control
plane: from the dispatcher taking it (span ``submitted``) to the firing
of the batch that delivered it (``fired``), over the decode steps of the
prompts due in the window."""
from harness.spans import load
from harness.stats import percentile


def read(r):
    s = load(r)
    if s is None:
        return None
    holds = [q["b"]["fired"] - q["submitted"] for q in s.served("decode")]
    return percentile(holds, 90) * 1e3 if holds else None
