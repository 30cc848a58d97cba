"""Mean ms a prompt waits in the control plane: from the dispatcher taking
it (span ``submitted``) to the firing of the batch that delivered it
(``fired``), over the prompts due in the window (the program's span
log)."""
from harness.spans import load, mean_ms


def read(r):
    s = load(r)
    if s is None:
        return None
    return mean_ms([q["b"]["fired"] - q["submitted"]
                    for q in s.served("prefill")])
