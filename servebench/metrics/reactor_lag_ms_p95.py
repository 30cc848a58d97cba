"""95th percentile (nearest rank) ms the plane's driving thread runs late:
over the prompts due in the window, due to taken (span ``due`` to
``submitted``: the arrival timer's lag), and over the window's batches,
runner return to completion taken (``run_end`` to ``delivered``)."""
from harness.spans import load, stamped
from harness.stats import percentile


def read(r):
    s = load(r)
    if s is None:
        return None
    lags = [q["submitted"] - q["due"] for q in s.taken("prefill")]
    lags += [b["delivered"] - b["run_end"] for b in s.window_batches()
             if stamped(b["run_end"], b["delivered"])]
    return percentile(lags, 95) * 1e3 if lags else None
