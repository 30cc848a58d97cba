"""Median time to first token, ms: from each prompt's due time to its
prefill's completion, over every prompt due in the window (a prompt
never served counts as waiting to the end of the drain)."""
from harness.stats import percentile


def read(r):
    return percentile(r.ttft_s, 50) * 1e3
