"""Launchers: the LM serving benchmark on the real plane (``bench_serving``)."""
