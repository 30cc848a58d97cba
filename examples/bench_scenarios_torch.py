"""Scenario benchmark on the PyTorch port in 30 seconds: adaptive Packrat
vs a static fat instance under a diurnal load curve.

Drives the full controller (estimator → knapsack → allocator →
active-passive reconfig → dispatcher) on the deterministic event loop
and prints the JSON report, byte-identical to
``examples/bench_scenarios.py``'s.  Swap ``diurnal`` for any name
printed by ``--list`` (bursty MMPP, Fig.-11 steps, ramps, flash-crowd
trace replay), or replay your own trace with ``--trace my_trace.json``.
Arguments after the script's name follow the example's own, so
``--execution real --real-model mlp-tiny`` serves a micro model on the
card instead (``--device cpu`` runs it on the CPU).

Run:  PYTHONPATH=src python examples/bench_scenarios_torch.py
"""

import sys

from repro_torch.launch.bench_serving import main

if __name__ == "__main__":
    sys.exit(main(["--scenario", "diurnal", "--duration", "30",
                   *sys.argv[1:]]))
