"""Quickstart on the PyTorch port: Packrat's optimizer end-to-end in 60 seconds.

Profiles a model (paper-calibrated ResNet-50 curve), solves the 2-D
knapsack for several batch sizes, and prints the chosen ⟨i,t,b⟩
configurations with their predicted speedups over the fat instance —
the paper's core loop (§3.2-§3.3) with zero hardware requirements.
``repro_torch.core`` holds byte-identical copies of the planner, so this
prints exactly what ``examples/quickstart.py`` prints, and touches no
device.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
"""

from repro_torch.core import PackratOptimizer, fat_config
from repro_torch.core.paper_profiles import RESNET50

T = 16           # threads on one socket (paper Table 1)

# 1. profile ⟨1,t,b⟩ single-instance latencies (here: calibrated model;
#    swap in MeasuredProfiler/AnalyticProfiler for real hardware)
profile = RESNET50.profile(T, max_batch=1024)
print(f"profiled {len(profile)} single-instance configurations "
      f"(the paper's (n+1)·T grid)")

# 2. solve the 2-D knapsack per batch size
opt = PackratOptimizer(profile)
print(f"\n{'B':>5} {'packrat config':<24} {'latency':>9} "
      f"{'fat latency':>11} {'speedup':>8}")
for B in (8, 16, 32, 64, 128, 256, 512, 1024):
    cfg = opt.solve(T, B)
    fat = fat_config(profile, T, B)
    print(f"{B:5d} {' '.join(str(g) for g in cfg.groups):<24}"
          f"{cfg.latency * 1e3:8.1f}ms {fat.latency * 1e3:10.1f}ms "
          f"{fat.latency / cfg.latency:7.2f}x")

# 3. non-power-of-two deployments mix instance types (§5.2.3)
opt14 = PackratOptimizer(RESNET50.profile(14, max_batch=1024))
cfg = opt14.solve(14, 256)
print(f"\nT=14, B=256 → {' '.join(str(g) for g in cfg.groups)} "
      f"(non-uniform split, Σi·t={cfg.total_threads}, "
      f"Σi·b={cfg.total_batch})")
