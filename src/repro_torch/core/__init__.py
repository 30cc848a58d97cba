"""Packrat core, copied byte for byte from the reference package.

* :mod:`repro_torch.core.knapsack` — the 2-D dynamic-programming optimizer.
* :mod:`repro_torch.core.profiler` — measured / analytic / tabulated profiling.
* :mod:`repro_torch.core.estimator` — online batch-size estimation.
* :mod:`repro_torch.core.reconfig` — active-passive zero-downtime scaling.
* :mod:`repro_torch.core.roofline` — roofline terms behind the analytic profile.
* :mod:`repro_torch.core.interference` — multi-instance contention models.
* :mod:`repro_torch.core.multimodel` — multi-model unit allocation.
* :mod:`repro_torch.core.paper_profiles` — the paper's fitted latency models
  behind the simulated planes.

The modules are pure Python and numpy; ``tests/test_torch_isolation.py``
holds each one byte-identical to its reference file.
"""

from .estimator import (ArrivalRateSignal, BatchSizeEstimator,
                        EstimatorConfig, HysteresisGate,
                        LatencyCorrectionSignal, floor_power_of_two)
from .interference import (CPUInterferenceModel, TPUInterferenceModel,
                           apply_constant_penalty)
from .knapsack import (FidelityLadder, FidelityRung, InstanceGroup,
                       PackratConfig, PackratOptimizer, PlanTable,
                       PlanTableRegistry, brute_force_solve,
                       default_engine, fat_config, next_power_of_two,
                       one_thread_per_core_config, plan_fingerprint,
                       planning_report, powers_of_two, profile_grid,
                       set_default_engine)
from .multimodel import (ModelPlacement, ModelWorkload, MultiModelAllocator,
                         solve_with_slo)
from .profiler import (AnalyticProfiler, MeasuredProfiler,
                       ProfileCalibrator, ProfileSpec, TabulatedProfiler,
                       measure_latency, profiling_cost_summary)
from .reconfig import (ActivePassiveController, Phase, needs_active_passive)
from .roofline import (TPU_V5E, HardwareSpec, RooflineTerms, model_flops_ratio)

__all__ = [
    "ActivePassiveController", "AnalyticProfiler", "ArrivalRateSignal",
    "BatchSizeEstimator", "CPUInterferenceModel", "EstimatorConfig",
    "FidelityLadder", "FidelityRung", "HardwareSpec", "HysteresisGate",
    "InstanceGroup", "LatencyCorrectionSignal", "MeasuredProfiler",
    "ModelPlacement", "ModelWorkload", "MultiModelAllocator",
    "PackratConfig", "PackratOptimizer", "Phase", "PlanTable",
    "PlanTableRegistry", "ProfileCalibrator", "ProfileSpec",
    "RooflineTerms", "TPUInterferenceModel", "TPU_V5E",
    "TabulatedProfiler", "apply_constant_penalty", "brute_force_solve",
    "default_engine", "fat_config", "floor_power_of_two",
    "measure_latency", "model_flops_ratio", "needs_active_passive",
    "next_power_of_two", "one_thread_per_core_config", "plan_fingerprint",
    "planning_report", "powers_of_two", "profile_grid",
    "profiling_cost_summary", "set_default_engine", "solve_with_slo",
]
