"""Packrat serving runtime, copied byte for byte from the reference package.

The single-node engine is here: execution planes (:class:`RealPlane`
runs the port's CUDA runners on wall-clock threads), the
:class:`Dispatcher` and its policies, :class:`PackratServer`, seeded
workloads, the scenario registry and :class:`MetricsCollector`.  The
reference's multi-model ``tenancy``, cluster ``fabric`` and vectorized
``fastsim`` engines are not part of this slice of the port, so this
``__init__`` exports only the copied modules' names.

``tests/test_torch_isolation.py`` holds each copied module
byte-identical to its reference file.
"""

from .allocator import (AllocationError, Placement, ResourceAllocator,
                        ResourcePool, UnitLease)
from .controller import ControllerConfig, ModelTenant, PackratServer
from .dispatcher import Dispatcher, DispatcherConfig
from .instance import (CalibratedBackend, CallableBackend, LatencyBackend,
                       TabulatedBackend, WorkerInstance)
from .metrics import (LatencyBucket, MetricsCollector, instance_report,
                      log2_ms_histogram, nearest_rank)
from .plane import (ExecutionPlane, RealPlane, SimulatedPlane, as_plane)
from .policy import (BatchSyncPolicy, ContinuousPolicy, DispatchPolicy,
                     make_policy)
from .scenarios import (FabricEvent, Scenario, ScenarioContext,
                        get_scenario, list_scenarios, register_scenario,
                        scenario)
from .simulator import (DEFAULT_MODEL, ArrivalProcess, EventLoop, Request,
                        Response, Shed, step_rate)
from .workloads import (DiurnalWorkload, MMPPWorkload, PoissonWorkload,
                        RampWorkload, StepWorkload, TraceWorkload, Workload)

__all__ = [
    "AllocationError", "ArrivalProcess", "BatchSyncPolicy",
    "CalibratedBackend", "CallableBackend", "ContinuousPolicy",
    "ControllerConfig", "DEFAULT_MODEL", "DispatchPolicy", "Dispatcher",
    "DispatcherConfig", "DiurnalWorkload", "EventLoop", "ExecutionPlane",
    "FabricEvent", "LatencyBackend", "LatencyBucket", "MMPPWorkload",
    "MetricsCollector", "ModelTenant", "PackratServer", "Placement",
    "PoissonWorkload", "RampWorkload", "RealPlane", "Request",
    "ResourceAllocator", "ResourcePool", "Response", "Scenario",
    "ScenarioContext", "Shed", "SimulatedPlane", "StepWorkload",
    "TabulatedBackend", "TraceWorkload", "UnitLease", "WorkerInstance",
    "Workload", "as_plane", "get_scenario", "instance_report",
    "list_scenarios", "log2_ms_histogram", "make_policy", "nearest_rank",
    "register_scenario", "scenario", "step_rate",
]
