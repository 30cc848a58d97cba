"""Packrat serving runtime, copied byte for byte from the reference package.

Every module here is a copy of its reference file: execution planes
(:class:`RealPlane` runs the port's CUDA runners on wall-clock threads),
the :class:`Dispatcher` and its policies, :class:`PackratServer`, the
multi-model resource plane (``tenancy``: :class:`MultiModelServer`), the
cluster fabric (``fabric``: :class:`ClusterRouter`), the vectorized
simulation engine (``fastsim``), seeded workloads, the scenario registry
and :class:`MetricsCollector`.  This ``__init__`` exports the
reference's names.  :class:`JaxBackend` keeps its name because its
module is a copy; its body calls a runner and reads the clock, so it
measures the port's runners as it measures the reference's.

``tests/test_torch_isolation.py`` holds each copied module
byte-identical to its reference file.
"""

from .allocator import (AllocationError, Placement, ResourceAllocator,
                        ResourcePool, UnitLease)
from .controller import ControllerConfig, ModelTenant, PackratServer
from .dispatcher import Dispatcher, DispatcherConfig
from .fabric import (ClusterRouter, FabricConfig, FabricNodeSpec,
                     TokenBucket)
from .instance import (CalibratedBackend, CallableBackend, JaxBackend,
                       LatencyBackend, TabulatedBackend, WorkerInstance)
from .metrics import (LatencyBucket, MetricsCollector, instance_report,
                      log2_ms_histogram, nearest_rank)
from .plane import (ExecutionPlane, RealPlane, SimulatedPlane, as_plane)
from .policy import (BatchSyncPolicy, ContinuousPolicy, DispatchPolicy,
                     make_policy)
from .scenarios import (FabricEvent, MultiModelScenario,
                        MultiModelScenarioContext,
                        Scenario, ScenarioContext, fabric_events,
                        get_mm_scenario,
                        get_scenario, list_mm_scenarios, list_scenarios,
                        mm_scenario, register_mm_scenario,
                        register_scenario, scenario)
from .simulator import (DEFAULT_MODEL, ArrivalProcess, EventLoop, Request,
                        Response, Shed, step_rate)
from .tenancy import MultiModelServer, TenantSpec
from .workloads import (DiurnalWorkload, MMPPWorkload, PoissonWorkload,
                        RampWorkload, StepWorkload, TraceWorkload, Workload)

__all__ = [
    "AllocationError", "ArrivalProcess", "BatchSyncPolicy",
    "CalibratedBackend",
    "CallableBackend", "ClusterRouter", "ContinuousPolicy",
    "ControllerConfig",
    "DEFAULT_MODEL", "DispatchPolicy", "Dispatcher", "DispatcherConfig",
    "DiurnalWorkload", "EventLoop", "ExecutionPlane", "FabricConfig",
    "FabricEvent", "FabricNodeSpec", "JaxBackend",
    "LatencyBackend",
    "LatencyBucket", "MMPPWorkload", "MetricsCollector", "ModelTenant",
    "MultiModelScenario", "MultiModelScenarioContext", "MultiModelServer",
    "PackratServer", "Placement", "PoissonWorkload", "RampWorkload",
    "RealPlane",
    "Request", "ResourceAllocator", "ResourcePool", "Response", "Scenario",
    "ScenarioContext", "Shed", "SimulatedPlane", "StepWorkload",
    "TabulatedBackend", "TenantSpec", "TokenBucket",
    "TraceWorkload", "UnitLease", "WorkerInstance", "Workload", "as_plane",
    "fabric_events", "get_mm_scenario", "get_scenario", "instance_report",
    "list_mm_scenarios", "list_scenarios", "log2_ms_histogram",
    "make_policy", "mm_scenario", "nearest_rank", "register_mm_scenario",
    "register_scenario", "scenario", "step_rate",
]
