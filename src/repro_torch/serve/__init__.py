"""Public service-layer API of the port.

One front door: :class:`ResourceManager` (queue + EASY backfilling +
allocate-then-map candidate waves), whose engine waves run on the card.
The pieces it composes -- :class:`MappingEngine`, :class:`EngineFleet`,
:class:`ClusterState`, the trace helpers -- are exported for direct use.
``__all__`` holds every name of the reference's ``repro.serve.__all__``
plus the port's own :class:`EngineStats` and the LM serving engine
(:class:`Engine`, :class:`ServeConfig`).
"""
from repro_torch.serve.cluster import Allocation, Candidate, ClusterState
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.fleet import (EngineFleet, EngineWorker, FaultPlan,
                                     FleetStats)
from repro_torch.serve.mapper import (DeadlinePolicy, EngineStats,
                                      MapCancelled, MapFuture, MappingEngine,
                                      MapRequest, MapResponse, QueueFull)
from repro_torch.serve.rm import (JobHandle, JobSpec, ReplayReport,
                                  ResourceManager, RMJournal, default_flows,
                                  dilation_score, objective_score)
from repro_torch.serve.trace import format_swf, parse_swf, synthetic_trace
from repro_torch.serve.transport import SubprocessWorker, WorkerTransport

__all__ = [
    # control plane (the front door)
    "ResourceManager", "RMJournal", "JobSpec", "JobHandle", "ReplayReport",
    "default_flows", "objective_score", "dilation_score",
    # mapping engine
    "MappingEngine", "MapRequest", "MapResponse", "MapFuture",
    "DeadlinePolicy", "EngineStats", "QueueFull", "MapCancelled",
    # distributed fleet (drop-in engine with failure recovery)
    "EngineFleet", "EngineWorker", "FaultPlan", "FleetStats",
    "WorkerTransport", "SubprocessWorker",
    # cluster model
    "ClusterState", "Allocation", "Candidate",
    # traces
    "parse_swf", "format_swf", "synthetic_trace",
    # LM serving
    "Engine", "ServeConfig",
]
