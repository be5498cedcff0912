"""Service layer of the port: the mapping engine, the cluster model and
the LM serving engine."""
from repro_torch.serve.cluster import Allocation, ClusterState
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.mapper import (DeadlinePolicy, EngineStats,
                                      MapCancelled, MapFuture, MappingEngine,
                                      MapRequest, MapResponse, QueueFull)

__all__ = [
    "MappingEngine", "MapRequest", "MapResponse", "MapFuture",
    "DeadlinePolicy", "EngineStats", "QueueFull", "MapCancelled",
    "ClusterState", "Allocation", "Engine", "ServeConfig",
]
