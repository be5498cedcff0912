"""Service layer of the port: the mapping engine and the cluster model."""
from repro_torch.serve.cluster import Allocation, ClusterState
from repro_torch.serve.mapper import (DeadlinePolicy, EngineStats,
                                      MapCancelled, MapFuture, MappingEngine,
                                      MapRequest, MapResponse, QueueFull)

__all__ = [
    "MappingEngine", "MapRequest", "MapResponse", "MapFuture",
    "DeadlinePolicy", "EngineStats", "QueueFull", "MapCancelled",
    "ClusterState", "Allocation",
]
