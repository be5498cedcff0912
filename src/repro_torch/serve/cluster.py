"""Live cluster state: node occupancy and allocation (numpy only).

A copy of the allocation half of ``repro/serve/cluster.py``, so that the
port runs the resource manager's allocate -> map -> release loop without
the reference package.  The paper maps a job onto "a subset of the
computer system" the scheduler hands it: :class:`ClusterState` holds the
machine's distance matrix ``M``, tracks busy nodes, carves a free-node
subset for each arriving job and returns the induced subgraph
``M[nodes][:, nodes]`` -- exactly the instance the mapping engine solves::

    cluster = ClusterState(M_system)
    alloc = cluster.allocate("job-0", size=32)     # None = queue it
    fut = engine.submit(MapRequest(job_id="job-0", C=flows, M=alloc.M_sub))
    nodes = alloc.physical(fut.result().perm)      # process k -> node
    ...                                            # job runs
    cluster.release("job-0")

Policies: ``"compact"`` (default) grows the allocation greedily from the
most central free node; ``"first_fit"`` takes the lowest-index free nodes.
Every policy sees the free set in sorted node-id order and returns a
sorted node array, so equal occupancy states carve identical subsets.
Thread-safe: the scheduler allocates while mapping futures resolve on the
engine's flusher thread.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

POLICIES = ("compact", "first_fit")


@dataclass(frozen=True)
class Allocation:
    """A job's slice of the machine.

    ``nodes[i]`` is the physical node backing local slot ``i``; ``M_sub``
    is the induced distance subgraph the mapping request should carry.
    """
    job_id: str
    nodes: np.ndarray          # (k,) physical node ids
    M_sub: np.ndarray          # (k, k) induced distance matrix

    @property
    def size(self) -> int:
        return int(self.nodes.shape[0])

    def physical(self, perm: np.ndarray) -> np.ndarray:
        """Map a solved permutation (process -> local slot) to physical
        node ids: process k runs on ``physical(perm)[k]``."""
        return self.nodes[np.asarray(perm)]


class ClusterState:
    """Node occupancy + allocation over a fixed system graph."""

    def __init__(self, M: np.ndarray, policy: str = "compact"):
        M = np.asarray(M, np.float32)
        if M.ndim != 2 or M.shape[0] != M.shape[1]:
            raise ValueError("system graph M must be square")
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}")
        self.M = M
        self.policy = policy
        self.num_nodes = M.shape[0]
        self._free = np.ones(self.num_nodes, bool)
        self._allocs: Dict[str, Allocation] = {}
        self._lock = threading.Lock()

    @property
    def num_free(self) -> int:
        with self._lock:
            return int(self._free.sum())

    @property
    def utilization(self) -> float:
        return 1.0 - self.num_free / self.num_nodes

    def allocation(self, job_id: str) -> Optional[Allocation]:
        with self._lock:
            return self._allocs.get(job_id)

    def free_nodes(self) -> np.ndarray:
        """Snapshot of the free node ids, sorted ascending."""
        with self._lock:
            return np.flatnonzero(self._free)

    def allocate(self, job_id: str, size: int) -> Optional[Allocation]:
        """Carve ``size`` free nodes for ``job_id``; None when the cluster
        cannot host the job right now (caller queues or backfills)."""
        if size < 1 or size > self.num_nodes:
            raise ValueError(f"job size {size} not in [1, {self.num_nodes}]")
        with self._lock:
            if job_id in self._allocs:
                raise ValueError(f"job {job_id!r} already allocated")
            free = np.flatnonzero(self._free)
            if free.shape[0] < size:
                return None
            if self.policy == "first_fit":
                nodes = free[:size]
            else:
                nodes = self._select_compact(free, size)
            self._free[nodes] = False
            alloc = Allocation(job_id=job_id, nodes=nodes,
                               M_sub=self.M[np.ix_(nodes, nodes)].copy())
            self._allocs[job_id] = alloc
            return alloc

    def release(self, job_id: str) -> None:
        """Return a finished job's nodes to the free pool."""
        with self._lock:
            alloc = self._allocs.pop(job_id, None)
            if alloc is None:
                raise KeyError(f"job {job_id!r} has no allocation")
            self._free[alloc.nodes] = True

    def _select_compact(self, free: np.ndarray, size: int) -> np.ndarray:
        """Greedy compact subset: seed at the most central free node, grow
        by the free node closest (total distance) to the chosen set."""
        sub = self.M[np.ix_(free, free)]          # distances among free nodes
        k = free.shape[0]
        seed = int(np.argmin(sub.sum(axis=1)))
        chosen = [seed]
        remaining = np.ones(k, bool)
        remaining[seed] = False
        dist_to_set = sub[seed].copy()            # sum of dist to chosen set
        for _ in range(size - 1):
            nxt = int(np.argmin(np.where(remaining, dist_to_set, np.inf)))
            chosen.append(nxt)
            remaining[nxt] = False
            dist_to_set += sub[nxt]
        return np.sort(free[np.array(chosen)])
