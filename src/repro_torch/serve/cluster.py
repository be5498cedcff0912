"""Live cluster state: node occupancy, candidate carving, reservations.

The port of ``repro/serve/cluster.py``: numpy only, carving bit for bit
as the reference does (the same tie rules of ``argmin``, the same float32
window sums of ``slab``), so both packages hand the mapping engine the
same induced subgraphs in the same occupancy state.

The paper maps a job onto "a subset of the computer system" the scheduler
hands it, not onto the whole machine.  :class:`ClusterState` models that
side of the loop: it holds the full system graph (the machine's distance
matrix ``M``), tracks which nodes are busy, carves out a free-node subset
for each arriving job, and returns the *induced* subgraph
``M[nodes][:, nodes]`` -- exactly the instance the mapping engine solves.
Releasing the allocation frees its nodes for the next job.

Allocation policies (also the candidate-carving policies of
:meth:`ClusterState.candidate_subsets`):

  * ``"compact"`` (default): greedy closest-node growth -- seed with the
    free node whose total distance to the other free nodes is smallest,
    then repeatedly add the free node closest to the chosen set.  This is
    the scheduler behaviour the paper assumes (jobs get a compact slice,
    the mapper then optimises *within* it).
  * ``"first_fit"``: lowest-index free nodes; models a fragmenting
    scheduler and gives the mapper more distance to recover.
  * ``"slab"``: the window of ``size`` consecutive free nodes (in node-id
    order, i.e. grid-coordinate order for grid machines) whose induced
    total distance is smallest -- a topology-aware contiguous slab.
  * ``"scatter"``: free nodes sampled at an even stride across the free
    set -- a deliberately spread-out subset that gives the
    allocate-then-map loop a diverse alternative to judge.

Determinism contract: every policy receives the free set in **sorted
node-id order** and returns a **sorted** node array, so two clusters in
the same occupancy state always carve bitwise-identical subsets -- the
mapping engine's digest cache then recognises repeated (cluster state,
job size) situations regardless of the release order that produced them.

The two-phase carving used by the resource manager
(:class:`~repro_torch.serve.rm.ResourceManager`):
:meth:`candidate_subsets` proposes K free-node subsets *without* mutating
occupancy, :meth:`reserve` pins their union while the mapping engine
scores all K induced subgraphs as one wave, and :meth:`promote` commits
the winning subset as the job's :class:`Allocation` (returning the losing
nodes to the free pool).  :meth:`cancel` aborts a reservation.

Thread-safe: the scheduler loop allocates while mapping futures resolve
on the engine's flusher thread.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

POLICIES = ("compact", "first_fit")
CANDIDATE_POLICIES = ("compact", "first_fit", "slab", "scatter")


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


@dataclass(frozen=True)
class Candidate:
    """One proposed free-node subset for a job, before any commitment.

    Produced by :meth:`ClusterState.candidate_subsets`; ``M_sub`` is the
    induced distance subgraph a :class:`~repro_torch.serve.mapper.MapRequest`
    for this candidate should carry.  ``nodes`` is sorted (see the module
    docstring's determinism contract).
    """
    policy: str
    nodes: np.ndarray          # (k,) sorted physical node ids
    M_sub: np.ndarray          # (k, k) induced distance matrix

    @property
    def size(self) -> int:
        return int(self.nodes.shape[0])


class ClusterState:
    """Node occupancy + allocation over a fixed system graph.

    Resource-manager integration: the blessed front door is
    :class:`repro_torch.serve.rm.ResourceManager`, which owns a queue, a
    cluster, and a mapping engine and drives the candidate-wave loop.
    Pairing the pieces by hand looks like::

        cluster = ClusterState(M_system)
        alloc = cluster.allocate("job-0", size=32)     # None = queue it
        fut = engine.submit(MapRequest(job_id="job-0",
                                       C=flows, M=alloc.M_sub))
        nodes = alloc.physical(fut.result().perm)      # process k -> node
        ...                                            # job runs
        cluster.release("job-0")
    """

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
        self._reserved: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ inspection
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
            return self._free_sorted()

    def induced(self, nodes: np.ndarray) -> np.ndarray:
        """The induced distance subgraph ``M[nodes][:, nodes]`` (a copy)."""
        nodes = np.asarray(nodes)
        return self.M[np.ix_(nodes, nodes)].copy()

    def _free_sorted(self) -> np.ndarray:
        # np.flatnonzero is already ascending; the explicit sort pins the
        # determinism contract every carving policy builds on (candidate
        # digests must be cache-stable across identical cluster states).
        return np.sort(np.flatnonzero(self._free))

    # ------------------------------------------------------------ lifecycle
    def allocate(self, job_id: str, size: int) -> Optional[Allocation]:
        """Carve ``size`` free nodes for ``job_id``; None when the cluster
        cannot host the job right now (caller queues or backfills)."""
        if size < 1 or size > self.num_nodes:
            raise ValueError(f"job size {size} not in [1, {self.num_nodes}]")
        with self._lock:
            if job_id in self._allocs:
                raise ValueError(f"job {job_id!r} already allocated")
            free = self._free_sorted()
            if free.shape[0] < size:
                return None
            if self.policy == "first_fit":
                nodes = free[:size]
            else:
                nodes = self._select_compact(free, size)
            return self._commit(job_id, nodes)

    def allocate_nodes(self, job_id: str, nodes: np.ndarray) -> Allocation:
        """Commit an explicit node set (e.g. a chosen candidate) for
        ``job_id``.  All nodes must currently be free."""
        nodes = np.sort(np.asarray(nodes, dtype=np.int64))
        with self._lock:
            if job_id in self._allocs:
                raise ValueError(f"job {job_id!r} already allocated")
            self._check_free(nodes)
            return self._commit(job_id, nodes)

    def release(self, job_id: str) -> None:
        """Return a finished job's nodes to the free pool."""
        with self._lock:
            alloc = self._allocs.pop(job_id, None)
            if alloc is None:
                raise KeyError(f"job {job_id!r} has no allocation")
            self._free[alloc.nodes] = True

    def _commit(self, job_id: str, nodes: np.ndarray) -> Allocation:
        """Mark ``nodes`` busy and record the allocation (lock held)."""
        self._free[nodes] = False
        alloc = Allocation(job_id=job_id, nodes=nodes,
                           M_sub=self.M[np.ix_(nodes, nodes)].copy())
        self._allocs[job_id] = alloc
        return alloc

    def _check_free(self, nodes: np.ndarray) -> None:
        if nodes.size == 0:
            raise ValueError("empty node set")
        if np.unique(nodes).size != nodes.size:
            raise ValueError("duplicate nodes")
        if nodes.min() < 0 or nodes.max() >= self.num_nodes:
            raise ValueError("node id out of range")
        if not self._free[nodes].all():
            busy = nodes[~self._free[nodes]]
            raise ValueError(f"nodes {busy.tolist()} are not free")

    # -------------------------------------------------------- candidate carve
    def candidate_subsets(self, size: int, k: int = 3,
                          policies: Sequence[str] = ("compact", "slab",
                                                     "scatter"),
                          ) -> List[Candidate]:
        """Propose up to ``k`` *distinct* free-node subsets for a job of
        ``size`` nodes, one per carving policy in order, **without
        mutating occupancy** -- the allocate-then-map loop scores all of
        them through the mapping engine and commits only the winner
        (:meth:`reserve` / :meth:`promote`).

        Returns fewer than ``k`` candidates when policies coincide (on an
        empty machine compact and slab often agree) and an empty list
        when the job does not fit right now.
        """
        if size < 1 or size > self.num_nodes:
            raise ValueError(f"job size {size} not in [1, {self.num_nodes}]")
        for p in policies:
            if p not in CANDIDATE_POLICIES:
                raise ValueError(
                    f"policy {p!r} not in {CANDIDATE_POLICIES}")
        with self._lock:
            free = self._free_sorted()
            if free.shape[0] < size:
                return []
            out: List[Candidate] = []
            seen = set()
            for policy in policies:
                if len(out) >= k:
                    break
                nodes = self._carve(policy, free, size)
                key = nodes.tobytes()
                if key in seen:
                    continue
                seen.add(key)
                out.append(Candidate(
                    policy=policy, nodes=nodes,
                    M_sub=self.M[np.ix_(nodes, nodes)].copy()))
            return out

    def _carve(self, policy: str, free: np.ndarray, size: int) -> np.ndarray:
        if policy == "compact":
            return self._select_compact(free, size)
        if policy == "first_fit":
            return free[:size]
        if policy == "slab":
            return self._select_slab(free, size)
        return self._select_scatter(free, size)

    # ------------------------------------------------------------ reservations
    def reserve(self, tag: str, nodes: np.ndarray) -> np.ndarray:
        """Pin ``nodes`` (all currently free) under ``tag``: they stop
        being allocatable but are not yet any job's allocation.  The
        resource manager reserves the union of a job's candidate subsets
        while the mapping wave is in flight, so a concurrent scheduling
        pass cannot steal them mid-solve.  Ends with :meth:`promote` or
        :meth:`cancel`.  Returns the (sorted) reserved node array."""
        nodes = np.sort(np.asarray(nodes, dtype=np.int64))
        with self._lock:
            if tag in self._reserved:
                raise ValueError(f"tag {tag!r} already holds a reservation")
            self._check_free(nodes)
            self._free[nodes] = False
            self._reserved[tag] = nodes
            return nodes

    def cancel(self, tag: str) -> None:
        """Drop a reservation, returning all its nodes to the free pool."""
        with self._lock:
            nodes = self._reserved.pop(tag, None)
            if nodes is None:
                raise KeyError(f"tag {tag!r} has no reservation")
            self._free[nodes] = True

    def promote(self, tag: str, job_id: str,
                nodes: np.ndarray) -> Allocation:
        """Commit ``nodes`` (a subset of ``tag``'s reservation) as
        ``job_id``'s allocation; the rest of the reservation is freed.
        Releasing the allocation later restores exactly the pre-wave
        occupancy."""
        nodes = np.sort(np.asarray(nodes, dtype=np.int64))
        with self._lock:
            held = self._reserved.get(tag)
            if held is None:
                raise KeyError(f"tag {tag!r} has no reservation")
            if job_id in self._allocs:
                raise ValueError(f"job {job_id!r} already allocated")
            if not np.isin(nodes, held).all():
                raise ValueError("promoted nodes must be reserved"
                                 f" under {tag!r}")
            del self._reserved[tag]
            self._free[held] = True               # free the losers ...
            return self._commit(job_id, nodes)    # ... keep the winner

    def reserved_nodes(self, tag: str) -> Optional[np.ndarray]:
        with self._lock:
            held = self._reserved.get(tag)
            return None if held is None else held.copy()

    # ---------------------------------------------------------------- policy
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
            dist_masked = np.where(remaining, dist_to_set, np.inf)
            nxt = int(np.argmin(dist_masked))
            chosen.append(nxt)
            remaining[nxt] = False
            dist_to_set += sub[nxt]
        return np.sort(free[np.array(chosen)])

    def _select_slab(self, free: np.ndarray, size: int) -> np.ndarray:
        """Cheapest window of ``size`` consecutive free nodes in node-id
        order (grid order for grid machines): a contiguous slab that is
        topology-aware without the greedy growth's O(F*size) scan."""
        sub = self.M[np.ix_(free, free)]
        nwin = free.shape[0] - size + 1
        best_w, best_cost = 0, np.inf
        for w in range(nwin):
            cost = float(sub[w:w + size, w:w + size].sum())
            if cost < best_cost:
                best_w, best_cost = w, cost
        return free[best_w:best_w + size]         # already sorted

    @staticmethod
    def _select_scatter(free: np.ndarray, size: int) -> np.ndarray:
        """Evenly strided sample across the free set.  Spacing is >= 1
        index, so the rounded positions are strictly increasing and the
        result is a sorted, duplicate-free subset."""
        if size == 1:
            return free[:1]
        idx = np.round(np.linspace(0, free.shape[0] - 1,
                                   size)).astype(np.int64)
        return free[idx]
