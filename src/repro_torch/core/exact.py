"""Exact QAP solvers for small orders and known-optimum instances.

A numpy-only copy of ``repro/core/exact.py``, so that the port and its
tests build the same instances without importing the reference package.

The paper (S2) notes exact methods (brute force, branch-and-bound) are
feasible only for small graphs; they validate the heuristics and the
known-optimum instance construction.

:func:`make_ring` / :func:`make_torus` build *structured sparse*
known-optimum instances at any order (ring/torus flow graph on the
matching wraparound topology, in the spirit of ``instances.make_taie``):
every flow sits on a distance-1 pair under the hidden optimal labelling
and every off-diagonal torus distance is >= 1, so F0 = sum(C) exactly.
"""
from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

from .instances import QAPInstance


def brute_force(C: np.ndarray, M: np.ndarray, limit: int = 9) -> Tuple[float, np.ndarray]:
    """Exhaustive search; feasible for n <= ~9."""
    n = C.shape[0]
    if n > limit:
        raise ValueError(f"brute force limited to n<={limit}, got {n}")
    best_f, best_p = np.inf, None
    C64, M64 = C.astype(np.float64), M.astype(np.float64)
    for perm in itertools.permutations(range(n)):
        p = np.asarray(perm)
        f = float((C64 * M64[np.ix_(p, p)]).sum())
        if f < best_f:
            best_f, best_p = f, p
    return best_f, best_p


def branch_and_bound(C: np.ndarray, M: np.ndarray, limit: int = 14) -> Tuple[float, np.ndarray]:
    """Simple DFS branch-and-bound with a Gilmore-Lawler-style partial bound.

    Places processes 0..n-1 onto nodes one at a time.  The bound on the
    unplaced remainder pairs sorted flows against sorted distances
    (rearrangement lower bound restricted to the free submatrices).
    """
    n = C.shape[0]
    if n > limit:
        raise ValueError(f"branch-and-bound limited to n<={limit}, got {n}")
    C64, M64 = C.astype(np.float64), M.astype(np.float64)

    best = {"f": np.inf, "p": None}
    assigned = np.full(n, -1, dtype=np.int64)
    used = np.zeros(n, dtype=bool)

    def lower_bound(k: int, partial: float) -> float:
        # Bound on interactions among the still-unplaced processes.
        free_p = np.arange(k, n)
        free_nodes = np.where(~used)[0]
        if len(free_p) < 2:
            return partial
        cf = C64[np.ix_(free_p, free_p)]
        mf = M64[np.ix_(free_nodes, free_nodes)]
        cv = np.sort(cf.ravel())[::-1]
        mv = np.sort(mf.ravel())
        return partial + float((cv * mv).sum())

    def dfs(k: int, partial: float) -> None:
        if partial >= best["f"]:
            return
        if k == n:
            best["f"], best["p"] = partial, assigned.copy()
            return
        if lower_bound(k, partial) >= best["f"]:
            return
        for node in range(n):
            if used[node]:
                continue
            # Incremental cost of placing process k on node.
            inc = C64[k, k] * M64[node, node]
            for j in range(k):
                inc += C64[k, j] * M64[node, assigned[j]]
                inc += C64[j, k] * M64[assigned[j], node]
            assigned[k] = node
            used[node] = True
            dfs(k + 1, partial + inc)
            used[node] = False
            assigned[k] = -1

    dfs(0, 0.0)
    return best["f"], best["p"]


def torus_distance_matrix(dims: Tuple[int, ...]) -> np.ndarray:
    """Wraparound (torus) Manhattan distances between all grid points.

    Unlike ``instances.grid_distance_matrix`` the coordinate differences
    wrap, so the graph is vertex-transitive and every off-diagonal
    distance is >= 1 with equality exactly on torus edges — the property
    the known-optimum construction below rests on.
    """
    pts = np.array(list(np.ndindex(*dims)), dtype=np.int64)       # (N, k)
    d = np.abs(pts[:, None, :] - pts[None, :, :])
    d = np.minimum(d, np.asarray(dims, np.int64)[None, None, :] - d)
    return d.sum(-1).astype(np.float32)


def make_torus(dims: Tuple[int, ...], version: int = 1,
               max_flow: int = 3) -> QAPInstance:
    """Known-optimum *sparse* instance: torus-neighbour flows on the
    matching torus topology, relabelled by a hidden permutation.

    Flows are positive integers on exactly the distance-1 pairs of the
    torus; any permutation places each such flow on a pair of distinct
    nodes, i.e. at distance >= 1, so F(p) >= sum(C) for every p — and the
    hidden labelling attains it: F0 = sum(C) exactly (integer, so every
    f32 comparison downstream is exact).  Density is O(1/n) (2*len(dims)
    neighbours per node), which is what makes these the scaling fixtures
    for the sparse/multilevel path at orders the ``make_taie`` family's
    dense-ish pools and the oracles above cannot reach.
    """
    n = int(np.prod(dims))
    rng = np.random.default_rng(7000003 * n + version)
    M = torus_distance_matrix(dims)
    adj = M == 1
    W = rng.integers(1, max_flow + 1, (n, n)).astype(np.float64)
    W = np.triu(W, 1)
    W = W + W.T                                   # symmetric integer weights
    C0 = np.where(adj, W, 0.0)
    f0 = float(C0.sum())          # == (C0 * M).sum(): support is distance 1
    sigma = rng.permutation(n)                    # hidden relabelling
    inv = np.argsort(sigma)
    C = C0[np.ix_(inv, inv)]      # F_C(p) = F_C0(p o sigma); p* = inv
    dims_s = "x".join(str(d) for d in dims)
    return QAPInstance(name=f"torus{dims_s}v{version:02d}s",
                       C=C.astype(np.float32), M=M.astype(np.float32),
                       optimum=f0, opt_perm=inv.astype(np.int32))


def make_ring(n: int, version: int = 1, max_flow: int = 3) -> QAPInstance:
    """1-D special case of :func:`make_torus`: ring flows on a ring."""
    inst = make_torus((n,), version, max_flow)
    inst.name = f"ring{n}v{version:02d}s"
    return inst
