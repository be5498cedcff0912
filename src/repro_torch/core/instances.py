"""QAP workload instances in the spirit of Taillard's ``taiXeyy`` set.

A numpy-only copy of ``repro/core/instances.py``, so that the port builds
the same instances without importing the reference package.

The paper benchmarks on tai27e01 .. tai729e01 (orders 27, 45, 75, 125, 175,
343, 729) where both matrices and the optimal objective value F0 are known.
The official ``.dat`` files cannot be downloaded in this offline container, so
we generate same-order instances with *provably known* optima:

Construction (documented in the reference's design notes, S6):
  1. Nodes are points of an n1 x n2 x n3 grid (matching each order's
     factorisation; 27 = 3^3 ... 729 = 9^3); the system matrix ``M`` is the
     rectilinear (Manhattan) grid distance -- the same geometry family used
     for the published instances.
  2. Off-diagonal pairs are ranked by distance ascending; a sparse,
     non-increasing integer flow pool (many zeros, few large values -- the
     "difficult, clustered" regime of Drezner-Hahn-Taillard) is assigned so
     the identity permutation pairs the largest flows with the smallest
     distances.
  3. By the rearrangement inequality over pair bijections, F(identity) equals
     the lower bound  sum_r flow_desc[r] * dist_asc[r]  which is valid for
     EVERY permutation, hence identity is optimal and F0 is known exactly.
  4. The program graph is then relabelled by a hidden random permutation
     sigma, so the (known) optimum becomes sigma, not identity.

If official Taillard files are present under ``data/qap/`` they are loaded
instead (``load_official``), and F0 must be supplied from the published table.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

# Grid factorisations for the paper's orders.
GRID: Dict[int, Tuple[int, int, int]] = {
    6: (1, 2, 3),       # tiny order used by unit tests (brute-forceable)
    8: (2, 2, 2),
    12: (2, 2, 3),
    27: (3, 3, 3),
    45: (3, 3, 5),
    75: (3, 5, 5),
    125: (5, 5, 5),
    175: (5, 5, 7),
    343: (7, 7, 7),
    729: (9, 9, 9),
}

PAPER_ORDERS = (27, 45, 75, 125, 175, 343, 729)


@dataclass
class QAPInstance:
    name: str
    C: np.ndarray            # program-graph flows (N, N) float32
    M: np.ndarray            # system-graph distances (N, N) float32
    optimum: Optional[float]  # known F0 (None when unknown)
    opt_perm: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def n(self) -> int:
        return self.C.shape[0]


def grid_distance_matrix(dims: Tuple[int, int, int]) -> np.ndarray:
    """Rectilinear distances between all points of a 3D grid."""
    pts = np.array([(x, y, z)
                    for x in range(dims[0])
                    for y in range(dims[1])
                    for z in range(dims[2])], dtype=np.int64)
    diff = np.abs(pts[:, None, :] - pts[None, :, :]).sum(-1)
    return diff.astype(np.float32)


def _flow_pool(num_pairs: int, rng: np.random.Generator,
               density: float = 0.35, max_flow: int = 100) -> np.ndarray:
    """Non-increasing sparse integer flows: ~density of pairs nonzero."""
    nonzero = max(1, int(num_pairs * density))
    # Heavy-tailed descending values with ties (clusters of equal flow).
    r = np.arange(nonzero, dtype=np.float64)
    vals = np.floor(max_flow * (1.0 - r / nonzero) ** 3).astype(np.int64)
    vals = np.maximum(vals, 1)
    pool = np.zeros(num_pairs, dtype=np.int64)
    pool[:nonzero] = vals
    del rng  # pool is deterministic; rng reserved for future variants
    return pool  # already non-increasing


def make_taie(n: int, version: int = 1, density: float = 0.35,
              max_flow: int = 100) -> QAPInstance:
    """Generate a known-optimum instance of order ``n`` (see module docstring)."""
    if n not in GRID:
        raise ValueError(f"order {n} not in supported set {sorted(GRID)}")
    rng = np.random.default_rng(1000003 * n + version)
    M = grid_distance_matrix(GRID[n])

    iu, ju = np.triu_indices(n, k=1)
    dists = M[iu, ju]
    order = np.lexsort((ju, iu, dists))          # distance asc, deterministic ties
    pool = _flow_pool(len(iu), rng, density, max_flow)

    C0 = np.zeros((n, n), dtype=np.float64)
    C0[iu[order], ju[order]] = pool
    C0[ju[order], iu[order]] = pool              # symmetric
    # Identity is optimal for (C0, M): rearrangement bound is attained.
    f0 = float((C0 * M).sum())

    sigma = rng.permutation(n)                   # hidden relabelling
    inv = np.argsort(sigma)
    C = C0[np.ix_(inv, inv)]                     # C[k,l] = C0[inv[k], inv[l]]
    # F_C(p) = F_C0(p o sigma); optimal p o sigma = id  =>  p* = sigma^-1 = inv.
    return QAPInstance(
        name=f"tai{n}e{version:02d}s",           # 's' = synthetic known-optimum
        C=C.astype(np.float32),
        M=M.astype(np.float32),
        optimum=f0,
        opt_perm=inv.astype(np.int32),
    )


def load_official(path: str, name: str, optimum: Optional[float] = None) -> QAPInstance:
    """Load a Taillard-format .dat file (n, then two n x n matrices)."""
    with open(path) as f:
        tokens = f.read().split()
    n = int(tokens[0])
    vals = np.array(tokens[1:1 + 2 * n * n], dtype=np.float64)
    A = vals[: n * n].reshape(n, n)
    B = vals[n * n:].reshape(n, n)
    # Taillard convention: first matrix distances, second flows.
    return QAPInstance(name=name, C=B.astype(np.float32),
                       M=A.astype(np.float32), optimum=optimum)


def get_instance(n: int, version: int = 1, data_dir: str = "data/qap") -> QAPInstance:
    """Official file if present, else the synthetic known-optimum instance."""
    fname = os.path.join(data_dir, f"tai{n}e{version:02d}.dat")
    if os.path.exists(fname):
        return load_official(fname, f"tai{n}e{version:02d}")
    return make_taie(n, version)
