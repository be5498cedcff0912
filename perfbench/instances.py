"""Frozen copies of the known-optimum instance generators the cells draw.

``taie`` is ``repro_torch.core.instances.make_taie`` and ``torus`` is
``repro_torch.core.exact.make_torus``, copied so that the yardstick does
not move when the program's generators do; a test holds the copies to the
originals bit for bit.  Both give integer flows ``C`` and distances ``M``
(float32, exact) and the known optimum ``F0``:

* ``taie(n, version)``: Taillard-style taiXXe instances (Drezner, Hahn &
  Taillard 2005) on a 3-D grid.  Only the hidden relabelling depends on
  ``version``, so every version of one order has the same ``F0``.
* ``torus(dims, version)``: a nearest-neighbour stencil (weights 1-3) on a
  wraparound torus allocation; ``F0 = sum(C)``.

The parts that do not depend on ``version`` are built once per order and
shared, so that a run can make thousands of requests in its set-up.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np

# The grid factorisations of the paper's orders (make_taie's GRID).
GRID = {6: (1, 2, 3), 8: (2, 2, 2), 12: (2, 2, 3), 27: (3, 3, 3),
        45: (3, 3, 5), 75: (3, 5, 5), 125: (5, 5, 5), 175: (5, 5, 7),
        343: (7, 7, 7), 729: (9, 9, 9)}


class Instance(NamedTuple):
    C: np.ndarray       # (n, n) float32 integer flows
    M: np.ndarray       # (n, n) float32 integer distances (shared, read-only)
    optimum: float      # F0


def grid_distance_matrix(dims: Tuple[int, int, int]) -> np.ndarray:
    """Rectilinear distances between all points of a 3-D grid."""
    pts = np.array([(x, y, z) for x in range(dims[0])
                    for y in range(dims[1]) for z in range(dims[2])],
                   dtype=np.int64)
    return np.abs(pts[:, None, :] - pts[None, :, :]).sum(-1).astype(np.float32)


def torus_distance_matrix(dims: Tuple[int, ...]) -> np.ndarray:
    """Wraparound Manhattan distances between all points of a torus."""
    pts = np.array(list(np.ndindex(*dims)), dtype=np.int64)
    d = np.abs(pts[:, None, :] - pts[None, :, :])
    d = np.minimum(d, np.asarray(dims, np.int64)[None, None, :] - d)
    return d.sum(-1).astype(np.float32)


def _read_only(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


@functools.lru_cache(maxsize=None)
def _taie_base(n: int, density: float, max_flow: int):
    """``(C0, M, F0)`` of order ``n``: the flow pool laid on the grid's
    pairs by ascending distance, so that the identity is optimal."""
    M = grid_distance_matrix(GRID[n])
    iu, ju = np.triu_indices(n, k=1)
    order = np.lexsort((ju, iu, M[iu, ju]))
    nonzero = max(1, int(len(iu) * density))
    r = np.arange(nonzero, dtype=np.float64)
    vals = np.maximum(np.floor(max_flow * (1.0 - r / nonzero) ** 3)
                      .astype(np.int64), 1)
    pool = np.zeros(len(iu), dtype=np.int64)
    pool[:nonzero] = vals
    C0 = np.zeros((n, n), dtype=np.float64)
    C0[iu[order], ju[order]] = pool
    C0[ju[order], iu[order]] = pool
    return _read_only(C0), _read_only(M), float((C0 * M).sum())


def taie(n: int, version: int, density: float = 0.35,
         max_flow: int = 100) -> Instance:
    """The order-``n`` taiXXe instance of ``version``."""
    if n not in GRID:
        raise ValueError(f"order {n} not in {sorted(GRID)}")
    C0, M, f0 = _taie_base(n, density, max_flow)
    sigma = np.random.default_rng(1000003 * n + version).permutation(n)
    inv = np.argsort(sigma)
    return Instance(C0[np.ix_(inv, inv)].astype(np.float32), M, f0)


@functools.lru_cache(maxsize=None)
def _torus_base(dims: Tuple[int, ...]):
    """``M`` and the torus edges ``(i, j)``, ``i < j``."""
    M = torus_distance_matrix(dims)
    i, j = np.nonzero(np.triu(M == 1, 1))
    return _read_only(M), i, j


def torus(dims: Tuple[int, ...], version: int, max_flow: int = 3) -> Instance:
    """The stencil instance on the ``dims`` torus of ``version``: each
    edge's weight is ``make_torus``'s draw, laid straight at its
    relabelled place."""
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    M, i, j = _torus_base(dims)
    rng = np.random.default_rng(7000003 * n + version)
    w = rng.integers(1, max_flow + 1, (n, n))[i, j].astype(np.float32)
    sigma = rng.permutation(n)              # C[sigma[i], sigma[j]] = C0[i, j]
    C = np.zeros((n, n), np.float32)
    C[sigma[i], sigma[j]] = w
    C[sigma[j], sigma[i]] = w
    return Instance(C, M, 2.0 * float(w.sum()))

