"""Multilevel coarsen -> map -> refine pipeline for large mapping
instances: the port of ``repro/core/multilevel.py``.

The engine serves orders of 256 and more through it:

* **Coarsening** (host-side numpy, copied from the reference): heavy-edge
  matching on the flow graph and closest-pair matching of the system
  graph, the coarse distance between clusters the minimum member
  distance.  Matchings are perfect (every cluster has two members, levels
  halve), so prolongation is a permutation by construction; an odd order
  stops coarsening.
* **Coarse solve**: dense ``annealing.run_psa`` (kernel K1 on the card)
  or ``genetic.run_pga`` (K2) at ``coarse_n``.
* **Refinement**: each level prolongs the coarser solution and
  warm-starts sparse SA from it (``init_perm``; flows as
  ``core.sparse.SparseFlows``, kernels K6/K7), so every level ends no
  worse than its prolonged seed.
* **Final polish**: the finest level ends with the sparse 2-swap descent
  of ``mapping.polish`` (K6 for its start, K7 for each round).

The keys are the reference's: ``fold_in`` 0 for the coarse solve,
``1 + li`` for refinement level ``li`` and 7 for the polish, so the same
request gives the same permutation as the reference engine.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import as_tensor, resolve_device
from . import annealing, genetic, keys, mapping, sparse


@dataclass(frozen=True)
class MultilevelConfig:
    coarse_n: int = 64            # stop coarsening at or below this order
    max_levels: int = 12          # safety bound on the level stack
    algorithm: str = "psa"        # coarse solver: "psa" | "pga"
    num_processes: int = 2
    coarse_sa: annealing.SAConfig = field(default=annealing.SAConfig(
        max_neighbors=30, iters_per_exchange=20, num_exchanges=10, solvers=8))
    coarse_ga: genetic.GAConfig = field(default=genetic.GAConfig(
        generations=60, pop_size=0))
    refine_sa: annealing.SAConfig = field(default=annealing.SAConfig(
        max_neighbors=16, iters_per_exchange=8, num_exchanges=4, solvers=2,
        flows="sparse"))
    final_polish_rounds: int = 64


class LevelInfo(NamedTuple):
    n: int                # order at this level
    nnz: int              # stored flow nonzeros at this level
    f_prolonged: float    # objective of the prolonged coarse solution
    f_refined: float      # objective after warm-started refinement
                          # (never above f_prolonged)


class MultilevelResult(NamedTuple):
    perm: np.ndarray          # finest-level permutation
    objective: float          # F(perm) on the input instance (exact, f64)
    coarse_objective: float   # objective of the coarsest-level solve
    levels: Tuple[LevelInfo, ...]   # coarsest-to-finest refinement trace
    seconds: float


def _np_objective(C: np.ndarray, M: np.ndarray, p: np.ndarray) -> float:
    """Exact (float64, host) objective: the reporting yardstick."""
    return float((C.astype(np.float64)
                  * M.astype(np.float64)[np.ix_(p, p)]).sum())


def heavy_edge_matching(C: np.ndarray) -> np.ndarray:
    """Perfect heavy-edge matching of the flow graph: (n//2, 2) pairs.

    Vertices are visited by descending total flow (stable, so ties are
    deterministic); each picks its heaviest unmatched neighbour.  Vertices
    left without a positive-weight partner are paired among themselves in
    index order -- the matching is always perfect (``n`` must be even).
    """
    n = C.shape[0]
    if n % 2 != 0:
        raise ValueError(f"heavy-edge matching needs an even order, got {n}")
    W = C.astype(np.float64)
    W = W + W.T
    np.fill_diagonal(W, 0.0)
    matched = np.zeros(n, dtype=bool)
    pairs = []
    for v in np.argsort(-W.sum(axis=1), kind="stable"):
        if matched[v]:
            continue
        w = np.where(matched, -1.0, W[v])
        w[v] = -1.0
        u = int(np.argmax(w))
        if w[u] <= 0.0:
            continue                      # no unmatched positive neighbour
        matched[v] = matched[u] = True
        pairs.append((int(v), u))
    left = np.where(~matched)[0]
    pairs.extend((int(left[i]), int(left[i + 1]))
                 for i in range(0, len(left), 2))
    return np.asarray(pairs, dtype=np.int64)


def closest_pair_matching(M: np.ndarray) -> np.ndarray:
    """Perfect matching of system nodes by ascending distance: (n//2, 2).

    Greedy in index order: each unmatched node grabs its nearest unmatched
    peer, so cluster members are topologically close and the coarse
    distance (minimum member distance) stays faithful.
    """
    n = M.shape[0]
    if n % 2 != 0:
        raise ValueError(f"closest-pair matching needs an even order, got {n}")
    matched = np.zeros(n, dtype=bool)
    pairs = []
    for i in range(n):
        if matched[i]:
            continue
        d = np.where(matched, np.inf, M[i].astype(np.float64))
        d[i] = np.inf
        j = int(np.argmin(d))
        matched[i] = matched[j] = True
        pairs.append((i, j))
    return np.asarray(pairs, dtype=np.int64)


def coarsen(C: np.ndarray, M: np.ndarray, flow_pairs: np.ndarray,
            sys_pairs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Contract one level: flows sum over cluster pairs (intra-cluster
    flows vanish into the zeroed diagonal); distances take the minimum
    member distance, an optimistic coarse proxy."""
    n = C.shape[0]
    nc = flow_pairs.shape[0]
    cid = np.empty(n, dtype=np.int64)
    cid[flow_pairs[:, 0]] = np.arange(nc)
    cid[flow_pairs[:, 1]] = np.arange(nc)
    ii, jj = np.nonzero(C)
    Cc = np.zeros((nc, nc), dtype=np.float64)
    np.add.at(Cc, (cid[ii], cid[jj]), C[ii, jj].astype(np.float64))
    np.fill_diagonal(Cc, 0.0)

    a0, a1 = sys_pairs[:, 0], sys_pairs[:, 1]
    Mc = np.minimum.reduce([M[np.ix_(a0, a0)], M[np.ix_(a0, a1)],
                            M[np.ix_(a1, a0)], M[np.ix_(a1, a1)]])
    Mc = Mc.astype(np.float64)
    np.fill_diagonal(Mc, 0.0)
    return Cc.astype(np.float32), Mc.astype(np.float32)


def prolong_perm(pc: np.ndarray, flow_pairs: np.ndarray,
                 sys_pairs: np.ndarray) -> np.ndarray:
    """Lift a coarse assignment: both members of flow cluster c land on
    the two system nodes of its system cluster ``pc[c]`` (refinement
    decides the orientation).  A permutation by construction."""
    n = 2 * pc.shape[0]
    p = np.empty(n, dtype=np.int32)
    p[flow_pairs[:, 0]] = sys_pairs[pc, 0]
    p[flow_pairs[:, 1]] = sys_pairs[pc, 1]
    return p


def coarsen_levels(C: np.ndarray, M: np.ndarray, cfg: MultilevelConfig):
    """The level stack, finest first: ``([(C, M, flow_pairs, sys_pairs),
    ...], (C_coarsest, M_coarsest))``.  Coarsening stops at or below
    ``cfg.coarse_n``, at an odd order, or after ``cfg.max_levels``."""
    stack = []
    Cl, Ml = C, M
    while (Cl.shape[0] > cfg.coarse_n and Cl.shape[0] % 2 == 0
           and len(stack) < cfg.max_levels):
        fp = heavy_edge_matching(Cl)
        sp = closest_pair_matching(Ml)
        stack.append((Cl, Ml, fp, sp))
        Cl, Ml = coarsen(Cl, Ml, fp, sp)
    return stack, (Cl, Ml)


def solve_multilevel(C, M, key=None, cfg: Optional[MultilevelConfig] = None,
                     device=None) -> MultilevelResult:
    """Coarsen -> solve coarse -> prolong-and-refine each level -> polish
    (module docstring).  ``C``/``M`` are dense host arrays and ``key`` a
    ``(2,)`` key (``keys.prng_key(0)`` by default); the solves run on
    ``device`` (``cuda`` unless it says otherwise)."""
    cfg = cfg or MultilevelConfig()
    if cfg.algorithm not in ("psa", "pga"):
        raise ValueError(
            f"algorithm must be 'psa' or 'pga', got {cfg.algorithm!r}")
    dev = resolve_device(device)
    key = keys.prng_key(0, dev) if key is None else as_tensor(
        key, torch.int64, dev)
    C = np.asarray(C, np.float32)
    M = np.asarray(M, np.float32)

    t0 = time.perf_counter()
    stack, (Cl, Ml) = coarsen_levels(C, M, cfg)

    # ---- coarse solve (dense: at coarse_n the dense path is the fast one).
    kc = keys.fold_in(key, 0)
    if cfg.algorithm == "psa":
        p, _, _ = annealing.run_psa(Cl, Ml, kc, cfg.coarse_sa,
                                    cfg.num_processes, device=dev)
    else:
        p, _, _ = genetic.run_pga(Cl, Ml, kc, cfg.coarse_ga,
                                  cfg.num_processes, device=dev)
    p = p.cpu().numpy()
    coarse_f = _np_objective(Cl, Ml, p)

    # ---- prolong + warm-started sparse refinement, coarsest to finest.
    levels = []
    for li, (Cl, Ml, fp, sp) in enumerate(reversed(stack)):
        p = prolong_perm(p, fp, sp)
        f_pro = _np_objective(Cl, Ml, p)
        Cs = sparse.prepare_flows(Cl, cfg.refine_sa.flows, device=dev)
        p_ref, _, _ = annealing.run_psa(
            Cs, Ml, keys.fold_in(key, 1 + li), cfg.refine_sa,
            cfg.num_processes, init_perm=p, device=dev)
        p = p_ref.cpu().numpy()
        f_ref = _np_objective(Cl, Ml, p)
        levels.append(LevelInfo(n=Cl.shape[0], nnz=int((Cl != 0).sum()),
                                f_prolonged=f_pro, f_refined=f_ref))

    # ---- final polish on the finest level (sparse 2-swap descent).
    if cfg.final_polish_rounds > 0:
        Cs = sparse.prepare_flows(C, cfg.refine_sa.flows, device=dev)
        p_pol, _ = mapping.polish(Cs, M, p, keys.fold_in(key, 7),
                                  rounds=cfg.final_polish_rounds, device=dev)
        p = p_pol.cpu().numpy()
    f = _np_objective(C, M, p)
    return MultilevelResult(perm=p.astype(np.int32), objective=f,
                            coarse_objective=coarse_f, levels=tuple(levels),
                            seconds=time.perf_counter() - t0)
