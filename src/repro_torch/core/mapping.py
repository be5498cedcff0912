"""Public mapping API: solve one job's mapping, and the final 2-swap
polish the serving engine applies to every wave.

``find_mapping`` gives the permutation ``p`` (process -> node) that
minimises the paper's functional for a program graph ``C`` and a system
graph ``M`` with any of the paper's three algorithms (``"psa"``,
``"pga"``, ``"pca"``) or the trivial ``"identity"``.  With a
``DeviceMesh`` it runs the search distributed over the mesh's ranks
(``core.distributed``), the paper's deployment: every rank calls it and
gets the same mapping.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import as_tensor, resolve_device
from ..kernels import ops
from . import annealing, composite, distributed, genetic, keys, qap

ALGORITHMS = ("psa", "pga", "pca", "identity")
POLISH_CANDIDATES = 256


def polish_batch(Cs, Ms, ps, key, rounds: int = 200, n_valid=None,
                 device=None):
    """Instance-batched greedy 2-swap descent: ``Cs``/``Ms`` ``(B, N, N)``
    (``Cs`` may be a ``SparseFlows`` with ``(B, N, D)`` leaves), ``ps (B,
    N)``, ``key (B, 2)``, ``n_valid`` optional ``(B,)``.

    Each round scores 256 random swaps of every instance in one
    ``kernels.ops.qap_delta`` call (K1, or K7 for sparse flows, on the
    card) and applies the best one (first index on ties) if it lowers F
    by more than 1e-9.  Returns ``(perms, fs)``.
    """
    C, M, key, nv, p = annealing.wave_inputs(Cs, Ms, key, n_valid, ps,
                                             device)
    dev = M.device
    if nv is not None:
        C = qap.mask_flows(C, nv)
    CT, MT = ops.transposes(C, M)
    f = qap.objective(C, M, p)
    b, n = p.shape
    round_keys = keys.split(key, rounds)                        # (B, R, 2)
    pairs_all = qap.random_swap_pairs(round_keys, POLISH_CANDIDATES, n,
                                      None if nv is None else nv[:, None])
    pairs_all = pairs_all.transpose(0, 1).contiguous()          # (R, B, K, 2)
    rows = torch.arange(b, device=dev)
    for t in range(rounds):
        pairs = pairs_all[t]
        deltas = ops.qap_delta(C, M, p, pairs, CT, MT)
        i = qap.first_argmin(deltas)
        d = deltas[rows, i]
        better = d < -1e-9
        ab = pairs[rows, i]
        p = torch.where(better[:, None],
                        qap.swap_positions(p, ab[:, 0], ab[:, 1]), p)
        f = torch.where(better, f + d, f)
    return p, f


def polish(C, M, p, key, rounds: int = 200, n_valid=None, device=None):
    """Single-instance :func:`polish_batch`: ``(perm, f)``."""
    C, M, key, nv, p = annealing.wave_inputs(C, M, key, n_valid, p, device)
    ps, fs = polish_batch(annealing.lead(C), M[None], p[None], key[None],
                          rounds, None if nv is None else nv.reshape(1),
                          device=M.device)
    return ps[0], fs[0]


@dataclass
class MappingResult:
    perm: np.ndarray          # p[k] = node index for process k
    objective: float          # F(p)
    baseline: float           # F(identity) -- the un-optimised placement
    algorithm: str
    seconds: float
    history: Optional[np.ndarray] = None

    @property
    def improvement(self) -> float:
        """Relative reduction of the communication functional vs identity."""
        if self.baseline == 0:
            return 0.0
        return (self.baseline - self.objective) / self.baseline


def find_mapping(C, M, algorithm: str = "psa", *, key=None,
                 num_processes: int = 4,
                 sa_cfg: Optional[annealing.SAConfig] = None,
                 ga_cfg: Optional[genetic.GAConfig] = None,
                 polish_rounds: int = 200, mesh=None, axis: str = "proc",
                 device=None) -> MappingResult:
    """Solve the mapping problem with the selected algorithm, then polish;
    never worse than the identity placement.  Runs on ``cuda`` unless
    ``device`` says otherwise.

    With ``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh``) the
    search itself runs distributed over the mesh dim ``axis`` (the
    paper's deployment: the mapping runs on the job's own nodes), on the
    mesh's device type; every rank calls this and gets the same result,
    and ``num_processes`` is the dim's size.  Otherwise processes are a
    batch dimension on one device.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}")
    if mesh is not None:
        if device is not None and \
                torch.device(device).type != mesh.device_type:
            raise ValueError(f"device {device} is not on the mesh's "
                             f"{mesh.device_type!r} devices")
        device = distributed.mesh_device(mesh)
    dev = resolve_device(device)
    C = as_tensor(C, torch.float32, dev)
    M = as_tensor(M, torch.float32, dev)
    n = C.shape[0]
    key = keys.prng_key(0, dev) if key is None else as_tensor(
        key, torch.int64, dev)
    ident = torch.arange(n, dtype=torch.int32, device=dev)
    baseline = float(qap.objective(C, M, ident))

    t0 = time.perf_counter()
    hist = None
    if algorithm == "identity":
        perm, f = ident, baseline
    else:
        if algorithm == "psa":
            cfg = sa_cfg or annealing.SAConfig()
            solve, mesh_solve = annealing.run_psa, distributed.run_psa_mesh
        elif algorithm == "pga":
            cfg = ga_cfg or genetic.GAConfig()
            solve, mesh_solve = genetic.run_pga, distributed.run_pga_mesh
        else:
            cfg = composite.CompositeConfig(
                sa=sa_cfg or annealing.SAConfig(num_exchanges=10, solvers=0),
                ga=ga_cfg or genetic.GAConfig())
            solve, mesh_solve = composite.run_pca, distributed.run_pca_mesh
        if mesh is not None:
            perm, f, hist = mesh_solve(C, M, key, cfg, mesh, axis)
        else:
            perm, f, hist = solve(C, M, key, cfg, num_processes, device=dev)
        if polish_rounds > 0:
            perm, f = polish(C, M, perm, keys.fold_in(key, 7), polish_rounds,
                             device=dev)
    f = float(f)
    seconds = time.perf_counter() - t0
    if f > baseline:
        perm, f = ident, baseline
    return MappingResult(perm=perm.cpu().numpy(), objective=f,
                         baseline=baseline, algorithm=algorithm,
                         seconds=seconds,
                         history=None if hist is None else hist.cpu().numpy())
