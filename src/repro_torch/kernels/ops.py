"""Kernel dispatch: a CUDA tensor goes to the kernel, a CPU tensor to the
plain PyTorch version.  Nothing else: there is no fallback from a CUDA
tensor to the plain version, and a kernel that cannot launch raises.

Flows are dense ``(N, N)`` / ``(B0, N, N)`` tensors or a
``core.sparse.SparseFlows``; :func:`qap_objective` and :func:`qap_delta`
route the sparse ones to :func:`qap_objective_sparse` and
:func:`qap_delta_sparse` (kernels K6/K7), so every solver gains the
sparse path without change.

:func:`selective_scan` (kernel K8) is the Mamba layer's scan
(``models/ssm.py``).

Call sites in ``repro_torch.core`` and ``repro_torch.models`` go
through these wrappers only.  Each kernel launch adds one to its count
(:func:`launch_counts`), so a run can show that its work went through the
kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.sparse import SparseFlows
from . import build
from .qap_delta import qap_delta_cuda, qap_delta_plain
from .qap_ga_step import qap_ga_step_cuda, qap_ga_step_plain
from .qap_objective import qap_objective_cuda, qap_objective_plain
from .qap_sa_step import qap_sa_step_cuda, qap_sa_step_plain
from .qap_sparse import (qap_delta_sparse_cuda, qap_delta_sparse_plain,
                         qap_objective_sparse_cuda, qap_objective_sparse_plain)
from .selective_scan import SelectiveScan

LANE = 128
# The fused steps' order cap, kept equal to the reference's
# (repro/kernels/qap_objective.py MAX_KERNEL_N) so that the SA loop and
# the GA generation resolve to the same realisation at every order.
MAX_FUSED_N = 768


def _route(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    with build.COUNT_LOCK:
        return {name: build.LAUNCHES[name] for name in build.KERNELS}


def branch_counts() -> Dict[str, int]:
    """Launches of K1, K4, K2 and K5 by branch (``"qap_delta/smem"``,
    ``"qap_delta/l2"``, ..., ``"qap_ga_step/l2"``) since the last
    :func:`reset_launch_counts`."""
    with build.COUNT_LOCK:
        return {f"{name}/{branch}": build.BRANCH_LAUNCHES[f"{name}/{branch}"]
                for name in ("qap_delta", "qap_sa_step", "qap_objective",
                             "qap_ga_step")
                for branch in ("smem", "l2")}


def reset_launch_counts() -> None:
    with build.COUNT_LOCK:
        build.LAUNCHES.clear()
        build.BRANCH_LAUNCHES.clear()


def transposes(C, M: torch.Tensor
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(C^T, M^T)`` contiguous, as the kernels read them: made once per
    solve on the card; ``(None, None)`` for the plain path and for sparse
    flows, which hold both orientations of ``C`` already and whose kernel
    K7 reads ``M`` alone."""
    if not _route(M) or isinstance(C, SparseFlows):
        return None, None
    return C.transpose(-2, -1).contiguous(), M.transpose(-2, -1).contiguous()


def qap_delta(C: torch.Tensor, M: torch.Tensor, p: torch.Tensor,
              pairs: torch.Tensor, CT: Optional[torch.Tensor] = None,
              MT: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Swap deltas ``p (B, N)`` x ``pairs (B, K, 2)`` -> ``(B, K)``.

    ``C``/``M`` shared ``(N, N)`` or instance-batched ``(B0, N, N)``;
    ``CT``/``MT`` (their transposes) are used by the kernel only.  A
    ``SparseFlows`` ``C`` goes to :func:`qap_delta_sparse`.
    """
    if isinstance(C, SparseFlows):
        return qap_delta_sparse(C, M, p, pairs)
    if _route(p):
        return qap_delta_cuda(C, M, p, pairs, CT, MT)
    return qap_delta_plain(C, M, p, pairs)


def qap_objective(C: torch.Tensor, M: torch.Tensor, perms: torch.Tensor
                  ) -> torch.Tensor:
    """F for ``perms (B, P, N)`` -> ``(B, P)``: every island's offspring
    of a wave in one call.  ``C``/``M`` shared ``(N, N)`` or
    instance-batched ``(B0, N, N)`` with ``B0`` dividing ``B``.  A
    ``SparseFlows`` ``C`` goes to :func:`qap_objective_sparse`."""
    if isinstance(C, SparseFlows):
        return qap_objective_sparse(C, M, perms)
    if _route(perms):
        return qap_objective_cuda(C, M, perms)
    return qap_objective_plain(C, M, perms)


def qap_objective_sparse(S: SparseFlows, M: torch.Tensor,
                         perms: torch.Tensor) -> torch.Tensor:
    """Sparse F for ``perms (B, P, N)`` -> ``(B, P)`` in O(nnz) each (K6
    on the card).  ``S`` leaves shared ``(N, D)`` with ``M (N, N)``, or
    instance-batched ``(B0, N, D)`` with ``M (B0, N, N)``, ``B0``
    dividing ``B``.  The reference capped its kernel at order 4096 and
    ran its plain version above; K6 takes every order."""
    if _route(perms):
        return qap_objective_sparse_cuda(S, M, perms)
    return qap_objective_sparse_plain(S, M, perms)


def qap_delta_sparse(S: SparseFlows, M: torch.Tensor, p: torch.Tensor,
                     pairs: torch.Tensor) -> torch.Tensor:
    """Sparse swap deltas ``p (B, N)`` x ``pairs (B, K, 2)`` -> ``(B, K)``
    in O(max degree) each (K7 on the card); ``S``/``M`` as for
    :func:`qap_objective_sparse`.  Every order, no cap."""
    if _route(p):
        return qap_delta_sparse_cuda(S, M, p, pairs)
    return qap_delta_sparse_plain(S, M, p, pairs)


def fused_step_fits(n: int) -> bool:
    """Do the fused SA and GA steps take order ``n``?  (The reference's
    cap.)"""
    return ((max(n, LANE) + LANE - 1) // LANE) * LANE <= MAX_FUSED_N


def qap_sa_step(C, M, p, f, best_p, best_f, temp, keys, n_valid, *,
                max_neighbors: int, max_success: int, event_width=None,
                CT: Optional[torch.Tensor] = None,
                MT: Optional[torch.Tensor] = None):
    """One whole SA temperature step for ``B`` chains: ``(p, f, best_p,
    best_f)``; candidates and uniforms come from each chain's key words.
    Callers guard orders with :func:`fused_step_fits`.  ``event_width``
    shapes the plain version's event windows; K4, like the reference's
    Pallas kernel, scans the candidates one by one and ignores it (every
    width gives the same states)."""
    if _route(p):
        return qap_sa_step_cuda(C, M, p, f, best_p, best_f, temp, keys,
                                n_valid, max_neighbors=max_neighbors,
                                max_success=max_success, CT=CT, MT=MT)
    return qap_sa_step_plain(C, M, p, f, best_p, best_f, temp, keys, n_valid,
                             max_neighbors=max_neighbors,
                             max_success=max_success, event_width=event_width)


def qap_ga_step(C, M, pop, fit, keys, n_valid, *, n_off: int, tournament: int,
                p_crossover: float, p_mutation: float, crossover: str = "ox"):
    """One whole GA generation for ``B`` islands: ``(pop, fit)``; every
    operator draw comes from each island's key words.  Callers guard
    orders with :func:`fused_step_fits`."""
    kw = dict(n_off=n_off, tournament=tournament, p_crossover=p_crossover,
              p_mutation=p_mutation, crossover=crossover)
    if _route(pop):
        return qap_ga_step_cuda(C, M, pop, fit, keys, n_valid, **kw)
    return qap_ga_step_plain(C, M, pop, fit, keys, n_valid, **kw)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba selective scan: ``u``, ``dt (B, S, D)``, ``a (D, N)``,
    ``b``, ``c (B, S, N)`` -> ``(y (B, S, D), h_last (B, D, N))`` f32
    (K8 on the card; contiguous f32 inputs).  Differentiable
    (:class:`selective_scan.SelectiveScan`): K8 forward, the plain scan
    recomputed for the backward; on ``meta`` tensors, shapes alone)."""
    if u.device.type != "meta":
        _route(u)
    return SelectiveScan.apply(u, dt, a, b, c)
