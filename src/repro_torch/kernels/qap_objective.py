"""Batched QAP objective: the CUDA kernel K2 and its plain version.

Replaces the TPU kernel ``repro/kernels/qap_objective.py``
(``qap_objective_pallas_batch``).  ``perms (B, P, N)`` -> ``(B, P)`` f32,

    F(p) = sum_{k,l} C[k, l] * M[p[k], p[l]].

``C``/``M`` are shared ``(N, N)`` or instance-batched ``(B0, N, N)`` with
``B0`` dividing ``B``: perms row ``b`` belongs to instance
``b // (B // B0)`` (the islands of one instance contiguous).  The GA
scores every island's offspring of a wave with one call per generation.

The kernel (``csrc/qap_objective.cu``) gathers ``M[p[k], p[l]]``
directly; the TPU kernel's cap (``MAX_KERNEL_N``) was a VMEM limit of its
one-hot matmul form.  It has two branches, chosen by the order: up to
:func:`build.dense_smem_max_n` (every dense bucket) a block stages one
instance's ``C`` and ``M`` in shared memory and scores a slice of its
permutations, one warp each; above it one block per permutation reads
``C`` and ``M`` from global memory (L2).  Sums run in another order than
the plain version's, so the two agree bit for bit on integer-valued
instances and to a relative 1e-6 elsewhere.
"""
from __future__ import annotations

import torch

from ..core import qap
from . import build

# The L2 branch keeps one permutation in shared memory, under the default
# 48 KB of dynamic shared memory a block may use.
_SMEM_LIMIT = 48 * 1024


def qap_objective_plain(C: torch.Tensor, M: torch.Tensor,
                        perms: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2 (counterpart of
    ``repro.kernels.ref.qap_objective_ref``): ``perms (B, P, N)`` ->
    ``(B, P)`` f32."""
    B, P, n = perms.shape
    if C.dim() == 2:
        return qap.objective(C.float(), M.float(), perms)
    b0 = C.shape[0]
    if B % b0 != 0:
        raise ValueError(f"batched C/M leading dim {b0} must divide B={B}")
    return qap.objective(C.float(), M.float(),
                         perms.reshape(b0, (B // b0) * P, n)).reshape(B, P)


def qap_objective_cuda(C: torch.Tensor, M: torch.Tensor,
                       perms: torch.Tensor) -> torch.Tensor:
    """Launch K2 on the card: same contract as :func:`qap_objective_plain`,
    ``perms`` a contiguous int32 CUDA tensor."""
    if perms.dim() != 3:
        raise ValueError(f"perms must be (B, P, N), got {tuple(perms.shape)}")
    B, P, n = perms.shape
    b0 = build.check_mats(B, n, C=C, M=M)
    build.check_args(C.device, ("perms", perms, torch.int32, (B, P, n)))
    if 4 * n > _SMEM_LIMIT:
        raise ValueError(f"order {n} needs {4 * n} B of shared memory "
                         f"(limit {_SMEM_LIMIT})")
    out = torch.empty((B, P), dtype=torch.float32, device=perms.device)
    if B * P == 0:
        return out
    smem = n <= build.dense_smem_max_n()
    err = build.library("qap_objective").qap_objective_launch(
        C.data_ptr(), M.data_ptr(), perms.data_ptr(), out.data_ptr(), B * P,
        n, (B * P) // b0, perms.device.index,
        torch.cuda.current_stream(perms.device).cuda_stream)
    build.check(err, "qap_objective")
    build.LAUNCHES["qap_objective"] += 1
    build.BRANCH_LAUNCHES["qap_objective/smem" if smem
                          else "qap_objective/l2"] += 1
    return out
