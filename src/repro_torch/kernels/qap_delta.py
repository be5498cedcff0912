"""Batched O(N) swap deltas: the CUDA kernel K1 and its plain version.

Replaces the TPU kernel ``repro/kernels/qap_delta.py``
(``qap_delta_pallas_batch``).  ``B`` permutations times ``K`` candidate
swaps each -> ``(B, K)`` f32 deltas, by the column/row/corner
decomposition

    d = sum_{k != a,b} (C[k,a]-C[k,b]) * (M[p[k],v]-M[p[k],u])
      + sum_{l != a,b} (C[a,l]-C[b,l]) * (M[v,p[l]]-M[u,p[l]])
      + corner terms,            u = p[a], v = p[b].

``C``/``M`` are shared ``(N, N)`` or instance-batched ``(B0, N, N)``
with ``B0`` dividing ``B``: row ``r`` belongs to instance
``r // (B // B0)``.  The kernel (``csrc/qap_delta.cu``) has two branches,
chosen by the order: up to :func:`build.dense_smem_max_n` (every dense
bucket) each block stages one instance's ``C`` and ``M`` in shared
memory; above it (the L2 branch) each block stages one permutation row
and each warp the four rows of ``M`` and ``M^T`` its candidate gathers
from, and reads its rows of ``C`` and ``C^T`` in place, so every read of
a column is a read of a contiguous row; callers that evaluate many
rounds against one instance compute the transposes once and pass them
in.  :func:`l2_plan` sizes that staging.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

# The L2 branch's most warps a block (kL2MaxWarps in csrc/qap_delta.cu)
# and rows a candidate stages (kStagedM: the four rows of M it gathers
# from; its rows of C are read in place).
L2_MAX_WARPS = 16
L2_STAGED_ROWS = 4


def l2_block_bytes(n: int, warps: int, sets: int) -> int:
    """Shared memory of a staged L2 block (``l2_block_bytes`` of
    ``csrc/qap_delta.cu``): the permutation row's slot and ``sets`` sets
    of four row slots for each warp."""
    return 4 * build.row_slot_words(n) * (1 + warps * sets * L2_STAGED_ROWS)


def l2_plan(n: int) -> Tuple[int, int]:
    """``(warps a block, row sets a warp)`` of K1's L2 branch at order
    ``n``, the one place they are decided: 16 warps with two sets (the
    next candidate's rows land while one is summed) where they fit
    :data:`build.SMEM_BLOCK_LIMIT` with the permutation row (orders up to
    445), else one set and as many warps as fit, up to 16 (measured
    faster than two sets and half the warps at tai729); ``(8, 0)`` -- rows
    read in place, counted as the ``"l2_unstaged"`` branch -- where not
    even one warp's one set fits."""
    slots = build.SMEM_BLOCK_LIMIT // (4 * build.row_slot_words(n)) - 1
    if slots >= 2 * L2_STAGED_ROWS * L2_MAX_WARPS:
        return L2_MAX_WARPS, 2
    warps = min(L2_MAX_WARPS, slots // L2_STAGED_ROWS)
    return (warps, 1) if warps >= 1 else (8, 0)


def _rows(X: torch.Tensor, inst: torch.Tensor, r: torch.Tensor
          ) -> torch.Tensor:
    """``X[inst, r, :]`` (shared X ignores ``inst``): ``(B, K)`` -> (B, K, N)."""
    return X[r] if X.dim() == 2 else X[inst[:, None], r]


def qap_delta_plain(C: torch.Tensor, M: torch.Tensor, p: torch.Tensor,
                    pairs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: ``p (B, N)`` x ``pairs (B, K, 2)`` ->
    ``(B, K)`` f32 (counterpart of ``repro.kernels.ref.qap_delta_ref``)."""
    B, n = p.shape
    Cf, Mf = C.to(torch.float32), M.to(torch.float32)
    rpt = B // C.shape[0] if C.dim() == 3 else 1
    inst = torch.arange(B, device=p.device) // rpt
    pl = p.long()
    a, b = pairs[..., 0].long(), pairs[..., 1].long()            # (B, K)
    u = torch.gather(pl, 1, a)
    v = torch.gather(pl, 1, b)
    CT = Cf.transpose(-2, -1)
    MT = Mf.transpose(-2, -1)
    pk = pl[:, None, :].expand(-1, a.shape[1], -1)               # (B, K, N)

    def by_p(rows):                                # rows[..., p[k]]
        return torch.gather(rows, 2, pk)

    idx = torch.arange(n, device=p.device)
    mask = (idx != a[..., None]) & (idx != b[..., None])
    col = torch.where(mask, (_rows(CT, inst, a) - _rows(CT, inst, b))
                      * (by_p(_rows(MT, inst, v)) - by_p(_rows(MT, inst, u))),
                      0.0).sum(-1)
    row = torch.where(mask, (_rows(Cf, inst, a) - _rows(Cf, inst, b))
                      * (by_p(_rows(Mf, inst, v)) - by_p(_rows(Mf, inst, u))),
                      0.0).sum(-1)

    def at(X, i, j):
        return X[i, j] if X.dim() == 2 else X[inst[:, None], i, j]

    corner = ((at(Cf, a, a) - at(Cf, b, b)) * (at(Mf, v, v) - at(Mf, u, u))
              + at(Cf, a, b) * (at(Mf, v, u) - at(Mf, u, v))
              + at(Cf, b, a) * (at(Mf, u, v) - at(Mf, v, u)))
    return col + row + corner


def qap_delta_cuda(C: torch.Tensor, M: torch.Tensor, p: torch.Tensor,
                   pairs: torch.Tensor, CT: Optional[torch.Tensor] = None,
                   MT: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 on the card: same contract as :func:`qap_delta_plain`,
    ``p``/``pairs`` int32 CUDA tensors.  ``CT``/``MT`` are read only above
    :func:`build.dense_smem_max_n` (the L2 branch, :func:`l2_plan`), where
    they default to fresh transposes."""
    B, n = p.shape
    if pairs.dim() != 3:
        raise ValueError(f"pairs must be (B, K, 2), got {tuple(pairs.shape)}")
    k = pairs.shape[1]
    b0 = build.check_mats(B, n, C=C, M=M)
    build.check_args(C.device, ("p", p, torch.int32, (B, n)),
                     ("pairs", pairs, torch.int32, (B, k, 2)))
    if pairs.data_ptr() % 8:
        raise ValueError("pairs must start on an 8-byte boundary (the kernel "
                         "reads each pair as one int2)")
    out = torch.empty((B, k), dtype=torch.float32, device=p.device)
    if B * k == 0:
        return out
    branch, ct, mt, (warps, sets) = "smem", None, None, (0, 0)
    if n > build.dense_smem_max_n():
        CT = C.transpose(-2, -1).contiguous() if CT is None else CT
        MT = M.transpose(-2, -1).contiguous() if MT is None else MT
        build.check_mats(B, n, C=C, CT=CT, MT=MT)
        ct, mt = CT.data_ptr(), MT.data_ptr()
        warps, sets = l2_plan(n)
        branch = "l2" if sets else "l2_unstaged"
    err = build.library("qap_delta").qap_delta_launch(
        C.data_ptr(), ct, M.data_ptr(), mt, p.data_ptr(), pairs.data_ptr(),
        out.data_ptr(), B, k, n, B // b0, warps, sets, p.device.index,
        torch.cuda.current_stream(p.device).cuda_stream)
    build.check(err, "qap_delta")
    build.count_launch("qap_delta", branch)
    return out
