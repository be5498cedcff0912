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
memory; above it the kernel reads ``C``, ``M`` and the transposes
``C^T``/``M^T`` from global memory, so that every read of a column is a
read of a contiguous row; callers that evaluate many rounds against one
instance compute them once and pass them in.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build


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
    :func:`build.dense_smem_max_n` (the L2 branch), where they default to
    fresh transposes."""
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
    smem = n <= build.dense_smem_max_n()
    ct = mt = None
    if not smem:
        CT = C.transpose(-2, -1).contiguous() if CT is None else CT
        MT = M.transpose(-2, -1).contiguous() if MT is None else MT
        build.check_mats(B, n, C=C, CT=CT, MT=MT)
        ct, mt = CT.data_ptr(), MT.data_ptr()
    err = build.library("qap_delta").qap_delta_launch(
        C.data_ptr(), ct, M.data_ptr(), mt, p.data_ptr(), pairs.data_ptr(),
        out.data_ptr(), B, k, n, B // b0, p.device.index,
        torch.cuda.current_stream(p.device).cuda_stream)
    build.check(err, "qap_delta")
    build.count_launch("qap_delta", "smem" if smem else "l2")
    return out
