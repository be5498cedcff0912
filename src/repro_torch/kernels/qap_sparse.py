"""Sparse QAP objective and swap delta: the CUDA kernels K6 and K7 and
their plain versions.

Replace the TPU kernels of ``repro/kernels/qap_sparse.py``
(``qap_objective_sparse_pallas_batch`` and
``qap_delta_sparse_pallas_batch``).  The flows are a
``core.sparse.SparseFlows`` (padded ELL rows of ``C`` and of ``C^T``), so
an objective costs O(nnz) and a swap delta O(max degree):

* K6: ``perms (B, P, N)`` -> ``(B, P)`` f32,
  ``F = sum_{r,d} vals[r,d] * M[p[r], p[cols[r,d]]]``;
* K7: ``p (B, N)`` x ``pairs (B, K, 2)`` -> ``(B, K)`` f32, the dense
  delta's column/row/corner decomposition with each full-length sum over
  the sparse rows ``a``/``b`` of ``C^T`` (column terms) and of ``C`` (row
  terms), and the corner entries of ``C`` found by lookups in those rows.

The leaves and ``M`` are shared (``(N, D)``, ``(N, N)``) or
instance-batched (``(B0, N, D)``, ``(B0, N, N)``) with ``B0`` dividing
``B``: row ``b`` belongs to instance ``b // (B // B0)``.  Padding entries
carry value 0 and an in-range column id, so they need no mask beyond the
delta's ``k != a, b``.

The TPU wrapper padded ``N`` and ``D`` to 128 lanes and capped orders at
``MAX_SPARSE_KERNEL_N = 4096``, a VMEM limit; above it the reference's
objective fell back to its plain version.  The CUDA kernels
(``csrc/qap_objective_sparse.cu``, ``csrc/qap_delta_sparse.cu``) mask the
ragged edge instead, take every order, and never fall back.  On
integer-valued instances every f32 sum is exact, so kernel and plain
version agree bit for bit.

K6 scores each permutation with one thread-block cluster: G blocks, block
g the rows ``[g N / G, (g + 1) N / G)``, whose sums rank 0 adds in rank
order over distributed shared memory, so a result has the same bits on
every call.  The host picks G from ``N``, the batch and the card's SMs
(:func:`objective_sparse_launch`).
"""
from __future__ import annotations

import functools

import torch

from . import build

# The most blocks a K6 cluster takes: 16, the largest an H100 schedules
# (above the portable 8 the launcher allows the non-portable size).  On
# the 4096 torus's levels at 1 x 1 and 1 x 4, 16 blocks a permutation were
# the fastest of 4, 8 and 16 (PERF.md).
K6_MAX_CLUSTER = 16


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def objective_sparse_launch(n: int, perms: int, sms: int):
    """K6's ``(grid, cluster)`` for ``perms`` permutations of order ``n``
    on a card of ``sms`` SMs: a cluster of G blocks a permutation, as
    many as spread the batch over the SMs, ``sms // perms``, at least 1
    and at most ``K6_MAX_CLUSTER`` and ``n`` (every block has a row).  A
    batch of up to 8 permutations gets 16 blocks each on an H100 (132
    SMs); a wide one gets one block each, which keeps every SM busy
    without blocks that have next to no entries.  The order of the sum
    follows G, so a permutation's F has the same bits in any batch with
    the same G (the route's 1 x 1 and 1 x 4 on an H100)."""
    cluster = max(1, min(K6_MAX_CLUSTER, n, sms // max(perms, 1)))
    return perms * cluster, cluster


def _leaves(S, b0: int, n: int):
    """The ELL leaves as ``(B0, N, D)`` tensors (shared leaves: B0 = 1)."""
    shape = (b0, n, S.max_degree)
    return (S.cols.long().reshape(shape), S.vals.float().reshape(shape),
            S.cols_t.long().reshape(shape), S.vals_t.float().reshape(shape))


def _instances(S, M: torch.Tensor, B: int) -> int:
    b0 = M.shape[0] if M.dim() == 3 else 1
    if B % b0 != 0:
        raise ValueError(f"batched S/M leading dim {b0} must divide B={B}")
    if S.cols.dim() != M.dim():
        raise ValueError("S leaves and M must be both shared or both batched")
    return b0


def qap_objective_sparse_plain(S, M: torch.Tensor, perms: torch.Tensor
                               ) -> torch.Tensor:
    """Plain PyTorch version of K6 (counterpart of
    ``repro.kernels.ref.qap_objective_sparse_ref``): ``perms (B, P, N)`` ->
    ``(B, P)`` f32."""
    B, P, n = perms.shape
    b0 = _instances(S, M, B)
    cols, vals, _, _ = _leaves(S, b0, n)
    d = cols.shape[-1]
    pl = perms.long().reshape(b0, -1, n)                       # (B0, Q, N)
    q = pl.shape[1]
    pc = torch.gather(pl, 2, cols.reshape(b0, 1, n * d).expand(b0, q, n * d))
    lin = pl[..., None] * n + pc.reshape(b0, q, n, d)          # M[p[r], p[c]]
    mv = torch.gather(M.float().reshape(b0, n * n), 1,
                      lin.reshape(b0, -1)).reshape(b0, q, n, d)
    return (vals[:, None] * mv).sum(dim=(-2, -1)).reshape(B, P)


def qap_delta_sparse_plain(S, M: torch.Tensor, p: torch.Tensor,
                           pairs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7 (counterpart of
    ``repro.kernels.ref.qap_delta_sparse_ref``): ``p (B, N)`` x ``pairs
    (B, K, 2)`` -> ``(B, K)`` f32."""
    B, n = p.shape
    b0 = _instances(S, M, B)
    cols, vals, cols_t, vals_t = _leaves(S, b0, n)
    Mf = M.float().reshape(b0, n, n)
    inst = torch.arange(B, device=p.device) // (B // b0)
    pl = p.long()
    a, b = pairs[..., 0].long(), pairs[..., 1].long()          # (B, K)
    u, v = torch.gather(pl, 1, a), torch.gather(pl, 1, b)
    ik = inst[:, None]
    ikd = inst[:, None, None]

    def by_p(idx):                                             # p[idx]
        return torch.gather(pl, 1, idx.reshape(B, -1)).reshape(idx.shape)

    def masked(ks):
        return (ks != a[..., None]) & (ks != b[..., None])

    def col_part(i):                       # column i of C = row i of C^T
        ks, ws = cols_t[ik, i], vals_t[ik, i]                  # (B, K, D)
        pk = by_p(ks)
        g = Mf[ikd, pk, v[..., None]] - Mf[ikd, pk, u[..., None]]
        return torch.where(masked(ks), ws * g, 0.0).sum(-1)

    def row_part(i):                       # row i of C
        ls, ws = cols[ik, i], vals[ik, i]
        pc = by_p(ls)
        g = Mf[ikd, v[..., None], pc] - Mf[ikd, u[..., None], pc]
        return torch.where(masked(ls), ws * g, 0.0).sum(-1)

    def centry(i, j):                      # C[i, j] via the sparse row i
        return torch.where(cols[ik, i] == j[..., None], vals[ik, i],
                           0.0).sum(-1)

    def m(i, j):
        return Mf[ik, i, j]

    col = col_part(a) - col_part(b)
    row = row_part(a) - row_part(b)
    corner = ((centry(a, a) - centry(b, b)) * (m(v, v) - m(u, u))
              + centry(a, b) * (m(v, u) - m(u, v))
              + centry(b, a) * (m(u, v) - m(v, u)))
    return col + row + corner


def _check_flows(S, M: torch.Tensor, B: int, n: int, leaves: int,
                 *specs) -> int:
    """Validate ``M``, the first ``leaves`` ELL leaves of ``S`` (``cols``,
    ``vals``, ``cols_t``, ``vals_t``) and a kernel's other ``(name,
    tensor, dtype, shape)`` specs in one pass; returns B0."""
    b0 = build.check_mats(B, n, M=M)
    ell = M.shape[:-1] + (S.max_degree,)
    i32, f32 = torch.int32, torch.float32
    flows = (("cols", S.cols, i32, ell), ("vals", S.vals, f32, ell),
             ("cols_t", S.cols_t, i32, ell), ("vals_t", S.vals_t, f32, ell))
    build.check_args(M.device, *flows[:leaves], *specs)
    return b0


def qap_objective_sparse_cuda(S, M: torch.Tensor, perms: torch.Tensor
                              ) -> torch.Tensor:
    """Launch K6 on the card: same contract as
    :func:`qap_objective_sparse_plain`, ``perms`` a contiguous int32 CUDA
    tensor."""
    if perms.dim() != 3:
        raise ValueError(f"perms must be (B, P, N), got {tuple(perms.shape)}")
    B, P, n = perms.shape
    d = S.max_degree
    b0 = _check_flows(S, M, B, n, 2, ("perms", perms, torch.int32, (B, P, n)))
    if n * d >= 2 ** 31:
        raise ValueError(f"N * D = {n * d} ELL entries: K6 indexes them "
                         f"with 32-bit ints")
    out = torch.empty((B, P), dtype=torch.float32, device=perms.device)
    if B * P == 0:
        return out
    grid, cluster = objective_sparse_launch(n, B * P,
                                            _sm_count(perms.device.index))
    err = build.library("qap_objective_sparse").qap_objective_sparse_launch(
        S.cols.data_ptr(), S.vals.data_ptr(), M.data_ptr(), perms.data_ptr(),
        out.data_ptr(), grid, cluster, n, d, (B * P) // b0,
        perms.device.index, torch.cuda.current_stream(perms.device).cuda_stream)
    build.check(err, "qap_objective_sparse")
    build.LAUNCHES["qap_objective_sparse"] += 1
    return out


def qap_delta_sparse_cuda(S, M: torch.Tensor, p: torch.Tensor,
                          pairs: torch.Tensor) -> torch.Tensor:
    """Launch K7 on the card: same contract as
    :func:`qap_delta_sparse_plain`, ``p``/``pairs`` int32 CUDA tensors
    (``pairs`` on an 8-byte boundary: the kernel reads a pair as one
    int2)."""
    if p.dim() != 2 or pairs.dim() != 3:
        raise ValueError(f"p must be (B, N) and pairs (B, K, 2), got "
                         f"{tuple(p.shape)} and {tuple(pairs.shape)}")
    B, n = p.shape
    k = pairs.shape[1]
    b0 = _check_flows(S, M, B, n, 4, ("p", p, torch.int32, (B, n)),
                      ("pairs", pairs, torch.int32, (B, k, 2)))
    if pairs.data_ptr() % 8:
        raise ValueError("pairs must start on an 8-byte boundary (the kernel "
                         "reads each pair as one int2)")
    out = torch.empty((B, k), dtype=torch.float32, device=p.device)
    if B * k == 0:
        return out
    err = build.library("qap_delta_sparse").qap_delta_sparse_launch(
        S.cols.data_ptr(), S.vals.data_ptr(), S.cols_t.data_ptr(),
        S.vals_t.data_ptr(), M.data_ptr(), p.data_ptr(), pairs.data_ptr(),
        out.data_ptr(), B, k, n, S.max_degree, B // b0, p.device.index,
        torch.cuda.current_stream(p.device).cuda_stream)
    build.check(err, "qap_delta_sparse")
    build.LAUNCHES["qap_delta_sparse"] += 1
    return out
