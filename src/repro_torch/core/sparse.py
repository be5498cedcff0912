"""Padded ELL storage for sparse flow matrices.

The port of ``repro/core/sparse.py``.  Real program graphs are sparse, so
the multilevel route's refinement levels keep ``C`` as padded row blocks
and evaluate objectives in O(nnz) and swap deltas in O(max degree):

* **Padded row blocks.**  Row k keeps its nonzero column ids in
  ``cols[k, :]`` (ascending) and their values in ``vals[k, :]``, both
  padded to a shared width ``D`` = max row degree.  Padding entries carry
  value 0 and an in-range column id, so every consumer reads full
  ``(N, D)`` blocks without ragged logic.
* **Both orientations.**  ``cols_t``/``vals_t`` hold the same layout for
  ``C^T``, so a swap delta reads column ``a`` of an asymmetric ``C`` as a
  row.
* **Leading batch dims.**  Every leaf may carry them (the instance axis
  of a wave), as the dense ``(B0, N, N)`` matrices do; ``shape`` gives the
  dense ``(..., N, N)`` view that solvers read sizes from.

Conversion (:func:`from_dense`) is host-side numpy with the reference's
stable argsort, so padding column ids equal the reference's; the leaves
then move to the requested device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class SparseFlows(NamedTuple):
    """ELL-format flow matrix (see module docstring): ``cols``/``vals``/
    ``cols_t``/``vals_t`` are ``(..., N, D)``, ``deg``/``deg_t`` ``(...,
    N)``.  ``deg`` counts the stored pattern's nonzeros per row (masking
    zeroes values but keeps the pattern)."""
    cols: torch.Tensor     # (..., N, D) int32 column ids of C's rows
    vals: torch.Tensor     # (..., N, D) f32 values of C's rows
    cols_t: torch.Tensor   # (..., N, D) int32 column ids of C^T's rows
    vals_t: torch.Tensor   # (..., N, D) f32 values of C^T's rows
    deg: torch.Tensor      # (..., N) int32 nonzeros per row of C
    deg_t: torch.Tensor    # (..., N) int32 nonzeros per row of C^T

    @property
    def n(self) -> int:
        return self.cols.shape[-2]

    @property
    def max_degree(self) -> int:
        return self.cols.shape[-1]

    @property
    def shape(self) -> Tuple[int, ...]:
        """The dense-equivalent shape ``(..., N, N)``."""
        return tuple(self.cols.shape[:-1]) + (self.n,)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def dim(self) -> int:
        """Dimensions of the dense view (2 shared, 3 instance-batched)."""
        return self.cols.dim()

    def nnz(self) -> torch.Tensor:
        """Stored nonzeros (per leading batch entry, if any)."""
        return self.deg.sum(dim=-1)

    def to(self, device) -> "SparseFlows":
        return SparseFlows(*(leaf.to(device) for leaf in self))

    def unsqueeze0(self) -> "SparseFlows":
        """Every leaf with a leading batch dim of 1 (the dense ``C[None]``)."""
        return SparseFlows(*(leaf[None] for leaf in self))


def max_degree(C) -> int:
    """Padded width needed to store ``C``: max nonzeros over rows of C and
    of C^T (host-side; accepts leading batch dims)."""
    A = np.asarray(C)
    nz = A != 0
    d = max(int(nz.sum(axis=-1).max(initial=0)),
            int(nz.sum(axis=-2).max(initial=0)))
    return max(d, 1)


def _rows_to_ell(A: np.ndarray, width: int):
    """One orientation's padded blocks: nonzero columns first (ascending),
    values gathered in place, so padding values are exactly 0."""
    order = np.argsort(A == 0, axis=1, kind="stable")   # False < True
    cols = order[:, :width].astype(np.int32)
    vals = np.take_along_axis(A, cols, axis=1).astype(np.float32)
    deg = (A != 0).sum(axis=1).astype(np.int32)
    return cols, vals, deg


def _ell_leaves(A: np.ndarray, width: int):
    if A.ndim > 2:
        parts = [_ell_leaves(a, width) for a in A.reshape((-1,) + A.shape[-2:])]
        return tuple(np.stack(leaf).reshape(A.shape[:-2] + leaf[0].shape)
                     for leaf in zip(*parts))
    return (_rows_to_ell(A, width)
            + _rows_to_ell(np.ascontiguousarray(A.T), width))


def from_dense(C, width: Optional[int] = None, device="cpu") -> SparseFlows:
    """Convert a dense ``(..., N, N)`` flow matrix to :class:`SparseFlows`
    on ``device``.  ``width`` pins the padded block width; it must hold
    the densest row."""
    if isinstance(C, torch.Tensor):
        C = C.detach().cpu().numpy()
    A = np.asarray(C, dtype=np.float32)
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"flow matrix must be (..., N, N), got {A.shape}")
    d = max_degree(A)
    if width is None:
        width = d
    elif width < d:
        raise ValueError(f"width={width} < max row degree {d}")
    cols, vals, deg, cols_t, vals_t, deg_t = _ell_leaves(A, width)
    return SparseFlows(*(torch.as_tensor(x).to(device) for x in
                         (cols, vals, cols_t, vals_t, deg, deg_t)))


def to_dense(S: SparseFlows) -> torch.Tensor:
    """Exact inverse of :func:`from_dense` (padding adds zeros)."""
    n = S.n
    lead = S.cols.shape[:-2]
    cols = S.cols.reshape(-1, n * S.max_degree).long()
    rows = torch.arange(n, device=cols.device).repeat_interleave(S.max_degree)
    flat = torch.zeros(cols.shape[0], n * n, dtype=S.vals.dtype,
                       device=cols.device)
    flat.scatter_add_(1, rows * n + cols, S.vals.reshape(cols.shape))
    return flat.reshape(lead + (n, n))


def mask_flows_sparse(S: SparseFlows, n_valid) -> SparseFlows:
    """Sparse counterpart of ``qap.mask_flows``: zero every flow touching
    a padded slot (the stored pattern stays).  ``n_valid`` is a scalar for
    shared leaves, or one order per instance for batched leaves."""
    nv = torch.as_tensor(n_valid, device=S.device)
    w = (torch.arange(S.n, device=S.device) < nv[..., None]).to(S.vals.dtype)

    def at(cols):                                   # w[cols] per instance
        return torch.gather(w, -1, cols.reshape(w.shape[:-1] + (-1,)).long()
                            ).reshape(cols.shape)

    return S._replace(vals=S.vals * w[..., :, None] * at(S.cols),
                      vals_t=S.vals_t * w[..., :, None] * at(S.cols_t))


def prepare_flows(C, flows: str, width: Optional[int] = None, device="cpu"):
    """The solver configs' ``flows`` hook: ``"sparse"`` converts a dense
    matrix once (a no-op for :class:`SparseFlows`), ``"dense"`` passes
    through."""
    if flows not in ("dense", "sparse"):
        raise ValueError(f"flows must be 'dense' or 'sparse', got {flows!r}")
    if flows == "sparse" and not isinstance(C, SparseFlows):
        return from_dense(C, width, device)
    return C
