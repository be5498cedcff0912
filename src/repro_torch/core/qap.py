"""Quadratic-assignment core for the job-mapping problem.

    F(p) = sum_{k,l} C[k, l] * M[p[k], p[l]]

``C`` is the program-graph (flow) matrix, ``M`` the system-graph
(distance) matrix and ``p[k]`` the node of process ``k``.  Permutations
are int32 tensors with leading batch dims written out; ``C``/``M`` are
either shared ``(N, N)`` or instance-batched ``(B0, N, N)``, in which case
the leading dim of ``p`` is the instance axis.  The wide candidate
evaluation of the solvers goes through ``repro_torch.kernels.ops``
(the CUDA kernel on the card, the plain version here on the CPU).
``objective``, ``mask_flows`` and ``swap_delta`` also take a
``core.sparse.SparseFlows`` ``C`` and run its O(nnz) path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.qap_delta import qap_delta_plain
from ..kernels.qap_sparse import qap_delta_sparse_plain
from .sparse import SparseFlows, mask_flows_sparse


def _gather_m(M: torch.Tensor, rows: torch.Tensor,
              cols: torch.Tensor) -> torch.Tensor:
    """``M[rows, cols]`` for shared M, or per instance (leading dim of
    ``rows``/``cols``) for a batched ``(B0, N, N)`` M."""
    if M.dim() == 2:
        return M[rows, cols]
    inst = torch.arange(M.shape[0], device=M.device)
    inst = inst.view((-1,) + (1,) * (rows.dim() - 1))
    return M[inst, rows, cols]


def objective(C, M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """F(p) for ``p`` of shape ``(..., N)`` -> ``(...)`` f32.  A
    ``SparseFlows`` ``C`` goes through ``kernels.ops.qap_objective_sparse``
    (kernel K6 on the card); batched leaves take ``p``'s leading dim as
    the instance axis."""
    if isinstance(C, SparseFlows):
        from ..kernels import ops
        b0 = C.shape[0] if C.dim() == 3 else 1
        perms = p.to(torch.int32).reshape(b0, -1, p.shape[-1]).contiguous()
        return ops.qap_objective_sparse(C, M, perms).reshape(p.shape[:-1])
    pl = p.long()
    Mp = _gather_m(M, pl[..., :, None], pl[..., None, :])    # (..., N, N)
    Cb = C if C.dim() == 2 else C.view(
        (C.shape[0],) + (1,) * (p.dim() - 2) + C.shape[1:])
    return (Cb * Mp).sum(dim=(-2, -1))


def masked_weights(valid: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Pair weights ``W[..., k, l] = valid[..., k] * valid[..., l]``."""
    w = valid.to(dtype)
    return w[..., :, None] * w[..., None, :]


def valid_mask(n: int, n_valid) -> torch.Tensor:
    """Boolean ``(..., n)`` mask of the first ``n_valid`` slots."""
    nv = torch.as_tensor(n_valid)
    return torch.arange(n, device=nv.device) < nv[..., None]


def mask_flows(C, n_valid):
    """Zero every flow touching a padded slot, so the plain objective and
    delta of the padded instance equal the unpadded ones.  ``n_valid`` is
    a scalar for ``(N, N)`` C, or ``(B0,)`` for batched C; sparse flows
    keep their pattern and lose the values."""
    if isinstance(C, SparseFlows):
        return mask_flows_sparse(C, n_valid)
    nv = torch.as_tensor(n_valid, device=C.device)
    return C * masked_weights(valid_mask(C.shape[-1], nv), C.dtype)


def masked_random_permutation(key: torch.Tensor, n: int, n_valid
                              ) -> torch.Tensor:
    """``(..., 2)`` keys -> ``(..., n)`` int32 permutations, uniformly
    random on the first ``n_valid`` slots and identity on the padded tail
    (uniform sort keys, stable argsort)."""
    from .keys import uniform
    idx = torch.arange(n, device=key.device)
    nv = torch.as_tensor(n_valid, device=key.device)
    x = uniform(key, (n,))
    sort_keys = torch.where(idx < nv[..., None], x,
                            1.0 + idx.to(torch.float32))
    return torch.argsort(sort_keys, dim=-1, stable=True).to(torch.int32)


def random_permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    from .keys import permutation
    return permutation(key, n)


def masked_random_permutations(key: torch.Tensor, batch: int, n: int,
                               n_valid) -> torch.Tensor:
    """``(..., 2)`` keys -> ``(..., batch, n)``: each key split ``batch``
    ways, one :func:`masked_random_permutation` per subkey (``n_valid``
    broadcast against ``(...)``)."""
    from .keys import split
    nv = torch.as_tensor(n_valid, device=key.device)
    return masked_random_permutation(split(key, batch), n, nv[..., None])


def random_permutations(key: torch.Tensor, batch: int, n: int
                        ) -> torch.Tensor:
    """``(..., 2)`` keys -> ``(..., batch, n)`` uniform permutations."""
    from .keys import split
    return random_permutation(split(key, batch), n)


def swap_positions(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """``p`` with entries at positions ``a`` and ``b`` exchanged, per row:
    ``p (..., N)``, ``a``/``b`` of shape ``(...)``."""
    a = torch.as_tensor(a, device=p.device).long()[..., None]
    b = torch.as_tensor(b, device=p.device).long()[..., None]
    a, b = torch.broadcast_tensors(a, b)
    pa, pb = torch.gather(p, -1, a), torch.gather(p, -1, b)
    return p.scatter(-1, a, pb).scatter(-1, b, pa)


def swap_delta(C, M: torch.Tensor, p: torch.Tensor, a, b) -> torch.Tensor:
    """O(N) increment of F after swapping positions ``a`` and ``b`` of
    ``p`` (``(..., N)``, shared C/M; ``a``/``b`` of shape ``(...)``);
    O(max degree) for a ``SparseFlows`` ``C``."""
    n = p.shape[-1]
    a = torch.as_tensor(a, device=p.device)
    b = torch.as_tensor(b, device=p.device)
    lead = torch.broadcast_shapes(p.shape[:-1], a.shape, b.shape)
    pairs = torch.stack(torch.broadcast_tensors(a, b), dim=-1).expand(
        lead + (2,)).reshape(-1, 1, 2)
    ps = p.expand(lead + (n,)).reshape(-1, n)
    plain = qap_delta_sparse_plain if isinstance(C, SparseFlows) \
        else qap_delta_plain
    return plain(C, M, ps, pairs).reshape(lead)


def first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last dim (``jnp.argmin``'s
    tie rule, on every device)."""
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == x.amin(-1, keepdim=True), idx,
                       x.shape[-1]).amin(-1)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last dim (``jnp.argmax``'s and
    ``lax.top_k(x, 1)``'s tie rule)."""
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == x.amax(-1, keepdim=True), idx,
                       x.shape[-1]).amin(-1)


def is_permutation(p: torch.Tensor) -> torch.Tensor:
    """True iff each row of ``p`` is a permutation of 0..N-1."""
    n = p.shape[-1]
    ref = torch.arange(n, device=p.device)
    return (torch.sort(p, dim=-1).values == ref).all(dim=-1)


def compose(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``(p o q)[..., k] = p[..., q[..., k]]``."""
    return torch.gather(p, -1, q.long())


def invert(p: torch.Tensor) -> torch.Tensor:
    n = p.shape[-1]
    ar = torch.arange(n, dtype=p.dtype, device=p.device).expand_as(p)
    return torch.empty_like(p).scatter_(-1, p.long(), ar)


def num_pairs(m):
    """C(m, 2) = m*(m-1)//2, halving the even factor first."""
    m = torch.as_tensor(m)
    return torch.where(m % 2 == 0, (m // 2) * (m - 1), m * ((m - 1) // 2))


def pair_from_index(idx, n) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat index in [0, C(n, 2)) -> unordered pair (a < b).

    A float32 sqrt seeds the row estimate, then exact integer comparisons
    correct it (the reference's decode, ``repro/core/qap.py``).
    """
    idx = torch.as_tensor(idx).long()
    n = torch.as_tensor(n, device=idx.device).long()
    s = num_pairs(n) - idx
    m = torch.sqrt(2.0 * s.to(torch.float32)).long()
    m = torch.minimum(m.clamp_min(2), n)
    for _ in range(2):
        m = torch.where(num_pairs(m - 1) >= s, m - 1, m)
    for _ in range(2):
        m = torch.where((m < n) & (num_pairs(m) < s), m + 1, m)
    a = n - m
    b = a + 1 + (num_pairs(m) - s)
    return a.to(torch.int32), b.to(torch.int32)


def random_swap_pairs(key: torch.Tensor, k: int, n: int,
                      n_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """``(..., 2)`` keys -> ``(..., k, 2)`` random distinct position pairs.

    With ``n_valid`` (broadcast against the keys' leading dims) pairs are
    drawn among the first ``n_valid`` positions; orders 0/1 get the no-op
    pair (0, 0).
    """
    from .keys import randint
    if n_valid is None:
        idx = randint(key, (k,), 0, (n * (n - 1)) // 2)
        a, b = pair_from_index(idx, n)
    else:
        nv = torch.as_tensor(n_valid, device=key.device).long()[..., None]
        nv2 = nv.clamp_min(2)
        idx = randint(key, (k,), 0, num_pairs(nv2))
        a, b = pair_from_index(idx, nv2)
        a = torch.where(nv >= 2, a, 0)
        b = torch.where(nv >= 2, b, 0)
    return torch.stack([a, b], dim=-1).to(torch.int32)
