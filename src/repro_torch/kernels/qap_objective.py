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
permutations, one warp each; above it (the L2 branch) a block takes a
group of permutations and a tile of rows of ``C``, each of its warps
stages the rows of ``C`` and ``M`` it reads, and a second small kernel
adds the tiles in order (:func:`l2_tiling`).  Sums run in another
order than the plain version's, so the two agree bit for bit on
integer-valued instances and to a relative 1e-6 elsewhere.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import qap
from . import build

# Orders the L2 branch takes: those whose permutation fits 48 KB (every
# order the branch has taken since it was written).
_SMEM_LIMIT = 48 * 1024
# The L2 branch's most warps a block (kL2MaxWarps of
# csrc/qap_objective.cu), most permutations a group (kL2MaxGroup), and
# rows of C a warp takes in a tile.
L2_MAX_WARPS = 4
L2_MAX_GROUP = 2
L2_ROWS_PER_WARP = 4


class L2Tiling(NamedTuple):
    """How K2's L2 branch cuts its work at one order and batch."""
    group: int       # G, permutations a block
    warps: int       # warps a block, each taking rows of the tile in turn
    sets: int        # row sets a warp (2: the next row lands meanwhile)
    tile_rows: int   # R, rows of C a block
    tiles: int       # ceil(N / R): the partial sums of a permutation
    blocks: int      # instances x ceil(perms an instance / G) x tiles


def l2_block_bytes(n: int, group: int, warps: int, sets: int) -> int:
    """Shared memory of an L2 block (``l2_block_bytes`` of
    ``csrc/qap_objective.cu``): G permutation rows, the reduction's G x
    warps floats (to 16 bytes) and each warp's ``sets`` sets of one row of
    C and G rows of M."""
    red = (group * warps + 3) & ~3
    return 4 * (build.row_slot_words(n) * (group + warps * sets * (1 + group))
                + red)


def l2_tiling(n: int, perms_per_inst: int, instances: int = 1) -> L2Tiling:
    """The L2 branch's tiling, decided here and nowhere else.  From the
    order alone: the group cap (:data:`L2_MAX_GROUP`, or 1 where not one
    warp fits at it: orders from 11,618), the warps and sets (two sets and
    :data:`L2_MAX_WARPS` warps where they fit, else one set and as many
    warps as fit, up to 4: small blocks, so that two or three share an
    SM at Table 1's orders, measured fastest there) and the tile,
    :data:`L2_ROWS_PER_WARP` rows a warp -- so a permutation's F depends
    on ``n`` alone, not on the batch or the card.  From the batch: G =
    min(cap, permutations an instance), which moves no bits."""
    for cap in (L2_MAX_GROUP, 1):
        words = build.SMEM_BLOCK_LIMIT // 4 - ((cap * L2_MAX_WARPS + 3) & ~3)
        rows = words // build.row_slot_words(n) - cap
        for sets, least in ((2, L2_MAX_WARPS), (1, 1)):
            warps = min(L2_MAX_WARPS, rows // (sets * (1 + cap)))
            if warps >= least:
                break
        if warps >= 1:
            break
    else:
        raise ValueError(f"order {n}: no tiling of K2's L2 branch fits "
                         f"{build.SMEM_BLOCK_LIMIT} B of shared memory")
    group = min(cap, max(perms_per_inst, 1))
    tile_rows = warps * L2_ROWS_PER_WARP
    tiles = -(-n // tile_rows)
    return L2Tiling(group, warps, sets, tile_rows, tiles,
                    instances * -(-perms_per_inst // group) * tiles)


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
    per_inst = (B * P) // b0
    partial, (group, warps, sets, tile_rows, tiles, _) = None, (0,) * 6
    if not smem:
        group, warps, sets, tile_rows, tiles, _ = l2_tiling(n, per_inst, b0)
        partial = torch.empty(B * P * tiles, dtype=torch.float32,
                              device=perms.device)
    err = build.library("qap_objective").qap_objective_launch(
        C.data_ptr(), M.data_ptr(), perms.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), B * P, n, per_inst,
        group, warps, sets, tile_rows, perms.device.index,
        torch.cuda.current_stream(perms.device).cuda_stream)
    build.check(err, "qap_objective")
    build.count_launch("qap_objective", "smem" if smem else "l2")
    return out
