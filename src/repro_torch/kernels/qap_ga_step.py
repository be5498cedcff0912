"""One whole GA generation per island: the CUDA kernel K5 and its plain
version.

Replaces the TPU kernel ``repro/kernels/qap_ga_step.py``
(``qap_ga_step_pallas_batch``).  For ``B`` islands: draw every operator's
randomness from the Threefry counter stream of the island's key words
(``prng.ga_draws``), breed ``n_off`` children (tournaments, OX/OXS
crossover, gated swap mutation), score them, and put them in place of the
worst members with the elitism guard.  Ring migration crosses islands and
stays with the caller.

The plain version is, operation for operation, ``genetic._offspring_counter``
followed by the objective and ``genetic._replace_worst``
(``core/ga_ops.py``), so the fused and unfused counter-regime generations
agree.  The kernel (``csrc/qap_ga_step.cu``) has two branches, chosen by
the shapes (:func:`smem_branch`): where the island's ``C``, ``M`` and
population fit a block's shared memory (the engine's GA at every dense
bucket) a block stages them once and breeds the children at once, one warp
each; elsewhere (:func:`l2_plan`) four kernels rank the members, breed
every child of every island at once, one warp each, score the children
with K2's L2 tile kernel and finish with the elitism guard, so a child's F
is K2's on any input.  Its integer work is exact, and the children's F
agree with the plain version bit for bit on integer-valued instances.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core import ga_ops
from . import build, prng, qap_objective
from .qap_objective import qap_objective_plain


def qap_ga_step_plain(C, M, pop, fit, keys, n_valid, *, n_off: int,
                      tournament: int, p_crossover: float, p_mutation: float,
                      crossover: str = "ox"):
    """Plain PyTorch version of K5 (counterpart of
    ``repro.kernels.ref.qap_ga_step_ref``): ``pop (B, P, N)`` int32,
    ``fit (B, P)`` f32, ``keys (B, 2)`` uint32 words, ``n_valid (B,)``;
    C/M shared or ``(B0, N, N)``.  Returns ``(pop, fit)``."""
    d = prng.ga_step_draws(keys, n_off, tournament, ga_ops.MAX_MUT,
                           pop.shape[1], n_valid)
    children = ga_ops.offspring(pop, fit, d, torch.as_tensor(n_valid),
                                p_crossover, p_mutation, crossover)
    return ga_ops.replace_worst(pop, fit, children,
                                qap_objective_plain(C, M, children))


@functools.lru_cache(maxsize=None)
def _smem_warps(P: int, n: int, n_off: int, tournament: int) -> int:
    """The warps K5's shared-memory branch breeds with at these shapes; 0
    where the L2 branch takes them."""
    return build.library("qap_ga_step").qap_ga_step_smem_warps(
        P, n, n_off, tournament)


def smem_branch(P: int, n: int, n_off: int, tournament: int) -> bool:
    """Does K5 take ``P`` members of order ``n``, ``n_off`` children and
    ``tournament`` on its shared-memory branch?  (``C``, ``M``, the
    population and one warp's scratch must fit a block's 227 KB.)"""
    return _smem_warps(P, n, n_off, tournament) > 0


# The L2 branch's most children a breed block, one warp each
# (kBreedMaxWarps of csrc/qap_ga_step.cu).
L2_BREED_WARPS = 4


class L2Plan(NamedTuple):
    """How K5's L2 branch cuts one call's work."""
    breed_warps: int                  # children a breed block, one a warp
    tiling: qap_objective.L2Tiling    # K2's L2 tiling of the children
    work_words: int                   # slots, children and tile sums


def l2_breed_bytes(n: int, tournament: int, warps: int) -> int:
    """Shared memory of a breed block (``breed_warp_words`` of
    ``csrc/qap_ga_step.cu``): per warp its two parents (row slots), the
    child, its rank array, the OX segment's bitmask (``ceil(n / 32)``
    words) and its tournament draws, rounded to 16 bytes."""
    words = (2 * build.row_slot_words(n) + 2 * n + -(-n // 32)
             + 2 * tournament)
    return 4 * warps * ((words + 3) & ~3)


def l2_plan(P: int, n: int, n_off: int, tournament: int, islands: int,
            instances: int = 1) -> L2Plan:
    """K5's L2 branch at these shapes, decided here and nowhere else, from
    the shapes alone (no property of the card): breed blocks of
    ``min(L2_BREED_WARPS, n_off)`` warps (fewer where they pass
    :data:`build.SMEM_BLOCK_LIMIT`), the children scored with K2's L2
    tiling (:func:`qap_objective.l2_tiling`, ``islands // instances *
    n_off`` children an instance: their F is K2's, bit for bit), and the
    workspace's words.  Raises ``ValueError`` where no block fits."""
    one = l2_breed_bytes(n, tournament, 1)
    fit = 4 * (P + 3)  # an island's new fitness and the guard's words
    if one > build.SMEM_BLOCK_LIMIT or fit > build.SMEM_BLOCK_LIMIT:
        raise ValueError(f"pop {P} x order {n}: K5's L2 branch needs more "
                         f"than {build.SMEM_BLOCK_LIMIT} B of shared memory")
    warps = min(L2_BREED_WARPS, n_off, build.SMEM_BLOCK_LIMIT // one)
    tiling = qap_objective.l2_tiling(n, islands // instances * n_off,
                                     instances)
    return L2Plan(warps, tiling, islands * n_off * (1 + n + tiling.tiles))


def qap_ga_step_cuda(C, M, pop, fit, keys, n_valid, *, n_off: int,
                     tournament: int, p_crossover: float, p_mutation: float,
                     crossover: str = "ox"):
    """Launch K5 on the card: same contract as :func:`qap_ga_step_plain`
    on CUDA tensors (``pop``/``n_valid`` int32, ``keys`` int64 words)."""
    if pop.dim() != 3:
        raise ValueError(f"pop must be (B, P, N), got {tuple(pop.shape)}")
    B, P, n = pop.shape
    b0 = build.check_mats(B, n, C=C, M=M)
    build.check_args(C.device, ("pop", pop, torch.int32, (B, P, n)),
                     ("fit", fit, torch.float32, (B, P)),
                     ("keys", keys, torch.int64, (B, 2)),
                     ("n_valid", n_valid, torch.int32, (B,)))
    if not 1 <= n_off <= P or tournament < 1 or crossover not in ("ox", "oxs"):
        raise ValueError(f"unsupported n_off={n_off}, tournament={tournament}"
                         f" or crossover={crossover!r} for pop {P}")
    smem = _smem_warps(P, n, n_off, tournament) > 0
    plan = None if smem else l2_plan(P, n, n_off, tournament, B, b0)
    pop_out, fit_out = torch.empty_like(pop), torch.empty_like(fit)
    if B == 0:
        return pop_out, fit_out
    work, args = None, (0,) * 5
    if plan is not None:
        work = torch.empty(plan.work_words, dtype=torch.int32,
                           device=pop.device)
        t = plan.tiling
        args = (plan.breed_warps, t.group, t.warps, t.sets, t.tile_rows)
    err = build.library("qap_ga_step").qap_ga_step_launch(
        C.data_ptr(), M.data_ptr(), pop.data_ptr(), fit.data_ptr(),
        keys.data_ptr(), n_valid.data_ptr(), pop_out.data_ptr(),
        fit_out.data_ptr(), None if work is None else work.data_ptr(), B, P,
        n, B // b0, n_off, tournament,
        ga_ops.f32(p_crossover), ga_ops.f32(p_mutation),
        int(crossover == "oxs"), *args, pop.device.index,
        torch.cuda.current_stream(pop.device).cuda_stream)
    build.check(err, "qap_ga_step")
    build.count_launch("qap_ga_step", "smem" if smem else "l2")
    return pop_out, fit_out
