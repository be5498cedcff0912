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
each; elsewhere a block builds one child at a time and reads ``C``, ``M``
and the population from global memory.  Its integer work is exact, and
the children's F agree bit for bit on integer-valued instances.
"""
from __future__ import annotations

import functools

import torch

from ..core import ga_ops
from . import build, prng
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
def _smem(P: int, n: int, n_off: int, tournament: int):
    """``(bytes, warps)`` of the K5 launch at these shapes: its dynamic
    shared memory (-1 where no branch takes them) and the shared-memory
    branch's warps (0 where the L2 branch takes them)."""
    lib = build.library("qap_ga_step")
    return (lib.qap_ga_step_smem_bytes(P, n, n_off, tournament),
            lib.qap_ga_step_smem_warps(P, n, n_off, tournament))


def smem_branch(P: int, n: int, n_off: int, tournament: int) -> bool:
    """Does K5 take ``P`` members of order ``n``, ``n_off`` children and
    ``tournament`` on its shared-memory branch?  (``C``, ``M``, the
    population and one warp's scratch must fit a block's 227 KB.)"""
    return _smem(P, n, n_off, tournament)[1] > 0


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
    smem_bytes, warps = _smem(P, n, n_off, tournament)
    if smem_bytes < 0:
        raise ValueError(f"pop {P} x order {n} needs more than 227 KB of "
                         f"shared memory")
    pop_out, fit_out = torch.empty_like(pop), torch.empty_like(fit)
    if B == 0:
        return pop_out, fit_out
    err = build.library("qap_ga_step").qap_ga_step_launch(
        C.data_ptr(), M.data_ptr(), pop.data_ptr(), fit.data_ptr(),
        keys.data_ptr(), n_valid.data_ptr(), pop_out.data_ptr(),
        fit_out.data_ptr(), B, P, n, B // b0, n_off, tournament,
        ga_ops.f32(p_crossover), ga_ops.f32(p_mutation),
        int(crossover == "oxs"), pop.device.index,
        torch.cuda.current_stream(pop.device).cuda_stream)
    build.check(err, "qap_ga_step")
    build.LAUNCHES["qap_ga_step"] += 1
    build.BRANCH_LAUNCHES["qap_ga_step/smem" if warps > 0
                          else "qap_ga_step/l2"] += 1
    return pop_out, fit_out
