"""One whole SA temperature step per chain: the CUDA kernel K4 and its
plain version; and a whole exchange round of such steps.

Replaces the TPU kernel ``repro/kernels/qap_sa_step.py``
(``qap_sa_step_pallas_batch``).  For ``B`` chains: draw ``max_neighbors``
candidate swaps and Metropolis uniforms from the Threefry counter stream
of each chain's key words (``prng.sa_draws``), consume them under the
``max_success`` cap, and return ``(p, f, best_p, best_f)``.  One step
leaves cooling to the caller.  A round (``steps=``) runs that many steps
from each chain's round key, step ``t`` keyed by ``keys.split(key,
steps)[t]``, cooling after each step (:class:`Cooling`, :func:`cool`),
and leaves the final temperatures in the caller's ``temp_out``: the bits
of ``steps`` single steps with the host's cooling between them.  On the
card a round is one launch, on K4's shared-memory branch alone.

The plain version consumes the candidates with the acceptance-event loop
(:func:`event_loop`, also the ``loop="event"`` hot loop of
``core.annealing``): each round scores a window of candidates (all of
them unless ``event_width`` narrows it) against the current state in one
wide delta call and applies the first accepted one.  The kernel
(``csrc/qap_sa_step.cu``) scans them one by one, one warp per chain: up
to ``build.dense_smem_max_n()`` (every dense bucket) the chains of an
instance share a block that stages ``C`` and ``M`` in shared memory;
above it, up to :data:`L2_MAX_N` (the fused steps' cap), each chain
stages the eight rows of ``C``, ``C^T``, ``M`` and ``M^T`` each
candidate reads, by bulk copies that a second warp issues, and sums the
candidate as K1's L2 branch does.
Rejected candidates never change the state, so the two agree bit for bit
on integer-valued instances, where every f32 sum is exact in any order.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core import qap
from ..core.keys import split as split_key
from . import build, prng
from .qap_delta import qap_delta_plain


def event_loop(delta: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               p: torch.Tensor, f: torch.Tensor, best_p: torch.Tensor,
               best_f: torch.Tensor, temp: torch.Tensor, pairs: torch.Tensor,
               us: torch.Tensor, max_success: int,
               width: Optional[int] = None):
    """Acceptance-event loop over ``B`` chains, ``width`` candidates a
    round (default: all ``K``).

    ``delta(p, pairs)`` scores ``(B, w, 2)`` candidates -> ``(B, w)``.
    Each round scores, for every chain, the window ``[off, off + w)``
    with ``off = min(start, K - w)`` (one ``delta`` call for all chains)
    and applies the first accepted candidate at or after ``start``, the
    rows before it masked (the reference's
    ``annealing._acceptance_event_loop``); a round with none advances
    past its window.  A chain stops once its ``K`` candidates are
    consumed or ``max_success`` swaps landed; stopped chains are masked
    while the others run on (what the reference's ``while_loop`` under
    ``vmap`` does).  Rejected candidates never change the state, so
    every width gives the same states.
    """
    B, K = us.shape
    w = K if width is None else min(max(int(width), 1), K)
    tsafe = temp.clamp_min(1e-9)[:, None]
    rows = torch.arange(B, device=p.device)
    cand = torch.arange(w, device=p.device)
    start = torch.zeros(B, dtype=torch.long, device=p.device)
    succ = torch.zeros(B, dtype=torch.long, device=p.device)
    for _ in range(K + 1):
        active = (start < K) & (succ < max_success)
        if not bool(active.any()):
            break
        off = (start.clamp_max(K - w))[:, None]
        idx = off + cand                                         # (B, w)
        if w == K:
            wpairs, wus = pairs, us
        else:
            wpairs = pairs.gather(1, idx[..., None].expand(B, w, 2))
            wus = us.gather(1, idx)
        ds = delta(p, wpairs)
        accept = (ds < 0) | (wus < torch.exp(-ds / tsafe))
        live = accept & (idx >= start[:, None]) & active[:, None]
        fire = live.any(dim=1)
        j = torch.where(live, cand, w).amin(dim=1).clamp_max(w - 1)
        ab = wpairs[rows, j].long()
        p = torch.where(fire[:, None], qap.swap_positions(p, ab[:, 0], ab[:, 1]), p)
        f = torch.where(fire, f + ds[rows, j], f)
        better = active & (f < best_f)
        best_p = torch.where(better[:, None], p, best_p)
        best_f = torch.where(better, f, best_f)
        start = torch.where(active, torch.where(fire, off[:, 0] + j + 1,
                                                off[:, 0] + w), start)
        succ = succ + fire.long()
    return p, f, best_p, best_f


class Cooling(NamedTuple):
    """The cooling after each temperature step of a round, then the clamp
    at ``t_final``: ``schedule`` ``"linear"`` (``T q``) or ``"cauchy"``
    (``T / (1 + beta T)``); ``q`` and ``t_final`` f32 values, ``beta``
    ``(B,)`` f32, one per chain."""
    schedule: str
    q: float
    t_final: float
    beta: torch.Tensor


# The kernel's codes of the schedules (kCoolLinear, kCoolCauchy of
# csrc/qap_sa_step.cu).
COOL_CODES = {"linear": 0, "cauchy": 1}


def cool(temp: torch.Tensor, schedule: str, q: float, beta: torch.Tensor
         ) -> torch.Tensor:
    """One cooling of ``temp``, unclamped: linear ``T q``; Cauchy ``T /
    (1 + beta T)`` with ``1 + beta T`` rounded once (the f64 product of
    two f32 is exact), as XLA's fused multiply-add rounds it.  K4's round
    cools in these roundings (``cool_step`` of ``csrc/qap_sa_step.cu``)."""
    if schedule == "linear":
        return temp * q
    if schedule == "cauchy":
        return temp / (beta.double() * temp.double() + 1.0).float()
    raise ValueError(f"unknown schedule {schedule!r}")


def cooled(temp: torch.Tensor, cooling: Cooling) -> torch.Tensor:
    """The temperature after one step of a round: :func:`cool`, then the
    clamp at ``t_final``."""
    return cool(temp, cooling.schedule, cooling.q,
                cooling.beta).clamp_min(cooling.t_final)


def qap_sa_step_plain(C, M, p, f, best_p, best_f, temp, keys, n_valid, *,
                      max_neighbors: int, max_success: int,
                      event_width: Optional[int] = None,
                      steps: Optional[int] = None,
                      cooling: Optional[Cooling] = None,
                      temp_out: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K4 (counterpart of
    ``repro.kernels.ref.qap_sa_step_ref``): ``p``/``best_p (B, N)`` int32,
    ``f``/``best_f``/``temp (B,)`` f32, ``keys (B, 2)`` uint32 words,
    ``n_valid (B,)``; C/M shared or ``(B0, N, N)``.  ``event_width``
    shapes the event loop's windows (default: every candidate), never
    its results.  With ``steps``, a round: ``keys`` are round keys, each
    step is this function's single step at ``split_key(keys, steps)[:,
    t]``, then ``cooled``; the final temperatures go to ``temp_out``."""
    if steps is not None:
        _check_round(steps, cooling, temp_out, temp)
        step_keys = split_key(keys, steps)                      # (B, S, 2)
        for t in range(steps):
            p, f, best_p, best_f = qap_sa_step_plain(
                C, M, p, f, best_p, best_f, temp, step_keys[:, t], n_valid,
                max_neighbors=max_neighbors, max_success=max_success,
                event_width=event_width)
            temp = cooled(temp, cooling)
        temp_out.copy_(temp)
        return p, f, best_p, best_f
    pairs, us = prng.sa_step_draws(keys, max_neighbors, n_valid)
    return event_loop(lambda pp, pr: qap_delta_plain(C, M, pp, pr),
                      p, f, best_p, best_f, temp, pairs, us, max_success,
                      event_width)


def _check_round(steps, cooling, temp_out, temp) -> None:
    """A round needs at least one step, a known schedule and a
    ``temp_out`` of ``temp``'s shape and type."""
    if not isinstance(steps, int) or steps < 1:
        raise ValueError(f"a round takes steps >= 1, got {steps!r}")
    if cooling is None or cooling.schedule not in COOL_CODES:
        raise ValueError(f"a round takes a Cooling with schedule in "
                         f"{sorted(COOL_CODES)}, got {cooling!r}")
    if temp_out is None or temp_out.shape != temp.shape \
            or temp_out.dtype != temp.dtype:
        raise ValueError("a round takes temp_out of temp's shape and dtype")


# The L2 branch's largest order (32 kMaxRegIters of csrc/qap_sa_step.cu:
# each lane keeps its p[lane + 32 j] in registers), the fused steps' cap,
# and the rows a candidate stages (kRowsPerCandidate of
# csrc/qap_delta.cuh), in each of its two row sets.
L2_MAX_N = 768
L2_STAGED_ROWS = 8


def l2_block_bytes(n: int) -> int:
    """Shared memory of K4's L2 block at order ``n`` (``l2_block_words``
    of ``csrc/qap_sa_step.cu``): two sets of eight row slots of ``128
    ceil(n / 128) + 4`` words, the chain's p and best_p, a slot each, and
    64 bytes of mbarriers and requests."""
    slot = 128 * -(-n // 128) + 4
    return 4 * (slot * (2 * L2_STAGED_ROWS + 2) + 16)


def l2_plan(n: int) -> int:
    """The shared memory of K4's L2 block at order ``n``, from the order
    alone: a block a chain, its warp and the warp that issues its copies,
    with two row sets (the next candidate's rows land while one is
    summed).  Raises ``ValueError`` above :data:`L2_MAX_N`."""
    if n > L2_MAX_N:
        raise ValueError(f"no branch of the qap_sa_step kernel takes order "
                         f"{n}: its L2 branch holds a chain's permutation "
                         f"in registers up to order {L2_MAX_N}")
    return l2_block_bytes(n)


def qap_sa_step_cuda(C, M, p, f, best_p, best_f, temp, keys, n_valid, *,
                     max_neighbors: int, max_success: int,
                     CT: Optional[torch.Tensor] = None,
                     MT: Optional[torch.Tensor] = None,
                     steps: Optional[int] = None,
                     cooling: Optional[Cooling] = None,
                     temp_out: Optional[torch.Tensor] = None):
    """Launch K4 on the card: same contract as :func:`qap_sa_step_plain`
    on CUDA tensors (``p``/``best_p``/``n_valid`` int32, ``keys`` int64
    words).  ``CT``/``MT`` are read only above
    :func:`build.dense_smem_max_n` (the L2 branch), where they default to
    fresh transposes.  A round (``steps``) is one launch on the
    shared-memory branch, counted as ``"smem_round"``, and refuses larger
    orders."""
    B, n = p.shape
    b0 = build.check_mats(B, n, C=C, M=M)
    build.check_args(
        C.device, ("p", p, torch.int32, (B, n)),
        ("best_p", best_p, torch.int32, (B, n)), ("f", f, torch.float32, (B,)),
        ("best_f", best_f, torch.float32, (B,)),
        ("temp", temp, torch.float32, (B,)), ("keys", keys, torch.int64, (B, 2)),
        ("n_valid", n_valid, torch.int32, (B,)))
    if steps is not None:
        _check_round(steps, cooling, temp_out, temp)
    smem = n <= build.dense_smem_max_n()
    beta = temp_ptr = None
    if steps is not None:
        if not smem:
            raise ValueError(f"a round runs on K4's shared-memory branch, up "
                             f"to order {build.dense_smem_max_n()}, not order "
                             f"{n}")
        build.check_args(C.device, ("beta", cooling.beta, torch.float32, (B,)),
                         ("temp_out", temp_out, torch.float32, (B,)))
        beta, temp_ptr = cooling.beta.data_ptr(), temp_out.data_ptr()
    if not smem:
        l2_plan(n)  # refuses an order the L2 branch does not take
    # one allocation for p and best_p, one for f and best_f
    perms = torch.empty((2, B, n), dtype=torch.int32, device=p.device)
    fs = torch.empty((2, B), dtype=torch.float32, device=p.device)
    if B == 0:
        return perms[0], fs[0], perms[1], fs[1]
    ct = mt = None
    if not smem:
        CT = C.transpose(-2, -1).contiguous() if CT is None else CT
        MT = M.transpose(-2, -1).contiguous() if MT is None else MT
        build.check_mats(B, n, C=C, CT=CT, MT=MT)
        ct, mt = CT.data_ptr(), MT.data_ptr()
    schedule, q, t_final = ((COOL_CODES[cooling.schedule], cooling.q,
                             cooling.t_final) if steps is not None
                            else (0, 0.0, 0.0))
    pp, fp = perms.data_ptr(), fs.data_ptr()
    err = build.library("qap_sa_step").qap_sa_step_launch(
        C.data_ptr(), ct, M.data_ptr(), mt, p.data_ptr(), f.data_ptr(),
        best_p.data_ptr(), best_f.data_ptr(), temp.data_ptr(), keys.data_ptr(),
        n_valid.data_ptr(), beta, pp, fp, pp + 4 * B * n, fp + 4 * B,
        temp_ptr, B, n, B // b0, max_neighbors, max_success, steps or 0,
        schedule, q, t_final, p.device.index,
        torch.cuda.current_stream(p.device).cuda_stream)
    build.check(err, "qap_sa_step")
    build.count_launch("qap_sa_step", "l2" if not smem else
                       "smem" if steps is None else "smem_round")
    p_out, bp_out = perms.unbind(0)
    f_out, bf_out = fs.unbind(0)
    return p_out, f_out, bp_out, bf_out
