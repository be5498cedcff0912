"""One whole SA temperature step per chain: the CUDA kernel K4 and its
plain version.

Replaces the TPU kernel ``repro/kernels/qap_sa_step.py``
(``qap_sa_step_pallas_batch``).  For ``B`` chains: draw ``max_neighbors``
candidate swaps and Metropolis uniforms from the Threefry counter stream
of each chain's key words (``prng.sa_draws``), consume them under the
``max_success`` cap, and return ``(p, f, best_p, best_f)``.  Cooling
stays with the caller.

The plain version consumes the candidates with the acceptance-event loop
(:func:`event_loop`, also the ``loop="event"`` hot loop of
``core.annealing``): each round scores a window of candidates (all of
them unless ``event_width`` narrows it) against the current state in one
wide delta call and applies the first accepted one.  The kernel (``csrc/qap_sa_step.cu``) scans them one by one: up to
``build.dense_smem_max_n()`` (every dense bucket) one warp per chain,
the chains of an instance sharing a block that stages ``C`` and ``M`` in
shared memory; above it one block per chain, reading ``C``, ``M`` and
their transposes from global memory.
Rejected candidates never change the state, so the two agree bit for bit
on integer-valued instances, where every f32 sum is exact in any order.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from ..core import qap
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


def qap_sa_step_plain(C, M, p, f, best_p, best_f, temp, keys, n_valid, *,
                      max_neighbors: int, max_success: int,
                      event_width: Optional[int] = None):
    """Plain PyTorch version of K4 (counterpart of
    ``repro.kernels.ref.qap_sa_step_ref``): ``p``/``best_p (B, N)`` int32,
    ``f``/``best_f``/``temp (B,)`` f32, ``keys (B, 2)`` uint32 words,
    ``n_valid (B,)``; C/M shared or ``(B0, N, N)``.  ``event_width``
    shapes the event loop's windows (default: every candidate), never
    its results."""
    pairs, us = prng.sa_step_draws(keys, max_neighbors, n_valid)
    return event_loop(lambda pp, pr: qap_delta_plain(C, M, pp, pr),
                      p, f, best_p, best_f, temp, pairs, us, max_success,
                      event_width)


@functools.lru_cache(maxsize=None)
def _smem_bytes(n: int, k: int) -> int:
    """Shared memory of the K4 branch that takes order ``n`` with ``k``
    candidates; -1 where neither branch takes it."""
    return build.library("qap_sa_step").qap_sa_step_smem_bytes(n, k)


def qap_sa_step_cuda(C, M, p, f, best_p, best_f, temp, keys, n_valid, *,
                     max_neighbors: int, max_success: int,
                     CT: Optional[torch.Tensor] = None,
                     MT: Optional[torch.Tensor] = None):
    """Launch K4 on the card: same contract as :func:`qap_sa_step_plain`
    on CUDA tensors (``p``/``best_p``/``n_valid`` int32, ``keys`` int64
    words).  ``CT``/``MT`` are read only above
    :func:`build.dense_smem_max_n` (the L2 branch), where they default to
    fresh transposes."""
    B, n = p.shape
    b0 = build.check_mats(B, n, C=C, M=M)
    build.check_args(
        C.device, ("p", p, torch.int32, (B, n)),
        ("best_p", best_p, torch.int32, (B, n)), ("f", f, torch.float32, (B,)),
        ("best_f", best_f, torch.float32, (B,)),
        ("temp", temp, torch.float32, (B,)), ("keys", keys, torch.int64, (B, 2)),
        ("n_valid", n_valid, torch.int32, (B,)))
    if _smem_bytes(n, max_neighbors) < 0:
        raise ValueError(f"no branch of the qap_sa_step kernel takes order "
                         f"{n} with {max_neighbors} candidates: its state "
                         f"needs more than 227 KB of shared memory")
    # one allocation for p and best_p, one for f and best_f
    perms = torch.empty((2, B, n), dtype=torch.int32, device=p.device)
    fs = torch.empty((2, B), dtype=torch.float32, device=p.device)
    if B == 0:
        return perms[0], fs[0], perms[1], fs[1]
    smem = n <= build.dense_smem_max_n()
    ct = mt = None
    if not smem:
        CT = C.transpose(-2, -1).contiguous() if CT is None else CT
        MT = M.transpose(-2, -1).contiguous() if MT is None else MT
        build.check_mats(B, n, C=C, CT=CT, MT=MT)
        ct, mt = CT.data_ptr(), MT.data_ptr()
    pp, fp = perms.data_ptr(), fs.data_ptr()
    err = build.library("qap_sa_step").qap_sa_step_launch(
        C.data_ptr(), ct, M.data_ptr(), mt, p.data_ptr(), f.data_ptr(),
        best_p.data_ptr(), best_f.data_ptr(), temp.data_ptr(), keys.data_ptr(),
        n_valid.data_ptr(), pp, fp, pp + 4 * B * n, fp + 4 * B, B, n, B // b0,
        max_neighbors, max_success, p.device.index,
        torch.cuda.current_stream(p.device).cuda_stream)
    build.check(err, "qap_sa_step")
    build.count_launch("qap_sa_step", "smem" if smem else "l2")
    p_out, bp_out = perms.unbind(0)
    f_out, bf_out = fs.unbind(0)
    return p_out, f_out, bp_out, bf_out
