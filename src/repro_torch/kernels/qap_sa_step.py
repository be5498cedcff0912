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
``core.annealing``): each round scores every remaining candidate against
the current state in one wide delta call and applies the first accepted
one.  The kernel (``csrc/qap_sa_step.cu``) scans them one by one.
Rejected candidates never change the state, so the two agree bit for bit
on integer-valued instances, where every f32 sum is exact in any order.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ..core import qap
from . import build, prng
from .qap_delta import qap_delta_plain

# The kernel's dynamic shared memory stays under the default 48 KB limit.
_SMEM_LIMIT = 48 * 1024


def event_loop(delta: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               p: torch.Tensor, f: torch.Tensor, best_p: torch.Tensor,
               best_f: torch.Tensor, temp: torch.Tensor, pairs: torch.Tensor,
               us: torch.Tensor, max_success: int):
    """Acceptance-event loop over ``B`` chains at full window width.

    ``delta(p, pairs)`` scores ``(B, K, 2)`` candidates -> ``(B, K)``.
    A chain stops once its ``K`` candidates are consumed or
    ``max_success`` swaps landed; stopped chains are masked while the
    others run on (what the reference's ``while_loop`` under ``vmap``
    does).  At most ``min(max_success, K) + 1`` rounds.
    """
    B, K = us.shape
    tsafe = temp.clamp_min(1e-9)[:, None]
    rows = torch.arange(B, device=p.device)
    cand = torch.arange(K, device=p.device)
    start = torch.zeros(B, dtype=torch.long, device=p.device)
    succ = torch.zeros(B, dtype=torch.long, device=p.device)
    for _ in range(K + 1):
        active = (start < K) & (succ < max_success)
        if not bool(active.any()):
            break
        ds = delta(p, pairs)
        accept = (ds < 0) | (us < torch.exp(-ds / tsafe))
        live = accept & (cand >= start[:, None]) & active[:, None]
        fire = live.any(dim=1)
        j = torch.where(live, cand, K).amin(dim=1).clamp_max(K - 1)
        ab = pairs[rows, j].long()
        p = torch.where(fire[:, None], qap.swap_positions(p, ab[:, 0], ab[:, 1]), p)
        f = torch.where(fire, f + ds[rows, j], f)
        better = active & (f < best_f)
        best_p = torch.where(better[:, None], p, best_p)
        best_f = torch.where(better, f, best_f)
        start = torch.where(active, torch.where(fire, j + 1, K), start)
        succ = succ + fire.long()
    return p, f, best_p, best_f


def qap_sa_step_plain(C, M, p, f, best_p, best_f, temp, keys, n_valid, *,
                      max_neighbors: int, max_success: int):
    """Plain PyTorch version of K4 (counterpart of
    ``repro.kernels.ref.qap_sa_step_ref``): ``p``/``best_p (B, N)`` int32,
    ``f``/``best_f``/``temp (B,)`` f32, ``keys (B, 2)`` uint32 words,
    ``n_valid (B,)``; C/M shared or ``(B0, N, N)``."""
    pairs, us = prng.sa_step_draws(keys, max_neighbors, n_valid)
    return event_loop(lambda pp, pr: qap_delta_plain(C, M, pp, pr),
                      p, f, best_p, best_f, temp, pairs, us, max_success)


def qap_sa_step_cuda(C, M, p, f, best_p, best_f, temp, keys, n_valid, *,
                     max_neighbors: int, max_success: int,
                     CT: Optional[torch.Tensor] = None,
                     MT: Optional[torch.Tensor] = None):
    """Launch K4 on the card: same contract as :func:`qap_sa_step_plain`
    on CUDA tensors (``p``/``best_p``/``n_valid`` int32)."""
    CT = C.transpose(-2, -1).contiguous() if CT is None else CT
    MT = M.transpose(-2, -1).contiguous() if MT is None else MT
    B, n = p.shape
    b0 = build.check_mats(B, n, C=C, M=M, CT=CT, MT=MT)
    build.check_args(
        C.device, ("p", p, torch.int32, (B, n)),
        ("best_p", best_p, torch.int32, (B, n)), ("f", f, torch.float32, (B,)),
        ("best_f", best_f, torch.float32, (B,)),
        ("temp", temp, torch.float32, (B,)), ("keys", keys, torch.int64, (B, 2)),
        ("n_valid", n_valid, torch.int32, (B,)))
    lib = build.library("qap_sa_step")
    smem = lib.qap_sa_step_smem_bytes(n, max_neighbors)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"order {n} x {max_neighbors} candidates needs "
                         f"{smem} B of shared memory (limit {_SMEM_LIMIT})")
    kw = build.key_words(keys)
    p_out, bp_out = torch.empty_like(p), torch.empty_like(best_p)
    f_out, bf_out = torch.empty_like(f), torch.empty_like(best_f)
    if B == 0:
        return p_out, f_out, bp_out, bf_out
    fn = lib.qap_sa_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(C.data_ptr(), CT.data_ptr(), M.data_ptr(), MT.data_ptr(),
                 p.data_ptr(), f.data_ptr(), best_p.data_ptr(),
                 best_f.data_ptr(), temp.data_ptr(), kw.data_ptr(),
                 n_valid.data_ptr(), p_out.data_ptr(), f_out.data_ptr(),
                 bp_out.data_ptr(), bf_out.data_ptr(), B, n, B // b0,
                 max_neighbors, max_success, stream)
    build.check(err, "qap_sa_step")
    build.LAUNCHES["qap_sa_step"] += 1
    return p_out, f_out, bp_out, bf_out
