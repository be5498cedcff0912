"""Threefry-2x32-20 counter stream: the plain PyTorch form.

The same cipher as ``repro/kernels/prng.py``, bit for bit.  The fused SA
kernel (``csrc/qap_sa_step.cu``) derives its candidate pairs and
Metropolis uniforms on the card from ``csrc/threefry.cuh``, which is this
module written as CUDA device functions on native ``uint32_t``; the
functions here are the host side of the same stream (the ``rng="counter"``
draws of the event/scan loops and the plain version of the fused step).

uint32 words are held in int64 tensors masked with ``& 0xFFFFFFFF``:
PyTorch has no ``+``, ``<<``, ``>>`` or ``%`` on ``torch.uint32`` on the
CPU.  Every value stays in [0, 2**32), so each add, shift and remainder
agrees with the 32-bit one.

    draw(j) = threefry2x32(k0, k1, stream_tag, j)

Uniforms keep the top 24 bits (``(w >> 8) * 2**-24``), exact in f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import qap

MASK32 = 0xFFFFFFFF

# Stream tags: one counter word per draw purpose.
STREAM_SA_PAIR = 1    # SA candidate swap pairs
STREAM_SA_ACC = 2     # SA Metropolis acceptance uniforms
STREAM_GA_SEL = 3     # GA tournament member indices
STREAM_GA_CUT = 4     # GA order-crossover cut points
STREAM_GA_XGATE = 5   # GA crossover gate uniforms
STREAM_GA_MUT = 6     # GA mutation position pairs
STREAM_GA_MGATE = 7   # GA mutation gate uniforms


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def _words(*xs):
    """Broadcast ints/tensors to int64 uint32-word tensors on one device."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    ts = [torch.as_tensor(x, dtype=torch.int64, device=dev) & MASK32
          for x in xs]
    return torch.broadcast_tensors(*ts)


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds: (key, counter) -> two uint32 words.

    Operands broadcast together; the result words are int64 tensors
    holding values in [0, 2**32).
    """
    ks0, ks1, x0, x1 = _words(k0, k1, c0, c1)
    ks2 = ks0 ^ ks1 ^ 0x1BD11BDA

    def rounds(x0, x1, rots):
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        return x0, x1

    ra, rb = (13, 15, 26, 6), (17, 29, 16, 24)
    inject = ((ks1, ks2, 1), (ks2, ks0, 2), (ks0, ks1, 3), (ks1, ks2, 4),
              (ks2, ks0, 5))
    x0, x1 = (x0 + ks0) & MASK32, (x1 + ks1) & MASK32
    for i, (ka, kb, c) in enumerate(inject):
        x0, x1 = rounds(x0, x1, ra if i % 2 == 0 else rb)
        x0, x1 = (x0 + ka) & MASK32, (x1 + kb + c) & MASK32
    return x0, x1


def uniform32(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 uniform in [0, 1): the top 24 bits times 2**-24
    (exact in f32, so every device gives the same value)."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def sa_draws(k0, k1, max_neighbors: int, n_valid):
    """One temperature step's candidate stream from raw key words.

    ``k0``/``k1``/``n_valid`` broadcast over leading dims ``(...)``;
    returns ``(a, b, us)`` of shape ``(..., max_neighbors)``: swap
    positions (``a < b``, uniform by modulo over the C(n_valid, 2) pairs
    of the valid prefix; orders < 2 get the no-op pair (0, 0)) and
    Metropolis uniforms.
    """
    k0, k1, nv = _words(k0, k1, n_valid)
    k0, k1, nv = k0[..., None], k1[..., None], nv[..., None]
    j = torch.arange(max_neighbors, dtype=torch.int64, device=k0.device)
    nv2 = nv.clamp_min(2)
    w0, _ = threefry2x32(k0, k1, STREAM_SA_PAIR, j)
    a, b = qap.pair_from_index(w0 % qap.num_pairs(nv2), nv2)
    ok = nv >= 2
    a = torch.where(ok, a, 0).to(torch.int32)
    b = torch.where(ok, b, 0).to(torch.int32)
    u0, _ = threefry2x32(k0, k1, STREAM_SA_ACC, j)
    return a, b, uniform32(u0)


def sa_step_draws(key: torch.Tensor, max_neighbors: int, n_valid):
    """Host form over ``(..., 2)`` key words: ``(pairs (..., K, 2),
    us (..., K))`` -- the arrays the event/scan loops consume in counter
    mode."""
    a, b, us = sa_draws(key[..., 0], key[..., 1], max_neighbors, n_valid)
    return torch.stack([a, b], dim=-1), us


class GADraws(NamedTuple):
    """One island generation's operator draws, leading dims ``(..., n_off)``."""
    sel: torch.Tensor     # (..., n_off, 2, tournament) int32 member indices
    cut1: torch.Tensor    # (..., n_off) int32 OX cut points, cut1 <= cut2
    cut2: torch.Tensor    # (..., n_off) int32
    xu: torch.Tensor      # (..., n_off) f32 crossover gate uniforms
    mut_i: torch.Tensor   # (..., n_off, max_mut) int32 mutation positions
    mut_j: torch.Tensor   # (..., n_off, max_mut) int32
    mut_u: torch.Tensor   # (..., n_off, max_mut) f32 mutation gate uniforms


def ga_draws(k0, k1, n_off: int, tournament: int, max_mut: int, pop: int,
             n_valid) -> GADraws:
    """One island generation's draw set from raw key words, one stream tag
    per operator; ``k0``/``k1``/``n_valid`` broadcast over leading dims
    ``(...)``.  Cut points and mutation positions lie in the valid prefix
    ``[0, max(n_valid, 1))``.  The fused GA kernel (``csrc/qap_ga_step.cu``)
    makes the same draws on the card (``csrc/threefry.cuh`` ga_draw_*)."""
    k0, k1, nv = _words(k0, k1, n_valid)
    k0, k1, nv = k0[..., None], k1[..., None], nv[..., None].clamp_min(1)
    lead = k0.shape[:-1]
    dev = k0.device

    def idx(m):
        return torch.arange(m, dtype=torch.int64, device=dev)

    w0, _ = threefry2x32(k0, k1, STREAM_GA_SEL, idx(n_off * 2 * tournament))
    sel = (w0 % pop).to(torch.int32).reshape(lead + (n_off, 2, tournament))
    w0, w1 = threefry2x32(k0, k1, STREAM_GA_CUT, idx(n_off))
    c1, c2 = (w0 % nv).to(torch.int32), (w1 % nv).to(torch.int32)
    w0, _ = threefry2x32(k0, k1, STREAM_GA_XGATE, idx(n_off))
    xu = uniform32(w0)
    w0, w1 = threefry2x32(k0, k1, STREAM_GA_MUT, idx(n_off * max_mut))
    mut_i = (w0 % nv).to(torch.int32).reshape(lead + (n_off, max_mut))
    mut_j = (w1 % nv).to(torch.int32).reshape(lead + (n_off, max_mut))
    w0, _ = threefry2x32(k0, k1, STREAM_GA_MGATE, idx(n_off * max_mut))
    mut_u = uniform32(w0).reshape(lead + (n_off, max_mut))
    return GADraws(sel, torch.minimum(c1, c2), torch.maximum(c1, c2), xu,
                   mut_i, mut_j, mut_u)


def ga_step_draws(key: torch.Tensor, n_off: int, tournament: int,
                  max_mut: int, pop: int, n_valid) -> GADraws:
    """Host form over ``(..., 2)`` key words (``genetic._offspring_counter``
    and the plain version of the fused GA step)."""
    return ga_draws(key[..., 0], key[..., 1], n_off, tournament, max_mut,
                    pop, n_valid)
