"""GA operator bodies with the draws taken out: the part of a generation
that both draw regimes, and the plain version of the fused GA step, share.

The port of ``repro/core/ga_ops.py``.  Every function takes explicit
leading batch dims (islands, offspring) where the reference is written
for one island under ``vmap``.  All of it is integer work (comparisons,
prefix sums, gathers) plus f32 comparisons against f32 gates, so it gives
the reference's children bit for bit on every device.  The prefix sums
are ``cumsum``: the reference's triangular-mask sums exist only because a
TPU kernel may not lower ``cumsum``, and integer sums agree in any order.
"""
from __future__ import annotations

import numpy as np
import torch

from . import qap

MAX_MUT = 4   # fixed per-individual mutation budget (genetic.py docstring)


def f32(x: float) -> float:
    """``x`` rounded to f32, as JAX rounds a Python float operand."""
    return float(np.float32(x))


def ox_apply(c1: torch.Tensor, c2: torch.Tensor, p1: torch.Tensor,
             p2: torch.Tensor, n_valid) -> torch.Tensor:
    """Order crossover given the cut points, over leading dims ``(...)``.

    The child keeps ``p1[c1:c2]``; the other positions of the valid prefix
    take ``p2``'s genes in p2-order from ``c2`` on (cyclically), skipping
    the segment's genes; positions at or past ``n_valid`` stay identity.
    ``c1``/``c2`` are ``(...)`` with ``c1 <= c2 < max(n_valid, 1)``,
    ``p1``/``p2`` ``(..., N)``, ``n_valid`` broadcast against ``(...)``.
    """
    n = p1.shape[-1]
    dev = p1.device
    nv = torch.as_tensor(n_valid, device=dev).long().clamp_min(1)[..., None]
    c1, c2 = c1.long()[..., None], c2.long()[..., None]
    pos = torch.arange(n, device=dev)
    validp = pos < nv
    seg_mask = (pos >= c1) & (pos < c2)
    seg_mask, validp = torch.broadcast_tensors(seg_mask, validp)
    # gene_in_seg[g]: the segment holds gene g (p1 is a permutation)
    gene_in_seg = torch.zeros(seg_mask.shape, dtype=torch.bool, device=dev)
    gene_in_seg = gene_in_seg.scatter(-1, p1.long().expand(seg_mask.shape),
                                      seg_mask)
    rot = torch.where(validp, (pos + c2) % nv, pos)
    genes = torch.gather(p2.long().expand(rot.shape), -1, rot)
    keep = ~torch.gather(gene_in_seg, -1, genes) & validp
    avail = ~torch.gather(seg_mask, -1, rot) & validp
    t_of_q = torch.where(validp, (pos - c2) % nv, pos)
    gene_rank = keep.long().cumsum(-1) - 1
    pos_rank = avail.long().cumsum(-1) - 1
    # val_by_rank[r]: the kept gene of rank r (0 where there is none); the
    # extra last column takes the writes of genes that are not kept.
    val_by_rank = torch.zeros(genes.shape[:-1] + (n + 1,), dtype=torch.long,
                              device=dev)
    val_by_rank = val_by_rank.scatter(-1, torch.where(keep, gene_rank, n),
                                      torch.where(keep, genes, 0))
    r_of_q = torch.gather(pos_rank, -1, t_of_q).clamp(0, n - 1)
    child = torch.where(seg_mask, p1.long(), torch.gather(val_by_rank, -1, r_of_q))
    return torch.where(validp, child, pos).to(p1.dtype)


def mutation_gate(p_mutation: float, n_valid) -> torch.Tensor:
    """Per-candidate swap probability ``min(p_mutation * n_valid / MAX_MUT,
    1)`` in f32: expected ``p_mutation * n`` swaps realised as ``MAX_MUT``
    gated candidates."""
    nv = torch.as_tensor(n_valid).to(torch.float32)
    return (nv * f32(p_mutation) / MAX_MUT).clamp_max(1.0)


def mutation_apply(p: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor,
                   us: torch.Tensor, gate) -> torch.Tensor:
    """``MAX_MUT`` gated position swaps in order: ``p (..., N)``,
    ``ii``/``jj``/``us`` ``(..., MAX_MUT)``, ``gate`` broadcast against
    ``(...)``.  ``ii == jj`` is a no-op."""
    for t in range(ii.shape[-1]):
        do = (us[..., t] < gate)[..., None]
        p = torch.where(do, qap.swap_positions(p, ii[..., t], jj[..., t]), p)
    return p


def tournament_pick(fit: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``idx[argmin(fit[idx])]`` with the first-minimum tie rule:
    ``fit (B, P)``, candidate members ``idx (B, ..., t)`` -> ``(B, ...)``."""
    vals = torch.gather(fit, 1, idx.reshape(fit.shape[0], -1).long()) \
        .view(idx.shape)
    best, bval = idx[..., 0], vals[..., 0]
    for t in range(1, idx.shape[-1]):
        better = vals[..., t] < bval
        best = torch.where(better, idx[..., t], best)
        bval = torch.where(better, vals[..., t], bval)
    return best


def parents(pop: torch.Tensor, fit: torch.Tensor, i1: torch.Tensor,
            i2: torch.Tensor, crossover: str):
    """Parent rows ``(B, n_off, N)`` of winners ``i1``/``i2 (B, n_off)``;
    with ``"oxs"`` the fitter parent donates the segment (ties keep the
    order)."""
    def rows(i):
        return torch.gather(pop, 1, i.long()[..., None].expand(
            -1, -1, pop.shape[-1]))
    par1, par2 = rows(i1), rows(i2)
    if crossover == "oxs":
        swap = (torch.gather(fit, 1, i2.long())
                < torch.gather(fit, 1, i1.long()))[..., None]
        par1, par2 = torch.where(swap, par2, par1), torch.where(swap, par1, par2)
    return par1, par2


def offspring(pop: torch.Tensor, fit: torch.Tensor, d, n_valid: torch.Tensor,
              p_crossover: float, p_mutation: float,
              crossover: str) -> torch.Tensor:
    """Counter-regime children ``(B, n_off, N)`` of islands ``pop (B, P, N)``
    from their draws ``d`` (``prng.GADraws``), ``n_valid (B,)``: the body
    of ``genetic._offspring_counter`` and of the plain fused step."""
    i1 = tournament_pick(fit, d.sel[..., 0, :])
    i2 = tournament_pick(fit, d.sel[..., 1, :])
    par1, par2 = parents(pop, fit, i1, i2, crossover)
    nv = n_valid[:, None]
    children = ox_apply(d.cut1, d.cut2, par1, par2, nv)
    children = torch.where((d.xu < f32(p_crossover))[..., None], children, par1)
    return mutation_apply(children, d.mut_i, d.mut_j, d.mut_u,
                          mutation_gate(p_mutation, nv))


def worst_slots(fit: torch.Tensor, n_off: int) -> torch.Tensor:
    """Slots of the ``n_off`` worst members per island, ascending fitness,
    ties toward the higher index at the cut: the tail of a *stable*
    ascending argsort, which is what the reference's ``top_k`` on the
    reversed fitness gives (``torch.topk`` promises no tie order)."""
    return torch.argsort(fit, dim=-1, stable=True)[..., fit.shape[-1] - n_off:]


def replace_worst(pop: torch.Tensor, fit: torch.Tensor,
                  children: torch.Tensor, child_fit: torch.Tensor):
    """Children replace the worst members (``children[k]`` into
    ``worst_slots[k]``), then the elitism guard: if the previous best
    (first minimum) was lost, it replaces the new worst (first maximum).
    Returns ``(pop, fit)``."""
    n_off, n = children.shape[1], pop.shape[-1]
    worst = worst_slots(fit, n_off)
    new_pop = pop.scatter(1, worst[..., None].expand(-1, -1, n), children)
    new_fit = fit.scatter(1, worst, child_fit)
    rows = torch.arange(pop.shape[0], device=pop.device)
    prev_i = qap.first_argmin(fit)
    prev_p, prev_f = pop[rows, prev_i], fit[rows, prev_i]
    worst_new = qap.first_argmax(new_fit)
    lost = prev_f < new_fit.amin(-1)
    new_pop[rows, worst_new] = torch.where(lost[:, None], prev_p,
                                           new_pop[rows, worst_new])
    new_fit[rows, worst_new] = torch.where(lost, prev_f,
                                           new_fit[rows, worst_new])
    return new_pop, new_fit
