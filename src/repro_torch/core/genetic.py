"""Parallel genetic algorithm (PGA) with ring migration.

The algorithm of ``repro/core/genetic.py`` (paper S3), with every
``vmap`` axis written out as one leading batch: the islands of all
instances of a wave, ``instances x processes``, advance together, the
islands of one instance contiguous (the kernels' ``r // (B // B0)``
contract).  Each island holds a population; each generation breeds
``n_off`` children by tournament selection, order crossover and swap
mutation, replaces the worst members (with an elitism guard), and sends
its best member to the next island of its ring.

``GAConfig.eval`` picks how a generation runs:

* ``"wide"`` (default): the operators run over every island at once and
  one ``kernels.ops.qap_objective`` call (kernel K2 on the card) scores
  every child of the wave;
* ``"fused"``: one ``kernels.ops.qap_ga_step`` launch (kernel K5) runs the
  whole generation of every island, its draws made on the card from the
  counter stream; above the fused cap it runs as ``"wide"`` counter draws;
* ``"island"``: the seed-era golden reference, with the scatter form of
  order crossover.

All three give the same populations.  ``GAConfig.rng`` picks the draws:
``"host"`` replays the reference's ``jax.random`` calls (``core.keys``),
``"counter"`` (implied by ``"fused"``) the Threefry counter stream.
``GAConfig.flows="sparse"`` takes ``C`` as a ``core.sparse.SparseFlows``:
children are then scored by the O(nnz) objective (kernel K6 on the card),
and ``"fused"`` runs as ``"wide"`` with counter draws.

Mutation realises per-gene Bernoulli(``p_mutation``) swaps as ``MAX_MUT``
candidate swaps, each gated with probability ``p_mutation * n /
MAX_MUT``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import ops, prng
from . import ga_ops, keys, qap
from .annealing import lead, wave_inputs
from .ga_ops import MAX_MUT, f32, worst_slots
from .sparse import SparseFlows

__all__ = ["GAConfig", "GAState", "MAX_MUT", "worst_slots", "run_pga",
           "run_pga_batch", "generation_step", "resolved_eval"]


@dataclass(frozen=True)
class GAConfig:
    pop_size: int = 0            # 0 => graph order (paper default)
    n_offspring: int = 0         # 0 => pop_size // 2
    p_crossover: float = 1.0
    p_mutation: float = 0.001    # per gene
    crossover: str = "ox"        # "ox" (basic) | "oxs" (with sorted parents)
    generations: int = 200
    migrants: int = 1            # paper: more than one degrades quality
    tournament: int = 2
    seed_identity: bool = False  # the as-allocated order joins population 0
    eval: str = "wide"           # "wide" | "island" | "fused" (same results)
    rng: str = "host"            # "host" (jax.random replay) | "counter"
    flows: str = "dense"         # "dense" | "sparse": C as a
                                 # core.sparse.SparseFlows (convert host-side
                                 # via sparse.prepare_flows)


class GAState(NamedTuple):
    pop: torch.Tensor     # (B, pop_size, N) int32, B islands
    fit: torch.Tensor     # (B, pop_size) f32


# ----------------------------------------------------------------------------
# Operators with host-regime draws, over leading dims (...)
# ----------------------------------------------------------------------------

def _cuts(key: torch.Tensor, n: int, n_valid):
    """OX cut points ``c1 <= c2`` drawn as the reference draws them:
    ``randint`` on each half of ``split(key)`` over ``[0, n)``, or over
    ``[0, max(n_valid, 1))`` (``n_valid`` broadcast against ``(...)``)."""
    hi = n if n_valid is None else torch.as_tensor(n_valid).clamp_min(1)
    k = keys.split(key)
    c1 = keys.randint(k[..., 0, :], (), 0, hi)
    c2 = keys.randint(k[..., 1, :], (), 0, hi)
    return torch.minimum(c1, c2), torch.maximum(c1, c2)


def order_crossover(key: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                    n_valid=None) -> torch.Tensor:
    """OX: the child keeps ``p1[c1:c2]``; the other positions take ``p2``'s
    genes in p2-order from ``c2`` on (cyclically), skipping duplicates.
    With ``n_valid`` both parents are identity on the padded tail and so
    is the child."""
    n = p1.shape[-1]
    c1, c2 = _cuts(key, n, n_valid)
    return ga_ops.ox_apply(c1, c2, p1, p2, n if n_valid is None else n_valid)


def _order_crossover_scatter(key: torch.Tensor, p1: torch.Tensor,
                             p2: torch.Tensor, n_valid=None) -> torch.Tensor:
    """The seed-era OX (scatter-based rank matching), the ``eval="island"``
    golden reference: the same child as :func:`order_crossover`."""
    n = p1.shape[-1]
    c1, c2 = _cuts(key, n, n_valid)
    dev = p1.device
    nv = torch.as_tensor(n if n_valid is None else n_valid,
                         device=dev).long().clamp_min(1)[..., None]
    pos = torch.arange(n, device=dev)
    c1, c2 = c1.long()[..., None], c2.long()[..., None]
    validp = (pos < nv).expand(p1.shape)
    seg_mask = ((pos >= c1) & (pos < c2)).expand(p1.shape)
    gene_in_seg = torch.zeros_like(seg_mask).scatter(-1, p1.long(), seg_mask)
    rot = torch.where(validp, (pos + c2) % nv, pos)
    genes = torch.gather(p2.long(), -1, rot)
    keep = ~torch.gather(gene_in_seg, -1, genes) & validp
    avail = ~torch.gather(seg_mask, -1, rot) & validp
    gene_rank = keep.long().cumsum(-1) - 1
    pos_rank = avail.long().cumsum(-1) - 1
    # rank-matched scatter: the r-th kept gene goes to the r-th free position
    pos_by_rank = torch.zeros(p1.shape[:-1] + (n + 1,), dtype=torch.long,
                              device=dev).scatter(
        -1, torch.where(avail, pos_rank, n), torch.where(avail, rot, 0))
    child = torch.where(seg_mask, p1.long(), torch.where(validp, 0, pos))
    target = torch.where(keep, torch.gather(pos_by_rank, -1,
                                            gene_rank.clamp_min(0)), n)
    child = torch.cat([child, torch.zeros_like(child[..., :1])], -1) \
        .scatter(-1, target, torch.where(keep, genes, 0))[..., :n]
    return child.to(p1.dtype)


def swap_mutation(key: torch.Tensor, p: torch.Tensor, p_mutation: float,
                  n_valid=None) -> torch.Tensor:
    """Expected ``p_mutation * N`` swaps through ``MAX_MUT`` gated
    candidates.  The gate is the reference's: a Python float rounded to
    f32 for an unpadded instance, the f32 form with ``n_valid``."""
    n = p.shape[-1]
    if n_valid is None:
        gate, hi = f32(min(p_mutation * n / MAX_MUT, 1.0)), n
    else:
        nv = torch.as_tensor(n_valid)
        gate, hi = ga_ops.mutation_gate(p_mutation, nv), nv.clamp_min(1)[..., None]
    k = keys.split(key, 3)
    ii = keys.randint(k[..., 0, :], (MAX_MUT,), 0, hi)
    jj = keys.randint(k[..., 1, :], (MAX_MUT,), 0, hi)
    us = keys.uniform(k[..., 2, :], (MAX_MUT,))
    return ga_ops.mutation_apply(p, ii, jj, us, gate)


def tournament_select(key: torch.Tensor, fit: torch.Tensor, k: int
                      ) -> torch.Tensor:
    """Tournament winners: ``key (B, ..., 2)``, ``fit (B, P)`` ->
    ``(B, ...)``, ``k`` candidates each, first minimum wins."""
    idx = keys.randint(key, (k,), 0, fit.shape[-1])
    return ga_ops.tournament_pick(fit, idx)


# ----------------------------------------------------------------------------
# Island GA
# ----------------------------------------------------------------------------

def _resolve(cfg: GAConfig, n: int) -> Tuple[int, int]:
    pop = cfg.pop_size if cfg.pop_size > 0 else n
    off = cfg.n_offspring if cfg.n_offspring > 0 else max(pop // 2, 1)
    return pop, off


def _resolve_n_off(cfg: GAConfig, pop_actual: int) -> int:
    # the composite algorithm may seed pop != graph order; never breed more
    n_off = cfg.n_offspring if cfg.n_offspring > 0 else max(pop_actual // 2, 1)
    return min(n_off, pop_actual)


def resolved_eval(cfg: GAConfig, n: Optional[int] = None) -> str:
    """The generation realisation that runs at order ``n``: ``"fused"``
    degrades to the equivalent ``"wide"`` counter path above the fused
    step's cap and for sparse flows, which the fused kernel does not
    read."""
    if cfg.eval not in ("wide", "island", "fused"):
        raise ValueError(f"unknown generation realisation {cfg.eval!r}")
    if cfg.eval == "fused" and (cfg.flows == "sparse" or (
            n is not None and not ops.fused_step_fits(n))):
        return "wide"
    return cfg.eval


def _check(cfg: GAConfig) -> None:
    resolved_eval(cfg)
    if cfg.rng not in ("host", "counter"):
        raise ValueError(f"unknown rng regime {cfg.rng!r}")
    if cfg.rng == "counter" and cfg.eval == "island":
        raise ValueError(
            "rng='counter' requires a wide-form eval ('wide'/'fused') -- "
            "eval='island' is the seed-era host-RNG golden reference")
    if cfg.flows not in ("dense", "sparse"):
        raise ValueError(f"flows must be 'dense' or 'sparse', got {cfg.flows!r}")


def _init_population(key: torch.Tensor, cfg: GAConfig, n: int,
                     n_valid=None, init_perm=None) -> torch.Tensor:
    """Initial populations ``(B0, I, pop, N)`` for island keys
    ``(B0, I, 2)``; ``n_valid``/``init_perm`` are per instance (``(B0,)``,
    ``(B0, N)``).  ``init_perm`` seeds member 0 of every island where its
    first entry is not negative."""
    pop_size, _ = _resolve(cfg, n)
    if n_valid is None:
        pop = qap.random_permutations(key, pop_size, n)
    else:
        pop = qap.masked_random_permutations(key, pop_size, n,
                                             n_valid[:, None])
    if cfg.seed_identity:
        pop[..., 0, :] = torch.arange(n, dtype=pop.dtype, device=pop.device)
    if init_perm is not None:
        use = (init_perm[:, 0] >= 0)[:, None, None]
        pop[..., 0, :] = torch.where(use, init_perm.to(pop.dtype)[:, None],
                                     pop[..., 0, :])
    return pop


def init_island(C: torch.Tensor, M: torch.Tensor, key: torch.Tensor,
                cfg: GAConfig, n_valid=None, init_perm=None) -> GAState:
    """Every island of a wave, scored in one ``ops.qap_objective`` call:
    island keys ``(B0, I, 2)`` -> state ``(B0 * I, pop, N)``."""
    b0, isl = key.shape[:2]
    pop = _init_population(key, cfg, C.shape[-1], n_valid, init_perm)
    pop = pop.reshape((b0 * isl,) + pop.shape[2:]).contiguous()
    return GAState(pop=pop, fit=ops.qap_objective(C, M, pop))


def _offspring(state: GAState, key: torch.Tensor, cfg: GAConfig,
               n_valid=None, crossover_fn=order_crossover) -> torch.Tensor:
    """Host-regime children ``(B, n_off, N)`` of every island (paper steps
    2-3): the reference's key tree -- ``split(key, 4)`` into selection,
    crossover, mutation and crossover-gate keys -- per island ``key (B,
    2)``; ``n_valid`` None or ``(B,)``."""
    b, pop_actual, _ = state.pop.shape
    n_off = _resolve_n_off(cfg, pop_actual)
    k = keys.split(key, 4)
    ksel, kx, kmut, kxp = k[:, 0], k[:, 1], k[:, 2], k[:, 3]
    sel = keys.split(ksel, 2 * n_off).view(b, n_off, 2, 2)
    i1 = tournament_select(sel[:, :, 0], state.fit, cfg.tournament)
    i2 = tournament_select(sel[:, :, 1], state.fit, cfg.tournament)
    par1, par2 = ga_ops.parents(state.pop, state.fit, i1, i2, cfg.crossover)
    nv = None if n_valid is None else n_valid[:, None]
    do_x = keys.uniform(kxp, (n_off,)) < f32(cfg.p_crossover)
    children = crossover_fn(keys.split(kx, n_off), par1, par2, nv)
    children = torch.where(do_x[..., None], children, par1)
    return swap_mutation(keys.split(kmut, n_off), children, cfg.p_mutation, nv)


def _offspring_counter(state: GAState, key: torch.Tensor, cfg: GAConfig,
                       n_valid=None) -> torch.Tensor:
    """Counter-regime :func:`_offspring`: the same operators, every draw
    from the counter stream of the island's key words -- the sequence the
    fused generation kernel replays on the card."""
    b, pop_actual, n = state.pop.shape
    nv = torch.full((b,), n, device=key.device) if n_valid is None else n_valid
    d = prng.ga_step_draws(key, _resolve_n_off(cfg, pop_actual),
                           cfg.tournament, MAX_MUT, pop_actual, nv)
    return ga_ops.offspring(state.pop, state.fit, d, nv, cfg.p_crossover,
                            cfg.p_mutation, cfg.crossover)


def _replace_worst(state: GAState, children: torch.Tensor,
                   child_fit: torch.Tensor) -> GAState:
    """Replace the worst ``n_off`` members with the children (paper step
    4), tie-stable, plus the elitism guard."""
    return GAState(*ga_ops.replace_worst(state.pop, state.fit, children,
                                         child_fit))


def breed(C: torch.Tensor, M: torch.Tensor, state: GAState,
          key: torch.Tensor, cfg: GAConfig, n_valid=None,
          offspring=_offspring) -> GAState:
    """One generation on every island (paper steps 2-5) without
    migration: children, one ``ops.qap_objective`` call, replacement."""
    children = offspring(state, key, cfg, n_valid)
    return _replace_worst(state, children, ops.qap_objective(C, M, children))


def _breed_island(C: torch.Tensor, M: torch.Tensor, state: GAState,
                  key: torch.Tensor, cfg: GAConfig, n_valid=None) -> GAState:
    """The seed-era generation (``eval="island"``): scatter-based OX.  The
    reference's full ``argsort`` worst-replacement is the stable argsort
    of :func:`worst_slots` already."""
    return breed(C, M, state, key, cfg, n_valid,
                 lambda s, k, c, v: _offspring(s, k, c, v,
                                               _order_crossover_scatter))


def receive_migrants(state: GAState, mig_p: torch.Tensor,
                     mig_f: torch.Tensor) -> GAState:
    """The migrant replaces each island's worst member (first maximum) if
    it is better (paper step 7)."""
    rows = torch.arange(state.pop.shape[0], device=state.pop.device)
    worst = qap.first_argmax(state.fit)
    better = mig_f < state.fit[rows, worst]
    pop, fit = state.pop.clone(), state.fit.clone()
    pop[rows, worst] = torch.where(better[:, None], mig_p, pop[rows, worst])
    fit[rows, worst] = torch.where(better, mig_f, fit[rows, worst])
    return GAState(pop=pop, fit=fit)


def island_best(state: GAState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each island's best member (first minimum): ``(B, N)``, ``(B,)``."""
    rows = torch.arange(state.pop.shape[0], device=state.pop.device)
    i = qap.first_argmin(state.fit)
    return state.pop[rows, i], state.fit[rows, i]


def generation_step(C: torch.Tensor, M: torch.Tensor, state: GAState,
                    key: torch.Tensor, cfg: GAConfig, num_processes: int,
                    n_valid=None) -> Tuple[GAState, torch.Tensor]:
    """One generation of every ring (breeding + ring migration).

    ``state`` holds ``B0 * num_processes`` islands, those of an instance
    contiguous; ``key (B0, 2)`` one key per instance, ``n_valid`` None or
    ``(B0,)``; ``C``/``M`` shared or ``(B0, N, N)``.  Returns the new state
    and each instance's pre-migration best ``(B0,)`` (the history entry).
    """
    b, pop_actual, n = state.pop.shape
    b0 = key.shape[0]
    ev = resolved_eval(cfg, n)
    isl_keys = keys.split(key, num_processes).reshape(b, 2)
    nv = None if n_valid is None else n_valid.repeat_interleave(num_processes)
    if ev == "fused":
        nv32 = torch.full((b,), n, device=key.device) if nv is None else nv
        pop, fit = ops.qap_ga_step(
            C, M, state.pop, state.fit, isl_keys,
            nv32.to(torch.int32).contiguous(),
            n_off=_resolve_n_off(cfg, pop_actual), tournament=cfg.tournament,
            p_crossover=cfg.p_crossover, p_mutation=cfg.p_mutation,
            crossover=cfg.crossover)
        state = GAState(pop=pop, fit=fit)
    elif ev == "wide":
        counter = cfg.rng == "counter" or cfg.eval == "fused"
        state = breed(C, M, state, isl_keys, cfg, nv,
                      _offspring_counter if counter else _offspring)
    else:
        state = _breed_island(C, M, state, isl_keys, cfg, nv)
    bp, bf = island_best(state)
    # Ring migration: island i receives the best of island i-1.
    mig_p = bp.view(b0, num_processes, n).roll(1, dims=1).reshape(b, n)
    mig_f = bf.view(b0, num_processes).roll(1, dims=1).reshape(b)
    return (receive_migrants(state, mig_p, mig_f),
            bf.view(b0, num_processes).amin(-1))


def evolve(C: torch.Tensor, M: torch.Tensor, state: GAState,
           key: torch.Tensor, cfg: GAConfig, num_processes: int, n_valid=None):
    """``cfg.generations`` generations from ``state``, then each
    instance's best: ``(best_perm (B0, N), best_f (B0,), history (B0,
    generations))``.  Shared by PGA and the composite algorithm's GA
    stage."""
    b0, n = key.shape[0], state.pop.shape[-1]
    gen_keys = keys.split(key, cfg.generations)                   # (B0, G, 2)
    history = []
    for g in range(cfg.generations):
        state, best = generation_step(C, M, state, gen_keys[:, g], cfg,
                                      num_processes, n_valid)
        history.append(best)
    bp, bf = island_best(state)
    bf = bf.view(b0, num_processes)
    i = qap.first_argmin(bf)
    rows = torch.arange(b0, device=key.device)
    hist = torch.stack(history, dim=1) if history else bf[:, :0]
    return bp.view(b0, num_processes, n)[rows, i], bf[rows, i], hist


def _pga_impl(C: torch.Tensor, M: torch.Tensor, key: torch.Tensor,
              cfg: GAConfig, num_processes: int, n_valid=None,
              init_perm=None):
    """PGA over a wave of ``B0`` instances, ``C``/``M`` ``(B0, N, N)``.
    ``init_perm`` seeds member 0 of every island; the elitism guard then
    keeps the result no worse than the seed.  ``C`` may be a
    ``SparseFlows`` with ``(B0, N, D)`` leaves."""
    _check(cfg)
    if cfg.flows == "sparse" and not isinstance(C, SparseFlows):
        raise TypeError(
            "GAConfig.flows='sparse' requires C as a core.sparse.SparseFlows"
            " -- convert host-side with sparse.prepare_flows(C, 'sparse')")
    if n_valid is not None:
        C = qap.mask_flows(C, n_valid)
    k = keys.split(key)
    kinit, krun = k[:, 0], k[:, 1]
    state = init_island(C, M, keys.split(kinit, num_processes), cfg, n_valid,
                        init_perm)
    return evolve(C, M, state, krun, cfg, num_processes, n_valid)


def run_pga_batch(Cs, Ms, key, cfg: GAConfig, num_processes: int = 4,
                  n_valid=None, init_perm=None, device=None):
    """Instance-batched PGA: ``Cs``/``Ms`` ``(B, N, N)``, ``key (B, 2)``,
    ``n_valid`` optional ``(B,)``, ``init_perm`` optional ``(B, N)`` warm
    starts (a negative first entry leaves that instance cold).  Returns
    ``(best_perms (B, N), best_fs (B,), history (B, generations))``; entry
    b equals ``run_pga`` on instance b.  Runs on ``cuda`` unless
    ``device`` says otherwise."""
    C, M, k, nv, ip = wave_inputs(Cs, Ms, key, n_valid, init_perm, device)
    return _pga_impl(C, M, k, cfg, num_processes, nv, ip)


def run_pga(C, M, key, cfg: GAConfig, num_processes: int = 4, n_valid=None,
            init_perm=None, device=None):
    """Island PGA on one instance: ``(best_perm, best_f, history)``."""
    C, M, k, nv, ip = wave_inputs(C, M, key, n_valid, init_perm, device)
    p, f, hist = _pga_impl(lead(C), M[None], k[None], cfg, num_processes,
                           None if nv is None else nv.reshape(1),
                           None if ip is None else ip[None])
    return p[0], f[0], hist[0]

