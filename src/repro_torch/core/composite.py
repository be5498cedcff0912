"""Parallel composite algorithm (PCA): SA seeding, then the island GA.

The algorithm of ``repro/core/composite.py`` (paper S3).  Stage 1 runs
simulated annealing *without* exchanges, so every process generates its
own diverse set of solutions; each chain's best becomes one member of its
process's GA population.  Stage 2 runs the parallel genetic algorithm
with ring migration from those populations.

Stage 1 is ``annealing.anneal_chains`` with ``exchange=False``: the same
hot loop as PSA (``cfg.sa.loop``: kernel K1 or K4 on the card), derived
keys as PSA derives them, chain 0 warm-started from ``init_perm``, and no
``seed_with``.  Stage 2 is ``genetic.evolve``: the same generations as
PGA (``cfg.ga.eval``: kernel K2 or K5 on the card).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from . import annealing, genetic, keys, qap


@dataclass(frozen=True)
class CompositeConfig:
    sa: annealing.SAConfig = annealing.SAConfig(num_exchanges=10, solvers=0)
    ga: genetic.GAConfig = genetic.GAConfig()


def _resolve_solvers(cfg: CompositeConfig, n: int) -> int:
    # Stage 1 emits one chain per GA population slot, unless the SA
    # config fixes the number of solvers (the engine's does: 8).
    pop, _ = genetic._resolve(cfg.ga, n)
    return cfg.sa.solvers if cfg.sa.solvers > 0 else pop


def seed_population(C: torch.Tensor, M: torch.Tensor, key: torch.Tensor,
                    cfg: CompositeConfig, num_processes: int, n_valid=None,
                    init_perm=None) -> genetic.GAState:
    """Stage 1: per-process SA chains, no exchanges, one chain per
    population slot.  ``C`` (masked past ``n_valid``) and ``M`` are
    ``(B0, N, N)``, ``key (B0, 2)``; returns ``B0 * num_processes``
    islands whose members are the chains' best permutations."""
    b0, n = C.shape[0], C.shape[-1]
    solvers = _resolve_solvers(cfg, n)
    sa_cfg = replace(cfg.sa, solvers=solvers)
    chains, _ = annealing.anneal_chains(C, M, key, sa_cfg, num_processes,
                                        False, n_valid, init_perm)
    return genetic.GAState(
        pop=chains.best_p.reshape(b0 * num_processes, solvers, n),
        fit=chains.best_f.reshape(b0 * num_processes, solvers))


def _pca_impl(C: torch.Tensor, M: torch.Tensor, key: torch.Tensor,
              cfg: CompositeConfig, num_processes: int, n_valid=None,
              init_perm=None):
    """PCA over a wave of ``B0`` instances, ``C``/``M`` ``(B0, N, N)``."""
    genetic._check(cfg.ga)
    if n_valid is not None:
        C = qap.mask_flows(C, n_valid)
    k = keys.split(key)
    state = seed_population(C, M, k[:, 0], cfg, num_processes, n_valid,
                            init_perm)
    return genetic.evolve(C, M, state, k[:, 1], cfg.ga, num_processes,
                          n_valid)


def run_pca_batch(Cs, Ms, key, cfg: CompositeConfig, num_processes: int = 4,
                  n_valid=None, init_perm=None, device=None):
    """Instance-batched PCA: ``Cs``/``Ms`` ``(B, N, N)``, ``key (B, 2)``,
    ``n_valid`` optional ``(B,)``, ``init_perm`` optional ``(B, N)`` warm
    starts of the stage-1 chains (a negative first entry leaves that
    instance cold).  Returns ``(best_perms (B, N), best_fs (B,),
    ga_history (B, generations))``; entry b equals ``run_pca`` on
    instance b.  Runs on ``cuda`` unless ``device`` says otherwise."""
    C, M, k, nv, ip = annealing.wave_inputs(Cs, Ms, key, n_valid, init_perm,
                                            device)
    return _pca_impl(C, M, k, cfg, num_processes, nv, ip)


def run_pca(C, M, key, cfg: CompositeConfig, num_processes: int = 4,
            n_valid=None, init_perm=None, device=None):
    """The composite algorithm on one instance: ``(best_perm, best_f,
    ga_history)``."""
    C, M, k, nv, ip = annealing.wave_inputs(C, M, key, n_valid, init_perm,
                                            device)
    p, f, hist = _pca_impl(C[None], M[None], k[None], cfg, num_processes,
                           None if nv is None else nv.reshape(1),
                           None if ip is None else ip[None])
    return p[0], f[0], hist[0]
