"""Paper Figs 1-2 on the port: objective value and search time vs
maxNeighbors (tai343).

The paper's finding: maxNeighbors ~= 50 gives the best objective at
acceptable time; larger values cost time without quality gain.
"""
from __future__ import annotations

from typing import List

from repro_torch.core import keys
from repro_torch.core.annealing import run_psa
from . import common


def rows(device=None) -> List[common.Row]:
    dev = common.device(device)
    C, M, inst = common.get(343, dev)
    out = []
    for mn in (10, 25, 50, 100, 200):
        cfg = common.sa_budget(neighbors=mn, solvers=8)
        t, res = common.time_fn(
            lambda cfg=cfg: run_psa(C, M, keys.prng_key(0), cfg,
                                    num_processes=2, device=dev))
        perm, f = common.solved(res)
        out.append(common.Row(
            f"fig1_2.maxNeighbors={mn}", t,
            f"F={f:.0f};A1={common.accuracy(f, inst.optimum):.1f}%",
            inst.n, perm, f))
    return out


def run(device=None) -> list:
    return [r.csv() for r in rows(device)]
