"""Paper Fig 4 on the port: objective vs consecutive iterations per
information exchange.

Total iterations N = c x n held fixed while the exchange period n varies
(paper: best around n=100; more exchanges burn time, fewer lose coupling).
"""
from __future__ import annotations

from typing import List

from repro_torch.core import keys
from repro_torch.core.annealing import SAConfig, run_psa
from . import common


def rows(device=None) -> List[common.Row]:
    dev = common.device(device)
    C, M, inst = common.get(343, dev)
    total = max(int(2000 * common.SCALE ** 0.5), 40)
    out = []
    for n in (10, 100, 1000):
        n_eff = min(n, total)
        cfg = SAConfig(max_neighbors=20, iters_per_exchange=n_eff,
                       num_exchanges=max(total // n_eff, 1), solvers=8)
        t, res = common.time_fn(
            lambda cfg=cfg: run_psa(C, M, keys.prng_key(2), cfg,
                                    num_processes=2, device=dev))
        perm, f = common.solved(res)
        out.append(common.Row(
            f"fig4.iters_per_exchange={n}", t,
            f"F={f:.0f};A1={common.accuracy(f, inst.optimum):.1f}%"
            f";exchanges={cfg.num_exchanges}",
            inst.n, perm, f))
    return out


def run(device=None) -> list:
    return [r.csv() for r in rows(device)]
