"""Paper Fig 5 on the port: solution quality vs number of solvers per
process (tai343).

Paper: ~125 solvers suffice for graphs up to 1024 vertices; more solvers
improve coverage of the solution space up to a saturation point.
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
    for sv in (8, 27, 64, 125):
        cfg = common.sa_budget(solvers=sv, num_exchanges=20, ipe=20)
        t, res = common.time_fn(
            lambda cfg=cfg: run_psa(C, M, keys.prng_key(3), cfg,
                                    num_processes=2, device=dev))
        perm, f = common.solved(res)
        out.append(common.Row(
            f"fig5.solvers={sv}", t,
            f"F={f:.0f};A1={common.accuracy(f, inst.optimum):.1f}%",
            inst.n, perm, f))
    return out


def run(device=None) -> list:
    return [r.csv() for r in rows(device)]
