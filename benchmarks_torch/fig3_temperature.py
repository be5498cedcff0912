"""Paper Fig 3 on the port: objective vs temperature-decrease function
(linear vs Cauchy).

The paper's finding: the Cauchy schedule reaches a lower average
objective in less time than the linear schedule.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core import keys
from repro_torch.core.annealing import run_psa
from . import common


def rows(device=None) -> List[common.Row]:
    dev = common.device(device)
    C, M, inst = common.get(343, dev)
    out = []
    for sched, q in (("linear", 0.95), ("linear", 0.8), ("cauchy", 0.0)):
        cfg = dataclasses.replace(common.sa_budget(solvers=8),
                                  schedule=sched, q=q or 0.95)
        name = sched if sched == "cauchy" else f"{sched}(q={q})"
        t, res = common.time_fn(
            lambda cfg=cfg: run_psa(C, M, keys.prng_key(1), cfg,
                                    num_processes=2, device=dev))
        perm, f = common.solved(res)
        out.append(common.Row(
            f"fig3.schedule={name}", t,
            f"F={f:.0f};A1={common.accuracy(f, inst.optimum):.1f}%",
            inst.n, perm, f))
    return out


def run(device=None) -> list:
    return [r.csv() for r in rows(device)]
