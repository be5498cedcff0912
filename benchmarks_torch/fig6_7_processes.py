"""Paper Figs 6-7 on the port: solution quality vs number of processes
(tai343, tai729).

Paper: more processes widen the candidate-solution space and improve
accuracy with near-constant runtime (each process is parallel hardware).
On one card the processes are rows of one batch, so runtime shows how the
batch scales; quality is the reproduced quantity.
"""
from __future__ import annotations

from typing import List

from repro_torch.core import keys
from repro_torch.core.annealing import run_psa
from . import common


def rows(device=None) -> List[common.Row]:
    dev = common.device(device)
    out = []
    for n_inst in (343, 729):
        C, M, inst = common.get(n_inst, dev)
        for procs in (1, 2, 4, 8):
            cfg = common.sa_budget(solvers=4, num_exchanges=15, ipe=15)
            t, res = common.time_fn(
                lambda cfg=cfg, p=procs: run_psa(
                    C, M, keys.prng_key(4), cfg, num_processes=p,
                    device=dev))
            perm, f = common.solved(res)
            out.append(common.Row(
                f"fig6_7.tai{n_inst}.processes={procs}", t,
                f"F={f:.0f};"
                f"A1={common.accuracy(f, inst.optimum):.1f}%",
                inst.n, perm, f))
    return out


def run(device=None) -> list:
    return [r.csv() for r in rows(device)]
