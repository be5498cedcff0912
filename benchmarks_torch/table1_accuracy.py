"""Paper Table 1 + Fig 8 on the port: accuracy (A1) and runtime of PSA /
PGA / PCA across all seven taiXe instances.

The paper's findings (S5-S6) that this table tests:
  * PSA has the minimum runtime at every order;
  * PGA/PCA beat PSA's accuracy on large graphs (tai343/tai729);
  * PCA (composite) tracks PGA's accuracy at comparable cost;
  * on small instances the GA is least accurate (A1 24-34% in the paper).

Budgets are scaled by REPRO_BENCH_SCALE (see common.py); a markdown Table 1
is also written to artifacts_torch/table1.md.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np

from repro_torch.core import composite, genetic, keys
from repro_torch.core.annealing import run_psa
from . import common

ORDERS = (27, 45, 75, 125, 175, 343, 729)
ART = os.path.join(os.path.dirname(__file__), "..", "artifacts_torch")
ALGORITHMS = ("psa", "pga", "pca")


def _algorithms(n: int, device=None):
    dev = common.device(device)
    sa = common.sa_budget(solvers=8, num_exchanges=30, ipe=30)
    ga = common.ga_budget(generations=150, pop=min(n, 128))
    pca = composite.CompositeConfig(
        sa=dataclasses.replace(sa, num_exchanges=max(sa.num_exchanges // 3, 2),
                               solvers=0),
        ga=ga)
    return {
        "psa": lambda C, M, k: run_psa(C, M, k, sa, num_processes=4,
                                       device=dev),
        "pga": lambda C, M, k: genetic.run_pga(C, M, k, ga, num_processes=4,
                                               device=dev),
        "pca": lambda C, M, k: composite.run_pca(C, M, k, pca,
                                                 num_processes=4, device=dev),
    }


def rows(device=None) -> List[common.Row]:
    """Each (order, algorithm): the best F of ``RUNS`` runs (keys 0 ..
    RUNS-1) with its permutation, and the mean wall time."""
    out = []
    for n in ORDERS:
        C, M, inst = common.get(n, device)
        for name, fn in _algorithms(n, device).items():
            fs, ts, perms = [], [], []
            for r in range(common.RUNS):
                t, res = common.time_fn(fn, C, M, keys.prng_key(r))
                perm, f = common.solved(res)
                fs.append(f)
                ts.append(t)
                perms.append(perm)
            best = int(np.argmin(fs))
            fbest, tmean = fs[best], float(np.mean(ts))
            a1 = common.accuracy(fbest, inst.optimum)
            out.append(common.Row(
                f"table1.tai{n}.{name}", tmean,
                f"F={fbest:.0f};F0={inst.optimum:.0f};A1={a1:.1f}%",
                n, perms[best], fbest))
    return out


def run(device=None) -> list:
    table = rows(device)
    _write_markdown(table)
    return [r.csv() for r in table]


def _write_markdown(table: List[common.Row]) -> None:
    os.makedirs(ART, exist_ok=True)
    lines = ["| instance | PSA F | PSA T(s) | PSA A1 | PGA F | PGA T(s) | "
             "PGA A1 | PCA F | PCA T(s) | PCA A1 | F0 |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    by = {(r.order, r.name.rsplit(".", 1)[1]): r for r in table}
    for n in dict.fromkeys(r.order for r in table):
        optimum = common.get(n, "cpu")[2].optimum
        cells = []
        for name in ALGORITHMS:
            r = by[(n, name)]
            cells += [f"{r.f:.0f}", f"{r.seconds:.2f}",
                      f"{common.accuracy(r.f, optimum):.0f}%"]
        lines.append(f"| tai{n}e01s | " + " | ".join(cells) +
                     f" | {optimum:.0f} |")
    with open(os.path.join(ART, "table1.md"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
