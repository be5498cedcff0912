"""The plain reference and the comparison that decides ``correct``.

The reference recomputes ``F(p) = sum_kl C[k, l] * M[p[k], p[l]]`` of an
answer from the request's own ``C`` and ``M`` (made by the benchmark from
``--seed``), in int64: every instance is integer-valued, so the sum is
exact.  It imports nothing of the program.

Numbers compared, each with its limit (``limits``):

* ``missing``: requests whose answer never came or raised (limit 0);
* ``invalid_perm``: answers that are not a permutation of ``range(n)``
  (limit 0);
* ``objective_gap``: the widest ``|objective - F(perm)|`` (limit 0: the
  program computes F in float32 on integers below 2**24, which is exact);
* ``worse_than_identity``: answers whose ``F(perm)`` lies above the
  identity placement's ``F = sum(C * M)``, which the configurations
  guarantee never happens (limit 0);
* ``mean_f_over_f0``: the mean ``F(perm) / F0`` over the answers, and
* ``worst_f_over_f0``: the highest ``F(perm) / F0`` of any one answer,
  each against the cell's own limit (``cells/<workload>.json``), set
  between sound runs and runs with a broken solver: the mean catches a
  solver that maps every answer a little worse, the worst one answer
  mapped far worse.

The control (``bf16_objective``) puts the reference in the program's
place at the precision below the configuration's float32: each answer's
objective is recomputed with bfloat16 products and sum.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

EXACT = ("missing", "invalid_perm", "objective_gap", "worse_than_identity")
OWN = ("mean_f_over_f0", "worst_f_over_f0")


def objective(C: np.ndarray, M: np.ndarray, perm: np.ndarray) -> int:
    """``F(perm)`` in exact integer arithmetic."""
    p = np.asarray(perm, np.int64)
    Ci = C.astype(np.int64)
    Mi = M.astype(np.int64)
    return int((Ci * Mi[np.ix_(p, p)]).sum())


def is_permutation(perm: np.ndarray, n: int) -> bool:
    perm = np.asarray(perm)
    return perm.shape == (n,) and bool(
        (np.sort(perm.astype(np.int64)) == np.arange(n)).all())


def bf16_objective(C: np.ndarray, M: np.ndarray, perm: np.ndarray) -> float:
    """The control: ``F(perm)`` with bfloat16 products, summed in
    bfloat16 (a pairwise tree, every partial sum rounded)."""
    import torch
    p = np.asarray(perm, np.int64)
    x = (torch.from_numpy(np.array(C)).to(torch.bfloat16)
         * torch.from_numpy(M[np.ix_(p, p)]).to(torch.bfloat16)).reshape(-1)
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        x = x[0::2] + x[1::2]
    return float(x[0])


def check(answers: Sequence[dict], missing: int
          ) -> Tuple[Dict[str, float], List[Tuple[Optional[int], bool]]]:
    """The compared numbers over ``answers`` (dicts with ``C``, ``M``,
    ``optimum``, ``perm``, ``objective``), of which ``missing`` never
    came; and each answer's ``F(perm)`` (None where it is not a
    permutation) and whether it is right on its own: a permutation, its
    objective ``F(perm)``, no worse than the identity."""
    invalid, worse, gap, ratios, out = 0, 0, 0.0, [], []
    for a in answers:
        if not is_permutation(a["perm"], a["C"].shape[0]):
            invalid += 1
            out.append((None, False))
            continue
        f = objective(a["C"], a["M"], a["perm"])
        g = abs(float(a["objective"]) - f)
        bad = f > int((a["C"].astype(np.int64)
                       * a["M"].astype(np.int64)).sum())
        worse += bad
        gap = max(gap, g)
        ratios.append(f / a["optimum"])
        out.append((f, g == 0 and not bad))
    read = {"missing": float(missing), "invalid_perm": float(invalid),
            "objective_gap": gap, "worse_than_identity": float(worse),
            "mean_f_over_f0": float(np.mean(ratios)) if ratios else
            float("inf"),
            "worst_f_over_f0": float(max(ratios)) if ratios else
            float("inf")}
    return read, out


def limits(cell_limits: Dict[str, float]) -> Dict[str, float]:
    """Every compared number's limit: 0 for the exact ones, the cell's
    own for the rest."""
    out = {name: 0.0 for name in EXACT}
    out.update({name: float(cell_limits[name]) for name in OWN})
    return out


def judge(read: Dict[str, float], lim: Dict[str, float]) -> bool:
    return all(read[k] <= lim[k] for k in lim)
