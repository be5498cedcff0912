"""Faults planted in the program, and the control, for the check of
``correct``: each must turn a run's ``correct`` false.

* ``state_unchanged``: K4 (``ops.qap_sa_step``) returns its chains'
  state unchanged, so the annealing does nothing;
* ``half_batch``: the solver answers the second half of a wave with the
  first half's answers;
* ``answer_altered``: two entries of every answer's permutation swapped
  where the wave's polish produces it, its objective kept;
* ``one_slot_unannealed``: the first slot of every wave skips the
  annealing and goes to the polish from the identity, the rest of the
  wave sound;
* ``worse_than_identity``: the first answer of every wave replaced by a
  placement worse than the identity, with its own F as its objective:
  what an engine without its guard answers where its solver fails;
* ``control``: the reference put in the program's place in bfloat16,
  one precision below the configuration's float32: every answer's
  objective recomputed with bfloat16 products and sums.

One chip holds every cell, so no exchange between chips can be left out.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import numpy as np

from . import harness, reference

FAULTS = ("state_unchanged", "half_batch", "answer_altered",
          "one_slot_unannealed", "worse_than_identity")


@contextlib.contextmanager
def planted(fault: str) -> Iterator[None]:
    """The program with ``fault`` planted, inside the block."""
    import torch
    from repro_torch.core import annealing, mapping
    from repro_torch.kernels import ops
    if fault == "state_unchanged":
        module, name = ops, "qap_sa_step"

        def broken(C, M, p, f, best_p, best_f, *args, **kw):
            return p, f, best_p, best_f
    elif fault == "half_batch":
        module, name = annealing, "run_psa_batch"
        solve = annealing.run_psa_batch

        def broken(*args, **kw):
            p, f, hist = solve(*args, **kw)
            h = p.shape[0] // 2
            p, f = p.clone(), f.clone()
            p[p.shape[0] - h:], f[f.shape[0] - h:] = p[:h], f[:h]
            return p, f, hist
    elif fault == "answer_altered":
        module, name = mapping, "polish_batch"
        polish = mapping.polish_batch

        def broken(*args, **kw):
            p, f = polish(*args, **kw)
            p = p.clone()
            p[:, [0, 1]] = p[:, [1, 0]]
            return p, f
    elif fault == "one_slot_unannealed":
        module, name = annealing, "run_psa_batch"
        solve = annealing.run_psa_batch

        def broken(Cs, Ms, *args, **kw):
            p, f, hist = solve(Cs, Ms, *args, **kw)
            p, f = p.clone(), f.clone()
            p[0] = torch.arange(p.shape[1], dtype=p.dtype, device=p.device)
            f[0] = (Cs[0] * Ms[0]).sum()
            return p, f, hist
    elif fault == "worse_than_identity":
        from repro_torch.serve.mapper import MappingEngine
        module, name = MappingEngine, "_respond"
        respond = MappingEngine._respond
        left = [0]                  # responses left in the group

        def broken(self, p, perm, objective, *args, **kw):
            resp = respond(self, p, perm, objective, *args, **kw)
            if resp.cached:
                return resp
            if left[0] > 0:
                left[0] -= 1
                return resp
            left[0] = resp.batch_size - 1
            worse = _worse_than_identity(p.req.C, p.req.M)
            return dataclasses.replace(
                resp, perm=worse,
                objective=float(reference.objective(p.req.C, p.req.M,
                                                    worse)))
    else:
        raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")
    original = getattr(module, name)
    setattr(module, name, broken)
    try:
        yield
    finally:
        setattr(module, name, original)


def _worse_than_identity(C: np.ndarray, M: np.ndarray) -> np.ndarray:
    """The identity with swaps that raise F applied until F lies above
    the identity's."""
    n = C.shape[0]
    perm = np.arange(n, dtype=np.int32)
    base = reference.objective(C, M, perm)
    rng = np.random.default_rng(n)
    while reference.objective(C, M, perm) <= base:
        i, j = rng.choice(n, 2, replace=False)
        trial = perm.copy()
        trial[[i, j]] = trial[[j, i]]
        if reference.objective(C, M, trial) > reference.objective(C, M,
                                                                   perm):
            perm = trial
    return perm


def control(run) -> None:
    """Put the bfloat16 reference's objectives in the program's place in
    ``run``'s answers, then check them again."""
    for a in run.answers:
        if a.error is None and reference.is_permutation(a.perm,
                                                        a.req.C.shape[0]):
            a.objective = reference.bf16_objective(a.req.C, a.req.M, a.perm)
    harness.check(run)
