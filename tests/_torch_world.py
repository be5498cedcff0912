"""The rank body of ``tests/test_torch_distributed.py``: every case of
the port's distributed solvers on one rank of a spawned world.  Kept out
of the test module, which imports JAX, so that the spawned ranks import
torch and the port only."""
import numpy as np
import torch

from repro_torch.core import (annealing, composite, distributed, genetic,
                              instances, keys, mapping)

ORDER = 12
# tests/test_distributed.py's budgets
SA = dict(max_neighbors=10, iters_per_exchange=10, num_exchanges=8,
          solvers=4)
PCA_SA = dict(max_neighbors=5, iters_per_exchange=5, num_exchanges=4,
              solvers=6)
GENERATIONS, PCA_GENERATIONS = 30, 15
# case -> (entry point, its config's kind, config changes, key seed)
CASES = {
    "psa-event": ("psa", dict(SA), 0),
    "psa-fused": ("psa", dict(SA, loop="fused"), 0),
    "pga-wide": ("pga", dict(generations=GENERATIONS), 1),
    "pga-fused": ("pga", dict(generations=GENERATIONS, eval="fused"), 1),
    "pca": ("pca", dict(PCA_SA), 2),
    "find-psa": ("find-psa", dict(SA), 3),
    "find-pga": ("find-pga", dict(generations=GENERATIONS), 3),
    "find-pca": ("find-pca", dict(PCA_SA), 3),
}
# The cases each world size runs: at 1 rank one of each algorithm and
# of find_mapping (each case costs the reference a few seconds'
# compile).
WORLD_CASES = {4: tuple(CASES), 1: ("psa-event", "pga-wide", "pca",
                                    "find-psa")}
# The reference's per-device GA body is ``genetic.breed`` whatever
# ``GAConfig.eval`` says, so its pga-fused is its pga-wide.
REFERENCE_CASE = {"pga-fused": "pga-wide"}


def run_case(name, mesh, C, M):
    """``(perm, f, hist)`` of one case as numpy, ``hist`` None for the
    ``find_mapping`` cases."""
    kind, kw, seed = CASES[name]
    key = keys.prng_key(seed)
    if kind == "psa":
        out = distributed.run_psa_mesh(C, M, key, annealing.SAConfig(**kw),
                                       mesh)
    elif kind == "pga":
        out = distributed.run_pga_mesh(C, M, key, genetic.GAConfig(**kw),
                                       mesh)
    elif kind == "pca":
        out = distributed.run_pca_mesh(C, M, key, composite.CompositeConfig(
            sa=annealing.SAConfig(**kw),
            ga=genetic.GAConfig(generations=PCA_GENERATIONS)), mesh)
    else:
        algorithm = kind.split("-")[1]
        sa = annealing.SAConfig(**kw) if algorithm != "pga" else None
        ga = None if algorithm == "psa" else genetic.GAConfig(
            **(kw if algorithm == "pga" else
               dict(generations=PCA_GENERATIONS)))
        res = mapping.find_mapping(C, M, algorithm, key=key, sa_cfg=sa,
                                   ga_cfg=ga, mesh=mesh)
        return res.perm, np.float32(res.objective), None
    p, f, h = out
    return p.cpu().numpy(), f.cpu().numpy(), h.cpu().numpy()


def all_cases(mesh):
    """Every case on this rank, one intra-op thread (four ranks share the
    host's cores)."""
    torch.set_num_threads(1)
    inst = instances.make_taie(ORDER)
    return {name: run_case(name, mesh, inst.C, inst.M)
            for name in WORLD_CASES[mesh.size()]}


def bad_axis(mesh):
    return distributed.run_psa_mesh(np.zeros((4, 4)), np.zeros((4, 4)),
                                    keys.prng_key(0), annealing.SAConfig(),
                                    mesh, axis="nope")
