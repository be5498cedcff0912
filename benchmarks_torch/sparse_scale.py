"""Sparse + multilevel scaling on the port: solve latency and quality vs
n and density.

Two sweeps, both on the known-optimum torus instances
(``core.exact.make_torus`` -- density O(1/n), optimum F0 = sum(C) exact):

1. **Evaluation throughput**: the dense objective/delta dispatches (K2 /
   K1 on the card; above order 169 their L2 branches) vs the sparse ones
   (``kernels.ops.qap_objective_sparse`` / ``qap_delta_sparse``, K6 / K7)
   on the same instances -- the O(n^2) -> O(nnz) per-evaluation claim.
2. **Multilevel end-to-end**: ``core.multilevel.solve_multilevel``
   (heavy-edge coarsening, dense coarse solve, warm-started sparse
   refinement per level) at orders up to 4096, recording wall latency
   and solution quality ``F / F0`` against the known optimum.

Results merge into ``BENCH_torch.json`` under ``"sparse_scale"``.

Usage (from the repo root):
    PYTHONPATH=src python -m benchmarks_torch.sparse_scale [--device cpu]
    PYTHONPATH=src python -m benchmarks_torch.sparse_scale --dry-run
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import annealing, exact, keys, multilevel, sparse
from repro_torch.kernels import ops

try:                                     # package form (benchmarks_torch.run)
    from . import common
except ImportError:                      # direct script invocation
    import common


# Torus factorisations for the sweep orders (any further order falls back
# to the flattest 2-factor split).
TORUS_DIMS = {
    64: (8, 8), 128: (8, 16), 256: (16, 16), 512: (8, 8, 8),
    1024: (32, 32), 2048: (32, 64), 4096: (16, 16, 16),
}


def torus_dims(n: int):
    if n in TORUS_DIMS:
        return TORUS_DIMS[n]
    for a in range(int(np.sqrt(n)), 0, -1):
        if n % a == 0:
            return (a, n // a)
    return (n,)


def bench_eval(n: int, perms_batch: int, pairs_batch: int, seed: int = 0,
               device=None):
    """Dense-vs-sparse evaluation throughput on one torus instance."""
    dev = common.device(device)
    inst = exact.make_torus(torus_dims(n))
    C = torch.as_tensor(inst.C, device=dev)
    M = torch.as_tensor(inst.M, device=dev)
    CT, MT = ops.transposes(C, M)
    S = sparse.from_dense(inst.C, device=dev)
    rng = np.random.default_rng(seed)
    perms = torch.as_tensor(np.stack([rng.permutation(n)
                                      for _ in range(perms_batch)]),
                            dtype=torch.int32, device=dev)[None]
    p = perms[:, 0].contiguous()
    pairs = torch.as_tensor(rng.integers(0, n, (pairs_batch, 2)),
                            dtype=torch.int32, device=dev)[None]

    t_do, f_d = common.time_fn(ops.qap_objective, C, M, perms)
    t_so, f_s = common.time_fn(ops.qap_objective_sparse, S, M, perms)
    assert torch.equal(f_d, f_s), "sparse objective diverged from dense"
    t_dd, d_d = common.time_fn(ops.qap_delta, C, M, p, pairs, CT, MT)
    t_sd, d_s = common.time_fn(ops.qap_delta_sparse, S, M, p, pairs)
    assert torch.equal(d_d, d_s), "sparse delta diverged from dense"
    nnz = int(S.nnz())
    return {
        "n": n, "nnz": nnz, "density": nnz / (n * n),
        "max_degree": int(S.max_degree),
        "perms": perms_batch, "pairs": pairs_batch,
        "dense_objective_s": t_do, "sparse_objective_s": t_so,
        "dense_objective_evals_per_s": perms_batch / t_do,
        "sparse_objective_evals_per_s": perms_batch / t_so,
        "objective_speedup": t_do / t_so,
        "dense_delta_s": t_dd, "sparse_delta_s": t_sd,
        "dense_delta_evals_per_s": pairs_batch / t_dd,
        "sparse_delta_evals_per_s": pairs_batch / t_sd,
        "delta_speedup": t_dd / t_sd,
    }


def bench_multilevel(n: int, cfg: multilevel.MultilevelConfig, seed: int = 0,
                     device=None):
    """End-to-end multilevel solve on a known-optimum torus instance."""
    inst = exact.make_torus(torus_dims(n))
    res = multilevel.solve_multilevel(inst.C, inst.M, keys.prng_key(seed),
                                      cfg, device=common.device(device))
    baseline = float((inst.C.astype(np.float64)
                      * inst.M.astype(np.float64)).sum())   # identity placement
    for lv in res.levels:           # the guarantee the pipeline rests on
        assert lv.f_refined <= lv.f_prolonged, lv
    nnz = int((inst.C != 0).sum())
    return {
        "n": n, "nnz": nnz, "density": nnz / (n * n),
        "seconds": res.seconds,
        "objective": res.objective, "optimum": inst.optimum,
        "baseline_identity": baseline,
        "quality": res.objective / inst.optimum,
        "improvement_vs_identity": baseline / res.objective,
        "coarse_objective": res.coarse_objective,
        "levels": [{"n": lv.n, "nnz": lv.nnz,
                    "f_prolonged": lv.f_prolonged,
                    "f_refined": lv.f_refined} for lv in res.levels],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--eval-sizes", type=int, nargs="+",
                    default=[256, 512, 1024, 4096])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[512, 1024, 4096],
                    help="multilevel end-to-end orders")
    ap.add_argument("--perms", type=int, default=8,
                    help="objective evaluation batch")
    ap.add_argument("--pairs", type=int, default=256,
                    help="delta evaluation batch")
    ap.add_argument("--coarse-n", type=int, default=64)
    ap.add_argument("--refine-exchanges", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--json", default=common.BENCH_JSON,
                    help="merge results into this JSON file ('' disables)")
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny shapes: CI smoke test")
    args = ap.parse_args(argv)

    if args.dry_run:
        args.eval_sizes, args.sizes = [64], [64]
        args.perms, args.pairs, args.coarse_n = 2, 16, 16
        args.refine_exchanges = 2

    cfg = multilevel.MultilevelConfig(
        coarse_n=args.coarse_n,
        refine_sa=annealing.SAConfig(
            max_neighbors=16, iters_per_exchange=8,
            num_exchanges=args.refine_exchanges, solvers=2, flows="sparse"))

    evals = []
    for n in args.eval_sizes:
        e = bench_eval(n, args.perms, args.pairs, device=args.device)
        evals.append(e)
        print(f"eval n={n:5d} density={e['density']:.4f}  "
              f"objective {e['dense_objective_evals_per_s']:8.1f} -> "
              f"{e['sparse_objective_evals_per_s']:8.1f} evals/s "
              f"({e['objective_speedup']:.2f}x)  "
              f"delta {e['dense_delta_evals_per_s']:8.1f} -> "
              f"{e['sparse_delta_evals_per_s']:8.1f} evals/s "
              f"({e['delta_speedup']:.2f}x)")

    solves = []
    for n in args.sizes:
        m = bench_multilevel(n, cfg, device=args.device)
        solves.append(m)
        print(f"multilevel n={n:5d}: {m['seconds']:7.1f}s  "
              f"F={m['objective']:.0f}  F0={m['optimum']:.0f}  "
              f"quality={m['quality']:.3f}  "
              f"identity/F={m['improvement_vs_identity']:.2f}x  "
              f"levels={[lv['n'] for lv in m['levels']]}")

    payload = {
        "config": {"eval_sizes": args.eval_sizes, "sizes": args.sizes,
                   "perms": args.perms, "pairs": args.pairs,
                   "coarse_n": args.coarse_n,
                   "refine_exchanges": args.refine_exchanges,
                   "device": args.device, "dry_run": args.dry_run},
        "eval": evals,
        "multilevel": solves,
    }
    if args.json:
        common.write_bench_json(args.json, "sparse_scale", payload)
        print(f"wrote {args.json} [sparse_scale]")
    if args.dry_run:
        print("dry-run OK")
    return payload


if __name__ == "__main__":
    main()
