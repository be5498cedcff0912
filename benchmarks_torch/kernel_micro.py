"""Kernel microbenchmarks of the port: QAP objective / swap-delta /
fused-step throughput through ``repro_torch.kernels.ops``.

On the card each call launches the hand-written kernel (K2 objective, K1
delta, K4 SA step, K5 GA step; orders 343 and 729 take the L2 branches);
on the CPU the same calls run the kernels' plain PyTorch versions, as the
reference's timed CPU path is its ``ref.*`` functions.  The objective row
reports, beside the achieved element rate, the H100's least time for the
call (bytes read once over 3.35 TB/s, or f32 operations over 67 TFLOP/s).

Besides the CSV rows consumed by ``benchmarks_torch/run.py``, results
merge into ``BENCH_torch.json`` under ``"kernel_micro"``.

Usage (from the repo root):
    PYTHONPATH=src python -m benchmarks_torch.kernel_micro [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import keys, qap
from repro_torch.kernels import ops

try:                                     # package form (benchmarks_torch.run)
    from . import common
except ImportError:                      # direct script invocation
    import common

SHAPES = ((125, 64), (343, 64), (729, 32))
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_PER_S = 67e12           # f32 outside the tensor cores


def objective_bound_us(n: int, batch: int) -> float:
    """The H100's least time for ``batch`` objectives of order ``n``."""
    nbytes = 4 * (2 * n * n + batch * n + batch)
    return max(nbytes / H100_BYTES_PER_S,
               2 * batch * n * n / H100_F32_PER_S) * 1e6


def run(json_path: str | None = common.BENCH_JSON, device=None) -> list:
    dev = common.device(device)
    rows = []
    payload = {
        "config": {"device": dev.type,
                   "device_name": (torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else "cpu")},
        "objective": {}, "delta": {}, "sa_step": {}, "ga_step": {},
    }
    rng = np.random.default_rng(0)
    for n, batch in SHAPES:
        C = torch.as_tensor(rng.integers(0, 50, (n, n)), dtype=torch.float32,
                            device=dev)
        M = torch.as_tensor(rng.integers(0, 20, (n, n)), dtype=torch.float32,
                            device=dev)
        CT, MT = ops.transposes(C, M)
        perms = qap.random_permutations(keys.prng_key(0, dev), batch, n)
        t, _ = common.time_fn(ops.qap_objective, C, M, perms[None])
        elems = batch * n * n
        rows.append(common.csv_row(
            f"kernel.objective.n={n}.b={batch}", t / batch * 1e6,
            f"gelem_s={elems/t/1e9:.2f};"
            f"bound_us={objective_bound_us(n, batch):.1f}"))
        payload["objective"][f"n={n}"] = {
            "batch": batch,
            "us_per_eval": t / batch * 1e6,
            "candidate_evals_per_s": batch / t,
        }

        p = perms[:1]
        pairs = qap.random_swap_pairs(keys.prng_key(1, dev), 256, n)[None]
        t, _ = common.time_fn(ops.qap_delta, C, M, p, pairs, CT, MT)
        rows.append(common.csv_row(
            f"kernel.delta.n={n}.k=256", t / 256 * 1e6,
            f"gelem_s={256*n/t/1e9:.3f};onchip=O(N)/swap"))
        payload["delta"][f"n={n}"] = {
            "k": 256,
            "us_per_eval": t / 256 * 1e6,
            "candidate_evals_per_s": 256 / t,
        }

        # Fused SA temperature step (K4): one launch decides
        # max_neighbors candidates per chain.
        chains, k, max_success = 16, 50, 5
        f0 = ops.qap_objective(C, M, perms[None, :chains])[0]
        temps = torch.full((chains,), float(f0.std(correction=0)) + 1.0,
                           dtype=torch.float32, device=dev)
        sa_keys = keys.split(keys.prng_key(2, dev), chains)
        nvs = torch.full((chains,), n, dtype=torch.int32, device=dev)
        sa = lambda p_, f_, ks: ops.qap_sa_step(
            C, M, p_, f_, p_, f_, temps, ks, nvs,
            max_neighbors=k, max_success=max_success, CT=CT, MT=MT)
        t, _ = common.time_fn(sa, perms[:chains].contiguous(), f0, sa_keys)
        rows.append(common.csv_row(
            f"kernel.sa_step.n={n}.chains={chains}", t / chains * 1e6,
            f"cand_evals_s={chains*k/t/1e9:.4f}e9;launches=1/step"))
        payload["sa_step"][f"n={n}"] = {
            "chains": chains, "max_neighbors": k,
            "us_per_step": t / chains * 1e6,
            "candidate_evals_per_s": chains * k / t,
        }

        # Fused GA generation step (K5): one launch breeds + scores +
        # replaces n_off offspring per island.
        islands, pop_size, n_off = 4, 16, 8
        pops = torch.stack([qap.random_permutations(
            keys.prng_key(10 + i, dev), pop_size, n) for i in range(islands)])
        fits = ops.qap_objective(C, M, pops)
        gkeys = keys.split(keys.prng_key(3, dev), islands)
        gnvs = torch.full((islands,), n, dtype=torch.int32, device=dev)
        ga = lambda pp, ff, ks: ops.qap_ga_step(
            C, M, pp, ff, ks, gnvs, n_off=n_off, tournament=3,
            p_crossover=0.8, p_mutation=0.2)
        t, _ = common.time_fn(ga, pops, fits, gkeys)
        rows.append(common.csv_row(
            f"kernel.ga_step.n={n}.islands={islands}",
            t / islands * 1e6,
            f"offspring_evals_s={islands*n_off/t:.1f};launches=1/gen"))
        payload["ga_step"][f"n={n}"] = {
            "islands": islands, "n_offspring": n_off,
            "us_per_generation": t / islands * 1e6,
            "candidate_evals_per_s": islands * n_off / t,
        }
    if json_path:
        common.write_bench_json(json_path, "kernel_micro", payload)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", default=common.BENCH_JSON)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    for row in run(args.json, args.device):
        print(row, flush=True)
    print(f"wrote {args.json} [kernel_micro]")


if __name__ == "__main__":
    main()
