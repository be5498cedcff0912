"""Mapping-service throughput on the port: batched engine vs the
sequential loop.

A resource manager receives a *stream* of mapping requests, and
dispatching a whole size bucket through one batched solve
(``annealing.run_psa_batch``: one leading instance axis over the
(processes, solvers) chain grid, one kernel launch per acceptance round
for the whole wave) is compared with solving the same instances one
``run_psa`` call at a time.  Both paths run the identical SA budget, so
the comparison is pure dispatch/batching efficiency; their objectives
must be equal (asserted).

With ``--mesh-shape N`` the same wave is also solved sharded over an
N-device instance mesh (``core.batch_sharded``; on the CPU N emulated
devices, on ``cuda`` at most the card count), its objectives asserted
equal to the batched solve's, and the results go under
``"throughput_mesh"``.

Results merge into ``BENCH_torch.json`` (``--json``) under the
``"throughput"`` key.

Usage (from the repo root):
    PYTHONPATH=src python -m benchmarks_torch.mapper_throughput
    PYTHONPATH=src python -m benchmarks_torch.mapper_throughput --dry-run
    PYTHONPATH=src python -m benchmarks_torch.mapper_throughput --dry-run --device cpu --mesh-shape 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import annealing, batch_sharded, keys
from repro_torch.serve.mapper import MapRequest, MappingEngine

try:                                     # package form (benchmarks_torch.run)
    from . import common
except ImportError:                      # direct script invocation
    import common


random_instance = common.random_instance


def pad_batch(insts, bucket, device):
    B = len(insts)
    Cs = np.zeros((B, bucket, bucket), np.float32)
    Ms = np.zeros((B, bucket, bucket), np.float32)
    nvs = np.zeros(B, np.int64)
    for i, (C, M) in enumerate(insts):
        n = C.shape[0]
        Cs[i, :n, :n] = C
        Ms[i, :n, :n] = M
        nvs[i] = n
    return (torch.as_tensor(Cs, device=device),
            torch.as_tensor(Ms, device=device),
            torch.as_tensor(nvs, device=device))


def bench(batch: int, n: int, bucket: int, cfg: annealing.SAConfig,
          num_processes: int, repeats: int, device=None, mesh=None):
    """Times of the sequential loop, the batched solve, the engine's
    flush and (with ``mesh``) the sharded solve, and the batched solve's
    objectives."""
    dev = common.device(device)
    insts = [random_instance(n, 100 + i) for i in range(batch)]
    ks = torch.stack([keys.prng_key(i) for i in range(batch)]).to(dev)
    Cs, Ms, nvs = pad_batch(insts, bucket, dev)

    # --- sequential baseline: one run_psa call per instance -------------
    def run_seq():
        outs = []
        for i in range(batch):
            p, f, _ = annealing.run_psa(Cs[i], Ms[i], ks[i], cfg,
                                        num_processes, n_valid=nvs[i],
                                        device=dev)
            outs.append((p, f))
        common.synchronize()
        return outs

    # --- batched: one run_psa_batch call for the whole bucket -----------
    def run_batch():
        out = annealing.run_psa_batch(Cs, Ms, ks, cfg, num_processes,
                                      n_valid=nvs, device=dev)
        common.synchronize()
        return out

    # --- mesh-sharded: same wave, instance axis over the mesh devices ---
    def run_sharded():
        out = batch_sharded.run_psa_batch_sharded(
            Cs, Ms, ks, cfg, num_processes, n_valid=nvs, mesh=mesh)
        common.synchronize()
        return out

    run_seq()                      # first use of every kernel before timing
    run_batch()
    t_sharded = None
    if mesh is not None:
        run_sharded()
        t_sharded = min(_timed(run_sharded) for _ in range(repeats))
    t_seq = min(_timed(run_seq) for _ in range(repeats))
    t_batch = min(_timed(run_batch) for _ in range(repeats))

    # --- engine end-to-end (queue + pad + dispatch + cache admin) -------
    def run_engine():
        eng = MappingEngine(buckets=(bucket,), num_processes=num_processes,
                            sa_cfg=cfg, polish_rounds=0, mesh=mesh,
                            device=None if mesh is not None else dev)
        for i, (C, M) in enumerate(insts):
            eng.submit(MapRequest(job_id=f"j{i}", C=C, M=M, seed=i))
        return eng.flush()
    run_engine()
    t_engine = min(_timed(run_engine) for _ in range(repeats))

    # equality: the batch axis changes throughput, not results
    seq_f = np.array([float(f) for _, f in run_seq()])
    batch_f = run_batch()[1].cpu().numpy()
    assert np.array_equal(seq_f, batch_f), (seq_f, batch_f)
    if mesh is not None:      # ...and neither does sharding the batch axis
        sharded_f = run_sharded()[1].cpu().numpy()
        assert np.array_equal(batch_f, sharded_f), (batch_f, sharded_f)
    return t_seq, t_batch, t_engine, t_sharded, batch_f


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--bucket", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--neighbors", type=int, default=16)
    ap.add_argument("--iters-per-exchange", type=int, default=5)
    ap.add_argument("--num-exchanges", type=int, default=3)
    ap.add_argument("--solvers", type=int, default=4)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--mesh-shape", type=int, default=None, metavar="N",
                    help="also time the wave sharded over an N-device "
                         "instance mesh (CPU: N emulated devices; cuda: at "
                         "most the card count)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--json", default=common.BENCH_JSON,
                    help="merge results into this JSON file ('' disables)")
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny shapes, one repeat: CI smoke test")
    args = ap.parse_args(argv)

    if args.dry_run:
        args.batch, args.n, args.bucket, args.repeats = 2, 8, 8, 1
        args.neighbors, args.iters_per_exchange = 4, 2
        args.num_exchanges, args.solvers = 2, 2
    if args.n > args.bucket:
        ap.error(f"--n {args.n} does not fit --bucket {args.bucket}")
    if args.batch < 1 or args.repeats < 1:
        ap.error("--batch and --repeats must be >= 1")

    mesh = common.instance_mesh(ap, args.mesh_shape, args.device)
    cfg = annealing.SAConfig(max_neighbors=args.neighbors,
                             iters_per_exchange=args.iters_per_exchange,
                             num_exchanges=args.num_exchanges,
                             solvers=args.solvers)
    t_seq, t_batch, t_engine, t_sharded, objectives = bench(
        args.batch, args.n, args.bucket, cfg, args.num_processes,
        args.repeats, device=args.device, mesh=mesh)
    B = args.batch
    print(f"instances: {B} x n={args.n} (bucket {args.bucket}), "
          f"SA budget: {cfg.max_neighbors} neighbors x "
          f"{cfg.iters_per_exchange} x {cfg.num_exchanges}, "
          f"{cfg.solvers} solvers x {args.num_processes} processes, "
          f"device {args.device}")
    print(f"sequential loop : {t_seq:.4f} s  ({B / t_seq:8.1f} mappings/s)")
    print(f"batched solve   : {t_batch:.4f} s  ({B / t_batch:8.1f} mappings/s)")
    if t_sharded is not None:
        print(f"sharded solve   : {t_sharded:.4f} s  "
              f"({B / t_sharded:8.1f} mappings/s)  "
              f"[{args.mesh_shape}-device mesh]")
    print(f"engine flush    : {t_engine:.4f} s  ({B / t_engine:8.1f} mappings/s)")
    print(f"speedup (batched vs sequential): {t_seq / t_batch:.2f}x")
    payload = {
        "config": {"batch": B, "n": args.n, "bucket": args.bucket,
                   "neighbors": cfg.max_neighbors,
                   "iters_per_exchange": cfg.iters_per_exchange,
                   "num_exchanges": cfg.num_exchanges,
                   "solvers": cfg.solvers,
                   "num_processes": args.num_processes,
                   "mesh_shape": args.mesh_shape,
                   "device": args.device,
                   "repeats": args.repeats, "dry_run": args.dry_run},
        "sequential_s": t_seq, "batched_s": t_batch,
        "engine_s": t_engine,
        "sequential_mappings_per_s": B / t_seq,
        "batched_mappings_per_s": B / t_batch,
        "engine_mappings_per_s": B / t_engine,
        "speedup_batched_vs_sequential": t_seq / t_batch,
        "objectives": objectives.tolist(),
    }
    if t_sharded is not None:
        payload["sharded_s"] = t_sharded
        payload["sharded_mappings_per_s"] = B / t_sharded
        payload["speedup_sharded_vs_batched"] = t_batch / t_sharded
    section = "throughput" if mesh is None else "throughput_mesh"
    if args.json:
        common.write_bench_json(args.json, section, payload)
        print(f"wrote {args.json} [{section}]")
    if args.dry_run:
        print("dry-run OK")
    return payload


if __name__ == "__main__":
    main()
