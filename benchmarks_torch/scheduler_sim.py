"""Scheduler replay + job-stream simulation over the port's mapping
service.

Default mode -- **trace replay** through the full control plane
(:class:`~repro_torch.serve.rm.ResourceManager`): a workload trace (synthetic
Poisson by default, or any SWF file via ``--trace PATH``) is replayed in
virtual time twice over the same cluster grid:

  * ``first_fit`` -- allocate-then-map the old way: one first-fit
    free-node subset per job, mapped after the fact;
  * ``co_opt``    -- allocate-*then*-map co-optimization: K candidate
    subsets (compact / slab / scatter) per job scored as ONE batched
    engine wave, argmin-objective candidate committed.

Reported per path: makespan, utilization, wait-time percentiles, mean
mapped QAP objective, and mapping wall time per wave; plus the headline
``objective_improvement`` of co_opt over first_fit.  Results are merged
into ``BENCH_torch.json`` under ``"scheduler_rm"``.  The
harness asserts every candidate wave rode at most one solver dispatch
via engine stats (``max_batches_per_wave``), not timing.

Legacy mode -- ``--stream`` runs the original wall-clock job-stream
benchmark (async futures+flusher vs sequential submit+flush per job)
and writes the ``"scheduler_sim"`` section; see ``run_stream``.  There
the timed paths run warm by default (``MappingEngine.warmup()`` runs one
dummy wave per bucket program, so every kernel has been used; an extra
``async_cold`` pass records what first-wave requests pay without it) --
``--no-warmup`` runs cold.

Engines run on ``--device`` (``cuda`` by default; ``cpu`` only when
asked for).  With ``--mesh-shape N`` engines dispatch their bucket waves
sharded over an N-device instance mesh (``core.batch_sharded``; on the
CPU N emulated devices, on ``cuda`` at most the card count) and results
land under ``"scheduler_rm_mesh"`` / ``"scheduler_sim_mesh"`` instead.

Usage (from the repo root):
    PYTHONPATH=src python -m benchmarks_torch.scheduler_sim              # replay
    PYTHONPATH=src python -m benchmarks_torch.scheduler_sim --trace x.swf
    PYTHONPATH=src python -m benchmarks_torch.scheduler_sim --stream     # legacy
    PYTHONPATH=src python -m benchmarks_torch.scheduler_sim --dry-run    # smoke
    PYTHONPATH=src python -m benchmarks_torch.scheduler_sim --dry-run --device cpu --mesh-shape 4
"""
from __future__ import annotations

import argparse
import heapq
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import annealing, instances
from repro_torch.serve.cluster import ClusterState
from repro_torch.serve.fleet import EngineFleet, FaultPlan
from repro_torch.serve.mapper import MapRequest, MappingEngine
from repro_torch.serve.rm import ResourceManager, RMJournal
from repro_torch.serve.trace import parse_swf, synthetic_trace

try:                                     # package form (benchmarks_torch.run)
    from . import common
except ImportError:                      # direct script invocation
    import common


@dataclass(frozen=True)
class Job:
    job_id: str
    size: int
    C: np.ndarray              # (size, size) flow matrix
    arrival_s: float           # offset from stream start
    run_s: float               # service time once mapped


def make_stream(num_jobs: int, sizes: Tuple[int, ...], weights: Tuple[float, ...],
                arrival_rate: float, run_s: float, seed: int) -> List[Job]:
    """Poisson arrivals, mixed job sizes, ring + random sparse flows."""
    rng = np.random.default_rng(seed)
    t = 0.0
    jobs = []
    for i in range(num_jobs):
        t += float(rng.exponential(1.0 / arrival_rate))
        n = int(rng.choice(sizes, p=np.asarray(weights) / sum(weights)))
        C = np.zeros((n, n), np.float32)
        for k in range(n):                         # heavy ring traffic
            C[k, (k + 1) % n] = C[(k + 1) % n, k] = 100.0
        extra = rng.random((n, n)) < 0.1           # sparse background flows
        C += np.triu(extra * rng.integers(1, 10, (n, n)), 1).astype(np.float32)
        C = np.triu(C, 1) + np.triu(C, 1).T
        jobs.append(Job(job_id=f"job{i}", size=n, C=C, arrival_s=t,
                        run_s=float(run_s * (0.5 + rng.random()))))
    return jobs


def _drain_completions(cluster: ClusterState, running: list,
                       now: float) -> None:
    while running and running[0][0] <= now:
        _, job_id = heapq.heappop(running)
        cluster.release(job_id)


def run_stream(jobs: List[Job], cluster: ClusterState, engine: MappingEngine,
               algorithm: str, deadline_ms: Optional[float],
               use_flusher: bool) -> Dict[str, float]:
    """Drive one full stream through allocate -> map -> run -> release."""
    running: list = []               # heap of (release_monotonic, job_id)
    in_flight: list = []             # (job, alloc, future, t_submit)
    latencies: Dict[str, float] = {}
    improvements: List[float] = []

    def settle(entry, block: bool) -> bool:
        job, alloc, fut, t_sub = entry
        if not block and not fut.done():
            return False
        resp = fut.result(timeout=600)
        resolved = fut.resolved_at or time.monotonic()
        latencies[job.job_id] = resolved - t_sub
        improvements.append(resp.improvement)
        # the job starts running when its mapping resolved, not when this
        # loop happened to poll -- otherwise the async path holds nodes an
        # extra inter-arrival gap and its throughput is underreported
        heapq.heappush(running, (resolved + job.run_s, job.job_id))
        return True

    t0 = time.monotonic()
    for job in jobs:
        # pace the Poisson stream in wall time
        lag = t0 + job.arrival_s - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        # admission: free nodes may be held by running jobs (wait for the
        # next completion) or by jobs whose mapping is still in flight
        # (wait for the future to resolve, then for the run to finish)
        while True:
            in_flight = [e for e in in_flight if not settle(e, block=False)]
            _drain_completions(cluster, running, time.monotonic())
            alloc = cluster.allocate(job.job_id, job.size)
            if alloc is not None:
                break
            if not running and not in_flight:
                raise RuntimeError(
                    f"{job.job_id} (size {job.size}) can never fit")
            if running:
                wait = max(running[0][0] - time.monotonic(), 0.0)
                time.sleep(min(wait + 1e-4, 0.02))
            else:
                time.sleep(0.002)
        t_sub = time.monotonic()
        fut = engine.submit(MapRequest(
            job_id=job.job_id, C=job.C, M=alloc.M_sub, algorithm=algorithm,
            seed=int(job.job_id[3:]), deadline_ms=deadline_ms))
        entry = (job, alloc, fut, t_sub)
        if use_flusher:
            in_flight.append(entry)
        else:
            engine.flush()               # the seed path: block per job
            settle(entry, block=True)
    for entry in in_flight:
        settle(entry, block=True)
    wall = time.monotonic() - t0
    while running:                       # let the last jobs finish
        _drain_completions(cluster, running, running[0][0])

    lat_ms = np.array(sorted(latencies.values())) * 1e3
    return {
        "jobs": len(jobs),
        "wall_s": wall,
        "mapped_jobs_per_s": len(jobs) / wall,
        "map_latency_p50_ms": float(np.percentile(lat_ms, 50)),
        "map_latency_p99_ms": float(np.percentile(lat_ms, 99)),
        "mean_improvement": float(np.mean(improvements)),
        "cache_hits": engine.stats.cache_hits,
        "warm_starts": engine.stats.warm_starts,
        "solver_batches": engine.stats.solver_batches,
        "deadline_flushes": engine.stats.deadline_flushes,
        "full_bucket_flushes": engine.stats.full_bucket_flushes,
    }


def load_trace(args, num_nodes: int):
    """Job specs for the replay: synthetic Poisson or an SWF file."""
    if args.trace == "synthetic":
        return synthetic_trace(args.jobs, sizes=tuple(args.sizes),
                               weights=tuple(args.weights),
                               arrival_rate=args.arrival_rate,
                               mean_run_s=max(args.run_s, 1e-3),
                               seed=args.seed)
    specs = parse_swf(args.trace, max_jobs=args.jobs)
    fitting = [s for s in specs if s.size <= num_nodes]
    if not fitting:
        raise SystemExit(f"no job in {args.trace} fits {num_nodes} nodes")
    if len(fitting) < len(specs):
        print(f"    skipped {len(specs) - len(fitting)} jobs larger than "
              f"the {num_nodes}-node cluster")
    return fitting


def run_replay(specs, M, mesh, sa_cfg, buckets, args) -> Dict[str, object]:
    """Replay the same specs through first-fit and co-optimized managers."""
    def fresh_engine():
        return MappingEngine(buckets=buckets, num_processes=2,
                             sa_cfg=sa_cfg,
                             polish_rounds=args.polish_rounds,
                             max_batch=args.max_batch, mesh=mesh,
                             device=args.device)

    out: Dict[str, object] = {}
    variants = (("first_fit", 1, ("first_fit",)),
                ("co_opt", args.candidates, tuple(args.policies)))
    for name, k, policies in variants:
        rm = ResourceManager(M, fresh_engine(), candidates=k,
                             policies=policies, algorithm=args.algorithm,
                             deadline_ms=args.deadline_ms)
        for s in specs:
            rm.submit_job(s)
        t0 = time.perf_counter()
        rep = rm.run()
        wall = time.perf_counter() - t0
        # single-dispatch waves, proven by engine stats (not timing): all
        # K candidates of a wave share one (bucket, algorithm, tier)
        # group, so one flush solves them in <= 1 batch
        assert rep.max_batches_per_wave <= 1, (
            f"{name}: a candidate wave split into "
            f"{rep.max_batches_per_wave} solver batches")
        out[name] = {**rep.asdict(), "wall_s": wall,
                     "solver_batches": rm.engine.stats.solver_batches,
                     "solver_calls": rm.engine.stats.solver_calls,
                     "cache_hits": rm.engine.stats.cache_hits}
        print(f"{name:>10}: makespan {rep.makespan_s:8.1f} s, "
              f"util {rep.utilization:5.1%}, "
              f"wait p50/p99 {rep.wait_p50_s:6.1f}/{rep.wait_p99_s:6.1f} s, "
              f"mean F {rep.mean_objective:10.1f}, "
              f"backfilled {rep.backfilled}, wall {wall:5.1f} s")
    base = out["first_fit"]["mean_objective"]
    coop = out["co_opt"]["mean_objective"]
    out["objective_improvement"] = (base - coop) / max(base, 1e-9)
    out["makespan_ratio"] = (out["first_fit"]["makespan_s"]
                             / max(out["co_opt"]["makespan_s"], 1e-9))
    print(f"allocate-then-map co-optimization: mean mapped objective "
          f"{coop:.1f} vs first-fit {base:.1f} "
          f"({out['objective_improvement']:+.1%})")
    return out


def run_fleet_replay(specs, M, sa_cfg, buckets, args) -> Dict[str, object]:
    """Fleet mode (``--workers N``): replay the same co-optimized trace
    through a single engine and through an :class:`EngineFleet` (thread
    or subprocess workers via ``--transport``); with ``--kill-one``,
    replay a third time while worker 0 is killed mid-wave (``--sigkill``
    makes that a real SIGKILL to a subprocess worker).  Proves (by
    assertion, not by eye) that no request is lost and every
    non-degraded mapping is bitwise-identical -- the kill only costs
    wall time for the re-solve.  The kill run writes an
    :class:`~repro_torch.serve.rm.RMJournal` and is replayed through
    :meth:`ResourceManager.recover`; the chaos metrics (degraded rate,
    recovery latency, journal-replay equality) land under ``"chaos"``.

    Each engine is warmed through its own transport
    (``warmup()``/``EngineFleet.warmup``) before its timed replay unless
    ``--no-warmup``, so the map-wall and makespan numbers are warm; the
    cold first-use cost lands in each run's ``warmup_s``.
    """
    def engine_kwargs():
        # warm_start off everywhere: fleet determinism requires solves to
        # be pure functions of the request (see serve/fleet.py), so the
        # single-engine baseline must match.
        return dict(buckets=buckets, num_processes=2, sa_cfg=sa_cfg,
                    polish_rounds=args.polish_rounds,
                    max_batch=args.max_batch, warm_start=False,
                    device=args.device)

    # Dies after completing candidates+1 requests: mid-second-wave, so
    # the kill provably exercises the requeue path (some of a dispatched
    # wave delivered, the rest recovered by another worker).
    kill_at = args.candidates + 1
    if args.sigkill:
        plan = FaultPlan(sigkill_worker_at={0: kill_at})
    else:
        plan = FaultPlan(kill_worker_at={0: kill_at})
    runs = [("single", lambda: MappingEngine(**engine_kwargs()))]
    runs.append(("fleet", lambda: EngineFleet(
        workers=args.workers, transport=args.transport,
        **engine_kwargs())))
    if args.kill_one:
        runs.append(("fleet_kill", lambda: EngineFleet(
            workers=args.workers, transport=args.transport,
            fault_plan=plan, **engine_kwargs())))

    journal_path = os.path.join(
        tempfile.mkdtemp(prefix="rm-journal-"), "rm.jsonl")
    out: Dict[str, object] = {}
    mappings: Dict[str, Dict[str, tuple]] = {}
    managers: Dict[str, ResourceManager] = {}
    for name, mk in runs:
        engine = mk()
        try:
            # Warm the bucket programs through the engine's own transport
            # (on the subprocess transport EngineFleet.warmup runs the
            # coordinator's engine, which builds the kernel libraries the
            # children load) BEFORE the timed replay, so the map-wall
            # percentiles measure mapping, not first use; the cold cost
            # is recorded separately as warmup_s.
            warmup_s = warmup_programs = None
            if args.warmup:
                policy = (engine._proto.policy
                          if isinstance(engine, EngineFleet)
                          else engine.policy)
                algo, tier = policy.resolve(args.algorithm,
                                            args.deadline_ms)
                t_w = time.perf_counter()
                warmup_programs = engine.warmup(algorithms=(algo,),
                                                tiers=(tier,))
                warmup_s = time.perf_counter() - t_w
                print(f"{name:>10}: warmed {warmup_programs} programs "
                      f"({algo}/{tier}) in {warmup_s:.1f}s")
            rm = ResourceManager(
                M, engine, candidates=args.candidates,
                policies=tuple(args.policies),
                algorithm=args.algorithm,
                deadline_ms=args.deadline_ms,
                journal=journal_path if name == "fleet_kill" else None)
            for s in specs:
                rm.submit_job(s)
            t0 = time.perf_counter()
            rep = rm.run()
            wall = time.perf_counter() - t0
        finally:
            if isinstance(engine, EngineFleet):
                engine.stop()
        if rm._journal is not None:
            rm._journal.close()
        managers[name] = rm
        # zero lost requests: every job finished with a mapping
        assert rep.jobs == len(specs), (
            f"{name}: {len(specs) - rep.jobs} jobs never finished")
        assert all(h.response is not None for h in rm.handles), (
            f"{name}: a job finished without a mapping")
        # a kill may re-solve one wave on a second worker; anything more
        # means batching broke
        limit = 2 if name == "fleet_kill" else 1
        assert rep.max_batches_per_wave <= limit, (
            f"{name}: a candidate wave took "
            f"{rep.max_batches_per_wave} solver batches (limit {limit})")
        # degraded responses (deadline fallbacks) are flagged and exempt
        # from the bitwise contract; everything else must match exactly
        mappings[name] = {
            h.job_id: (h.response.perm.tolist(), h.response.objective)
            for h in rm.handles if not h.response.degraded}
        entry = {**rep.asdict(), "wall_s": wall,
                 "mapped_jobs_per_s": len(specs) / max(wall, 1e-9),
                 "timed_warm": bool(args.warmup),
                 "warmup_s": warmup_s,
                 "warmup_programs": warmup_programs}
        if isinstance(engine, EngineFleet):
            st = engine.stats
            entry.update(requeued=st.requeued,
                         worker_deaths=st.worker_deaths,
                         respawns=st.respawns,
                         duplicate_results=st.duplicate_results,
                         dispatched_waves=st.dispatched_waves,
                         solver_batches=st.solver_batches,
                         cache_hits=st.cache_hits,
                         degraded=st.degraded,
                         breaker_trips=st.breaker_trips,
                         first_recovery_s=st.first_recovery_s)
        out[name] = entry
        extra = ""
        if isinstance(engine, EngineFleet):
            extra = (f", deaths {engine.stats.worker_deaths}, "
                     f"requeued {engine.stats.requeued}")
        print(f"{name:>10}: makespan {rep.makespan_s:8.1f} s, "
              f"{entry['mapped_jobs_per_s']:6.2f} mapped-jobs/s, "
              f"wall {wall:5.1f} s{extra}")
    # bitwise equality: same perm and objective per job across every run
    # (degraded mappings, if a --deadline-ms was set, are exempt but
    # counted)
    base = mappings["single"]
    for name, got in mappings.items():
        for jid, pair in got.items():
            assert pair == base[jid], (
                f"{name}: mapping for {jid} differs from the "
                f"single-engine replay")
    out["bitwise_equal"] = True
    out["zero_lost"] = True
    if args.kill_one:
        assert out["fleet_kill"]["worker_deaths"] >= 1
        assert out["fleet_kill"]["requeued"] >= 1, (
            "the kill never exercised the requeue path")
        out["recovered_ratio"] = (
            out["fleet_kill"]["mapped_jobs_per_s"]
            / max(out["single"]["mapped_jobs_per_s"], 1e-9))
        print(f"kill-one recovery: {out['fleet_kill']['requeued']} "
              f"requests requeued, throughput "
              f"{out['recovered_ratio']:.2f}x of the single engine, "
              f"results bitwise-equal")
        out["chaos"] = _chaos_metrics(M, journal_path,
                                      managers["fleet_kill"], args)
    return out


def _chaos_metrics(M, journal_path: str, rm_kill: ResourceManager,
                   args) -> Dict[str, object]:
    """Chaos accounting for the kill run: degraded-response rate,
    recovery latency (kill -> first requeued request resolved), and
    journal-recovery equality -- :meth:`ResourceManager.recover` replayed
    from the kill run's journal must reproduce its exact completed-job
    set and ``ClusterState`` occupancy."""
    st = rm_kill.engine.stats
    degraded_rate = st.degraded / max(st.resolved, 1)
    rec = ResourceManager.recover(M, journal_path,
                                  MappingEngine(device=args.device))
    done_orig = sorted(h.job_id for h in rm_kill.handles if h.done())
    done_rec = sorted(h.job_id for h in rec.handles if h.done())
    occupancy_equal = (rec.cluster.num_free == rm_kill.cluster.num_free
                       and rec.clock == rm_kill.clock)
    assert done_rec == done_orig, (
        "journal recovery lost or invented completed jobs")
    assert occupancy_equal, "journal recovery occupancy mismatch"
    chaos = {
        "transport": args.transport,
        "fault": "sigkill" if args.sigkill else "exit",
        "degraded_responses": st.degraded,
        "degraded_rate": degraded_rate,
        "recovery_latency_s": st.first_recovery_s,
        "journal_events": len(RMJournal.read_events(journal_path)),
        "journal_recovery_equal": True,
        "recovered_completed_jobs": len(done_rec),
    }
    lat = ("n/a" if st.first_recovery_s is None
           else f"{st.first_recovery_s * 1e3:.0f} ms")
    print(f"chaos: degraded rate {degraded_rate:.1%}, recovery latency "
          f"{lat}, journal recovery reproduced "
          f"{len(done_rec)}/{len(done_orig)} completed jobs exactly")
    return chaos


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--jobs", type=int, default=50)
    ap.add_argument("--stream", action="store_true",
                    help="run the legacy wall-clock job-stream benchmark "
                         "(async vs sequential) instead of the RM replay")
    ap.add_argument("--trace", default="synthetic", metavar="SRC",
                    help="replay source: 'synthetic' (default) or an SWF "
                         "file path")
    ap.add_argument("--candidates", type=int, default=3,
                    help="candidate allocations scored per job (replay)")
    ap.add_argument("--policies", nargs="+",
                    default=("compact", "slab", "scatter"),
                    help="candidate carving policies (replay co_opt path)")
    ap.add_argument("--grid", type=int, nargs=3, default=(4, 4, 8),
                    metavar=("X", "Y", "Z"), help="cluster node grid")
    ap.add_argument("--sizes", type=int, nargs="+", default=(8, 16, 24, 32))
    ap.add_argument("--weights", type=float, nargs="+",
                    default=(4.0, 3.0, 2.0, 1.0))
    ap.add_argument("--arrival-rate", type=float, default=40.0,
                    help="Poisson arrivals per second")
    ap.add_argument("--run-s", type=float, default=0.1,
                    help="mean job service time after mapping")
    ap.add_argument("--algorithm", default="psa")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline for the engine's policy")
    ap.add_argument("--flush-deadline-ms", type=float, default=30.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--neighbors", type=int, default=24)
    ap.add_argument("--iters-per-exchange", type=int, default=12)
    ap.add_argument("--num-exchanges", type=int, default=6)
    ap.add_argument("--solvers", type=int, default=8)
    ap.add_argument("--polish-rounds", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=None, metavar="N",
                    help="replay through an N-worker EngineFleet (plus a "
                         "single-engine baseline) and assert bitwise-equal "
                         "mappings; results land under 'fleet'")
    ap.add_argument("--kill-one", action="store_true",
                    help="with --workers: replay a third time while worker "
                         "0 is killed mid-wave, asserting zero lost "
                         "requests and recovered throughput; the kill run "
                         "is journaled and replayed through "
                         "ResourceManager.recover (chaos metrics)")
    ap.add_argument("--transport", choices=("thread", "subprocess"),
                    default="thread",
                    help="fleet worker backing: in-process threads "
                         "(default) or isolated subprocess workers")
    ap.add_argument("--sigkill", action="store_true",
                    help="with --kill-one --transport subprocess: the "
                         "worker SIGKILLs itself (real hard death) "
                         "instead of exiting cleanly")
    ap.add_argument("--mesh-shape", type=int, default=None, metavar="N",
                    help="shard bucket waves over an N-device instance "
                         "mesh (CPU: N emulated devices; cuda: at most "
                         "the card count)")
    ap.add_argument("--device", default="cuda",
                    help="engines' device: 'cuda' (default) or 'cpu'")
    ap.add_argument("--json", default=common.BENCH_JSON,
                    help="merge results into this JSON file ('' disables)")
    ap.add_argument("--warmup", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="warm bucket programs via "
                         "MappingEngine.warmup() before the timed streams "
                         "(an extra cold async pass is measured first, so "
                         "the JSON records warm-vs-cold p99); --no-warmup "
                         "runs everything cold")
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny stream + cluster: CI smoke test")
    args = ap.parse_args(argv)

    if args.dry_run:
        # 16 nodes hosting a few jobs at once (single size bucket), so
        # same-bucket arrivals actually coalesce into batched dispatches
        args.jobs, args.grid = 8, (2, 2, 4)
        args.sizes, args.weights = (6, 8), (3.0, 1.0)
        args.arrival_rate, args.run_s = 200.0, 0.02
        args.neighbors, args.iters_per_exchange = 4, 2
        args.num_exchanges, args.solvers, args.polish_rounds = 2, 2, 4
        args.max_batch = 4
    if len(args.sizes) != len(args.weights):
        ap.error("--sizes and --weights must have the same length")
    if args.kill_one and args.workers is None:
        ap.error("--kill-one requires --workers N")
    if args.sigkill and not args.kill_one:
        ap.error("--sigkill requires --kill-one")
    if args.sigkill and args.transport != "subprocess":
        ap.error("--sigkill requires --transport subprocess (threads "
                 "cannot be SIGKILLed individually)")
    if args.workers is not None and args.stream:
        ap.error("--workers is a replay mode; drop --stream")
    if args.workers is not None and args.workers < 1:
        ap.error("--workers must be >= 1")

    M = instances.grid_distance_matrix(tuple(args.grid))
    if max(args.sizes) > M.shape[0]:
        ap.error(f"largest job ({max(args.sizes)}) exceeds cluster "
                 f"({M.shape[0]} nodes)")
    mesh = common.instance_mesh(ap, args.mesh_shape, args.device)
    sa_cfg = annealing.SAConfig(max_neighbors=args.neighbors,
                                iters_per_exchange=args.iters_per_exchange,
                                num_exchanges=args.num_exchanges,
                                solvers=args.solvers)
    if args.workers is not None:
        specs = load_trace(args, M.shape[0])
        buckets = tuple(sorted(set(
            max(4, int(2 ** np.ceil(np.log2(max(s.size, 2)))))
            for s in specs)))
        kill_word = " SIGKILLing" if args.sigkill else ", killing"
        print(f"fleet replay: {len(specs)} jobs over {M.shape[0]} nodes, "
              f"{args.workers} {args.transport} workers on {args.device}"
              + (f"{kill_word} worker 0 mid-wave" if args.kill_one else ""))
        out = run_fleet_replay(specs, M, sa_cfg, buckets, args)
        chaos = out.pop("chaos", None)
        payload = {
            "config": {"jobs": len(specs), "grid": list(args.grid),
                       "trace": args.trace,
                       "workers": args.workers,
                       "transport": args.transport,
                       "kill_one": args.kill_one,
                       "sigkill": args.sigkill,
                       "kill_at": args.candidates + 1,
                       "candidates": args.candidates,
                       "policies": list(args.policies),
                       "algorithm": args.algorithm,
                       "max_batch": args.max_batch,
                       "device": args.device,
                       "dry_run": args.dry_run},
            **out,
        }
        if args.json:
            common.write_bench_json(args.json, "fleet", payload)
            sections = "[fleet]"
            if chaos is not None:
                common.write_bench_json(args.json, "chaos", chaos)
                sections = "[fleet, chaos]"
            print(f"wrote {args.json} {sections}")
        if args.dry_run:
            print("dry-run OK")
        return {"fleet": payload, "chaos": chaos}

    if not args.stream:
        specs = load_trace(args, M.shape[0])
        buckets = tuple(sorted(set(
            max(4, int(2 ** np.ceil(np.log2(max(s.size, 2)))))
            for s in specs)))
        print(f"replaying {len(specs)} jobs over {M.shape[0]} nodes "
              f"({args.grid[0]}x{args.grid[1]}x{args.grid[2]}), "
              f"{args.candidates} candidates/{'+'.join(args.policies)}, "
              f"engines on {args.device}"
              + (f", waves sharded over a {args.mesh_shape}-device mesh"
                 if mesh is not None else ""))
        out = run_replay(specs, M, mesh, sa_cfg, buckets, args)
        section = "scheduler_rm" if mesh is None else "scheduler_rm_mesh"
        payload = {
            "config": {"jobs": len(specs), "grid": list(args.grid),
                       "trace": args.trace,
                       "sizes": list(args.sizes),
                       "arrival_rate": args.arrival_rate,
                       "run_s": args.run_s,
                       "algorithm": args.algorithm,
                       "deadline_ms": args.deadline_ms,
                       "candidates": args.candidates,
                       "policies": list(args.policies),
                       "max_batch": args.max_batch,
                       "mesh_shape": args.mesh_shape,
                       "device": args.device,
                       "dry_run": args.dry_run},
            **out,
        }
        if args.json:
            common.write_bench_json(args.json, section, payload)
            print(f"wrote {args.json} [{section}]")
        if args.dry_run:
            print("dry-run OK")
        return {section: payload}

    jobs = make_stream(args.jobs, tuple(args.sizes), tuple(args.weights),
                       args.arrival_rate, args.run_s, args.seed)
    buckets = tuple(sorted(set(int(2 ** np.ceil(np.log2(s)))
                               for s in args.sizes)))

    def fresh_engine():
        return MappingEngine(buckets=buckets, num_processes=2,
                             sa_cfg=sa_cfg, polish_rounds=args.polish_rounds,
                             flush_deadline_ms=args.flush_deadline_ms,
                             max_batch=args.max_batch, mesh=mesh,
                             device=args.device)

    print(f"{args.jobs} jobs over {M.shape[0]} nodes "
          f"({args.grid[0]}x{args.grid[1]}x{args.grid[2]}), sizes "
          f"{tuple(args.sizes)}, {args.arrival_rate}/s arrivals, engines on "
          f"{args.device}"
          + (f", waves sharded over a {args.mesh_shape}-device mesh"
             if mesh is not None else ""))

    results = {}

    def measure(name, use_flusher):
        eng = fresh_engine()
        cluster = ClusterState(M)
        if use_flusher:
            eng.start()
        try:
            results[name] = run_stream(jobs, cluster, eng, args.algorithm,
                                       args.deadline_ms, use_flusher)
        finally:
            if use_flusher:
                eng.stop()
        r = results[name]
        print(f"{name:>10}: {r['mapped_jobs_per_s']:7.2f} mapped-jobs/s, "
              f"p50 {r['map_latency_p50_ms']:7.1f} ms, "
              f"p99 {r['map_latency_p99_ms']:7.1f} ms, "
              f"batches {r['solver_batches']}, warm {r['warm_starts']}")

    # Warmup: MappingEngine.warmup() runs one dummy wave per (bucket, wave
    # size, warm-start presence) program the timed paths can dispatch --
    # for exactly the (algorithm, budget tier) the deadline policy
    # resolves for this stream -- so neither timed path pays first use.
    # An async pass on a fresh engine that was never warmed is measured
    # first: its p99 is what first-wave requests pay without warmup.  The
    # reference switches JAX's persistent compilation cache off around
    # this pass; the port has no such cache (its kernels are built once
    # per checkout and loaded by every engine), so its cold pass is a
    # fresh engine without warmup(), run before any other engine here.
    warmup_info = {"enabled": bool(args.warmup)}
    if args.warmup:
        measure("async_cold", True)
        warm_eng = fresh_engine()
        algo, tier = warm_eng.policy.resolve(args.algorithm,
                                             args.deadline_ms)
        t0 = time.perf_counter()
        warmup_info["programs"] = warm_eng.warmup(algorithms=(algo,),
                                                  tiers=(tier,))
        warmup_info["seconds"] = time.perf_counter() - t0
        print(f"    warmup: {warmup_info['programs']} programs "
              f"({algo}/{tier}) in {warmup_info['seconds']:.1f}s")

    for name, use_flusher in (("sequential", False), ("async", True)):
        measure(name, use_flusher)
    if args.warmup:
        cold = results["async_cold"]["map_latency_p99_ms"]
        warm_p99 = results["async"]["map_latency_p99_ms"]
        warmup_info["p99_cold_ms"] = cold
        warmup_info["p99_warm_ms"] = warm_p99
        warmup_info["p99_cold_over_warm"] = cold / max(warm_p99, 1e-9)
        print(f"    p99 cold {cold:.1f} ms -> warm {warm_p99:.1f} ms "
              f"({warmup_info['p99_cold_over_warm']:.1f}x)")

    speedup = (results["async"]["mapped_jobs_per_s"]
               / results["sequential"]["mapped_jobs_per_s"])
    print(f"async vs sequential throughput: {speedup:.2f}x")

    payload = {
        "config": {"jobs": args.jobs, "grid": list(args.grid),
                   "sizes": list(args.sizes),
                   "arrival_rate": args.arrival_rate,
                   "run_s": args.run_s, "algorithm": args.algorithm,
                   "deadline_ms": args.deadline_ms,
                   "flush_deadline_ms": args.flush_deadline_ms,
                   "max_batch": args.max_batch,
                   "mesh_shape": args.mesh_shape,
                   "device": args.device,
                   "dry_run": args.dry_run},
        "sequential": results["sequential"],
        "async": results["async"],
        "throughput_speedup": speedup,
        "warmup": warmup_info,
    }
    if "async_cold" in results:
        payload["async_cold"] = results["async_cold"]
    section = "scheduler_sim" if mesh is None else "scheduler_sim_mesh"
    if args.json:
        common.write_bench_json(args.json, section, payload)
        print(f"wrote {args.json} [{section}]")
    if args.dry_run:
        print("dry-run OK")
    return {section: payload}


if __name__ == "__main__":
    main()
