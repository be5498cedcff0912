"""Solver hot-loop microbenchmarks on the port: the batched loops against
the sequential ones they replace.

``sa`` mode -- acceptance-event loop vs sequential candidate scan.  The
event loop (``SAConfig(loop="event")``, the default) scores every
remaining candidate of a temperature level in one ``kernels.ops.
qap_delta`` call (kernel K1 on the card) and applies the first accepted
one; the scan (``loop="scan"``) tests the candidates one by one.  Timed:
per-temperature-step latency and candidates decided per second over a
chain grid, at a hot start (fresh chains at T0) and after a full cooling
run, plus end-to-end ``run_psa_batch`` waves at the engine's default
budget.

``ga`` mode -- wide generation vs per-island generation.  The wide step
(``GAConfig(eval="wide")``, the default) runs selection, crossover and
mutation over every island at once and scores all offspring in one
``kernels.ops.qap_objective`` call (K2); ``eval="island"`` is the
seed-era golden reference.  Timed: full ``run_pga`` solves and
end-to-end ``run_pga_batch`` waves at the engine's default GA budget.

``--loop fused`` -- the fused steps vs the unfused counter-stream loops:
``SAConfig(loop="fused")`` runs a whole temperature step as one launch
(K4) and ``GAConfig(eval="fused")`` a whole generation (K5); both replay
the counter stream of ``loop="event", rng="counter"`` / ``eval="wide",
rng="counter"``.  Timed: batched waves, as rounds per second.

Every pair of loops must give the same objectives bit for bit (the
instances are integer-valued, so every F and delta is exact on the card
too); that is asserted on every run.  Results merge into
``BENCH_torch.json`` under ``"solver_hotloop"`` / ``"ga_hotloop"`` /
``"fused"``.  Runs on ``--device`` (``cuda`` by default).

Usage (from the repo root):
    PYTHONPATH=src python -m benchmarks_torch.solver_hotloop
    PYTHONPATH=src python -m benchmarks_torch.solver_hotloop --mode ga
    PYTHONPATH=src python -m benchmarks_torch.solver_hotloop --dry-run
    PYTHONPATH=src python -m benchmarks_torch.solver_hotloop --dry-run --loop fused
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import torch

from repro_torch.core import annealing, genetic, keys

try:                                     # package form (benchmarks_torch.run)
    from . import common
except ImportError:                      # direct script invocation
    import common


def random_instance(n: int, seed: int, dev):
    C, M = common.random_instance(n, seed)
    return torch.as_tensor(C, device=dev), torch.as_tensor(M, device=dev)


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    common.synchronize()
    return time.perf_counter() - t0


def _run_steps(C, M, states, beta, key, cfg, steps):
    """``steps`` temperature levels over a leading chain axis."""
    for k in keys.split(key, steps):
        states = annealing.temperature_step(
            C, M, states, keys.split(k, states.f.shape[0]), cfg, beta)
    return states


def _batch(n: int, batch: int, seed0: int, dev):
    insts = [random_instance(n, seed0 + i, dev) for i in range(batch)]
    Cs = torch.stack([c for c, _ in insts])
    Ms = torch.stack([m for _, m in insts])
    nvs = torch.full((batch,), n, dtype=torch.int64, device=dev)
    ks = torch.stack([keys.prng_key(i, dev) for i in range(batch)])
    return Cs, Ms, nvs, ks


def _assert_equal(fa, fb) -> None:
    fa, fb = fa.cpu().numpy(), fb.cpu().numpy()
    assert fa.tobytes() == fb.tobytes(), (fa, fb)


def _interleaved(runs, repeats):
    """Min wall seconds per run over ``repeats`` interleaved A/B rounds."""
    ts = {name: [] for name in runs}
    for _ in range(repeats):
        for name, run in runs.items():
            ts[name].append(_timed(run))
    return {name: min(t) for name, t in ts.items()}


def _equal_outputs(runs):
    """Each run once (first use of the kernels), objectives equal."""
    fs = {name: run()[1] for name, run in runs.items()}
    first, *rest = fs.values()
    for f in rest:
        _assert_equal(first, f)


def bench_step(n, chains, cfg, steps, repeats, dev):
    """Per-temperature-step latency, scan vs event, on one chain grid, at
    ``hot`` (fresh chains at T0) and ``annealed`` (after a full cooling
    run)."""
    C, M = random_instance(n, 7, dev)
    beta = annealing.make_beta(C, M, keys.prng_key(0, dev)[None], cfg)
    hot = annealing.init_chain(C, M, keys.split(keys.prng_key(1, dev),
                                                chains), cfg)
    schedule_len = cfg.num_exchanges * cfg.iters_per_exchange
    annealed = _run_steps(C, M, hot, beta, keys.prng_key(9, dev), cfg,
                          schedule_len)
    out = {}
    finals = {}
    for name, c in (("scan", replace(cfg, loop="scan")),
                    ("event", replace(cfg, loop="event"))):
        entry = {}
        for phase, states in (("hot", hot), ("annealed", annealed)):
            run = lambda: _run_steps(C, M, states, beta,
                                     keys.prng_key(2, dev), c, steps)
            finals[(name, phase)] = run().best_f
            t = min(_timed(run) for _ in range(repeats))
            entry[phase] = {
                "step_ms": t / steps * 1e3,
                # candidates decided per second: both loops decide
                # max_neighbors candidates per step
                "candidates_decided_per_s":
                    chains * cfg.max_neighbors * steps / t,
            }
        out[name] = entry
    for phase in ("hot", "annealed"):
        _assert_equal(finals[("scan", phase)], finals[("event", phase)])
        out[f"speedup_event_vs_scan_{phase}"] = \
            out["scan"][phase]["step_ms"] / out["event"][phase]["step_ms"]
    return out


def bench_solve(n, batch, cfg, repeats, dev):
    """End-to-end batched waves, scan vs event."""
    Cs, Ms, nvs, ks = _batch(n, batch, 100, dev)
    runs = {name: (lambda c=replace(cfg, loop=name): annealing.run_psa_batch(
        Cs, Ms, ks, c, 2, n_valid=nvs, device=dev))
        for name in ("scan", "event")}
    _equal_outputs(runs)
    ts = _interleaved(runs, repeats)
    out = {name: {"wave_ms": t * 1e3, "maps_per_s": batch / t}
           for name, t in ts.items()}
    out["speedup_event_vs_scan"] = \
        out["event"]["maps_per_s"] / out["scan"]["maps_per_s"]
    return out


def bench_ga_solve(n, islands, cfg, repeats, dev):
    """Full run_pga solves, island vs wide: generations/s and offspring
    evaluations/s."""
    C, M = random_instance(n, 11, dev)
    key = keys.prng_key(3, dev)
    _, n_off = genetic._resolve(cfg, n)
    runs = {name: (lambda c=replace(cfg, eval=name): genetic.run_pga(
        C, M, key, c, islands, device=dev)) for name in ("island", "wide")}
    _equal_outputs(runs)
    ts = _interleaved(runs, repeats)
    out = {name: {"solve_ms": t * 1e3,
                  "generations_per_s": cfg.generations / t,
                  "offspring_evals_per_s":
                      cfg.generations * islands * n_off / t}
           for name, t in ts.items()}
    out["speedup_wide_vs_island"] = (out["island"]["solve_ms"]
                                     / out["wide"]["solve_ms"])
    return out


def bench_ga_batch(n, batch, islands, cfg, repeats, dev):
    """End-to-end batched run_pga_batch waves, island vs wide."""
    Cs, Ms, nvs, ks = _batch(n, batch, 200, dev)
    runs = {name: (lambda c=replace(cfg, eval=name): genetic.run_pga_batch(
        Cs, Ms, ks, c, islands, n_valid=nvs, device=dev))
        for name in ("island", "wide")}
    _equal_outputs(runs)
    ts = _interleaved(runs, repeats)
    out = {name: {"wave_ms": t * 1e3, "maps_per_s": batch / t}
           for name, t in ts.items()}
    out["speedup_wide_vs_island"] = (out["wide"]["maps_per_s"]
                                     / out["island"]["maps_per_s"])
    return out


def bench_fused_sa(n, batch, cfg, repeats, dev):
    """Fused temperature steps vs the event loop on the same counter
    stream."""
    Cs, Ms, nvs, ks = _batch(n, batch, 300, dev)
    variants = {"event": replace(cfg, loop="event", rng="counter"),
                "fused": replace(cfg, loop="fused")}
    runs = {name: (lambda c=c: annealing.run_psa_batch(
        Cs, Ms, ks, c, 2, n_valid=nvs, device=dev))
        for name, c in variants.items()}
    _equal_outputs(runs)
    ts = _interleaved(runs, repeats)
    steps = cfg.num_exchanges * cfg.iters_per_exchange
    out = {name: {"wave_ms": t * 1e3, "maps_per_s": batch / t,
                  # a "round" is one temperature step of one batched wave
                  "rounds_per_s": steps * batch / t}
           for name, t in ts.items()}
    out["speedup_fused_vs_event"] = (out["fused"]["maps_per_s"]
                                     / out["event"]["maps_per_s"])
    # Launches per temperature step: the event loop scores a window of
    # event_width candidates per round (all of them on the card), one K1
    # launch a round, for at most max_success accepting rounds plus
    # ceil(max_neighbors / event_width) sweeping ones; the fused step is
    # one K4.
    width = annealing.resolved_event_width(variants["event"], n, dev)
    k, s = cfg.max_neighbors, cfg.max_success
    out["dispatches_per_temperature_step"] = {"fused": 1,
                                              "event": min(s, k) + -(-k // width)}
    return out


def bench_fused_ga(n, batch, islands, cfg, repeats, dev):
    """Fused generations vs the wide loop on the same counter stream."""
    Cs, Ms, nvs, ks = _batch(n, batch, 400, dev)
    variants = {"wide": replace(cfg, eval="wide", rng="counter"),
                "fused": replace(cfg, eval="fused")}
    runs = {name: (lambda c=c: genetic.run_pga_batch(
        Cs, Ms, ks, c, islands, n_valid=nvs, device=dev))
        for name, c in variants.items()}
    _equal_outputs(runs)
    ts = _interleaved(runs, repeats)
    out = {name: {"wave_ms": t * 1e3, "maps_per_s": batch / t,
                  # a "round" is one generation of one batched wave
                  "rounds_per_s": cfg.generations * batch / t}
           for name, t in ts.items()}
    out["speedup_fused_vs_wide"] = (out["fused"]["maps_per_s"]
                                    / out["wide"]["maps_per_s"])
    # one K2 launch a wide generation (the operators run as torch ops
    # around it); one K5 launch a fused generation
    out["dispatches_per_generation"] = {"fused": 1, "wide": 1}
    return out


def _sa_cfg(dry_run: bool) -> annealing.SAConfig:
    if dry_run:
        return annealing.SAConfig(max_neighbors=10, max_success=3,
                                  iters_per_exchange=4, num_exchanges=2,
                                  solvers=4)
    # the engine's default budget: what the serving path runs
    return annealing.SAConfig(max_neighbors=25, iters_per_exchange=30,
                              num_exchanges=20, solvers=8)


def _ga_cfg(dry_run: bool) -> genetic.GAConfig:
    if dry_run:
        return genetic.GAConfig(generations=6, pop_size=8)
    return genetic.GAConfig(generations=80, pop_size=32)


def _config(args, dev, **kw):
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"device": args.device, "device_name": name,
            "dry_run": args.dry_run, **kw}


def run_fused(args, dev):
    sa_cfg, ga_cfg = _sa_cfg(args.dry_run), _ga_cfg(args.dry_run)
    ns, batch, islands = ([16], 2, 2) if args.dry_run else ([32, 64], 8, 2)
    payload = {"config": _config(args, dev, batch=batch,
                                 sa_max_neighbors=sa_cfg.max_neighbors,
                                 sa_solvers=sa_cfg.solvers,
                                 ga_generations=ga_cfg.generations,
                                 ga_islands=islands),
               "sa": {}, "ga": {}}
    for n in ns:
        if args.mode in ("sa", "both"):
            sa = bench_fused_sa(n, batch, sa_cfg, args.repeats, dev)
            payload["sa"][f"n={n}"] = sa
            print(f"sa n={n:4d}  {sa['event']['rounds_per_s']:8.1f} -> "
                  f"{sa['fused']['rounds_per_s']:8.1f} temp-steps/s "
                  f"({sa['speedup_fused_vs_event']:.2f}x)")
        if args.mode in ("ga", "both"):
            ga = bench_fused_ga(n, batch, islands, ga_cfg, args.repeats, dev)
            payload["ga"][f"n={n}"] = ga
            print(f"ga n={n:4d}  {ga['wide']['rounds_per_s']:8.1f} -> "
                  f"{ga['fused']['rounds_per_s']:8.1f} generations/s "
                  f"({ga['speedup_fused_vs_wide']:.2f}x)")
    if args.json:
        common.write_bench_json(args.json, "fused", payload)
        print(f"wrote {args.json} [fused]")
    return {"fused": payload}


def run_sa(args, dev):
    cfg = _sa_cfg(args.dry_run)
    ns, steps, batch = ([16], 8, 2) if args.dry_run else ([32, 64], 64, 8)
    # worst-case wide rounds per temperature level on this device (full
    # width on the card: max_success + 1; windowed on the CPU)
    width = annealing.resolved_event_width(cfg, device=dev)
    k, s = cfg.max_neighbors, cfg.max_success
    payload = {
        "config": _config(args, dev, max_neighbors=k, max_success=s,
                          solvers=cfg.solvers, chains=args.chains,
                          batch=batch, event_width=width),
        "sequential_depth": {"scan": k, "event": min(s, k) + -(-k // width),
                             "event_full_width": min(s, k) + 1},
        "per_step": {}, "solve": {},
    }
    for n in ns:
        step = bench_step(n, args.chains, cfg, steps, args.repeats, dev)
        solve = bench_solve(n, batch, cfg, args.repeats, dev)
        payload["per_step"][f"n={n}"] = step
        payload["solve"][f"n={n}"] = solve
        print(f"n={n:4d}  step hot: {step['scan']['hot']['step_ms']:6.2f} -> "
              f"{step['event']['hot']['step_ms']:6.2f} ms "
              f"({step['speedup_event_vs_scan_hot']:.2f}x)  annealed: "
              f"{step['scan']['annealed']['step_ms']:6.2f} -> "
              f"{step['event']['annealed']['step_ms']:6.2f} ms "
              f"({step['speedup_event_vs_scan_annealed']:.2f}x)  wave: "
              f"{solve['scan']['maps_per_s']:6.2f} -> "
              f"{solve['event']['maps_per_s']:6.2f} maps/s "
              f"({solve['speedup_event_vs_scan']:.2f}x)")
    if args.json:
        common.write_bench_json(args.json, "solver_hotloop", payload)
        print(f"wrote {args.json} [solver_hotloop]")
    return payload


def run_ga(args, dev):
    cfg = _ga_cfg(args.dry_run)
    ns, batch, islands = ([16], 2, 2) if args.dry_run else ([32, 64], 8, 2)
    pop, n_off = genetic._resolve(cfg, ns[0])
    payload = {"config": _config(args, dev, generations=cfg.generations,
                                 pop_size=pop, n_offspring=n_off,
                                 islands=islands, batch=batch),
               "solve": {}, "solve_batch": {}}
    for n in ns:
        solo = bench_ga_solve(n, islands, cfg, args.repeats, dev)
        wave = bench_ga_batch(n, batch, islands, cfg, args.repeats, dev)
        payload["solve"][f"n={n}"] = solo
        payload["solve_batch"][f"n={n}"] = wave
        print(f"n={n:4d}  solve: {solo['island']['generations_per_s']:7.1f} "
              f"-> {solo['wide']['generations_per_s']:7.1f} gens/s "
              f"({solo['speedup_wide_vs_island']:.2f}x)  wave: "
              f"{wave['island']['maps_per_s']:6.2f} -> "
              f"{wave['wide']['maps_per_s']:6.2f} maps/s "
              f"({wave['speedup_wide_vs_island']:.2f}x)")
    if args.json:
        common.write_bench_json(args.json, "ga_hotloop", payload)
        print(f"wrote {args.json} [ga_hotloop]")
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", default=common.BENCH_JSON)
    ap.add_argument("--mode", choices=("sa", "ga", "both"), default="both",
                    help="which hot loop to benchmark")
    ap.add_argument("--loop", choices=("default", "fused"), default="default",
                    help="'fused' benches the fused steps against the "
                         "unfused counter-stream loops (equality asserted)")
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny budgets: CI smoke that still writes JSON")
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    if args.loop == "fused":
        return run_fused(args, dev)
    out = {}
    if args.mode in ("sa", "both"):
        out["solver_hotloop"] = run_sa(args, dev)
    if args.mode in ("ga", "both"):
        out["ga_hotloop"] = run_ga(args, dev)
    return out


if __name__ == "__main__":
    main()
