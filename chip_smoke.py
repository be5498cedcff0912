#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which must pass:

1. build the CUDA kernels of ``src/repro_torch/csrc`` with nvcc;
2. print the card's name and power limit;
3. hold each kernel (K1 ``qap_delta``, K4 ``qap_sa_step``, K2
   ``qap_objective``, K5 ``qap_ga_step``) against its plain PyTorch
   version on the card, at the shapes the engine gives it (bitwise: the
   instances are integer-valued), and time both;
4. drive the port's ``MappingEngine`` on the card through one full wave
   of the 128 bucket (32 requests of order 125) plus waves of the 64 and
   32 buckets, on five routes: PSA with ``loop="event"`` (kernel K1) and
   ``loop="fused"`` (K4), PGA with ``eval="wide"`` (K2) and
   ``eval="fused"`` (K5), and PCA (K1, then K2); the launch counts are
   set to 0 just before each wave and read just after;
5. check every response (a feasible permutation, an objective equal to
   F(perm), no worse than the identity and no better than the instance's
   known optimum) and check one request per bucket against the same
   engine on the CPU, bit for bit.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.  It exits non-zero, printing
no result, when there is no CUDA device or no ``src/repro_torch`` beside
it.  It imports nothing of JAX or of the reference package.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_PER_S = 67e12           # f32 outside the tensor cores

ORDER, BUCKET, WAVE = 125, 128, 32
SA_KW = dict(max_neighbors=25, iters_per_exchange=30, num_exchanges=20,
             solvers=8)
GA_KW = dict(generations=80, pop_size=32)     # the engine's default GA
NUM_PROCESSES = 2
POLISH_K = 256
ISLANDS = WAVE * NUM_PROCESSES
N_OFF = GA_KW["pop_size"] // 2

# route -> (algorithm, SAConfig changes, GAConfig changes)
ROUTES = {
    "psa-event": ("psa", dict(loop="event"), {}),
    "psa-fused": ("psa", dict(loop="fused"), {}),
    "pga-wide": ("pga", {}, dict(eval="wide")),
    "pga-fused": ("pga", {}, dict(eval="fused")),
    "pca": ("pca", {}, {}),
}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def wave_instances(device):
    """32 padded order-125 instances (make_taie versions 1..32)."""
    import numpy as np
    import torch
    from repro_torch.core import instances
    Cs = np.zeros((WAVE, BUCKET, BUCKET), np.float32)
    Ms = np.zeros((WAVE, BUCKET, BUCKET), np.float32)
    for v in range(WAVE):
        inst = instances.make_taie(ORDER, version=v + 1)
        Cs[v, :ORDER, :ORDER] = inst.C
        Ms[v, :ORDER, :ORDER] = inst.M
    return torch.as_tensor(Cs, device=device), torch.as_tensor(Ms, device=device)


def check_qap_delta(device):
    """K1 against its plain version at the event-loop shape (512 chains x
    25 candidates) and the polish shape (32 x 256), shared and per
    instance."""
    import torch
    from repro_torch.core import keys, qap
    from repro_torch.kernels.qap_delta import qap_delta_cuda, qap_delta_plain
    Cs, Ms = wave_instances(device)
    nv = torch.full((WAVE,), ORDER, dtype=torch.int64, device=device)
    Cs = qap.mask_flows(Cs, nv)
    CT, MT = Cs.transpose(1, 2).contiguous(), Ms.transpose(1, 2).contiguous()
    base = keys.prng_key(2024, device)
    out = {}
    for label, chains, k in (("event", WAVE * NUM_PROCESSES * SA_KW["solvers"],
                              SA_KW["max_neighbors"]), ("polish", WAVE, POLISH_K)):
        ck = keys.split(keys.fold_in(base, k), chains)
        p = qap.masked_random_permutation(ck, BUCKET, ORDER)
        pairs = qap.random_swap_pairs(keys.fold_in(ck, 1), k, BUCKET,
                                      torch.full((chains,), ORDER, device=device))
        for mats, (C, M, Ct, Mt) in (
                ("batched", (Cs, Ms, CT, MT)),
                ("shared", (Cs[0].contiguous(), Ms[0].contiguous(),
                            CT[0].contiguous(), MT[0].contiguous()))):
            got = qap_delta_cuda(C, M, p, pairs, Ct, Mt)
            want = qap_delta_plain(C, M, p, pairs)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            require(torch.equal(got, want),
                    f"qap_delta {label}/{mats}: kernel != plain, max err {err}")
            ms = cuda_ms(lambda: qap_delta_cuda(C, M, p, pairs, Ct, Mt), 200)
            plain = cuda_ms(lambda: qap_delta_plain(C, M, p, pairs), 20)
            b0 = C.shape[0] if C.dim() == 3 else 1
            nbytes = 4 * (4 * b0 * BUCKET * BUCKET + chains * BUCKET
                          + chains * k * 3)
            bound, by = bound_ms(nbytes, 8 * BUCKET * chains * k)
            out[(label, mats)] = dict(err=err, ms=ms, plain_ms=plain,
                                      bound_ms=bound, bound_by=by)
            print(f"qap_delta {label:6s} {mats:7s} B={chains} K={k}: "
                  f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}), max err {err}", flush=True)
    return out


def scan_evaluated(C, M, p, f, temp, keys_w, nv, k, max_success):
    """Candidates the sequential scan scores before the acceptance cap
    stops it: the work K4's data needs in this step."""
    import torch
    from repro_torch.core import qap
    from repro_torch.kernels import prng
    from repro_torch.kernels.qap_delta import qap_delta_plain
    pairs, us = prng.sa_step_draws(keys_w, k, nv)
    tsafe = temp.clamp_min(1e-9)
    succ = torch.zeros_like(nv, dtype=torch.long)
    evaluated = 0
    for t in range(k):
        active = succ < max_success
        evaluated += int(active.sum())
        d = qap_delta_plain(C, M, p, pairs[:, t:t + 1])[:, 0]
        acc = ((d < 0) | (us[:, t] < torch.exp(-d / tsafe))) & active
        p = torch.where(acc[:, None],
                        qap.swap_positions(p, pairs[:, t, 0], pairs[:, t, 1]), p)
        succ += acc.long()
    return evaluated


def check_qap_sa_step(device):
    """K4 against its plain version: 512 chains, order 125 in the 128
    bucket, 25 candidates, at most 10 acceptances, starting at T0."""
    import torch
    from repro_torch.core import annealing, keys, qap
    from repro_torch.kernels.qap_sa_step import (qap_sa_step_cuda,
                                                 qap_sa_step_plain)
    Cs, Ms = wave_instances(device)
    nv_i = torch.full((WAVE,), ORDER, dtype=torch.int64, device=device)
    Cs = qap.mask_flows(Cs, nv_i)
    CT, MT = Cs.transpose(1, 2).contiguous(), Ms.transpose(1, 2).contiguous()
    rpt = NUM_PROCESSES * SA_KW["solvers"]
    chains = WAVE * rpt
    ck = keys.split(keys.prng_key(7, device), chains)
    p = qap.masked_random_permutation(ck, BUCKET, ORDER)
    f = qap.objective(Cs, Ms, p.view(WAVE, rpt, BUCKET)).reshape(-1)
    temp = annealing.initial_temperature(f, 0.3, 0.3)
    nv = torch.full((chains,), ORDER, dtype=torch.int32, device=device)
    step_keys = keys.fold_in(ck, 3)
    k, cap = SA_KW["max_neighbors"], 10
    args = (Cs, Ms, p, f, p.clone(), f.clone(), temp, step_keys, nv)
    got = qap_sa_step_cuda(*args, max_neighbors=k, max_success=cap, CT=CT, MT=MT)
    want = qap_sa_step_plain(*args, max_neighbors=k, max_success=cap)
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    for name, g, w in zip(("p", "f", "best_p", "best_f"), got, want):
        require(torch.equal(g, w), f"qap_sa_step {name}: kernel != plain "
                f"(max err {err})")
    ms = cuda_ms(lambda: qap_sa_step_cuda(*args, max_neighbors=k,
                                          max_success=cap, CT=CT, MT=MT), 100)
    plain = cuda_ms(lambda: qap_sa_step_plain(*args, max_neighbors=k,
                                              max_success=cap), 10)
    evaluated = scan_evaluated(Cs, Ms, p, f, temp, step_keys, nv, k, cap)
    nbytes = (4 * 4 * WAVE * BUCKET * BUCKET          # C, C^T, M, M^T
              + 4 * 4 * chains * BUCKET               # p, best_p in and out
              + chains * (4 * 4 + 8 + 4 * 2))         # f, bf, temp, nv, keys; f, bf out
    bound, by = bound_ms(nbytes, 8 * BUCKET * evaluated)
    print(f"qap_sa_step B={chains} N={BUCKET} K={k} cap={cap}: kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms ({by}), "
          f"{evaluated} of {chains * k} candidates scored, max err {err}",
          flush=True)
    return dict(err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)


def island_populations(device, pop):
    """``ISLANDS`` populations of ``pop`` random order-125 permutations in
    the 128 bucket (identity tail), over the wave's masked instances."""
    import torch
    from repro_torch.core import keys, qap
    Cs, Ms = wave_instances(device)
    Cs = qap.mask_flows(Cs, torch.full((WAVE,), ORDER, device=device))
    ck = keys.split(keys.prng_key(pop, device), ISLANDS)
    pops = qap.masked_random_permutations(ck, pop, BUCKET, ORDER).contiguous()
    return Cs, Ms, pops


def check_qap_objective(device):
    """K2 against its plain version at the GA's shapes: one generation's
    children (64 islands x 16) and the initial populations (64 x 32), per
    instance and shared."""
    import torch
    from repro_torch.kernels.qap_objective import (qap_objective_cuda,
                                                   qap_objective_plain)
    out = {}
    for label, pop in (("generation", N_OFF), ("init", GA_KW["pop_size"])):
        Cs, Ms, pops = island_populations(device, pop)
        for mats, (C, M) in (("batched", (Cs, Ms)),
                             ("shared", (Cs[0].contiguous(), Ms[0].contiguous()))):
            got = qap_objective_cuda(C, M, pops)
            want = qap_objective_plain(C, M, pops)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            require(torch.equal(got, want),
                    f"qap_objective {label}/{mats}: kernel != plain, max err {err}")
            ms = cuda_ms(lambda: qap_objective_cuda(C, M, pops), 200)
            plain = cuda_ms(lambda: qap_objective_plain(C, M, pops), 20)
            b0 = C.shape[0] if C.dim() == 3 else 1
            count = ISLANDS * pop
            nbytes = 4 * (2 * b0 * BUCKET * BUCKET + count * BUCKET + count)
            bound, by = bound_ms(nbytes, 2 * BUCKET * BUCKET * count)
            out[(label, mats)] = dict(err=err, ms=ms, plain_ms=plain,
                                      bound_ms=bound, bound_by=by)
            print(f"qap_objective {label:10s} {mats:7s} {ISLANDS}x{pop}: "
                  f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}), max err {err}", flush=True)
    return out


def check_qap_ga_step(device):
    """K5 against its plain version: 64 islands of 32, order 125 in the
    128 bucket, at the engine's GA settings (16 children, binary
    tournaments, OX, p_mutation 0.001) and at a wider setting (32
    children: every member replaced, the elitism guard; OXS, p_mutation
    0.3)."""
    import torch
    from repro_torch.core import keys
    from repro_torch.kernels.qap_ga_step import (qap_ga_step_cuda,
                                                 qap_ga_step_plain)
    from repro_torch.kernels.qap_objective import qap_objective_plain
    pop = GA_KW["pop_size"]
    Cs, Ms, pops = island_populations(device, pop)
    fits = qap_objective_plain(Cs, Ms, pops)
    step_keys = keys.split(keys.prng_key(5, device), ISLANDS)
    nv = torch.full((ISLANDS,), ORDER, dtype=torch.int32, device=device)
    engine_kw = dict(n_off=N_OFF, tournament=2, p_crossover=1.0,
                     p_mutation=0.001, crossover="ox")
    wide_kw = dict(n_off=pop, tournament=3, p_crossover=0.7, p_mutation=0.3,
                   crossover="oxs")
    args = (Cs, Ms, pops, fits, step_keys, nv)
    err = 0.0
    for kw in (engine_kw, wide_kw):
        got = qap_ga_step_cuda(*args, **kw)
        want = qap_ga_step_plain(*args, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(("pop", "fit"), got, want):
            e = float((g.float() - w.float()).abs().max())
            err = max(err, e)
            require(torch.equal(g, w), f"qap_ga_step {name} {kw}: kernel != "
                    f"plain (max err {e})")
    ms = cuda_ms(lambda: qap_ga_step_cuda(*args, **engine_kw), 100)
    plain = cuda_ms(lambda: qap_ga_step_plain(*args, **engine_kw), 10)
    nbytes = (4 * 2 * WAVE * BUCKET * BUCKET          # C, M
              + 2 * 4 * ISLANDS * pop * BUCKET        # populations in and out
              + 2 * 4 * ISLANDS * pop                 # fitness in and out
              + ISLANDS * (8 + 4))                    # key words, n_valid
    bound, by = bound_ms(nbytes, 2 * BUCKET * BUCKET * ISLANDS * N_OFF)
    print(f"qap_ga_step {ISLANDS} islands x {pop}, {N_OFF} children, "
          f"N={BUCKET}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), max err {err}", flush=True)
    return dict(err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)


def requests():
    """A full 128-bucket wave of order-125 requests, three each of orders
    45 and 27; returns the requests and each instance's known optimum."""
    from repro_torch.core import instances
    from repro_torch.serve import MapRequest
    reqs, optima = [], {}
    for order, count in ((ORDER, WAVE), (45, 3), (27, 3)):
        for v in range(1, count + 1):
            inst = instances.make_taie(order, version=v)
            job = f"n{order}-v{v}"
            reqs.append(MapRequest(job_id=job, C=inst.C, M=inst.M,
                                   seed=1000 * order + v))
            optima[job] = inst.optimum
    return reqs, optima


def check_response(req, resp, optimum):
    import numpy as np
    n = req.C.shape[0]
    perm = np.asarray(resp.perm)
    require(perm.shape == (n,) and (np.sort(perm) == np.arange(n)).all(),
            f"{req.job_id}: infeasible permutation")
    f = float((np.asarray(req.C, np.float64)
               * np.asarray(req.M, np.float64)[np.ix_(perm, perm)]).sum())
    require(f == resp.objective, f"{req.job_id}: objective {resp.objective} "
            f"!= F(perm) {f}")
    require(optimum <= resp.objective <= resp.baseline,
            f"{req.job_id}: objective {resp.objective} outside [F0 {optimum}, "
            f"F(identity) {resp.baseline}]")


def engine_for(route, device):
    from repro_torch.core.annealing import SAConfig
    from repro_torch.core.genetic import GAConfig
    from repro_torch.serve import MappingEngine
    _, sa, ga = ROUTES[route]
    return MappingEngine(sa_cfg=SAConfig(**SA_KW, **sa),
                         ga_cfg=GAConfig(**GA_KW, **ga),
                         num_processes=NUM_PROCESSES, device=device)


def route_requests(route):
    import dataclasses
    reqs, optima = requests()
    algorithm = ROUTES[route][0]
    return [dataclasses.replace(r, algorithm=algorithm) for r in reqs], optima


def drive_engine(route):
    """Submit and flush each bucket's wave on the card, the launch counts
    set to 0 just before each wave and read just after; returns the
    requests, the responses and the launch counts summed over the waves."""
    import torch
    from repro_torch.kernels import ops
    reqs, optima = route_requests(route)
    engine = engine_for(route, "cuda")
    t = time.perf_counter()
    engine.warmup(algorithms=(ROUTES[route][0],))
    torch.cuda.synchronize()
    print(f"[{route}] warmup {time.perf_counter() - t:.3f} s", flush=True)
    resps, total = {}, {}
    for order in (ORDER, 45, 27):
        wave = [r for r in reqs if r.C.shape[0] == order]
        ops.reset_launch_counts()
        t = time.perf_counter()
        futs = [engine.submit(r) for r in wave]
        engine.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = ops.launch_counts()
        for r, fut in zip(wave, futs):
            resps[r.job_id] = fut.result()
            check_response(r, resps[r.job_id], optima[r.job_id])
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        ratio = sum(resps[r.job_id].objective / optima[r.job_id]
                    for r in wave) / len(wave)
        print(f"[{route}] bucket {resps[wave[0].job_id].bucket}: {len(wave)} "
              f"requests of order {order}, wave wall {wall:.4f} s, launches "
              f"{counts}, mean F/F0 {ratio:.4f}", flush=True)
    return reqs, resps, total


def check_against_cpu(route, reqs, resps):
    """The same engine on the CPU, one request per bucket."""
    picks = [reqs[0], reqs[WAVE], reqs[WAVE + 3]]
    engine = engine_for(route, "cpu")
    t = time.perf_counter()
    futs = [engine.submit(r) for r in picks]
    engine.flush()
    for r, fut in zip(picks, futs):
        cpu, gpu = fut.result(), resps[r.job_id]
        require((cpu.perm == gpu.perm).all() and cpu.objective == gpu.objective,
                f"[{route}] {r.job_id}: card F={gpu.objective} != cpu "
                f"F={cpu.objective}")
    print(f"[{route}] card == cpu on {[r.job_id for r in picks]} "
          f"({time.perf_counter() - t:.1f} s on the cpu)", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.kernels import build

    t = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t:.2f} s", flush=True)
    for name, log in build.build_log().items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"nvcc {name}: {line.strip()}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    device = torch.device("cuda")
    delta = check_qap_delta(device)
    sa = check_qap_sa_step(device)
    obj = check_qap_objective(device)
    ga = check_qap_ga_step(device)

    runs = {}
    for route in ROUTES:
        reqs, resps, counts = drive_engine(route)
        runs[route] = counts
        check_against_cpu(route, reqs, resps)
    for route, kernel in (("psa-event", "qap_delta"), ("psa-fused", "qap_sa_step"),
                          ("psa-fused", "qap_delta"), ("pga-wide", "qap_objective"),
                          ("pga-wide", "qap_delta"), ("pga-fused", "qap_ga_step"),
                          ("pca", "qap_objective"), ("pca", "qap_delta")):
        require(runs[route][kernel] > 0, f"{route} launched no {kernel}")

    d = delta[("event", "batched")]
    o = obj[("generation", "batched")]
    kernels = [
        dict(name="qap_delta", route="cuda",
             source="src/repro_torch/csrc/qap_delta.cu",
             replaces="src/repro/kernels/qap_delta.py:95",
             launches=runs["psa-event"]["qap_delta"], max_abs_err=max(
                 v["err"] for v in delta.values()),
             ms=d["ms"], plain_ms=d["plain_ms"], bound_ms=d["bound_ms"],
             bound_by=d["bound_by"], library_ms=None),
        dict(name="qap_sa_step", route="cuda",
             source="src/repro_torch/csrc/qap_sa_step.cu",
             replaces="src/repro/kernels/qap_sa_step.py:122",
             launches=runs["psa-fused"]["qap_sa_step"], max_abs_err=sa["err"],
             ms=sa["ms"], plain_ms=sa["plain_ms"], bound_ms=sa["bound_ms"],
             bound_by=sa["bound_by"], library_ms=None),
        dict(name="qap_objective", route="cuda",
             source="src/repro_torch/csrc/qap_objective.cu",
             replaces="src/repro/kernels/qap_objective.py:65",
             launches=runs["pga-wide"]["qap_objective"], max_abs_err=max(
                 v["err"] for v in obj.values()),
             ms=o["ms"], plain_ms=o["plain_ms"], bound_ms=o["bound_ms"],
             bound_by=o["bound_by"], library_ms=None),
        dict(name="qap_ga_step", route="cuda",
             source="src/repro_torch/csrc/qap_ga_step.cu",
             replaces="src/repro/kernels/qap_ga_step.py:134",
             launches=runs["pga-fused"]["qap_ga_step"], max_abs_err=ga["err"],
             ms=ga["ms"], plain_ms=ga["plain_ms"], bound_ms=ga["bound_ms"],
             bound_by=ga["bound_by"], library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
