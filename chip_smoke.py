#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which must pass:

1. build the CUDA kernels of ``src/repro_torch/csrc`` with nvcc;
2. print the card's name and power limit;
3. hold each kernel (K1 ``qap_delta``, K4 ``qap_sa_step``, K2
   ``qap_objective``, K5 ``qap_ga_step``, K6 ``qap_objective_sparse``,
   K7 ``qap_delta_sparse``) against its plain PyTorch version on the
   card, at the shapes the engine gives it (bitwise: the instances are
   integer-valued), and time both, by CUDA events and (the kernel) in a
   CUDA graph; K1, K4, K2 and K5 on both branches, the shared-memory
   one at the 128 bucket and the L2 one at order 256; K6 at every level
   of the 4096 torus (orders 4096 ... 128, ELL widths 6 ... 46) at the
   route's 1 x 1 and 1 x 4 and at 64 x 4 on the finest, shared and
   batched, then on real-valued flows: the same bits on two calls and for
   a permutation alone, within 1e-5 of the plain version; then K8
   ``selective_scan`` at the Jamba prefill's full-width shape (4 x 512 x
   8192, d_state 16) and a ragged one (2 x 49 x 200, d_state 4), ``y`` and the final state
   within 2e-4 of their largest magnitude;
4. drive the port's ``MappingEngine`` on the card through one full wave
   of the 128 bucket (32 requests of order 125) plus waves of the 64 and
   32 buckets, on five routes: PSA with ``loop="event"`` (kernel K1) and
   ``loop="fused"`` (K4), PGA with ``eval="wide"`` (K2) and
   ``eval="fused"`` (K5), and PCA (K1, then K2); then a sixth route,
   ``multilevel``: requests of orders 512, 1024 and 4096 (known-optimum
   tori) through the large buckets (K1 for the coarse solve, K6 and K7
   on the refinement levels and in the final polish); the launch counts
   are set to 0 just before each wave or request and read just after,
   and every K1, K2, K4 and K5 launch there must have taken the
   shared-memory branch;
   then a seventh route, ``rm-replay``, the control plane: a 24-job
   ``synthetic_trace`` on the 512-node 8 x 8 x 8 torus through
   ``ResourceManager``'s defaults (3 candidates, EASY backfilling, psa)
   over ``MappingEngine(warm_start=False)`` (K1, every launch on the
   shared-memory branch, one batch a wave); the same trace through a
   subprocess ``EngineFleet`` of two workers on the card whose worker 0
   SIGKILLs itself after 4 requests (the same decisions job for job, one
   death, no failure, free device memory down by at least one CUDA
   context per child while both live); its first 8 jobs through one
   engine and a thread fleet under a kill on the card and one engine on
   the CPU (all three equal); and ``PlacementService.solve_batch`` of the
   first job's candidates, card == CPU;
   then an eighth route, ``lm-serve``: Jamba-v0.1-52B at full width, 8 of
   its 32 layers (one ``mMmMaMmM`` super-block), bf16 weights drawn on the
   card from a seeded generator, dropless MoE, served through the port's
   ``Engine.generate``: 4 prompts of 512 tokens, 16 greedy tokens (K8
   once per Mamba layer of the prefill: 7 launches);
5. check every response (a feasible permutation, an objective equal to
   F(perm), no worse than the identity and no better than the instance's
   known optimum) and check one request per bucket (the 1024 and 4096
   requests on the multilevel route) against the same engine on the
   CPU, bit for bit; on ``lm-serve``, every token in the vocabulary,
   finite logits, decode against teacher forcing at full width on the
   same bf16 weights in f32 compute (argmax agreement >= 0.95, logits
   within 1e-3 of their largest magnitude; the served bf16 arithmetic's
   agreement over 16 prompts is printed), and Jamba's ``SMOKE`` width
   in f32 on the card against the CPU (the same greedy tokens, prefill
   logits within 1e-4 of their largest magnitude).

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.  It exits non-zero, printing
no result, when there is no CUDA device or no ``src/repro_torch`` beside
it.  It imports nothing of JAX or of the reference package.
"""
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_PER_S = 67e12           # f32 outside the tensor cores

ORDER, BUCKET, WAVE = 125, 128, 32
L2_ORDER = 256       # K1, K2, K4, K5 past their shared-memory thresholds
SA_KW = dict(max_neighbors=25, iters_per_exchange=30, num_exchanges=20,
             solvers=8)
GA_KW = dict(generations=80, pop_size=32)     # the engine's default GA
NUM_PROCESSES = 2
POLISH_K = 256
ISLANDS = WAVE * NUM_PROCESSES
N_OFF = GA_KW["pop_size"] // 2

# The multilevel route: known-optimum tori of orders 512, 1024 and 4096,
# served at the engine's default MultilevelConfig.  Refinement scores 4
# chains (2 processes x 2 solvers) x 16 candidates per K7 launch, the
# polish 1 x 256; the chain start scores 4 permutations per K6 launch.
ML_TORI = ((8, 8, 8), (32, 32), (16, 16, 16))
ML_CHAINS, ML_K = 4, 16

# The rm-replay route: the resource manager's defaults (3 candidates from
# compact/slab/scatter, EASY backfilling, psa) over the engine's default
# budgets, replaying a synthetic trace on the 512-node 8 x 8 x 8 torus.
# Offered load about 0.5 x 60 x 41.6 / 512 = 2.4 machines, so a queue
# builds and backfilling has work; flows are default_flows (integers).
RM_TORUS = (8, 8, 8)
RM_TRACE = dict(sizes=(16, 32, 64, 128), weights=(4, 3, 2, 1),
                arrival_rate=0.5, mean_run_s=60.0, seed=0)
RM_JOBS, RM_CPU_JOBS = 24, 8
RM_TIMEOUT_S = 120.0     # children dying in a loop fail the route
RM_MAX_RESPAWNS = 2

# The lm-serve route: 4 prompts of 512 tokens, 16 new tokens, greedy.
LM_BATCH, LM_PROMPT, LM_NEW = 4, 512, 16
LM_TF_ROWS = 16          # prompts in the bf16 teacher-forcing measurement

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


def graph_ms(fn, reps):
    """Mean device milliseconds per call: ``reps`` calls captured in one
    CUDA graph and replayed, so no host work sits between the launches
    (``cuda_ms`` of a small kernel measures how fast the host issues it)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def integer_instances(n, count, seed, device):
    """``count`` symmetric integer-valued instances of order ``n`` (C in
    [0, 18], M in [2, 18]) from a seeded numpy generator."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    C = rng.integers(0, 10, (count, n, n)).astype(np.float32)
    M = rng.integers(1, 10, (count, n, n)).astype(np.float32)
    C, M = C + C.transpose(0, 2, 1), M + M.transpose(0, 2, 1)
    return torch.as_tensor(C, device=device), torch.as_tensor(M, device=device)


def branch_launched(kernel, branch, fn):
    """Run ``fn`` and require that it launched ``kernel`` once, on
    ``branch`` ("smem" or "l2")."""
    from repro_torch.kernels import ops
    before = ops.branch_counts()
    out = fn()
    after = ops.branch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    require(moved == {f"{kernel}/{branch}": 1},
            f"{kernel}: expected one launch on its {branch} branch, got "
            f"{moved}")
    return out


def check_qap_delta(device):
    """K1 against its plain version, each launch on the branch its order
    selects: the shared-memory branch at the 128 bucket's event-loop shape
    (512 chains x 25 candidates) and polish shape (32 x 256), shared and
    per instance; the L2 branch at order 256 (8 integer instances, 128
    chains x 25), one order class above the threshold."""
    import torch
    from repro_torch.core import keys, qap
    from repro_torch.kernels.qap_delta import qap_delta_cuda, qap_delta_plain
    Cs, Ms = wave_instances(device)
    nv = torch.full((WAVE,), ORDER, dtype=torch.int64, device=device)
    Cs = qap.mask_flows(Cs, nv)
    C2, M2 = integer_instances(L2_ORDER, 8, 256, device)
    base = keys.prng_key(2024, device)
    out = {}
    for label, (Cb, Mb, order, n), chains, k in (
            ("event", (Cs, Ms, ORDER, BUCKET),
             WAVE * NUM_PROCESSES * SA_KW["solvers"], SA_KW["max_neighbors"]),
            ("polish", (Cs, Ms, ORDER, BUCKET), WAVE, POLISH_K),
            ("l2", (C2, M2, L2_ORDER, L2_ORDER), 8 * 16,
             SA_KW["max_neighbors"])):
        branch = "l2" if label == "l2" else "smem"
        CT = Cb.transpose(1, 2).contiguous()
        MT = Mb.transpose(1, 2).contiguous()
        ck = keys.split(keys.fold_in(base, k), chains)
        p = qap.masked_random_permutation(ck, n, order)
        nv = torch.full((chains,), order, device=device)
        pairs = qap.random_swap_pairs(keys.fold_in(ck, 1), k, n, nv)
        for mats, (C, M, Ct, Mt) in (
                ("batched", (Cb, Mb, CT, MT)),
                ("shared", (Cb[0].contiguous(), Mb[0].contiguous(),
                            CT[0].contiguous(), MT[0].contiguous()))):
            launch = lambda: qap_delta_cuda(C, M, p, pairs, Ct, Mt)
            got = branch_launched("qap_delta", branch, launch)
            want = qap_delta_plain(C, M, p, pairs)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            require(torch.equal(got, want), f"qap_delta {label}/{mats}: "
                    f"kernel != plain, max err {err}")
            ms, dev_ms = cuda_ms(launch, 200), graph_ms(launch, 200)
            plain = cuda_ms(lambda: qap_delta_plain(C, M, p, pairs), 20)
            b0 = C.shape[0] if C.dim() == 3 else 1
            io = chains * n + chains * k * 3          # p; pairs in, deltas out
            bound, by = bound_ms(4 * (2 * b0 * n * n + io),
                                 8 * n * chains * k)
            bound4, _ = bound_ms(4 * (4 * b0 * n * n + io), 8 * n * chains * k)
            out[(label, mats)] = dict(err=err, ms=ms, graph_ms=dev_ms,
                                      plain_ms=plain, bound_ms=bound,
                                      bound_by=by)
            print(f"qap_delta {label:6s} {mats:7s} N={n} B={chains} K={k} "
                  f"({branch} branch): kernel {ms:.4f} ms ({dev_ms:.4f} ms in "
                  f"a graph), plain {plain:.4f} ms, bound {bound:.4f} ms "
                  f"({by}; {bound4:.4f} counting C^T and M^T as well), max "
                  f"err {err}", flush=True)
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
    """K4 against its plain version, starting at T0, 25 candidates, at
    most 10 acceptances: the shared-memory branch at the 128 bucket (512
    chains, order 125, one warp per chain), the L2 branch at order 256 (8
    integer instances x 16 chains).  Returns the 128 bucket's numbers."""
    import torch
    from repro_torch.core import annealing, keys, qap
    from repro_torch.kernels.qap_sa_step import (qap_sa_step_cuda,
                                                 qap_sa_step_plain)
    Cs, Ms = wave_instances(device)
    nv_i = torch.full((WAVE,), ORDER, dtype=torch.int64, device=device)
    Cs = qap.mask_flows(Cs, nv_i)
    C2, M2 = integer_instances(L2_ORDER, 8, 257, device)
    rpt = NUM_PROCESSES * SA_KW["solvers"]
    k, cap = SA_KW["max_neighbors"], 10
    out = {}
    for label, Cb, Mb, order, n in (("smem", Cs, Ms, ORDER, BUCKET),
                                    ("l2", C2, M2, L2_ORDER, L2_ORDER)):
        b0 = Cb.shape[0]
        chains = b0 * rpt
        CT = Cb.transpose(1, 2).contiguous()
        MT = Mb.transpose(1, 2).contiguous()
        ck = keys.split(keys.prng_key(7, device), chains)
        p = qap.masked_random_permutation(ck, n, order)
        f = qap.objective(Cb, Mb, p.view(b0, rpt, n)).reshape(-1)
        temp = annealing.initial_temperature(f, 0.3, 0.3)
        nv = torch.full((chains,), order, dtype=torch.int32, device=device)
        step_keys = keys.fold_in(ck, 3)
        args = (Cb, Mb, p, f, p.clone(), f.clone(), temp, step_keys, nv)
        launch = lambda: qap_sa_step_cuda(*args, max_neighbors=k,
                                          max_success=cap, CT=CT, MT=MT)
        got = branch_launched("qap_sa_step", label, launch)
        want = qap_sa_step_plain(*args, max_neighbors=k, max_success=cap)
        torch.cuda.synchronize()
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        for name, g, w in zip(("p", "f", "best_p", "best_f"), got, want):
            require(torch.equal(g, w), f"qap_sa_step {label} {name}: kernel "
                    f"!= plain (max err {err})")
        ms, dev_ms = cuda_ms(launch, 100), graph_ms(launch, 100)
        plain = cuda_ms(lambda: qap_sa_step_plain(*args, max_neighbors=k,
                                                  max_success=cap), 10)
        evaluated = scan_evaluated(Cb, Mb, p, f, temp, step_keys, nv, k, cap)
        io = (4 * 4 * chains * n              # p, best_p in and out
              + chains * (4 * 4 + 16 + 4 * 2))  # f, bf, temp, nv, keys; out
        bound, by = bound_ms(4 * 2 * b0 * n * n + io, 8 * n * evaluated)
        bound4, _ = bound_ms(4 * 4 * b0 * n * n + io, 8 * n * evaluated)
        out[label] = dict(err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain,
                          bound_ms=bound, bound_by=by)
        print(f"qap_sa_step B={chains} N={n} K={k} cap={cap} ({label} "
              f"branch): kernel {ms:.4f} ms ({dev_ms:.4f} ms in a graph), "
              f"plain {plain:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{bound4:.4f} counting C^T and M^T as well), {evaluated} of "
              f"{chains * k} "
              f"candidates scored, max err {err}", flush=True)
    return out["smem"]


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


# K2 and K5 at order L2_ORDER, past their shared-memory thresholds: 8
# integer instances of NUM_PROCESSES islands each.
L2_INSTANCES = 8


def ga_shapes(device, pop):
    """``(branch, C, M, pops, order)`` of each branch K2 and K5 take on the
    GA's path: the 128 bucket's wave (shared memory) and ``L2_INSTANCES``
    integer instances of order ``L2_ORDER`` (L2), ``pop`` members an
    island."""
    from repro_torch.core import keys, qap
    Cs, Ms, pops = island_populations(device, pop)
    C2, M2 = integer_instances(L2_ORDER, L2_INSTANCES, 258, device)
    ck = keys.split(keys.prng_key(pop + 1, device),
                    L2_INSTANCES * NUM_PROCESSES)
    pops2 = qap.masked_random_permutations(ck, pop, L2_ORDER,
                                           L2_ORDER).contiguous()
    return (("smem", Cs, Ms, pops, ORDER), ("l2", C2, M2, pops2, L2_ORDER))


def check_qap_objective(device):
    """K2 against its plain version at the GA's shapes, each launch on the
    branch its order selects: one generation's children (16 an island)
    and the initial populations (32 an island), per instance and shared,
    on the shared-memory branch at the 128 bucket (64 islands) and on the
    L2 branch at order 256 (16 islands)."""
    import torch
    from repro_torch.kernels.qap_objective import (qap_objective_cuda,
                                                   qap_objective_plain)
    out = {}
    for label, pop in (("generation", N_OFF), ("init", GA_KW["pop_size"])):
        for branch, Cs, Ms, pops, _ in ga_shapes(device, pop):
            n = pops.shape[-1]
            for mats, (C, M) in (("batched", (Cs, Ms)),
                                 ("shared", (Cs[0].contiguous(),
                                             Ms[0].contiguous()))):
                launch = lambda: qap_objective_cuda(C, M, pops)
                got = branch_launched("qap_objective", branch, launch)
                want = qap_objective_plain(C, M, pops)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                require(torch.equal(got, want), f"qap_objective {label}/"
                        f"{branch}/{mats}: kernel != plain, max err {err}")
                ms, dev_ms = cuda_ms(launch, 200), graph_ms(launch, 200)
                plain = cuda_ms(lambda: qap_objective_plain(C, M, pops), 20)
                b0 = C.shape[0] if C.dim() == 3 else 1
                count = pops.shape[0] * pop
                nbytes = 4 * (2 * b0 * n * n + count * n + count)
                bound, by = bound_ms(nbytes, 2 * n * n * count)
                out[(label, branch, mats)] = dict(
                    err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain,
                    bound_ms=bound, bound_by=by)
                print(f"qap_objective {label:10s} {mats:7s} N={n} "
                      f"{pops.shape[0]}x{pop} ({branch} branch): kernel "
                      f"{ms:.4f} ms ({dev_ms:.4f} ms in a graph), plain "
                      f"{plain:.4f} ms, bound {bound:.4f} ms ({by}), max err "
                      f"{err}", flush=True)
    return out


def check_qap_ga_step(device):
    """K5 against its plain version on both branches: the shared-memory
    one with 64 islands of 32, order 125 in the 128 bucket, the L2 one
    with 16 islands of 32 at order 256; each at the engine's GA settings
    (16 children, binary tournaments, OX, p_mutation 0.001) and at a wider
    setting (32 children, more than the kernel's 16 warps: every member
    replaced, the elitism guard; OXS, p_mutation 0.3).  Returns the 128
    bucket's numbers at the engine's settings."""
    import torch
    from repro_torch.core import keys
    from repro_torch.kernels.qap_ga_step import (qap_ga_step_cuda,
                                                 qap_ga_step_plain)
    from repro_torch.kernels.qap_objective import qap_objective_plain
    pop = GA_KW["pop_size"]
    engine_kw = dict(n_off=N_OFF, tournament=2, p_crossover=1.0,
                     p_mutation=0.001, crossover="ox")
    wide_kw = dict(n_off=pop, tournament=3, p_crossover=0.7, p_mutation=0.3,
                   crossover="oxs")
    out = {}
    for branch, Cs, Ms, pops, order in ga_shapes(device, pop):
        islands, _, n = pops.shape
        fits = qap_objective_plain(Cs, Ms, pops)
        step_keys = keys.split(keys.prng_key(5, device), islands)
        nv = torch.full((islands,), order, dtype=torch.int32, device=device)
        args = (Cs, Ms, pops, fits, step_keys, nv)
        err = 0.0
        for kw in (engine_kw, wide_kw):
            got = branch_launched("qap_ga_step", branch,
                                  lambda: qap_ga_step_cuda(*args, **kw))
            want = qap_ga_step_plain(*args, **kw)
            torch.cuda.synchronize()
            for name, g, w in zip(("pop", "fit"), got, want):
                e = float((g.float() - w.float()).abs().max())
                err = max(err, e)
                require(torch.equal(g, w), f"qap_ga_step {branch} {name} "
                        f"{kw}: kernel != plain (max err {e})")
        launch = lambda: qap_ga_step_cuda(*args, **engine_kw)
        ms, dev_ms = cuda_ms(launch, 100), graph_ms(launch, 100)
        plain = cuda_ms(lambda: qap_ga_step_plain(*args, **engine_kw), 10)
        nbytes = (4 * 2 * Cs.shape[0] * n * n        # C, M
                  + 2 * 4 * islands * pop * n        # populations in and out
                  + 2 * 4 * islands * pop            # fitness in and out
                  + islands * (8 + 4))               # key words, n_valid
        bound, by = bound_ms(nbytes, 2 * n * n * islands * N_OFF)
        out[branch] = dict(err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain,
                           bound_ms=bound, bound_by=by)
        print(f"qap_ga_step {islands} islands x {pop}, {N_OFF} children, "
              f"N={n} ({branch} branch): kernel {ms:.4f} ms ({dev_ms:.4f} ms "
              f"in a graph), plain {plain:.4f} ms, bound {bound:.4f} ms "
              f"({by}), max err {err}", flush=True)
    out["smem"]["err"] = max(v["err"] for v in out.values())
    return out["smem"]


@functools.lru_cache(maxsize=None)
def torus(dims):
    from repro_torch.core import exact
    return exact.make_torus(dims)


@functools.lru_cache(maxsize=None)
def torus_levels():
    """The 4096 torus's level stack at the default MultilevelConfig:
    ``[(C, M, flow_pairs, sys_pairs), ...]``, finest first."""
    from repro_torch.core import multilevel
    inst = torus(ML_TORI[-1])
    stack, _ = multilevel.coarsen_levels(inst.C, inst.M,
                                         multilevel.MultilevelConfig())
    return stack


def second_instance(C, M, seed):
    """Another instance of the same order and ELL width: C and M
    relabelled by two random permutations."""
    import numpy as np
    rng = np.random.default_rng(seed)
    s, t = rng.permutation(C.shape[0]), rng.permutation(C.shape[0])
    return C[np.ix_(s, s)], M[np.ix_(t, t)]


def flows_pair(C, M, b0, device):
    """Shared ``(S, M)`` for ``b0 == 0``, else ``b0`` instances (the level
    and relabelled copies) with batched leaves."""
    import numpy as np
    import torch
    from repro_torch.core import sparse
    if b0 == 0:
        return (sparse.from_dense(C, device=device),
                torch.as_tensor(M, device=device))
    mats = [(C, M)] + [second_instance(C, M, i) for i in range(1, b0)]
    Cs = np.stack([c for c, _ in mats])
    Ms = np.stack([m for _, m in mats])
    return (sparse.from_dense(Cs, device=device),
            torch.as_tensor(Ms, device=device))


def _unique(idx):
    import torch
    return int(torch.unique(torch.cat([i.reshape(-1) for i in idx])).numel())


def objective_sparse_work(S, M, perms):
    """(bytes, f32 ops) that K6's inputs need: each stored nonzero of the
    flows (column id and value) once per instance, every permutation,
    each distinct M entry the nonzeros select, the outputs."""
    import torch
    B, P, n = perms.shape
    b0 = M.shape[0] if M.dim() == 3 else 1
    d = S.max_degree
    cols = S.cols.long().reshape(b0, n, d)
    nz = S.vals.reshape(b0, n, d) != 0
    q = B * P // b0
    pl = perms.long().reshape(b0, q, n)
    pc = torch.gather(pl, 2, cols.reshape(b0, 1, n * d).expand(b0, q, n * d))
    inst = torch.arange(b0, device=perms.device).view(b0, 1, 1, 1)
    lin = inst * n * n + pl[..., None] * n + pc.reshape(b0, q, n, d)
    m_entries = _unique([lin[nz[:, None].expand_as(lin)]])
    nnz = int(nz.sum())
    return (8 * nnz + 4 * B * P * n + 4 * m_entries + 4 * B * P,
            2 * nnz * q)


def delta_sparse_work(S, M, p, pairs):
    """(bytes, f32 ops) that K7's inputs need: the ELL rows a and b of C
    and C^T (their stored nonzeros), each distinct entry of p and of M
    the unmasked nonzeros and the corners select, the pairs, the
    outputs."""
    import torch
    B, n = p.shape
    K = pairs.shape[1]
    b0 = M.shape[0] if M.dim() == 3 else 1
    d = S.max_degree
    inst = (torch.arange(B, device=p.device) // (B // b0))[:, None].expand(B, K)
    pl = p.long()
    a, b = pairs[..., 0].long(), pairs[..., 1].long()
    u, v = torch.gather(pl, 1, a), torch.gather(pl, 1, b)
    row = torch.arange(B, device=p.device)[:, None].expand(B, K)
    m_idx = [inst * n * n + x * n + y for x, y in ((u, u), (v, v), (u, v),
                                                   (v, u))]
    p_idx = [row * n + a, row * n + b]
    ops = 13 * B * K
    ell_rows = [inst * n + a, inst * n + b]
    for cols, vals, transposed in ((S.cols, S.vals, False),
                                   (S.cols_t, S.vals_t, True)):
        cols = cols.long().reshape(b0, n, d)
        vals = vals.reshape(b0, n, d)
        for r in (a, b):
            ks, ws = cols[inst, r], vals[inst, r]               # (B, K, D)
            keep = (ws != 0) & (ks != a[..., None]) & (ks != b[..., None])
            pk = torch.gather(pl, 1, ks.reshape(B, -1)).reshape(ks.shape)
            base = inst[..., None] * n * n
            for x in (u, v):
                xi = x[..., None]
                lin = base + (pk * n + xi if transposed else xi * n + pk)
                m_idx.append(lin[keep])
            p_idx.append((row[..., None] * n + ks)[keep])
            ops += 3 * int(keep.sum())
    deg = torch.stack([S.deg.reshape(b0, n), S.deg_t.reshape(b0, n)])
    rows = torch.unique(torch.cat([r.reshape(-1) for r in ell_rows]))
    ell_bytes = 8 * int(deg.reshape(2, -1)[:, rows].sum())
    return (ell_bytes + 4 * _unique(m_idx) + 4 * _unique(p_idx)
            + 12 * B * K, ops)


def check_qap_delta_sparse(device):
    """K7 against its plain version on the 4096 torus's finest (n=4096,
    D=6) and coarsest (n=128, D=46) refinement levels, at the refinement
    shape (4 chains x 16 candidates, shared leaves and two instances)
    and the polish shape (1 x 256, shared and the engine's one-instance
    batch)."""
    import torch
    from repro_torch.core import keys, qap
    from repro_torch.kernels.qap_sparse import (qap_delta_sparse_cuda,
                                                qap_delta_sparse_plain)
    stack = torus_levels()
    out = {}
    for level, (C, M, _, _) in (("finest", stack[0]), ("coarsest", stack[-1])):
        n = C.shape[0]
        for label, chains, k in (("refine", ML_CHAINS, ML_K),
                                 ("polish", 1, POLISH_K)):
            ck = keys.split(keys.prng_key(n + k, device), chains)
            p = qap.random_permutation(ck, n)
            pairs = qap.random_swap_pairs(keys.fold_in(ck, 1), k, n)
            for mats, b0 in (("shared", 0), ("batched", min(2, chains))):
                S, Mt = flows_pair(C, M, b0, device)
                launch = lambda: qap_delta_sparse_cuda(S, Mt, p, pairs)
                got = launch()
                want = qap_delta_sparse_plain(S, Mt, p, pairs)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                require(torch.equal(got, want), f"qap_delta_sparse {level}/"
                        f"{label}/{mats}: kernel != plain, max err {err}")
                ms, dev_ms = cuda_ms(launch, 200), graph_ms(launch, 200)
                plain = cuda_ms(lambda: qap_delta_sparse_plain(S, Mt, p,
                                                               pairs), 20)
                bound, by = bound_ms(*delta_sparse_work(S, Mt, p, pairs))
                out[(level, label, mats)] = dict(
                    err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain,
                    bound_ms=bound, bound_by=by)
                print(f"qap_delta_sparse {level:8s} N={n} D={S.max_degree} "
                      f"{label:6s} {mats:7s} B={chains} K={k}: kernel "
                      f"{ms:.4f} ms ({dev_ms:.4f} ms in a graph), plain "
                      f"{plain:.4f} ms, bound {bound:.6f} ms ({by}), max err "
                      f"{err}", flush=True)
    return out


def check_qap_objective_sparse(device):
    """K6 against its plain version, bit for bit: at every level of the
    4096 torus (n 4096 ... 128, D 6 ... 46) at the route's two shapes, 1
    x 1 (``make_beta``, ``_seed_chain0``) and 1 x 4 (the chain start), and
    at a wider 64 x 4 batch on the finest level; shared leaves and
    batched ones (the engine's one instance; two at 64 x 4).  Then on
    real-valued flows at the finest and coarsest levels: two calls give
    the same bits, a permutation alone the same bits as in the batch,
    within 1e-5 of the plain version's largest |F|."""
    import torch
    from repro_torch.core import keys, qap, sparse
    from repro_torch.kernels.qap_sparse import (qap_objective_sparse_cuda,
                                                qap_objective_sparse_plain)
    stack = torus_levels()
    out = {}
    cases = [(level, 1, per) for level in stack for per in (1, ML_CHAINS)]
    for level, rows, per in cases + [(stack[0], 64, ML_CHAINS)]:
        C, M = level[0], level[1]
        n = C.shape[0]
        pk = keys.split(keys.prng_key(rows + per + n, device), rows * per)
        perms = qap.random_permutation(pk, n).reshape(rows, per, n)
        for mats, b0 in (("shared", 0), ("batched", min(2, rows))):
            S, Mt = flows_pair(C, M, b0, device)
            got = qap_objective_sparse_cuda(S, Mt, perms)
            want = qap_objective_sparse_plain(S, Mt, perms)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            require(torch.equal(got, want), f"qap_objective_sparse N={n} "
                    f"{rows}x{per}/{mats}: kernel != plain, max err {err}")
            launch = lambda: qap_objective_sparse_cuda(S, Mt, perms)
            ms, dev_ms = cuda_ms(launch, 200), graph_ms(launch, 200)
            plain = cuda_ms(lambda: qap_objective_sparse_plain(S, Mt, perms),
                            20)
            bound, by = bound_ms(*objective_sparse_work(S, Mt, perms))
            out[(n, rows, per, mats)] = dict(err=err, ms=ms, plain_ms=plain,
                                             bound_ms=bound, bound_by=by)
            print(f"qap_objective_sparse N={n} D={S.max_degree} {rows}x{per} "
                  f"{mats:7s}: kernel {ms:.4f} ms ({dev_ms:.5f} ms in a "
                  f"graph), plain {plain:.4f} ms, bound {bound:.6f} ms "
                  f"({by}), max err {err}", flush=True)
    g = torch.Generator().manual_seed(19)
    for level in (stack[0], stack[-1]):
        C, M = level[0], level[1]
        n = C.shape[0]
        S = sparse.from_dense(C * torch.rand(C.shape, generator=g).numpy(),
                              device=device)
        Mr = torch.as_tensor(M, device=device) * torch.rand(
            M.shape, generator=g).to(device)
        pk = keys.split(keys.prng_key(n, device), ML_CHAINS)
        perms = qap.random_permutation(pk, n).reshape(1, ML_CHAINS, n)
        got = qap_objective_sparse_cuda(S, Mr, perms)
        again = qap_objective_sparse_cuda(S, Mr, perms)
        alone = qap_objective_sparse_cuda(S, Mr, perms[:, :1].contiguous())
        want = qap_objective_sparse_plain(S, Mr, perms)
        torch.cuda.synchronize()
        err, scale = (float((got - want).abs().max()),
                      float(want.abs().max()))
        require(torch.equal(got, again) and torch.equal(alone[0, 0],
                                                        got[0, 0]),
                f"qap_objective_sparse N={n}: real-valued flows gave other "
                f"bits on another call or alone")
        require(err <= 1e-5 * scale, f"qap_objective_sparse N={n}: real-"
                f"valued max err {err} > 1e-5 * {scale}")
        print(f"qap_objective_sparse N={n} D={S.max_degree} real-valued "
              f"1x{ML_CHAINS}: the same bits on two calls and alone, max err "
              f"{err:.3e} against the plain version (max |F| {scale:.4e})",
              flush=True)
    return out


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


def require_smem_branch(route, counts, branches):
    """Every K1, K2, K4 and K5 launch of a dense bucket (orders up to 128)
    or a multilevel coarse solve (order 64) took the shared-memory
    branch."""
    for kernel in ("qap_delta", "qap_sa_step", "qap_objective",
                   "qap_ga_step"):
        require(branches[f"{kernel}/smem"] == counts[kernel]
                and branches[f"{kernel}/l2"] == 0,
                f"[{route}] {kernel} launches {counts[kernel]}, by branch "
                f"{branches}: not all on the shared-memory branch")


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
        branches = ops.branch_counts()
        for r, fut in zip(wave, futs):
            resps[r.job_id] = fut.result()
            check_response(r, resps[r.job_id], optima[r.job_id])
        require_smem_branch(route, counts, branches)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        ratio = sum(resps[r.job_id].objective / optima[r.job_id]
                    for r in wave) / len(wave)
        print(f"[{route}] bucket {resps[wave[0].job_id].bucket}: {len(wave)} "
              f"requests of order {order}, wave wall {wall:.4f} s, launches "
              f"{counts}, branches {branches}, mean F/F0 {ratio:.4f}",
              flush=True)
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


def ml_requests():
    from repro_torch.serve import MapRequest
    out = []
    for i, dims in enumerate(ML_TORI):
        inst = torus(dims)
        out.append((MapRequest(job_id=f"torus{inst.C.shape[0]}", C=inst.C,
                               M=inst.M, seed=50 + i), inst.optimum))
    return out


def ml_engine(device):
    from repro_torch.core.multilevel import MultilevelConfig
    from repro_torch.serve import MappingEngine
    return MappingEngine(multilevel_min_n=256,
                         multilevel_cfg=MultilevelConfig(), device=device)


def drive_multilevel():
    """Serve the three tori on the card through the large buckets, one
    request at a time: the launch counts set to 0 just before each and
    read just after.  The level trace of each solve is read from
    ``solve_multilevel``'s result as the engine calls it."""
    import torch
    from repro_torch.core import multilevel
    from repro_torch.kernels import ops
    results = []
    solve = multilevel.solve_multilevel

    def traced(*args, **kw):
        res = solve(*args, **kw)
        results.append(res)
        return res

    multilevel.solve_multilevel = traced
    engine = ml_engine("cuda")
    resps, total = {}, {}
    try:
        for req, optimum in ml_requests():
            ops.reset_launch_counts()
            t = time.perf_counter()
            fut = engine.submit(req)
            engine.flush()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = ops.launch_counts()
            branches = ops.branch_counts()
            resp = resps[req.job_id] = fut.result()
            check_response(req, resp, optimum)
            require_smem_branch("multilevel", counts, branches)
            for kernel in ("qap_delta", "qap_objective_sparse",
                           "qap_delta_sparse"):
                require(counts[kernel] > 0,
                        f"[multilevel] {req.job_id} launched no {kernel}")
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            res = results[-1]
            levels = [dict(n=lv.n, nnz=lv.nnz, f_prolonged=lv.f_prolonged,
                           f_refined=lv.f_refined) for lv in res.levels]
            print(f"[multilevel] bucket {resp.bucket}: order "
                  f"{req.C.shape[0]}, wall {wall:.4f} s (solve "
                  f"{res.seconds:.4f} s), launches {counts}, F/F0 "
                  f"{resp.objective / optimum:.4f}, coarse F "
                  f"{res.coarse_objective}, levels {levels}", flush=True)
    finally:
        multilevel.solve_multilevel = solve
    return resps, total


def check_multilevel_against_cpu(resps):
    """The same engine on the CPU on the 1024 and 4096 requests."""
    engine = ml_engine("cpu")
    picks = [r for r, _ in ml_requests()][1:]
    t = time.perf_counter()
    futs = [engine.submit(r) for r in picks]
    engine.flush()
    for r, fut in zip(picks, futs):
        cpu, gpu = fut.result(), resps[r.job_id]
        require((cpu.perm == gpu.perm).all() and cpu.objective == gpu.objective,
                f"[multilevel] {r.job_id}: card F={gpu.objective} != cpu "
                f"F={cpu.objective}")
    print(f"[multilevel] card == cpu on {[r.job_id for r in picks]} "
          f"({time.perf_counter() - t:.1f} s on the cpu)", flush=True)


def device_memory_used_mib():
    """The card's used memory by ``nvidia-smi`` (MiB): readable before
    this process has a CUDA context, unlike ``torch.cuda.mem_get_info``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()
    return float(out[0])


def context_bytes():
    """Device memory one CUDA context takes: the card's used memory
    before and after this process creates its own (one 4-byte tensor)."""
    import torch
    before = device_memory_used_mib()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    ctx = (device_memory_used_mib() - before) * 2 ** 20
    require(ctx > 0, f"[rm-replay] a CUDA context measured {ctx} bytes")
    return ctx


def rm_trace(num_jobs):
    from repro_torch.serve import synthetic_trace
    return synthetic_trace(num_jobs, **RM_TRACE)


def rm_replay(engine, num_jobs):
    """Replay the trace through ``ResourceManager`` over ``engine``, the
    launch counts set to 0 just before ``run`` and read just after;
    returns the manager, its report, the run's wall and the counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import ResourceManager
    rm = ResourceManager(torus(RM_TORUS).M, engine,
                         map_timeout_s=RM_TIMEOUT_S)
    for spec in rm_trace(num_jobs):
        rm.submit_job(spec)
    ops.reset_launch_counts()
    t = time.perf_counter()
    rep = rm.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return rm, rep, wall, (ops.launch_counts(), ops.branch_counts())


def rm_decisions(rm):
    """Each job's decisions: start and finish, candidate policy, backfill,
    nodes, permutation and objective."""
    return {h.job_id: (h.start_s, h.finish_s, h.candidate_policy,
                       h.backfilled, h.allocation.nodes.tolist(),
                       h.response.perm.tolist(), h.response.objective)
            for h in rm.handles}


def check_rm_replay(label, rm, rep, wall, counts, num_jobs):
    """Every job finished with a permutation of its size whose objective
    is F(perm) recomputed in numpy and no worse than the identity; jobs
    whose run intervals overlap hold disjoint nodes.  Prints the
    replay's metrics."""
    import numpy as np
    require(rep.jobs == num_jobs and all(h.done() for h in rm.handles),
            f"[rm-replay] {label}: {rep.jobs} of {num_jobs} jobs finished")
    for h in rm.handles:
        n, perm = h.spec.size, np.asarray(h.response.perm)
        require(perm.shape == (n,) and (np.sort(perm) == np.arange(n)).all(),
                f"[rm-replay] {label} {h.job_id}: infeasible permutation")
        M_sub = np.asarray(h.allocation.M_sub, np.float64)
        f = float((np.asarray(h.C, np.float64)
                   * M_sub[np.ix_(perm, perm)]).sum())
        require(f == h.response.objective <= h.response.baseline,
                f"[rm-replay] {label} {h.job_id}: objective "
                f"{h.response.objective}, F(perm) {f}, baseline "
                f"{h.response.baseline}")
    for i, a in enumerate(rm.handles):
        for b in rm.handles[i + 1:]:
            if a.start_s < b.finish_s and b.start_s < a.finish_s:
                require(not set(a.allocation.nodes.tolist())
                        & set(b.allocation.nodes.tolist()),
                        f"[rm-replay] {label}: {a.job_id} and {b.job_id} "
                        f"overlap in time and share nodes")
    print(f"[rm-replay] {label}: {rep.jobs} jobs, makespan "
          f"{rep.makespan_s:.4f} s (virtual), utilization "
          f"{rep.utilization:.4f}, wait mean / p50 / p99 "
          f"{rep.mean_wait_s:.4f} / {rep.wait_p50_s:.4f} / "
          f"{rep.wait_p99_s:.4f} s, backfilled {rep.backfilled}, mean "
          f"objective {rep.mean_objective:.4f}, mean improvement "
          f"{rep.mean_improvement:.4f}, candidate waves "
          f"{rep.candidate_waves}, max batches per wave "
          f"{rep.max_batches_per_wave}", flush=True)
    print(f"[rm-replay] {label}: map wall per wave p50 "
          f"{rep.map_wall_p50_ms:.4f} ms, p99 {rep.map_wall_p99_ms:.4f} ms "
          f"(host clock; each wave ends in a copy to the host); replay wall "
          f"{wall:.4f} s; launches {counts[0]}, branches {counts[1]}",
          flush=True)


class MemoryProbe:
    """A fleet as the manager calls it, reading the card's free memory
    just before the third wave is submitted: both workers alive, each
    past its first wave (worker 0 dies in its second, the third overall)."""

    def __init__(self, fleet):
        self.fleet, self.free, self.apps = fleet, None, None

    def __getattr__(self, name):
        return getattr(self.fleet, name)

    def submit(self, req):
        import torch
        f = self.fleet
        if (self.free is None and f.stats.dispatched_waves >= 2
                and all(w.alive and w.completed > 0 for w in f.workers)):
            self.free = torch.cuda.mem_get_info()[0]
            self.apps = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip()
        return f.submit(req)


def fleet_line(label, stats):
    print(f"[rm-replay] {label} fleet: deaths {stats.worker_deaths}, "
          f"respawns {stats.respawns}, requeued {stats.requeued}, failed "
          f"{stats.failed}, first_recovery_s {stats.first_recovery_s}, "
          f"dispatched waves {stats.dispatched_waves}, solver batches "
          f"{stats.solver_batches}", flush=True)


def drive_rm_replay(ctx_bytes):
    """The resource manager on the card: (1) the 24-job trace through one
    engine; (2) through a subprocess fleet of two workers on the card,
    worker 0 SIGKILLing itself after 4 requests: per job equal to (1),
    one death, no failure, free device memory down by at least one CUDA
    context per child while both live; (3) the first 8 jobs through one
    engine on the card, a thread fleet under a kill on the card and one
    engine on the CPU: all three equal; (4) ``PlacementService`` on the
    first job's three candidates, card == CPU.  Returns replay 1's
    launch counts."""
    import torch
    from repro_torch.launch.placement import PlacementService
    from repro_torch.serve import (ClusterState, EngineFleet, FaultPlan,
                                   MappingEngine, default_flows)
    t_route = time.perf_counter()
    print(f"[rm-replay] {RM_JOBS}-job synthetic_trace({RM_TRACE}) on the "
          f"{'x'.join(map(str, RM_TORUS))} torus, ResourceManager defaults, "
          f"MappingEngine(warm_start=False) at the default budgets",
          flush=True)

    engine = MappingEngine(warm_start=False)
    t = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    print(f"[rm-replay] single engine warmup {time.perf_counter() - t:.3f} "
          f"s", flush=True)
    rm1, rep1, wall, counts = rm_replay(engine, RM_JOBS)
    check_rm_replay("single engine", rm1, rep1, wall, counts, RM_JOBS)
    require(rep1.max_batches_per_wave == 1,
            f"[rm-replay] {rep1.max_batches_per_wave} batches in a wave")
    require(counts[0]["qap_delta"] > 0, "[rm-replay] launched no qap_delta")
    require_smem_branch("rm-replay", *counts)
    first = rm_decisions(rm1)

    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    fleet = EngineFleet(workers=2, transport="subprocess",
                        fault_plan=FaultPlan(sigkill_worker_at={0: 4}),
                        warm_start=False).start()
    probe = MemoryProbe(fleet)
    try:
        rm2, rep2, wall, counts2 = rm_replay(probe, RM_JOBS)
    finally:
        fleet.stop()
    free_after = torch.cuda.mem_get_info()[0]
    check_rm_replay("subprocess fleet, SIGKILL", rm2, rep2, wall, counts2,
                    RM_JOBS)
    print("[rm-replay] (the subprocess fleet's launches are counted in its "
          "children, not here)", flush=True)
    fleet_line("subprocess", fleet.stats)
    require(probe.free is not None, "[rm-replay] memory probe never ran")
    drop = free0 - probe.free
    print(f"[rm-replay] free device memory {free0 / 2 ** 30:.3f} GiB before "
          f"the fleet, {probe.free / 2 ** 30:.3f} GiB with both children "
          f"alive (down {drop / 2 ** 20:.1f} MiB; one CUDA context "
          f"{ctx_bytes / 2 ** 20:.1f} MiB), {free_after / 2 ** 30:.3f} GiB "
          f"after stop; nvidia-smi compute apps: {probe.apps!r}", flush=True)
    require(drop >= 2 * ctx_bytes, f"[rm-replay] free memory down "
            f"{drop} bytes with two children alive, less than two CUDA "
            f"contexts ({ctx_bytes} bytes each): the children are not on "
            f"the card")
    st = fleet.stats
    require(st.worker_deaths == 1 and st.failed == 0
            and st.respawns <= RM_MAX_RESPAWNS,
            f"[rm-replay] subprocess fleet: deaths {st.worker_deaths}, "
            f"failed {st.failed}, respawns {st.respawns}")
    require(rm_decisions(rm2) == first,
            "[rm-replay] subprocess fleet decisions != single engine's")
    skip = ("map_wall_p50_ms", "map_wall_p99_ms", "max_batches_per_wave")
    require({k: v for k, v in rep2.asdict().items() if k not in skip}
            == {k: v for k, v in rep1.asdict().items() if k not in skip},
            "[rm-replay] subprocess fleet report != single engine's")

    short = {}
    rm3, rep3, wall, counts3 = rm_replay(MappingEngine(warm_start=False),
                                         RM_CPU_JOBS)
    check_rm_replay(f"{RM_CPU_JOBS} jobs, single engine", rm3, rep3, wall,
                    counts3, RM_CPU_JOBS)
    short["card"] = rm_decisions(rm3)
    fleet = EngineFleet(workers=2, fault_plan=FaultPlan(kill_worker_at={1: 2}),
                        warm_start=False)
    try:
        rm4, rep4, wall, counts4 = rm_replay(fleet, RM_CPU_JOBS)
    finally:
        fleet.stop()
    check_rm_replay(f"{RM_CPU_JOBS} jobs, thread fleet, kill", rm4, rep4,
                    wall, counts4, RM_CPU_JOBS)
    fleet_line("thread", fleet.stats)
    require(fleet.stats.worker_deaths == 1 and fleet.stats.failed == 0,
            "[rm-replay] thread fleet: deaths or failures off the plan")
    require(counts4[0]["qap_delta"] > 0,
            "[rm-replay] thread fleet launched no qap_delta")
    short["thread fleet"] = rm_decisions(rm4)
    rm5, rep5, wall, _ = rm_replay(MappingEngine(warm_start=False,
                                                 device="cpu"), RM_CPU_JOBS)
    print(f"[rm-replay] {RM_CPU_JOBS} jobs on the cpu: {wall:.1f} s",
          flush=True)
    short["cpu"] = rm_decisions(rm5)
    require(short["card"] == short["thread fleet"] == short["cpu"],
            "[rm-replay] 8-job trace: card, thread fleet and cpu disagree")
    print(f"[rm-replay] {RM_CPU_JOBS}-job trace: card == thread fleet == cpu",
          flush=True)

    spec = rm_trace(1)[0]
    cands = ClusterState(torus(RM_TORUS).M).candidate_subsets(spec.size)
    insts = [(default_flows(spec.size, spec.seed), c.M_sub) for c in cands]
    placed = {}
    for device in ("cuda", "cpu"):
        svc = PlacementService(device=device)
        t = time.perf_counter()
        placed[device] = [(r.perm.tolist(), r.cost_before, r.cost_after)
                          for r in svc.solve_batch(insts)]
        if device == "cuda":
            torch.cuda.synchronize()
        print(f"[rm-replay] placement of {spec.job_id}'s {len(insts)} "
              f"candidates (order {spec.size}) on {device}: "
              f"{time.perf_counter() - t:.3f} s, F {[p[2] for p in placed[device]]}"
              f" of identity {[p[1] for p in placed[device]]}", flush=True)
        svc.close()
    require(placed["cuda"] == placed["cpu"],
            "[rm-replay] placement: card != cpu")
    print(f"[rm-replay] route wall {time.perf_counter() - t_route:.1f} s",
          flush=True)
    return counts[0]


def scan_inputs(shape, device, seed):
    """u, dt, a, b, c for K8 in the ranges of the reference's kernel test
    (dt in [0.001, 0.1], a in [-1, -0.1]), drawn on the card."""
    import torch
    bsz, s, d, n = shape
    g = torch.Generator(device=device).manual_seed(seed)
    rand = functools.partial(torch.rand, generator=g, device=device)
    randn = functools.partial(torch.randn, generator=g, device=device)
    return (randn(bsz, s, d), rand(bsz, s, d) * 0.099 + 0.001,
            -(rand(d, n) * 0.9 + 0.1), randn(bsz, s, n), randn(bsz, s, n))


def sfu_floor_ms(count):
    """Least milliseconds for ``count`` special-function operations (one
    ``ex2`` in each accurate ``expf``) at 16 a clock per SM, at the card's
    SM count and its largest SM clock (``nvidia-smi clocks.max.sm``)."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return count / (16 * sms * mhz * 1e6) * 1e3, sms, mhz


def check_selective_scan(device):
    """K8 against its plain version at the Jamba prefill's full-width
    shape and at a ragged one: ``y`` and ``h_last`` within 2e-4 of their
    largest magnitude (the reference's kernel-test bar); whether they are
    bitwise equal is printed, and beside the byte bound the floor of its
    ``expf`` count on the special-function units."""
    import torch
    from repro_torch.kernels.selective_scan import (selective_scan_cuda,
                                                    selective_scan_plain)
    out = {}
    for label, shape in (("full", (LM_BATCH, LM_PROMPT, 8192, 16)),
                         ("ragged", (2, 49, 200, 4))):
        args = scan_inputs(shape, device, sum(shape))
        y, h = selective_scan_cuda(*args)
        want_y, want_h = selective_scan_plain(*args)
        torch.cuda.synchronize()
        err = float((y - want_y).abs().max())
        err_h = float((h - want_h).abs().max())
        for name, e, w in (("y", err, want_y), ("h_last", err_h, want_h)):
            require(e <= 2e-4 * float(w.abs().max()), f"selective_scan "
                    f"{label}: {name} max err {e} > 2e-4 * max")
        launch = lambda: selective_scan_cuda(*args)
        ms, dev_ms = cuda_ms(launch, 50), graph_ms(launch, 50)
        plain = cuda_ms(lambda: selective_scan_plain(*args), 2)
        bsz, s, d, n = shape
        nbytes = 4 * (3 * bsz * s * d + d * n + 2 * bsz * s * n + bsz * d * n)
        bound, by = bound_ms(nbytes, 7 * bsz * s * d * n + bsz * s * d)
        sfu, sms, mhz = sfu_floor_ms(bsz * s * d * n)
        out[label] = dict(err=err, err_h=err_h, ms=ms, graph_ms=dev_ms,
                          plain_ms=plain, bound_ms=bound, bound_by=by)
        print(f"selective_scan {label:6s} B={bsz} S={s} D={d} N={n}: kernel "
              f"{ms:.4f} ms ({dev_ms:.4f} ms in a graph), plain {plain:.4f} "
              f"ms, bound {bound:.4f} ms ({by}); expf floor {sfu:.4f} ms ("
              f"{bsz * s * d * n} special-function ops at 16 a clock on "
              f"{sms} SMs at {mhz:.0f} MHz), max err y {err} h_last "
              f"{err_h}, bitwise y {torch.equal(y, want_y)} h_last "
              f"{torch.equal(h, want_h)}", flush=True)
    return out


class TimedModel:
    """The port's ``Model`` with every prefill and decode step timed on
    the host clock around a ``torch.cuda.synchronize()``, and the logits
    they return kept."""

    def __init__(self, model):
        self.model, self.device = model, model.device
        self.times = {"prefill": [], "decode": []}
        self.logits = []

    def _timed(self, name, fn, *args, **kw):
        import torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = fn(*args, **kw)
        torch.cuda.synchronize()
        self.times[name].append(time.perf_counter() - t)
        self.logits.append(logits)
        return logits, cache

    def prefill(self, *args, **kw):
        return self._timed("prefill", self.model.prefill, *args, **kw)

    def decode_step(self, *args, **kw):
        return self._timed("decode", self.model.decode_step, *args, **kw)


def lm_config():
    """Jamba-v0.1-52B at full width, cut to one super-block of 8 layers,
    served with bf16 weights and dropless MoE."""
    from repro_torch import configs
    return configs.get_config("jamba_v0_1_52b").with_overrides(
        num_layers=8, layer_pattern="mMmMaMmM", param_dtype="bf16",
        moe_capacity_factor=0.0)


def drive_lm_serve():
    """Serve 4 prompts of 512 tokens, 16 greedy tokens each, through the
    port's ``Engine`` on the card, the launch counts set to 0 just before
    ``generate`` and read just after; then decode against teacher
    forcing at full width.  Returns the launch counts of ``generate``."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.api import Model
    from repro_torch.models.param import tree_leaves
    from repro_torch.serve import Engine, ServeConfig
    cfg = lm_config()
    mamba_layers = sum(ch in "mM" for ch in cfg.layer_pattern)
    model = Model(cfg, device="cuda")
    t = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[lm-serve] {cfg.name} cut to {cfg.num_layers} layers "
          f"({cfg.layer_pattern}), {model.num_params()} parameters in "
          f"{cfg.param_dtype}, drawn on the card in "
          f"{time.perf_counter() - t:.2f} s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    timed = TimedModel(model)
    engine = Engine(timed, params, ServeConfig(max_new_tokens=LM_NEW))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    out = engine.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    require(out.shape == (LM_BATCH, LM_NEW), f"[lm-serve] output {out.shape}")
    require(((out >= 0) & (out < cfg.vocab_size)).all(),
            "[lm-serve] a token outside the vocabulary")
    require(all(bool(torch.isfinite(x).all()) for x in timed.logits),
            "[lm-serve] non-finite logits")
    require(counts["selective_scan"] == mamba_layers,
            f"[lm-serve] {counts['selective_scan']} selective_scan launches "
            f"for one prefill of {mamba_layers} Mamba layers")
    prefill_s = timed.times["prefill"][0]
    decode_s = sum(timed.times["decode"]) / len(timed.times["decode"])
    print(f"[lm-serve] {LM_BATCH} x {LM_PROMPT} prompts, {LM_NEW} greedy "
          f"tokens: generate wall {wall:.4f} s, prefill {prefill_s:.4f} s, "
          f"decode {decode_s * 1e3:.3f} ms per step "
          f"({len(timed.times['decode'])} steps), "
          f"{out.size / wall:.2f} generated tokens/s, peak "
          f"{peak / 2 ** 30:.2f} GiB, launches {counts}", flush=True)
    print(f"[lm-serve] tokens {out[:, :8].tolist()}", flush=True)
    # a decode step reads every weight but the embedding (dropless MoE
    # runs all experts): its least time at the card's memory rate
    step_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)
                     if t is not params["embed"]["embedding"])
    print(f"[lm-serve] a decode step reads {step_bytes / 1e9:.3f} GB of "
          f"weights: bound {step_bytes / H100_BYTES_PER_S * 1e3:.3f} ms "
          f"(bytes), measured {decode_s * 1e3:.3f} ms", flush=True)

    # decode against teacher forcing at full width: the gate in f32
    # compute on the same bf16 weights, then the served bf16 arithmetic
    gate = teacher_forcing(
        Model(cfg.with_overrides(compute_dtype=torch.float32), device="cuda"),
        params, LM_BATCH, "f32 compute")
    require(gate["agree"] >= 0.95,
            f"[lm-serve] f32 argmax agreement {gate['agree']} < 0.95")
    require(gate["diff"] <= 1e-3 * gate["scale"],
            f"[lm-serve] f32 teacher forcing: max diff {gate['diff']} > "
            f"1e-3 * {gate['scale']}")
    # The served bf16 arithmetic, measured: its logits come out of a bf16
    # product (the reference's logits_fn), so a row's top two often tie
    # within one bf16 step, and decode and prefill round differently
    # (other GEMM shapes); its argmax agreement is printed, not gated.
    teacher_forcing(model, params, LM_TF_ROWS, "bf16 compute")
    del params
    torch.cuda.empty_cache()
    return counts


def teacher_forcing(model, params, rows, label):
    """Logits of [prefill(S) -> decode token S] against the last logits of
    prefill(S + 1) for ``rows`` prompts of ``LM_PROMPT`` tokens (K8 7
    times per prefill).  Returns the agreement of the argmaxes, the max
    abs difference and the largest logit; prints each row's max
    difference and top-2 gap, and for each row whose argmaxes differ the
    gap between the two tokens' prefill logits."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    cfg = model.cfg
    toks = torch.as_tensor(
        np.random.default_rng(1).integers(2, cfg.vocab_size,
                                          (rows, LM_PROMPT + 1)),
        dtype=torch.int32, device="cuda")
    ops.reset_launch_counts()
    _, cache = model.prefill(params, {"tokens": toks[:, :LM_PROMPT]},
                             cache_len=LM_PROMPT + 8)
    a, _ = model.decode_step(params, cache, {"tokens": toks[:, LM_PROMPT:]},
                             LM_PROMPT)
    del cache
    b, _ = model.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    launched = ops.launch_counts()["selective_scan"]
    mamba_layers = sum(ch in "mM" for ch in cfg.layer_pattern)
    require(launched == 2 * mamba_layers, f"[lm-serve] {launched} "
            f"selective_scan launches for two prefills")
    require(bool(torch.isfinite(a).all() & torch.isfinite(b).all()),
            f"[lm-serve] non-finite teacher-forcing logits ({label})")
    ia, ib = a.argmax(-1), b.argmax(-1)
    top2 = b.topk(2, dim=-1).values
    rows_idx = torch.arange(rows, device=b.device)
    out = dict(agree=float((ia == ib).float().mean()),
               diff=float((a - b).abs().max()), scale=float(b.abs().max()))
    row_diff = (a - b).abs().amax(-1).tolist()
    top2_gap = (top2[:, 0] - top2[:, 1]).tolist()
    ties = (b[rows_idx, ib] - b[rows_idx, ia])[ia != ib].tolist()
    print(f"[lm-serve] decode vs teacher forcing at full width, {label}, "
          f"{rows} rows: max abs diff {out['diff']:.6f} (logits max "
          f"{out['scale']:.4f}), argmax agreement {out['agree']}; per row "
          f"max diff {[round(x, 4) for x in row_diff]}, top-2 gap "
          f"{[round(x, 4) for x in top2_gap]}, prefill-logit gap of each "
          f"disagreement {ties}", flush=True)
    return out


def check_lm_against_cpu():
    """Jamba's SMOKE width in f32, weights drawn once on the CPU from one
    seed: the card's greedy tokens equal the CPU's, and its prefill
    logits agree to 1e-4 of their largest magnitude."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models.api import Model
    from repro_torch.serve import Engine, ServeConfig
    cfg = configs.smoke_config("jamba_v0_1_52b").with_overrides(
        compute_dtype=torch.float32)
    prompts = np.random.default_rng(2).integers(
        2, cfg.vocab_size, (4, 49)).astype(np.int32)
    out, logits = {}, {}
    t = time.perf_counter()
    for device in ("cuda", "cpu"):
        model = Model(cfg, device=device)
        params = model.init(torch.Generator().manual_seed(0))
        ops.reset_launch_counts()
        logits[device], _ = model.prefill(
            params, {"tokens": torch.as_tensor(prompts, device=device)})
        launched = ops.launch_counts()["selective_scan"]
        require(launched == (7 if device == "cuda" else 0),
                f"[lm-serve] smoke prefill on {device}: {launched} launches")
        out[device] = Engine(model, params,
                             ServeConfig(max_new_tokens=8)).generate(prompts)
    err = float((logits["cuda"].cpu() - logits["cpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    require((out["cuda"] == out["cpu"]).all(),
            f"[lm-serve] smoke tokens: card {out['cuda'].tolist()} != cpu "
            f"{out['cpu'].tolist()}")
    require(err <= 1e-4 * scale, f"[lm-serve] smoke prefill logits: max err "
            f"{err} > 1e-4 * {scale}")
    print(f"[lm-serve] smoke width f32: card == cpu tokens {out['cuda'][0]}, "
          f"prefill logits max err {err} (max {scale:.4f}) "
          f"({time.perf_counter() - t:.1f} s)", flush=True)


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

    ctx_bytes = context_bytes()
    device = torch.device("cuda")
    delta = check_qap_delta(device)
    sa = check_qap_sa_step(device)
    obj = check_qap_objective(device)
    ga = check_qap_ga_step(device)
    dsp = check_qap_delta_sparse(device)
    osp = check_qap_objective_sparse(device)
    scan = check_selective_scan(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    ml_resps, runs["multilevel"] = drive_multilevel()
    check_multilevel_against_cpu(ml_resps)
    runs["rm-replay"] = drive_rm_replay(ctx_bytes)
    runs["lm-serve"] = drive_lm_serve()
    check_lm_against_cpu()

    d = delta[("event", "batched")]
    o = obj[("generation", "smem", "batched")]
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
        dict(name="qap_objective_sparse", route="cuda",
             source="src/repro_torch/csrc/qap_objective_sparse.cu",
             replaces="src/repro/kernels/qap_sparse.py:78",
             launches=runs["multilevel"]["qap_objective_sparse"],
             max_abs_err=max(v["err"] for v in osp.values()),
             **{k: osp[(4096, 1, ML_CHAINS, "batched")][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None),
        dict(name="qap_delta_sparse", route="cuda",
             source="src/repro_torch/csrc/qap_delta_sparse.cu",
             replaces="src/repro/kernels/qap_sparse.py:192",
             launches=runs["multilevel"]["qap_delta_sparse"],
             max_abs_err=max(v["err"] for v in dsp.values()),
             **{k: dsp[("finest", "refine", "batched")][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None),
        dict(name="selective_scan", route="cuda",
             source="src/repro_torch/csrc/selective_scan.cu",
             replaces="src/repro/kernels/selective_scan.py:73",
             launches=runs["lm-serve"]["selective_scan"],
             max_abs_err=max(v["err"] for v in scan.values()),
             **{k: scan["full"][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
