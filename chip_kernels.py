#!/usr/bin/env python3
"""Time the kernels of one checkout's port on one NVIDIA GPU, and probe
which kernels equal their plain versions bit for bit on inputs that are
not integer-valued.

Run from the root of a checkout:

    python3 chip_kernels.py [--src DIR] [--probe] [--host] [--k4-phases]
        [--k4-skeleton] [--k7-mt] [--k6]
    python3 chip_kernels.py [--src DIR] --k4-round

``--src`` is the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two commits can be compared in one
call on one card: unpack the other commit into a directory that
``.gitignore`` lists and run old, new, new, old.  The kernels are built
from that directory's sources.  For K1 ``qap_delta`` (the event round,
16 chains x 25 candidates per instance, and the polish round, 256
candidates per instance) and K4 ``qap_sa_step`` (16 chains per instance,
25 candidates, at most 10 acceptances), each at the 128 bucket's wave of
32 instances and the 64 and 32 buckets' waves of 3, and for K2
``qap_objective`` (16 children an island) and K5 ``qap_ga_step`` (islands
of 32), 2 islands a request at the same waves (64 islands at the 128
bucket, 6 at the others), then for K1 and K2 on their L2 branches
(Table 1's 32 x 50 and 4 x 64 on tai343 and tai729, the exact-size
polish's 1 x 256 at order 200, K2 at 8 x 4096) and K4 and K5 on theirs
(``chip_smoke.py``'s 128 x 25 and 16 islands of 32 at order 256, one
exact-size request at order 200, Table 1's fused 32 x 50 and 4 islands
of 128 with 64 children on tai343 and tai729), then for K7
``qap_delta_sparse`` at the
multilevel route's shapes (the 4096 torus's finest level, n=4096 and ELL
width 6, and its coarsest, n=128 and width 46, at 4 chains x 16
candidates; the polish's 1 x 256 on the finest) and K8
``selective_scan`` at the Jamba prefill's 4 x 512 x 8192, d_state 16,
it prints milliseconds per call by CUDA events over a loop of wrapper
calls, in a CUDA graph of the same calls (device time alone), and their
difference: what the host adds per call when it, and not the card, sets
the pace.  ``--probe`` also runs each kernel of the port (K1, K2, K4-K8)
and its plain version on random real-valued inputs and prints whether
they agree bit for bit (and K4, K5 and K6 against themselves on a second
call, K5's new members' fitness against K2's F of them).  ``--host``
splits what the host spends issuing a call of some rows into the
wrapper's Python and its C launch function.  ``--k4-phases`` splits K4's
L2 kernel's cycles a candidate by clock64() (``K4_PHASE_EDITS``), and
``--k4-skeleton`` times it against its loop alone and against an empty
loop (``K4_SKELETON_EDITS``), copies of the package's source built into
``build/``.
``--k7-mt`` also times, in a CUDA graph at every level of the 4096 torus
(4 chains x 16 candidates) and at the polish's 1 x 256, K7 as built (the
column terms gathered down columns of ``M``) against the same kernel
with the column terms gathered along rows of ``M^T``, a copy of the
package's source with only that changed.  ``--k6`` adds K6
``qap_objective_sparse`` at every level of the 4096 torus at the route's
1 x 1 and 1 x 4, and at 64 x 4 on the finest and coarsest levels, to the
timed kernels (any package, so old and new compare), and, for a package
whose K6 runs one cluster a permutation, times in a CUDA graph its
cluster capped at 4, 8 and 16 blocks and the variants of
``K6_STAGE_EDITS`` (where the kernel keeps the permutation; copies of
the package's source with only that changed, built into
``build/k6_<i>/``), each checked bit for bit first.
``--k4-round`` times, alone, one PSA exchange round (2 x 125 chains an
instance, the paper's 100 temperature steps of 50 candidates) through
``annealing._chain_round``, hot (at T0) and cold (at t_final), by CUDA
events and in a CUDA graph, at every instantiation's shapes the engine
gives K4's shared-memory branch: the 32 and 64 buckets, the benchmark
cell's wave (128 instances of order 125 in the 128 bucket) and order
169: on a package whose K4 runs a round a launch, that launch and,
beside it, the same round forced to a launch a step; on an older
package its 100 launches with the host's key splits and cooling between
them; and one single-step launch alone.

The shapes and helpers are those of ``chip_smoke.py``.  Prints the card's
name and power limit; exits non-zero without a CUDA device.
"""
import argparse
import contextlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def padded_wave(order, bucket, count, device):
    """``count`` masked ``make_taie`` instances of ``order`` padded into the
    ``bucket`` (the engine's wave at that bucket)."""
    import numpy as np
    import torch
    from repro_torch.core import instances, qap
    Cs = np.zeros((count, bucket, bucket), np.float32)
    Ms = np.zeros((count, bucket, bucket), np.float32)
    for v in range(count):
        inst = instances.make_taie(order, version=v + 1)
        Cs[v, :order, :order] = inst.C
        Ms[v, :order, :order] = inst.M
    Cs = torch.as_tensor(Cs, device=device)
    return (qap.mask_flows(Cs, torch.full((count,), order, device=device)),
            torch.as_tensor(Ms, device=device))


def island_perms(order, bucket, islands, pop, device):
    """``islands`` populations of ``pop`` random permutations of ``order``
    in the ``bucket`` (identity tail), as ``chip_smoke.py`` draws them."""
    from repro_torch.core import keys, qap
    ck = keys.split(keys.prng_key(pop, device), islands)
    return qap.masked_random_permutations(ck, pop, bucket, order).contiguous()


def timing_rows(dev, k6=False):
    """(label, fn, reps) of each kernel at the smoke's shapes: K1, K4, K2
    and K5 at the 128 bucket's 32-request wave and the 64 and 32 buckets'
    3-request waves (2 islands a request for K2/K5), then the L2 branches
    (``l2_rows``), K7 and K8 at their routes' shapes; with ``k6``, then K6
    at the shapes of ``k6_cases``."""
    import torch
    import chip_smoke as cs
    from repro_torch.core import annealing, keys, qap
    from repro_torch.kernels.qap_delta import qap_delta_cuda
    from repro_torch.kernels.qap_ga_step import qap_ga_step_cuda
    from repro_torch.kernels.qap_objective import (qap_objective_cuda,
                                                   qap_objective_plain)
    from repro_torch.kernels.qap_sa_step import qap_sa_step_cuda
    rpt = cs.NUM_PROCESSES * cs.SA_KW["solvers"]
    k = cs.SA_KW["max_neighbors"]
    out = []
    for order, bucket, count in ((cs.ORDER, cs.BUCKET, cs.WAVE), (45, 64, 3),
                                 (27, 32, 3)):
        Cs, Ms = padded_wave(order, bucket, count, dev)
        CT = Cs.transpose(1, 2).contiguous()
        MT = Ms.transpose(1, 2).contiguous()
        for label, chains, kk in (("event", count * rpt, k),
                                  ("polish", count, cs.POLISH_K)):
            ck = keys.split(keys.fold_in(keys.prng_key(2024, dev), kk), chains)
            p = qap.masked_random_permutation(ck, bucket, order)
            pairs = qap.random_swap_pairs(
                keys.fold_in(ck, 1), kk, bucket,
                torch.full((chains,), order, device=dev))
            out.append((f"K1 {label} N={bucket} {chains}x{kk}",
                        lambda C=Cs, M=Ms, CT=CT, MT=MT, p=p, pairs=pairs:
                        qap_delta_cuda(C, M, p, pairs, CT, MT), 200))
        chains = count * rpt
        ck = keys.split(keys.prng_key(7, dev), chains)
        p = qap.masked_random_permutation(ck, bucket, order)
        f = qap.objective(Cs, Ms, p.view(count, rpt, bucket)).reshape(-1)
        temp = annealing.initial_temperature(f, 0.3, 0.3)
        nv = torch.full((chains,), order, dtype=torch.int32, device=dev)
        args = (Cs, Ms, p, f, p.clone(), f.clone(), temp, keys.fold_in(ck, 3),
                nv)
        out.append((f"K4 N={bucket} {chains} chains",
                    lambda args=args, CT=CT, MT=MT: qap_sa_step_cuda(
                        *args, max_neighbors=k, max_success=10, CT=CT, MT=MT),
                    100))
        islands = count * cs.NUM_PROCESSES
        kids = island_perms(order, bucket, islands, cs.N_OFF, dev)
        out.append((f"K2 N={bucket} {islands}x{cs.N_OFF}",
                    lambda C=Cs, M=Ms, kids=kids: qap_objective_cuda(C, M, kids),
                    200))
        pops = island_perms(order, bucket, islands, cs.GA_KW["pop_size"], dev)
        fits = qap_objective_plain(Cs, Ms, pops)
        gkeys = keys.split(keys.prng_key(5, dev), islands)
        gnv = torch.full((islands,), order, dtype=torch.int32, device=dev)
        out.append((f"K5 N={bucket} {islands}x{cs.GA_KW['pop_size']}",
                    lambda C=Cs, M=Ms, pops=pops, fits=fits, gkeys=gkeys,
                    gnv=gnv: qap_ga_step_cuda(
                        C, M, pops, fits, gkeys, gnv, n_off=cs.N_OFF,
                        tournament=2, p_crossover=1.0, p_mutation=0.001,
                        crossover="ox"), 100))
    out += l2_rows(dev) + sparse_delta_rows(dev) + scan_rows(dev)
    if k6:
        out += sparse_objective_rows(dev)
    return out


def timings(k6=False):
    """(label, events ms, graph ms) of each row of ``timing_rows``."""
    import torch
    import chip_smoke as cs
    return [(label, cs.cuda_ms(fn, reps), cs.graph_ms(fn, reps))
            for label, fn, reps in timing_rows(torch.device("cuda"), k6)]


def l2_rows(dev):
    """K1 and K2 past the shared-memory threshold, at the shapes their L2
    branches serve: Table 1's PSA round (32 chains x 50 candidates) and
    PGA generation (4 islands x 64 children) on tai343 and tai729, the
    exact-size polish (1 x 256 on an order-193 instance padded into 200)
    and sparse_scale's dense baseline (8 permutations of one order-4096
    instance).  Through the wrappers alone, so any package compares."""
    import torch
    import chip_smoke as cs
    from repro_torch.core import instances, keys, qap
    from repro_torch.kernels.qap_delta import qap_delta_cuda
    from repro_torch.kernels.qap_objective import qap_objective_cuda
    out = []
    for n in cs.PAPER_KERNEL_ORDERS:
        inst = instances.get_instance(n)
        C = torch.as_tensor(inst.C, device=dev)
        M = torch.as_tensor(inst.M, device=dev)
        CT, MT = C.t().contiguous(), M.t().contiguous()
        base = keys.prng_key(n, dev)
        p = qap.random_permutations(base, 32, n)
        pairs = qap.random_swap_pairs(keys.split(keys.fold_in(base, 1), 32),
                                      50, n)
        pops = qap.random_permutations(keys.split(keys.fold_in(base, 2), 4),
                                       64, n)
        out.append((f"K1 L2 tai{n} 32x50",
                    lambda C=C, M=M, p=p, pairs=pairs, CT=CT, MT=MT:
                    qap_delta_cuda(C, M, p, pairs, CT, MT), 200))
        out.append((f"K2 L2 tai{n} 4x64",
                    lambda C=C, M=M, pops=pops: qap_objective_cuda(C, M, pops),
                    50))
    n, nv = cs.EXACT_ORDER, cs.EXACT_NV
    C, M = cs.padded_integer_instances(n, nv, 1, 200, dev)
    CT, MT = C.transpose(1, 2).contiguous(), M.transpose(1, 2).contiguous()
    ck = keys.split(keys.prng_key(n, dev), 1)
    p = qap.masked_random_permutation(ck, n, nv)
    pairs = qap.random_swap_pairs(keys.fold_in(ck, 1), cs.POLISH_K, n,
                                  torch.full((1,), nv, device=dev))
    out.append((f"K1 L2 polish N={n} 1x{cs.POLISH_K}",
                lambda: qap_delta_cuda(C, M, p, pairs, CT, MT), 200))
    n, count = cs.K2_WIDE_ORDER, cs.K2_WIDE_PERMS
    g = torch.Generator(device=dev).manual_seed(n)
    Cw = torch.randint(0, 2, (n, n), generator=g, device=dev).float()
    Mw = torch.randint(0, 2, (n, n), generator=g, device=dev).float()
    perms = qap.random_permutations(keys.prng_key(n, dev), count,
                                    n)[None].contiguous()
    out.append((f"K2 L2 N={n} 1x{count}",
                lambda: qap_objective_cuda(Cw, Mw, perms), 10))
    return out + fused_l2_rows(dev)


def fused_l2_rows(dev):
    """K4 and K5 past their shared-memory thresholds, at the shapes their
    L2 branches serve: chip_smoke's order-256 checks (8 integer instances
    x 16 chains x 25 candidates; 16 islands of 32, 16 children), one
    exact-size request of order 193 padded into 200 (16 chains; 2 islands
    of 32), and Table 1's fused PSA and PGA on tai343 and tai729 (32
    chains x 50 candidates; 4 islands of 128, 64 children).  The SA steps
    start at T0 with at most 10 acceptances.  Through the wrappers alone,
    so any package compares."""
    import torch
    import chip_smoke as cs
    from repro_torch.core import annealing, instances, keys, qap
    from repro_torch.kernels.qap_ga_step import qap_ga_step_cuda
    from repro_torch.kernels.qap_objective import (qap_objective_cuda,
                                                   qap_objective_plain)
    from repro_torch.kernels.qap_sa_step import qap_sa_step_cuda

    def sa_row(label, C, M, order, chains, k):
        b0, n = C.shape[0], C.shape[-1]
        CT = C.transpose(1, 2).contiguous()
        MT = M.transpose(1, 2).contiguous()
        ck = keys.split(keys.prng_key(7, dev), chains)
        p = qap.masked_random_permutation(ck, n, order)
        f = qap.objective(C, M, p.view(b0, chains // b0, n)).reshape(-1)
        temp = annealing.initial_temperature(f, 0.3, 0.3)
        nv = torch.full((chains,), order, dtype=torch.int32, device=dev)
        args = (C, M, p, f, p.clone(), f.clone(), temp, keys.fold_in(ck, 3),
                nv)
        return (f"K4 L2 {label} {chains}x{k}",
                lambda: qap_sa_step_cuda(*args, max_neighbors=k,
                                         max_success=10, CT=CT, MT=MT), 100)

    def ga_rows(label, C, M, order, islands, pop, n_off):
        """K5, then K2 scoring as many permutations (K5's scoring part)."""
        n = C.shape[-1]
        ck = keys.split(keys.prng_key(pop + 1, dev), islands)
        pops = qap.masked_random_permutations(ck, pop, n, order).contiguous()
        fits = qap_objective_plain(C, M, pops)
        gk = keys.split(keys.prng_key(5, dev), islands)
        nv = torch.full((islands,), order, dtype=torch.int32, device=dev)
        kids = pops[:, :n_off].contiguous()
        return [(f"K5 L2 {label} {islands}x{pop}/{n_off}",
                 lambda: qap_ga_step_cuda(
                     C, M, pops, fits, gk, nv, n_off=n_off, tournament=2,
                     p_crossover=1.0, p_mutation=0.001, crossover="ox"), 50),
                (f"K2 L2 {label} {islands}x{n_off}",
                 lambda: qap_objective_cuda(C, M, kids), 50)]

    out = []
    C, M = cs.integer_instances(cs.L2_ORDER, 8, 257, dev)
    out.append(sa_row(f"N={cs.L2_ORDER}", C, M, cs.L2_ORDER, 8 * 16,
                      cs.SA_KW["max_neighbors"]))
    C, M = cs.integer_instances(cs.L2_ORDER, cs.L2_INSTANCES, 258, dev)
    out += ga_rows(f"N={cs.L2_ORDER}", C, M, cs.L2_ORDER,
                   cs.L2_INSTANCES * cs.NUM_PROCESSES, cs.GA_KW["pop_size"],
                   cs.N_OFF)
    n, nv = cs.EXACT_ORDER, cs.EXACT_NV
    C, M = cs.padded_integer_instances(n, nv, 1, 200, dev)
    out.append(sa_row(f"N={n}", C, M, nv,
                      cs.NUM_PROCESSES * cs.SA_KW["solvers"],
                      cs.SA_KW["max_neighbors"]))
    out += ga_rows(f"N={n}", C, M, nv, cs.NUM_PROCESSES, cs.GA_KW["pop_size"],
                   cs.N_OFF)
    for n in cs.PAPER_KERNEL_ORDERS:
        inst = instances.get_instance(n)
        C = torch.as_tensor(inst.C, device=dev)[None].contiguous()
        M = torch.as_tensor(inst.M, device=dev)[None].contiguous()
        out.append(sa_row(f"tai{n}", C, M, n, 32, 50))
        out += ga_rows(f"tai{n}", C, M, n, 4, 128, 64)[:1]  # K2: l2_rows
    return out


class _Recorder:
    """A kernel library whose launch functions record their arguments and
    return 0 (no launch); its other functions are the library's."""

    def __init__(self, real, seen):
        self.real, self.seen = real, seen

    def __getattr__(self, attr):
        f = getattr(self.real, attr)
        if not attr.endswith("_launch"):
            return f

        def record(*args):
            self.seen["call"] = (f, args)
            return 0
        return record


@contextlib.contextmanager
def recording(seen):
    """Within the block, the package's wrappers hand their C launch
    function's arguments to ``seen["call"]`` = (function, args) and launch
    nothing."""
    from repro_torch.kernels import build
    library, stubs = build.library, {}

    def stub(name):
        if name not in stubs:
            stubs[name] = _Recorder(library(name), seen)
        return stubs[name]

    build.library = stub
    try:
        yield
    finally:
        build.library = library


def host_rows(rows):
    """(label, wrapper ms, wrapper without its launch ms, launch alone ms)
    on the host clock, each over 200 calls with no synchronize between
    them: what the host spends issuing one call, split into the wrapper's
    Python (its C launch function replaced by a stub that returns 0) and
    the C launch function with the same arguments (its checks, its
    launches through the driver).  ``rows``: (label, fn, reps) as
    ``timings`` takes them."""
    import time
    import torch

    def per_call(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        took = time.perf_counter() - t
        torch.cuda.synchronize()
        return took / reps * 1e3

    out = []
    for label, fn, _ in rows:
        seen = {}
        with recording(seen):
            python_ms = per_call(fn)
            kept = fn()  # the outputs the recorded launch writes
        launch, args = seen["call"]
        out.append((label, per_call(fn), python_ms,
                    per_call(lambda: launch(*args))))
        del kept
    return out


def k6_cases(dev):
    """K6's inputs at every level of the 4096 torus at the route's two
    shapes, 1 x 1 (``make_beta``, ``_seed_chain0``) and 1 x 4 (the chain
    start), then chip_smoke's wide 64 x 4 on the finest and the coarsest
    level, in the engine's form (one instance, batched leaves): (label,
    S, M, perms)."""
    import chip_smoke as cs
    from repro_torch.core import keys, qap
    stack = cs.torus_levels()
    shapes = [(level, 1, per) for level in stack
              for per in (1, cs.ML_CHAINS)]
    cases = []
    for level, rows, per in shapes + [(stack[0], 64, cs.ML_CHAINS),
                                      (stack[-1], 64, cs.ML_CHAINS)]:
        S, M = cs.flows_pair(level[0], level[1], 1, dev)
        n = M.shape[-1]
        pk = keys.split(keys.prng_key(n + rows * per, dev), rows * per)
        perms = qap.random_permutation(pk, n).reshape(rows, per, n)
        cases.append((f"K6 N={n} D={S.max_degree} {rows}x{per}", S, M,
                      perms))
    return cases


def sparse_objective_rows(dev):
    """K6 through the package's wrapper at every level x {1 x 1, 1 x 4}
    and at 64 x 4 (``k6_cases``): works for any package, so old and new
    compare."""
    from repro_torch.kernels.qap_sparse import qap_objective_sparse_cuda
    return [(label, lambda S=S, M=M, perms=perms:
             qap_objective_sparse_cuda(S, M, perms), 200)
            for label, S, M, perms in k6_cases(dev)]


# Where K6 keeps the permutation, as edits of the package's source: (old,
# new) pairs, each found exactly once.  The package reads p through L1.
_K6_READ = "  auto pget = [&](int i) { return __ldg(p + i); };\n"
_K6_LAUNCH = "  cfg.blockDim = dim3(kThreads);\n"
_K6_SLICE_SMEM = (_K6_LAUNCH, _K6_LAUNCH + "  cfg.dynamicSmemBytes = "
                  "static_cast<size_t>(N / cluster + 1) * sizeof(int);\n")
K6_STAGE_EDITS = {
    # each block stages its rows' slice; p[c] outside it through L1
    "rows' slice": (
        (_K6_READ,
         "  extern __shared__ int sp[];\n"
         "  for (int i = r0 + threadIdx.x; i < r1; i += kThreads)"
         " sp[i - r0] = p[i];\n"
         "  __syncthreads();\n"
         "  auto pget = [&](int i) {\n"
         "    return static_cast<unsigned>(i - r0) <"
         " static_cast<unsigned>(r1 - r0) ? sp[i - r0] : __ldg(p + i);\n"
         "  };\n"),
        _K6_SLICE_SMEM),
    # each block stages its rows' slice; every p[.] is read from the block
    # that owns it over distributed shared memory, after a cluster barrier
    # (which also stands for the first half of the end's barrier)
    "DSMEM slices": (
        ("  cluster_arrive_relaxed();", "  // cluster_arrive_relaxed();"),
        ("  cluster_wait();  // every block has started",
         "  // cluster_wait();  // every block has started"),
        (_K6_READ,
         "  extern __shared__ int sp[];\n"
         "  for (int i = r0 + threadIdx.x; i < r1; i += kThreads)"
         " sp[i - r0] = p[i];\n"
         "  cluster_arrive();\n"
         "  cluster_wait();\n"
         "  auto pget = [&](int i) {\n"
         "    const int owner = static_cast<int>("
         "(static_cast<long long>(i + 1) * G - 1) / N);\n"
         "    const int base = static_cast<int>("
         "static_cast<long long>(owner) * N / G);\n"
         "    return *cluster.map_shared_rank(sp + (i - base), owner);\n"
         "  };\n"),
        _K6_SLICE_SMEM),
    # each block stages all of p (up to 48 KB: orders to 12 288)
    "whole p": (
        (_K6_READ,
         "  extern __shared__ int sp[];\n"
         "  for (int i = threadIdx.x; i < N; i += kThreads) sp[i] = p[i];\n"
         "  __syncthreads();\n"
         "  auto pget = [&](int i) { return sp[i]; };\n"),
        (_K6_LAUNCH, _K6_LAUNCH + "  cfg.dynamicSmemBytes = "
         "static_cast<size_t>(N) * sizeof(int);\n")),
}


def k6_stage_libraries():
    """This package's K6 with each of ``K6_STAGE_EDITS`` applied, built
    with the package's flags into ``build/k6_<i>/``, all at once; returns
    them by name, bound as the package binds K6.  Raises if the source no
    longer matches an edit."""
    import ctypes
    import shutil
    from repro_torch.kernels import build
    procs = {}
    for i, (name, edits) in enumerate(K6_STAGE_EDITS.items()):
        out = os.path.join(ROOT, "build", f"k6_{i}")
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(build.CSRC, out)
        path = os.path.join(out, "qap_objective_sparse.cu")
        with open(path) as f:
            src = f.read()
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"K6 source has changed: {old.strip()!r}")
            src = src.replace(old, new)
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(out, "libqap_objective_sparse.so")
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", out, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc K6 {name}:\n{log}")
        libs[name] = build._bind(ctypes.CDLL(lib),
                                 build.SIGNATURES["qap_objective_sparse"])
    return libs


def k6_configs():
    """(label, library, cluster cap) of the K6 variants ``--k6`` times:
    the package's kernel with its cluster capped at 4, 8 and 16 blocks
    (16 is the package's own), and the staging variants of
    ``K6_STAGE_EDITS`` uncapped."""
    from repro_torch.kernels import build
    lib = build.library("qap_objective_sparse")
    configs = [(f"L1 cap {cap}", lib, cap) for cap in (4, 8, 16)]
    return configs + [(name, stage_lib, 16)
                      for name, stage_lib in k6_stage_libraries().items()]


def k6_rows(configs):
    """(label, [(config label, G, graph ms, graph ms)]) of K6 at every
    level x {1 x 1, 1 x 4} and at 64 x 4 (``k6_cases``; G = 1 there
    whatever the cap): each config checked bit for bit against the
    plain version, then timed in a CUDA graph in config order and again
    in reverse; each launch through the C entry point with the cluster
    ``objective_sparse_launch`` gives, capped at the config's cap."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.qap_sparse import (objective_sparse_launch,
                                                qap_objective_sparse_plain)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for label, S, M, perms in k6_cases(dev):
        B, P, n = perms.shape
        q, d = B * P, S.max_degree
        want = qap_objective_sparse_plain(S, M, perms)
        out = torch.empty_like(want)

        def launch(lib, cap):
            cluster = min(cap, objective_sparse_launch(n, q, sms)[1])
            grid = q * cluster
            return cluster, lambda: build.check(
                lib.qap_objective_sparse_launch(
                    S.cols.data_ptr(), S.vals.data_ptr(), M.data_ptr(),
                    perms.data_ptr(), out.data_ptr(), grid, cluster, n, d,
                    q, dev.index or 0,
                    torch.cuda.current_stream(dev).cuda_stream), label)

        fns = []
        for name, lib, cap in configs:
            cluster, fn = launch(lib, cap)
            out.zero_()
            fn()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"K6 {name} != plain at {label}")
            fns.append((name, cluster, fn))
        first = [cs.graph_ms(fn, 200) for _, _, fn in fns]
        second = [cs.graph_ms(fn, 200) for _, _, fn in reversed(fns)][::-1]
        rows.append((label, [(name, cluster, a, b) for (name, cluster, _), a, b
                             in zip(fns, first, second)]))
    return rows


def sparse_delta_rows(dev):
    """K7 at the multilevel route's shapes, as the engine calls it (one
    instance, batched leaves): the 4096 torus's finest level (n=4096,
    D=6) and coarsest (n=128, D=46) at the refinement's 4 chains x 16
    candidates, and the final polish's 1 x 256 on the finest.  A package
    whose K7 reads M^T gets it made once, outside the loop."""
    import inspect
    import chip_smoke as cs
    from repro_torch.core import keys, qap
    from repro_torch.kernels.qap_sparse import qap_delta_sparse_cuda
    takes_mt = "MT" in inspect.signature(qap_delta_sparse_cuda).parameters
    stack = cs.torus_levels()
    rows = []
    for level, chains, k in ((stack[0], cs.ML_CHAINS, cs.ML_K),
                             (stack[-1], cs.ML_CHAINS, cs.ML_K),
                             (stack[0], 1, cs.POLISH_K)):
        C, M = level[0], level[1]
        n = C.shape[0]
        S, Mt = cs.flows_pair(C, M, 1, dev)
        ck = keys.split(keys.prng_key(n + k, dev), chains)
        p = qap.random_permutation(ck, n)
        pairs = qap.random_swap_pairs(keys.fold_in(ck, 1), k, n)
        extra = (Mt.transpose(-2, -1).contiguous(),) if takes_mt else ()
        rows.append((f"K7 N={n} D={S.max_degree} {chains}x{k}",
                     lambda S=S, Mt=Mt, p=p, pairs=pairs, extra=extra:
                     qap_delta_sparse_cuda(S, Mt, p, pairs, *extra), 200))
    return rows


def scan_rows(dev):
    """K8 at the Jamba prefill's shape (4 x 512 x 8192, d_state 16)."""
    import chip_smoke as cs
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    shape = (cs.LM_BATCH, cs.LM_PROMPT, 8192, 16)
    args = cs.scan_inputs(shape, dev, sum(shape))
    return [("K8 " + "x".join(map(str, shape)),
             lambda: selective_scan_cuda(*args), 50)]


# The M^T form of K7: each instance's M is followed by its transpose in
# one buffer, and the column terms read M^T[v, p[k]] along a row in place
# of M[p[k], v] down a column.  (old, new) pairs, each found exactly once.
K7_MT_EDITS = (
    ("  const float* m = M + inst * N * N;\n",
     "  const float* m = M + 2 * inst * N * N;\n"
     "  const float* mt = m + static_cast<size_t>(N) * N;\n"),
    ("  const float* mv = m + static_cast<size_t>(v) * N;\n",
     "  const float* mv = m + static_cast<size_t>(v) * N;\n"
     "  const float* mtu = mt + static_cast<size_t>(u) * N;\n"
     "  const float* mtv = mt + static_cast<size_t>(v) * N;\n"),
    ("    const float* mka = m + static_cast<size_t>(prow[ka]) * N;\n"
     "    const float* mkb = m + static_cast<size_t>(prow[kb]) * N;\n",
     "    const int pka = prow[ka], pkb = prow[kb];\n"),
    ("    const float gka = mka[v] - mka[u];\n"
     "    const float gkb = mkb[v] - mkb[u];\n",
     "    const float gka = mtv[pka] - mtu[pka];\n"
     "    const float gkb = mtv[pkb] - mtu[pkb];\n"),
)


def edited_library(name, edits, tag):
    """This package's kernel library ``name`` built from a copy of its
    sources with ``edits`` ((old, new) pairs, each found exactly once)
    applied, with the package's flags, into ``build/<tag>/``; returns it
    bound as the package binds ``name``.  Raises if the source no longer
    matches an edit."""
    import ctypes
    import shutil
    from repro_torch.kernels import build
    out = os.path.join(ROOT, "build", tag)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    path = os.path.join(out, f"{name}.cu")
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name} source has changed: {old.strip()!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out, f"lib{name}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", out, "-o", lib,
                    path], check=True, capture_output=True, text=True)
    return build._bind(ctypes.CDLL(lib), build.SIGNATURES[name])


def k7_mt_library():
    """The M^T form of this package's K7 (``K7_MT_EDITS``), built into
    ``build/k7_mt/``."""
    return edited_library("qap_delta_sparse", K7_MT_EDITS, "k7_mt")


# K4's L2 kernel with its time split by clock64(): per chain, the cycles
# of the whole kernel after its state is loaded, and for each candidate
# those of requesting the next candidate's rows, of waiting for its own
# rows, of its delta and of its accept step; and the candidates scored --
# written over best_p's first six words.  (old, new) pairs, each found
# exactly once.
K4_PHASE_EDITS = (
    ("  const float tsafe = fmaxf(temp[r], 1e-9f);\n  __syncwarp();\n",
     "  const float tsafe = fmaxf(temp[r], 1e-9f);\n  __syncwarp();\n"
     "  const long long t_start = clock64();\n"
     "  long long t_issue = 0, t_wait = 0, t_delta = 0, t_accept = 0;\n"
     "  int scored = 0;\n"),
    ("    if (more) request(a1, b1, set ^ 1, false);\n    land(set);\n",
     "    const long long t0 = clock64();\n"
     "    if (more) request(a1, b1, set ^ 1, false);\n"
     "    const long long t0b = clock64();\n    land(set);\n"),
    ("    const float d =\n",
     "    const long long t1 = clock64();\n    const float d =\n"),
    ("    bool restage = false;\n",
     "    const long long t2 = clock64();\n    t_issue += t0b - t0;\n"
     "    t_wait += t1 - t0b;\n    t_delta += t2 - t1;\n    ++scored;\n"
     "    bool restage = false;\n"),
    ("    set ^= 1;\n  }\n",
     "    set ^= 1;\n    t_accept += clock64() - t2;\n  }\n"),
    ("    bf_out[r] = bf;\n  }\n}\n\n}  // namespace",
     "    bf_out[r] = bf;\n"
     "    bp_out[row0] = static_cast<int>(clock64() - t_start);\n"
     "    bp_out[row0 + 1] = static_cast<int>(t_issue);\n"
     "    bp_out[row0 + 2] = static_cast<int>(t_wait);\n"
     "    bp_out[row0 + 3] = static_cast<int>(t_delta);\n"
     "    bp_out[row0 + 4] = static_cast<int>(t_accept);\n"
     "    bp_out[row0 + 5] = scored;\n  }\n}\n\n}  // namespace"),
)


def k4_phase_rows(edits=(), tag="k4_phases"):
    """(label, graph ms, mean cycles a chain: whole loop, then a
    candidate's request for the next one's rows, wait for its own rows,
    delta and accept step, candidates scored) of K4's L2 branch at the
    ``fused_l2_rows`` SA shapes, from the ``K4_PHASE_EDITS`` copy (and ``edits`` after them) launched with the
    package's arguments."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    lib = edited_library("qap_sa_step", K4_PHASE_EDITS + tuple(edits), tag)
    dev = torch.device("cuda")
    rows = []
    for label, fn, _ in fused_l2_rows(dev):
        if not label.startswith("K4"):
            continue
        seen = {}
        with recording(seen):
            kept = fn()  # the outputs the recorded arguments point to
        args = list(seen["call"][1])
        B, n = args[15], args[16]
        bp = torch.empty(B * n, dtype=torch.int32, device=dev)
        args[13] = bp.data_ptr()

        def launch():
            args[-1] = torch.cuda.current_stream(dev).cuda_stream
            build.check(lib.qap_sa_step_launch(*args), label)

        ms = cs.graph_ms(launch, 50)
        launch()
        torch.cuda.synchronize()
        c = bp.view(B, n)[:, :6].double()
        per = c[:, 5].clamp_min(1)
        rows.append((label, ms, float(c[:, 0].mean()),
                     *(float((c[:, k] / per).mean()) for k in (1, 2, 3, 4)),
                     float(c[:, 5].mean())))
        del kept
    return rows


# K4's L2 kernel cut down, for timing alone (neither gives K4's results):
# "skeleton" stages no rows and scores nothing (d = 0, each candidate
# accepted without the Metropolis test), so only the loop around them is
# left -- the draws' shuffles, the swap, the best copy; "empty" scores no
# candidate.  (old, new) pairs, each found exactly once.
K4_SKELETON_EDITS = {
    "skeleton": (
        ("    const float d =\n        repro_torch::delta_from_regs"
         "<kMaxRegIters>(x, pr, a, b, u, v, N);\n",
         "    const float d = 0.f * x[0][lane];\n"),
        ("    if ((d < 0.f) || (ut < expf(-d / tsafe))) {  // the same in "
         "every lane\n      __syncwarp();  // every lane has read p[a] and "
         "p[b]\n      if (lane == 0) {\n        p[a] = v;",
         "    if ((d < 0.f) || (ut < 2.f)) {\n      __syncwarp();\n"
         "      if (lane == 0) {\n        p[a] = v;"),
        ("  if (producer && !scores) return;\n", "  if (producer) return;\n"),
        ("pending = scores ? 1u : 0u,", "pending = 0u,"),
        ("    if (more) request(a1, b1, set ^ 1, false);\n    land(set);\n",
         ""),
        ("  if (scores && lane == 0) {\n", "  if (false) {\n"),
        ("      restage = more && (a1 == a || a1 == b || b1 == a || b1 == b);"
         "\n", "")),
    "empty": (
        ("  for (int t = 0; t < K && successes < max_success; ++t) {\n",
         "  for (int t = 0; t < 0; ++t) {\n"),),
}


def k4_skeleton_rows():
    """(label, graph ms of the package's K4 L2 kernel, of its skeleton, of
    its empty loop) at the ``fused_l2_rows`` SA shapes (10 candidates
    scored a chain), each from ``K4_SKELETON_EDITS`` launched with the
    package's arguments."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    libs = [build.library("qap_sa_step")] + [
        edited_library("qap_sa_step", e, f"k4_{name}")
        for name, e in K4_SKELETON_EDITS.items()]
    dev = torch.device("cuda")
    rows = []
    for label, fn, _ in fused_l2_rows(dev):
        if not label.startswith("K4"):
            continue
        seen = {}
        with recording(seen):
            kept = fn()  # the outputs the recorded arguments point to
        args = list(seen["call"][1])
        times = []
        for lib in libs:
            def launch(lib=lib):
                args[-1] = torch.cuda.current_stream(dev).cuda_stream
                build.check(lib.qap_sa_step_launch(*args), label)
            times.append(cs.graph_ms(launch, 100))
        rows.append((label, *times))
        del kept
    return rows


# (label, order, bucket, instances) of --k4-round: the engine's waves of
# taiXe-27 and -45 in the 32 and 64 buckets, the benchmark cell's
# (taiXe-125 in the 128 bucket) and integer instances of order 169, the
# shared-memory branch's largest, at 250 chains an instance.
K4_ROUND_SHAPES = (("27 in 32", 27, 32, 128), ("45 in 64", 45, 64, 128),
                   ("125 in 128", 125, 128, 128), ("169", 169, 169, 16))


def k4_round_rows(dev, shapes=K4_ROUND_SHAPES):
    """(label, events ms, graph ms) of one PSA exchange round (the paper's
    100 temperature steps of 50 candidates, 250 chains an instance)
    through ``annealing._chain_round``, hot (at T0) and cold (at t_final),
    at each of ``shapes``: "round" (one launch) where the package's K4
    runs a round a launch, raising unless it gives the bits of the steps;
    "steps", a launch a temperature step with the host's cooling between
    them (by events ``_chain_round`` forced to it, key splits included;
    in the graph ``_advance`` 100 times from keys split beforehand); and
    "step", one single-step K4 launch alone."""
    import torch
    from repro_torch.core import annealing, instances, keys, qap
    from repro_torch.kernels import ops
    import chip_smoke as cs
    cfg = annealing.SAConfig(max_neighbors=50, max_success=10,
                             iters_per_exchange=100, num_exchanges=50,
                             solvers=125, loop="fused")
    r = 2 * cfg.solvers
    has_round = hasattr(annealing, "_round_steps")
    rows = []
    for name, order, n, b0 in shapes:
        if order in instances.GRID:
            C, M = padded_wave(order, n, b0, dev)
        else:
            C, M = cs.integer_instances(n, b0, order, dev)
        nv = torch.full((b0,), order, dtype=torch.int64, device=dev)
        key = keys.split(keys.split(keys.prng_key(35, dev), b0), 3)
        beta = annealing.make_beta(C, M, key[:, 0], cfg, nv) \
            .repeat_interleave(r)
        ck = keys.split(key[:, 1], r)
        p = qap.masked_random_permutation(ck, n, nv[:, None])
        f = qap.objective(C, M, p)
        p, f = p.reshape(b0 * r, n), f.reshape(-1)
        nv_c = nv.repeat_interleave(r)
        nv32 = nv_c.to(torch.int32)
        inst = (C, M) + ops.transposes(C, M)
        rk = keys.split(key[:, 2], r).reshape(b0 * r, 2)
        step_keys = keys.split(rk, cfg.iters_per_exchange).transpose(0, 1) \
            .contiguous()
        for phase, temp in (
                ("hot", annealing.initial_temperature(f, cfg.mu, cfg.phi)),
                ("cold", torch.full_like(f, annealing._f32(cfg.t_final)))):
            state = annealing.SAState(p, f, p.clone(), f.clone(), temp)

            def one_round(state=state):
                return annealing._chain_round(inst, state, rk, cfg, beta,
                                              nv_c, nv32)

            def steps(state=state):
                # the key splits made outside: a graph cannot capture them
                for t in range(cfg.iters_per_exchange):
                    state = annealing._advance(inst, state, step_keys[t],
                                               None, None, cfg, beta, nv32)
                return state

            def one_step(state=state):
                return ops.qap_sa_step(
                    C, M, state.p, state.f, state.best_p, state.best_f,
                    state.temp, step_keys[0], nv32,
                    max_neighbors=cfg.max_neighbors,
                    max_success=cfg.max_success)

            label = f"{name} {phase} {b0 * r}"
            want = steps()
            if has_round:
                if not all(torch.equal(a, b)
                           for a, b in zip(one_round(), want)):
                    raise RuntimeError(f"K4 {label}: the round differs from "
                                       f"its steps")
                rows.append((f"K4 round {label}", cs.cuda_ms(one_round, 2),
                             cs.graph_ms(one_round, 3)))
            with forced_steps(annealing) if has_round else \
                    contextlib.nullcontext():
                events = cs.cuda_ms(one_round, 2)
            rows.append((f"K4 steps {label}", events, cs.graph_ms(steps, 3)))
            rows.append((f"K4 step {label}", cs.cuda_ms(one_step, 20),
                         cs.graph_ms(one_step, 20)))
    return rows


@contextlib.contextmanager
def forced_steps(annealing):
    """``annealing._chain_round`` a launch a temperature step, inside the
    block."""
    real = annealing._round_steps
    annealing._round_steps = lambda cfg, p: 1
    try:
        yield
    finally:
        annealing._round_steps = real


def k7_mt_rows():
    """(label, graph ms reading M, graph ms reading M^T, graph ms reading
    M^T, graph ms reading M) of K7 at every level of the 4096 torus (4
    chains x 16 candidates, shared leaves) and the polish's 1 x 256 on the
    finest, both forms called through the same C entry point; raises if
    either form differs from the plain version."""
    import torch
    import chip_smoke as cs
    from repro_torch.core import keys, qap
    from repro_torch.kernels import build
    from repro_torch.kernels.qap_sparse import qap_delta_sparse_plain
    dev = torch.device("cuda")
    forms = {"M": build.library("qap_delta_sparse"), "MT": k7_mt_library()}
    stack = cs.torus_levels()
    shapes = [(level, cs.ML_CHAINS, cs.ML_K) for level in stack]
    rows = []
    for level, chains, k in shapes + [(stack[0], 1, cs.POLISH_K)]:
        S, M = cs.flows_pair(level[0], level[1], 0, dev)
        n = M.shape[-1]
        ck = keys.split(keys.prng_key(n + k, dev), chains)
        p = qap.random_permutation(ck, n)
        pairs = qap.random_swap_pairs(keys.fold_in(ck, 1), k, n)
        out = torch.empty((chains, k), device=dev)

        def launch(form, M):
            mat = M if form == "M" else torch.stack([M, M.T]).contiguous()
            return lambda: build.check(forms[form].qap_delta_sparse_launch(
                S.cols.data_ptr(), S.vals.data_ptr(), S.cols_t.data_ptr(),
                S.vals_t.data_ptr(), mat.data_ptr(), p.data_ptr(),
                pairs.data_ptr(), out.data_ptr(), chains, k, n, S.max_degree,
                chains, dev.index or 0,
                torch.cuda.current_stream(dev).cuda_stream), form)

        # checked on an M made asymmetric (the torus's M equals its
        # transpose, so it would not tell the two matrices apart)
        skew = M + torch.ones_like(M).triu(1)
        want = qap_delta_sparse_plain(S, skew, p, pairs)
        for form in forms:
            out.zero_()
            launch(form, skew)()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"K7 reading {form} != plain at N={n}")
        timed = {form: launch(form, M) for form in forms}
        rows.append((f"K7 N={n} D={S.max_degree} {chains}x{k}",
                     *(cs.graph_ms(timed[form], 200)
                       for form in ("M", "MT", "MT", "M"))))
    return rows


def float_instances(n, count, seed, device):
    """``count`` real-valued instances of order ``n`` (uniform in [0, 1),
    so no f32 sum of them is exact in every order)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand(count, n, n, generator=g, device=device),
            torch.rand(count, n, n, generator=g, device=device))


def probe():
    """Each kernel against its plain version on real-valued inputs:
    (label, bitwise equal, max abs difference, largest magnitude)."""
    import torch
    import chip_smoke as cs
    from repro_torch.core import keys, qap, sparse
    from repro_torch.kernels import ops
    from repro_torch.kernels.qap_delta import qap_delta_plain
    from repro_torch.kernels.qap_ga_step import qap_ga_step_plain
    from repro_torch.kernels.qap_objective import qap_objective_plain
    from repro_torch.kernels.qap_sa_step import qap_sa_step_plain
    from repro_torch.kernels.qap_sparse import (qap_delta_sparse_plain,
                                                qap_objective_sparse_plain)
    from repro_torch.kernels.selective_scan import selective_scan_plain
    dev = torch.device("cuda")
    rows = []

    def record(label, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        rows.append((label, all(torch.equal(g, w) for g, w in zip(got, want)),
                     max(float((g.float() - w.float()).abs().max())
                         for g, w in zip(got, want)),
                     max(float(w.float().abs().max()) for w in want)))

    for n in (cs.BUCKET, cs.L2_ORDER):
        C, M = float_instances(n, 4, n, dev)
        chains = 64
        ck = keys.split(keys.prng_key(n, dev), chains)
        p = qap.random_permutation(ck, n)
        pairs = qap.random_swap_pairs(keys.fold_in(ck, 1), 25, n)
        record(f"K1 N={n}", ops.qap_delta(C, M, p, pairs),
               qap_delta_plain(C, M, p, pairs))
        f = qap.objective(C, M, p.view(4, chains // 4, n)).reshape(-1)
        temp = f * 0.01
        nv = torch.full((chains,), n, dtype=torch.int32, device=dev)
        args = (C, M, p, f, p.clone(), f.clone(), temp, keys.fold_in(ck, 3),
                nv)
        kw = dict(max_neighbors=25, max_success=10)
        got = ops.qap_sa_step(*args, **kw)
        record(f"K4 N={n}", got, qap_sa_step_plain(*args, **kw))
        record(f"K4 N={n} again", ops.qap_sa_step(*args, **kw), got)
    C, M = float_instances(cs.BUCKET, 4, 3, dev)
    pk = keys.split(keys.prng_key(3, dev), 4 * 32)
    pops = qap.random_permutation(pk, cs.BUCKET).reshape(4, 32, cs.BUCKET)
    record("K2 N=128", ops.qap_objective(C, M, pops),
           qap_objective_plain(C, M, pops))
    fits = qap_objective_plain(C, M, pops)
    gk = keys.split(keys.prng_key(4, dev), 4)
    gnv = torch.full((4,), cs.BUCKET, dtype=torch.int32, device=dev)
    kw = dict(n_off=16, tournament=2, p_crossover=1.0, p_mutation=0.001,
              crossover="ox")
    record("K5 N=128", ops.qap_ga_step(C, M, pops, fits, gk, gnv, **kw),
           qap_ga_step_plain(C, M, pops, fits, gk, gnv, **kw))
    # K5's L2 branch: against the plain version, and its new members'
    # fitness against K2's F of them
    n = cs.L2_ORDER
    C, M = float_instances(n, 2, n + 1, dev)
    pk = keys.split(keys.prng_key(n, dev), 4 * 32)
    pops = qap.random_permutation(pk, n).reshape(4, 32, n)
    fits = ops.qap_objective(C, M, pops)
    gnv = torch.full((4,), n, dtype=torch.int32, device=dev)
    got = ops.qap_ga_step(C, M, pops, fits, gk, gnv, **kw)
    record(f"K5 N={n}", got, qap_ga_step_plain(C, M, pops, fits, gk, gnv,
                                               **kw))
    record(f"K5 N={n} again", ops.qap_ga_step(C, M, pops, fits, gk, gnv,
                                              **kw), got)
    new = (got[0] != pops).any(-1)
    record(f"K5 N={n} F = K2's", got[1][new],
           ops.qap_objective(C, M, got[0])[new])
    # sparse flows: the 4096 torus's finest (D = 6) and coarsest (n = 128,
    # D = 46) levels with real-valued weights
    g = torch.Generator().manual_seed(6)
    for level in (cs.torus_levels()[0], cs.torus_levels()[-1]):
        Cl, Ml = level[0], level[1]
        n = Cl.shape[0]
        S = sparse.from_dense(Cl * torch.rand(Cl.shape, generator=g).numpy(),
                              device=dev)
        Md = torch.as_tensor(Ml, device=dev) * torch.rand(
            Ml.shape, generator=g).to(dev)
        ck = keys.split(keys.prng_key(n, dev), 4)
        p = qap.random_permutation(ck, n)
        perms = p.reshape(1, 4, n)
        tag = f"N={n} D={S.max_degree}"
        got = ops.qap_objective(S, Md, perms)
        record(f"K6 {tag}", got, qap_objective_sparse_plain(S, Md, perms))
        record(f"K6 {tag} again", ops.qap_objective(S, Md, perms), got)
        pairs = qap.random_swap_pairs(keys.fold_in(ck, 1), 16, n)
        record(f"K7 {tag}", ops.qap_delta(S, Md, p, pairs),
               qap_delta_sparse_plain(S, Md, p, pairs))
    for shape in ((2, 130, 1024, 16), (2, 49, 200, 4)):
        scan = cs.scan_inputs(shape, dev, sum(shape))
        record("K8 " + "x".join(map(str, shape)), ops.selective_scan(*scan),
               selective_scan_plain(*scan))
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(ROOT, "src"))
    parser.add_argument("--probe", action="store_true")
    parser.add_argument("--k7-mt", action="store_true")
    parser.add_argument("--k6", action="store_true")
    parser.add_argument("--host", action="store_true")
    parser.add_argument("--k4-phases", action="store_true")
    parser.add_argument("--k4-skeleton", action="store_true")
    parser.add_argument("--k4-round", action="store_true")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_kernels: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.abspath(args.src)
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_kernels: no repro_torch under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    sys.path.insert(1, ROOT)
    from repro_torch.kernels import build, qap_sparse
    build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; package {src}", flush=True)
    if args.k4_round:
        for label, ev, gr in k4_round_rows(torch.device("cuda")):
            print(f"k4-round {label:34s} events {ev:.4f} ms, graph "
                  f"{gr:.4f} ms", flush=True)
        return 0
    for label, ev, gr in timings(args.k6):
        print(f"{label:26s} events {ev:.4f} ms, graph {gr:.5f} ms, events - "
              f"graph {ev - gr:.4f} ms", flush=True)
    if args.host:
        import torch
        wanted = ("K1 event N=128", "K4 N=128", "K5 N=128", "K1 L2 tai343",
                  "K4 L2", "K5 L2 N=256")
        rows = [r for r in timing_rows(torch.device("cuda"), False)
                if r[0].startswith(wanted)]
        for label, total, python_ms, launch in host_rows(rows):
            print(f"host {label:26s} wrapper {total:.4f} ms: Python "
                  f"{python_ms:.4f} ms, launch {launch:.4f} ms", flush=True)
    if args.probe:
        for label, same, err, scale in probe():
            print(f"probe {label:18s} bitwise {same}, max abs diff {err:.3e} "
                  f"(max |plain| {scale:.3e})", flush=True)
    if args.k6 and hasattr(qap_sparse, "objective_sparse_launch"):
        for label, cells in k6_rows(k6_configs()):
            print(f"k6 {label:20s} graph ms " + "; ".join(
                f"{name} (G={g}) {a:.5f}, {b:.5f}"
                for name, g, a, b in cells), flush=True)
    if args.k4_phases:
        for label, ms, total, issue, wait, delta, accept, scored in \
                k4_phase_rows():
            print(f"k4-phases {label:22s} graph {ms:.5f} ms; "
                  f"cycles a chain {total:.0f}, a candidate: issue "
                  f"{issue:.0f}, wait {wait:.0f}, delta {delta:.0f}, accept "
                  f"{accept:.0f}; {scored:.1f} scored", flush=True)
    if args.k4_skeleton:
        for label, kernel, skeleton, empty in k4_skeleton_rows():
            print(f"k4-skeleton {label:22s} graph ms: kernel {kernel:.5f}, "
                  f"skeleton {skeleton:.5f}, empty {empty:.5f}", flush=True)
    if args.k7_mt:
        for label, m1, t1, t2, m2 in k7_mt_rows():
            print(f"k7-mt {label:22s} graph ms reading M {m1:.5f}, M^T "
                  f"{t1:.5f}, M^T {t2:.5f}, M {m2:.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
