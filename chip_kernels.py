#!/usr/bin/env python3
"""Time the kernels of one checkout's port on one NVIDIA GPU, and probe
which kernels equal their plain versions bit for bit on inputs that are
not integer-valued.

Run from the root of a checkout:

    python3 chip_kernels.py [--src DIR] [--probe] [--k7-mt] [--k6]

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
polish's 1 x 256 at order 200, K2 at 8 x 4096), then for K7
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
they agree bit for bit (and K6 against itself on a second call).
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

The shapes and helpers are those of ``chip_smoke.py``.  Prints the card's
name and power limit; exits non-zero without a CUDA device.
"""
import argparse
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


def timings(k6=False):
    """(label, events ms, graph ms) of each kernel at the smoke's shapes:
    K1, K4, K2 and K5 at the 128 bucket's 32-request wave and the 64 and
    32 buckets' 3-request waves (2 islands a request for K2/K5), then K7
    and K8 at their routes' shapes; with ``k6``, then K6 at the shapes
    of ``k6_cases``."""
    import torch
    import chip_smoke as cs
    from repro_torch.core import annealing, keys, qap
    from repro_torch.kernels.qap_delta import qap_delta_cuda
    from repro_torch.kernels.qap_ga_step import qap_ga_step_cuda
    from repro_torch.kernels.qap_objective import (qap_objective_cuda,
                                                   qap_objective_plain)
    from repro_torch.kernels.qap_sa_step import qap_sa_step_cuda
    dev = torch.device("cuda")
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
    return [(label, cs.cuda_ms(fn, reps), cs.graph_ms(fn, reps))
            for label, fn, reps in out]


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


def k7_mt_library():
    """Build the M^T form of this package's K7 into ``build/k7_mt/``
    with the package's flags; returns it bound as the package binds K7."""
    import ctypes
    import shutil
    from repro_torch.kernels import build
    out = os.path.join(ROOT, "build", "k7_mt")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    path = os.path.join(out, "qap_delta_sparse.cu")
    with open(path) as f:
        src = f.read()
    for old, new in K7_MT_EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"K7 source has changed: {old.strip()!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out, "libqap_delta_sparse.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", out, "-o", lib,
                    path], check=True, capture_output=True, text=True)
    return build._bind(ctypes.CDLL(lib), build.SIGNATURES["qap_delta_sparse"])


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
        record(f"K4 N={n}", ops.qap_sa_step(*args, **kw),
               qap_sa_step_plain(*args, **kw))
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
    for label, ev, gr in timings(args.k6):
        print(f"{label:26s} events {ev:.4f} ms, graph {gr:.5f} ms, events - "
              f"graph {ev - gr:.4f} ms", flush=True)
    if args.probe:
        for label, same, err, scale in probe():
            print(f"probe {label:18s} bitwise {same}, max abs diff {err:.3e} "
                  f"(max |plain| {scale:.3e})", flush=True)
    if args.k6 and hasattr(qap_sparse, "objective_sparse_launch"):
        for label, cells in k6_rows(k6_configs()):
            print(f"k6 {label:20s} graph ms " + "; ".join(
                f"{name} (G={g}) {a:.5f}, {b:.5f}"
                for name, g, a, b in cells), flush=True)
    if args.k7_mt:
        for label, m1, t1, t2, m2 in k7_mt_rows():
            print(f"k7-mt {label:22s} graph ms reading M {m1:.5f}, M^T "
                  f"{t1:.5f}, M^T {t2:.5f}, M {m2:.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
