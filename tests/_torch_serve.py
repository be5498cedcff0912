"""Shared pieces of the port's control-plane tests: one intra-op thread
per test process, the engine configuration of the reference's fleet and
transport tests, and the checks that hold the port's answers to a single
port engine and to the reference's engine.

One thread: the suite runs several test processes at once, each with
PyTorch's default of one intra-op thread per core.  The port's CPU
solvers issue many small ops, and each process's idle threads spinning
for work then starve the others (a 5 s file took minutes beside three
others); with one thread each, the processes share the cores.  Import
``one_torch_thread`` into a test module to apply it there; subprocess
workers the module spawns inherit ``OMP_NUM_THREADS=1``.
"""
import os

import numpy as np
import pytest
import torch

from repro.serve import MappingEngine as RefEngine
from repro.serve import MapRequest as RefRequest
from repro_torch.core import annealing
from repro_torch.serve import MappingEngine, MapRequest

from _fixtures import SA_SMALL, instance

# tests/test_fleet.py's engine, so the reference reuses its programs.
COMMON = dict(buckets=(8,), polish_rounds=0, max_batch=4, num_processes=2,
              flush_deadline_ms=10.0)
ENGINE_KW = dict(COMMON, sa_cfg=annealing.SAConfig(
    max_neighbors=10, iters_per_exchange=8, num_exchanges=4, solvers=4),
    device="cpu")
REF_KW = dict(COMMON, sa_cfg=SA_SMALL)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    env = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def make_reqs(k, n=6, algorithm="psa", seed0=0, cls=MapRequest):
    """k distinct instances (distinct digests -- no dedup in a wave)."""
    reqs = []
    for i in range(k):
        C, M = instance(n, seed0 + i)
        reqs.append(cls(job_id=f"j{i}", C=C, M=M, algorithm=algorithm,
                        seed=seed0 + i))
    return reqs


def solve_all(engine, reqs):
    futs = [engine.submit(r) for r in reqs]
    engine.flush()
    return {r.job_id: f.result(timeout=0) for r, f in zip(reqs, futs)}


def reference_results(reqs):
    """The same requests through the reference's single engine, warm
    starts off."""
    ref = [RefRequest(job_id=r.job_id, C=r.C, M=r.M, algorithm=r.algorithm,
                      seed=r.seed, cache_seed=r.cache_seed,
                      deadline_ms=r.deadline_ms) for r in reqs]
    return solve_all(RefEngine(warm_start=False, **REF_KW), ref)


def assert_bitwise_equal(resps, refs):
    assert set(resps) == set(refs)
    for job_id, resp in resps.items():
        ref = refs[job_id]
        np.testing.assert_array_equal(resp.perm, ref.perm)
        assert resp.objective == ref.objective
        assert (resp.algorithm, resp.tier) == (ref.algorithm, ref.tier)


def assert_matches_both(out, reqs):
    """``out`` equals a single port ``MappingEngine(warm_start=False)`` (the
    fleet's determinism contract) and the reference's engine, bit for
    bit."""
    assert_bitwise_equal(out, solve_all(
        MappingEngine(warm_start=False, **ENGINE_KW), reqs))
    assert_bitwise_equal(out, reference_results(reqs))
