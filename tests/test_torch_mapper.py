"""The port's MappingEngine against ``repro.serve.MappingEngine``: the
same requests give the same permutations and objectives, bit for bit."""
import dataclasses
import inspect

import numpy as np
import pytest

from repro.core import annealing as jann
from repro.core import genetic as jgen
from repro.core import mapping as jmapping
from repro.serve.mapper import MappingEngine as RefEngine
from repro.serve.mapper import MapRequest as RefRequest
from repro_torch.core import annealing, genetic, instances, mapping, multilevel
from repro_torch.serve import (ClusterState, MapCancelled, MappingEngine,
                               MapRequest, QueueFull)

from _fixtures import instance

SA_KW = dict(max_neighbors=8, iters_per_exchange=6, num_exchanges=3,
             solvers=3)
GA_KW = dict(generations=4, pop_size=8, p_mutation=0.2)
ENGINE_KW = dict(buckets=(8, 16), polish_rounds=20)


def _requests(cls):
    """Mixed orders (one above every bucket: the exact-size path), a
    tight-deadline request, then a warm start (same M as j4, new C)."""
    first = []
    for i, n in enumerate([5, 8, 12, 16, 16, 20]):
        C, M = instance(n, 40 + i)
        first.append(cls(job_id=f"j{i}", C=C, M=M, seed=i + 3,
                         deadline_ms=100.0 if i == 1 else None))
    _, M = instance(16, 44)
    C2, _ = instance(16, 99)
    return first, cls(job_id="warm", C=C2, M=M, seed=11)


def _drive(engine, cls):
    first, warm = _requests(cls)
    futs = [engine.submit(r) for r in first]
    engine.flush()
    wf = engine.submit(warm)
    engine.flush()
    hit = engine.map_one(first[2].C, first[2].M, seed=123)
    return [f.result() for f in futs] + [wf.result(), hit]


def _same(want, got):
    for w, g in zip(want, got, strict=True):
        assert g.job_id == w.job_id
        np.testing.assert_array_equal(g.perm, w.perm)
        assert g.objective == w.objective
        assert (g.baseline, g.bucket, g.tier, g.warm_start, g.cached) == \
            (w.baseline, w.bucket, w.tier, w.warm_start, w.cached)


def test_engine_matches_reference_engine():
    ref = RefEngine(sa_cfg=jann.SAConfig(**SA_KW), **ENGINE_KW)
    port = MappingEngine(sa_cfg=annealing.SAConfig(**SA_KW), device="cpu",
                         **ENGINE_KW)
    want, got = _drive(ref, RefRequest), _drive(port, MapRequest)
    _same(want, got)
    assert [r.tier for r in got[:2]] == ["default", "tight"]
    assert got[-2].warm_start and got[-1].cached
    assert got[5].bucket is None                       # exact-size path
    assert port.stats.cache_hits == ref.stats.cache_hits == 1
    assert port.stats.warm_starts == ref.stats.warm_starts == 1


def test_fused_engine_matches_reference_engine():
    """The fused loop on one wave of each bucket."""
    cfg = dict(SA_KW, loop="fused")
    ref = RefEngine(sa_cfg=jann.SAConfig(**cfg), **ENGINE_KW)
    port = MappingEngine(sa_cfg=annealing.SAConfig(**cfg), device="cpu",
                         **ENGINE_KW)
    outs = []
    for engine, cls in ((ref, RefRequest), (port, MapRequest)):
        reqs = [r for r in _requests(cls)[0] if r.job_id in ("j0", "j2", "j3")]
        futs = [engine.submit(r) for r in reqs]
        engine.flush()
        outs.append([f.result() for f in futs])
    _same(*outs)


def test_cache_hit_serves_the_solved_permutation():
    engine = MappingEngine(sa_cfg=annealing.SAConfig(**SA_KW), device="cpu",
                           **ENGINE_KW)
    C, M = instance(12, 5)
    first = engine.map_one(C, M, seed=1)
    again = engine.map_one(C, M, seed=2)
    assert not first.cached and again.cached and again.batch_size == 0
    np.testing.assert_array_equal(first.perm, again.perm)
    assert first.objective == again.objective
    assert engine.stats.solver_calls == 1 and engine.stats.cache_hits == 1


@pytest.mark.parametrize("algorithm,deadline", [("pga", None), ("pca", None),
                                                ("auto", 5000.0)])
def test_ga_routes_match_reference_engine(algorithm, deadline):
    """PGA, PCA and ``auto`` with a slack deadline (which resolves to PCA)
    through both engines: every bucket, the exact-size path, a warm start
    and a cache hit give the same responses."""
    def drive(engine, cls):
        first, warm = _requests(cls)
        first = [dataclasses.replace(r, algorithm=algorithm,
                                     deadline_ms=deadline) for r in first]
        futs = [engine.submit(r) for r in first]
        engine.flush()
        wf = engine.submit(dataclasses.replace(warm, algorithm=algorithm,
                                               deadline_ms=deadline))
        engine.flush()
        hit = engine.map_one(first[2].C, first[2].M, algorithm=algorithm,
                             seed=123, deadline_ms=deadline)
        return [f.result() for f in futs] + [wf.result(), hit]

    ref = RefEngine(sa_cfg=jann.SAConfig(**SA_KW),
                    ga_cfg=jgen.GAConfig(**GA_KW), **ENGINE_KW)
    port = MappingEngine(sa_cfg=annealing.SAConfig(**SA_KW),
                         ga_cfg=genetic.GAConfig(**GA_KW),
                         device="cpu", **ENGINE_KW)
    want, got = drive(ref, RefRequest), drive(port, MapRequest)
    _same(want, got)
    resolved = "pca" if algorithm == "auto" else algorithm
    assert {r.algorithm for r in got} == {resolved}
    assert got[-2].warm_start and got[-1].cached
    assert got[5].bucket is None                       # exact-size path


def test_warmup_runs_each_algorithm():
    engine = MappingEngine(sa_cfg=annealing.SAConfig(**SA_KW),
                           ga_cfg=genetic.GAConfig(**GA_KW), device="cpu",
                           **ENGINE_KW)
    assert engine.warmup(buckets=(8,), algorithms=("psa", "pga", "pca")) == 3
    assert engine.stats.warmup_programs == 3
    with pytest.raises(ValueError, match="algorithm"):
        engine.warmup(algorithms=("bogus",))


def test_warmup_signature_matches_reference():
    want = inspect.signature(RefEngine.warmup).parameters
    got = inspect.signature(MappingEngine.warmup).parameters
    assert list(got) == list(want)
    assert [p.default for p in got.values()] == \
        [p.default for p in want.values()]


def test_warmup_tiers_and_validation():
    engine = MappingEngine(sa_cfg=annealing.SAConfig(**SA_KW), device="cpu",
                           **ENGINE_KW)
    one = engine.warmup(buckets=(8,), tiers=("default",))
    assert engine.warmup(buckets=(8,), tiers=("default", "tight")) == 2 * one
    assert engine.stats.warmup_programs == 3 * one
    # accepted and ignored: nothing is compiled per wave size on the card
    assert engine.warmup(buckets=(8,), batch_sizes=(1, 4), warm_starts=(False,),
                         execute=True) == one
    ref = RefEngine(sa_cfg=jann.SAConfig(**SA_KW), **ENGINE_KW)
    for eng in (ref, engine):
        with pytest.raises(ValueError, match="tier must be one of"):
            eng.warmup(tiers=("loose",))
        with pytest.raises(ValueError, match="unknown bucket"):
            eng.warmup(buckets=(64,))
    for eng in (RefEngine(sa_cfg=jann.SAConfig(**SA_KW), pad_batches=False,
                          **ENGINE_KW),
                MappingEngine(sa_cfg=annealing.SAConfig(**SA_KW), device="cpu",
                              pad_batches=False, **ENGINE_KW)):
        with pytest.raises(ValueError, match="pad_batches=False: pass "
                                             "batch_sizes= explicitly"):
            eng.warmup()


@pytest.mark.parametrize("algorithm", ["psa", "pga", "pca"])
def test_warmup_leaves_results_unchanged(algorithm):
    """A request mapped after warming both tiers equals one from a cold
    engine, and the reference's, bit for bit."""
    def port():
        return MappingEngine(sa_cfg=annealing.SAConfig(**SA_KW),
                             ga_cfg=genetic.GAConfig(**GA_KW), device="cpu",
                             **ENGINE_KW)

    warmed = port()
    warmed.warmup(buckets=(16,), algorithms=(algorithm,),
                  tiers=("default", "tight"))
    C, M = instance(12, 400)
    got = warmed.map_one(C, M, algorithm, job_id="w")
    cold = port().map_one(C, M, algorithm, job_id="w")
    ref = RefEngine(sa_cfg=jann.SAConfig(**SA_KW),
                    ga_cfg=jgen.GAConfig(**GA_KW),
                    **ENGINE_KW).map_one(C, M, algorithm, job_id="w")
    for other in (cold, ref):
        np.testing.assert_array_equal(got.perm, other.perm)
        assert got.objective == other.objective


def test_max_pending_and_cancel():
    engine = MappingEngine(sa_cfg=annealing.SAConfig(**SA_KW), device="cpu",
                           max_pending=1, **ENGINE_KW)
    C, M = instance(8, 3)
    first = engine.submit(MapRequest(job_id="a", C=C, M=M))
    refused = engine.submit(MapRequest(job_id="b", C=C, M=M))
    assert isinstance(refused.exception(timeout=1), QueueFull)
    assert first.cancel() and not first.cancel()
    assert engine.flush() == {}
    with pytest.raises(MapCancelled):
        first.result(timeout=1)
    assert (engine.stats.rejected, engine.stats.cancelled,
            engine.stats.solver_calls) == (1, 1, 0)


def test_large_bucket_orders_fail_their_future():
    """A multilevel solve that raises fails the futures of its own group
    only: the dense group of the same flush is served, then the flush
    raises the error."""
    engine = MappingEngine(sa_cfg=annealing.SAConfig(**SA_KW), device="cpu",
                           multilevel_min_n=20,
                           multilevel_cfg=multilevel.MultilevelConfig(
                               algorithm="bogus"), **ENGINE_KW)
    C, M = instance(24, 2)
    fut = engine.submit(MapRequest(job_id="big", C=C, M=M))
    C, M = instance(8, 3)
    ok = engine.submit(MapRequest(job_id="small", C=C, M=M))
    with pytest.raises(ValueError, match="algorithm"):
        engine.flush()
    assert isinstance(fut.exception(timeout=1), ValueError)
    assert ok.result(timeout=1).bucket == 8


def test_flusher_thread_and_allocate_map_release_loop():
    """The README's loop on the port: allocate a compact slice of a grid
    machine, map the job's flows onto it with the background flusher,
    translate to physical nodes, release."""
    cluster = ClusterState(instances.grid_distance_matrix((2, 3, 4)))
    with MappingEngine(sa_cfg=annealing.SAConfig(**SA_KW), device="cpu",
                       flush_deadline_ms=1.0, **ENGINE_KW) as engine:
        futs = {}
        for j, size in enumerate([6, 8, 5]):
            alloc = cluster.allocate(f"job{j}", size)
            C, _ = instance(size, j)
            futs[alloc.job_id] = (alloc, engine.submit(MapRequest(
                job_id=alloc.job_id, C=C, M=alloc.M_sub, seed=j)))
        assert cluster.num_free == 24 - 19
        for job_id, (alloc, fut) in futs.items():
            resp = fut.result(timeout=60)
            nodes = alloc.physical(resp.perm)
            assert sorted(nodes.tolist()) == sorted(alloc.nodes.tolist())
            assert resp.objective <= resp.baseline
            cluster.release(job_id)
    assert cluster.num_free == 24


def test_find_mapping_matches_reference():
    import jax
    C, M = instance(10, 77)
    cfg = jann.SAConfig(**SA_KW)
    want = jmapping.find_mapping(C, M, "psa", key=jax.random.PRNGKey(5),
                                 num_processes=2, sa_cfg=cfg, polish_rounds=15)
    got = mapping.find_mapping(C, M, "psa", key=np.asarray(jax.random.PRNGKey(5)),
                               num_processes=2, sa_cfg=annealing.SAConfig(**SA_KW),
                               polish_rounds=15, device="cpu")
    np.testing.assert_array_equal(got.perm, np.asarray(want.perm))
    assert got.objective == want.objective and got.baseline == want.baseline
    np.testing.assert_array_equal(got.history, want.history)
    ident = mapping.find_mapping(C, M, "identity", device="cpu")
    assert ident.objective == ident.baseline == want.baseline
    for algorithm in ("pga", "pca"):
        want = jmapping.find_mapping(
            C, M, algorithm, key=jax.random.PRNGKey(5), num_processes=2,
            sa_cfg=jann.SAConfig(**dict(SA_KW, solvers=0)),
            ga_cfg=jgen.GAConfig(**GA_KW), polish_rounds=15)
        got = mapping.find_mapping(
            C, M, algorithm, key=np.asarray(jax.random.PRNGKey(5)),
            num_processes=2, sa_cfg=annealing.SAConfig(**dict(SA_KW, solvers=0)),
            ga_cfg=genetic.GAConfig(**GA_KW), polish_rounds=15, device="cpu")
        np.testing.assert_array_equal(got.perm, np.asarray(want.perm))
        assert got.objective == want.objective
        np.testing.assert_array_equal(got.history, want.history)
