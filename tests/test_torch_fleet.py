"""The port's thread-backed EngineFleet, pinned as ``tests/test_fleet.py``
pins the reference's: any worker count, count-based kills, dropped
heartbeats, stragglers, the circuit breaker, ``max_pending``, the shared
cache and the deadline degradation ladder.  Every recovered result is
checked bit for bit against a single port ``MappingEngine(warm_start=
False)`` and against the reference's engine on the same numpy inputs."""
import time
from contextlib import contextmanager

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # optional test dependency
    from _hypothesis_compat import given, settings, st

from repro.serve import EngineFleet as RefFleet
from repro.serve import MappingEngine as RefEngine
from repro.serve import MapRequest as RefRequest
from repro_torch.core import instances
from repro_torch.kernels import build, ops
from repro_torch.serve import (ClusterState, EngineFleet, FaultPlan,
                               MapCancelled, MappingEngine, MapRequest,
                               QueueFull)

from _fixtures import instance as _instance
from _torch_serve import (ENGINE_KW, REF_KW, assert_matches_both,
                          make_reqs, one_torch_thread,  # noqa: F401
                          reference_results)


@contextmanager
def make_fleet(**kw):
    fleet = EngineFleet(**{**ENGINE_KW, **kw})
    try:
        yield fleet
    finally:
        if not fleet._shutdown:
            fleet.stop()


def wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


# ----------------------------------------------------- drop-in equivalence
@pytest.mark.parametrize("workers", [1, 2, 3, 4])
def test_any_worker_count_matches_single_and_reference_engines(workers):
    reqs = make_reqs(9, seed0=20)
    with make_fleet(workers=workers) as fleet:
        futs = [fleet.submit(r) for r in reqs]
        out = fleet.flush()
        assert all(f.done() for f in futs)
    assert_matches_both(out, reqs)
    # 9 distinct requests, max_batch 4 -> 3 waves, spread over the fleet
    assert fleet.stats.dispatched_waves == 3
    assert fleet.stats.solver_calls == 9
    assert fleet.stats.worker_deaths == fleet.stats.requeued == 0
    assert len(fleet.workers) == workers


def test_fleet_map_one_validation_and_no_meshes():
    C, M = _instance(6, seed=3)
    with make_fleet(workers=2) as fleet:
        resp = fleet.map_one(C, M, algorithm="psa", seed=3)
        want = RefEngine(warm_start=False, **REF_KW).map_one(
            C, M, algorithm="psa", seed=3)
        np.testing.assert_array_equal(resp.perm, want.perm)
        assert resp.objective == want.objective
        with pytest.raises(ValueError, match="algorithm"):
            fleet.submit(MapRequest(job_id="bad", C=C, M=M,
                                    algorithm="nope"))
        with pytest.raises(ValueError, match="square"):
            fleet.submit(MapRequest(job_id="bad", C=C[:3], M=M,
                                    algorithm="psa"))
    with pytest.raises(RuntimeError, match="stopped"):
        fleet.submit(MapRequest(job_id="late", C=C, M=M, algorithm="psa"))
    fleet.stop()                           # idempotent
    # the port has no device mesh: meshes= is an unknown keyword
    with pytest.raises(TypeError):
        EngineFleet(workers=1, meshes=[object()], **ENGINE_KW)
    with pytest.raises(ValueError, match="engine_factory"):
        EngineFleet(workers=1, engine_factory=lambda wid: None, **ENGINE_KW)
    with pytest.raises(ValueError, match="worker"):
        EngineFleet(workers=0, **ENGINE_KW)


# ------------------------------------------------------------ kill + requeue
def test_kill_one_requeues_and_stays_bitwise():
    reqs = make_reqs(6, seed0=40)
    with make_fleet(workers=2,
                    fault_plan=FaultPlan(kill_worker_at={0: 1})) as fleet:
        futs = [fleet.submit(r) for r in reqs]
        out = fleet.flush()
        assert all(f.done() for f in futs)
    assert_matches_both(out, reqs)
    assert fleet.stats.worker_deaths == 1
    assert fleet.stats.requeued >= 1
    assert fleet.stats.resolved == 6
    assert fleet.stats.failed == 0
    assert fleet.stats.first_recovery_s is not None


def test_kill_mid_wave_respawns_when_no_worker_survives():
    reqs = make_reqs(4, seed0=60)
    with make_fleet(workers=1,
                    fault_plan=FaultPlan(kill_worker_at={0: 2})) as fleet:
        [fleet.submit(r) for r in reqs]
        out = fleet.flush()
    assert_matches_both(out, reqs)
    assert fleet.stats.worker_deaths == 1
    assert fleet.stats.requeued == 2       # the undelivered half of the wave
    assert fleet.stats.respawns == 1
    assert [w.wid for w in fleet.workers] == [0, 1]
    assert not fleet.workers[0].alive and fleet.workers[1].alive


def test_kill_during_background_flush():
    reqs = make_reqs(6, seed0=80)
    with EngineFleet(workers=2, fault_plan=FaultPlan(kill_worker_at={0: 1}),
                     **ENGINE_KW) as fleet:
        futs = [fleet.submit(r) for r in reqs]
        out = {r.job_id: f.result(timeout=60.0)
               for r, f in zip(reqs, futs)}
    assert_matches_both(out, reqs)
    assert fleet.stats.worker_deaths == 1
    assert fleet.stats.resolved == 6


# ------------------------------------- stragglers + double-resolution guard
def test_straggler_redispatch_first_result_wins():
    reqs = make_reqs(1, seed0=100)
    with make_fleet(workers=2,
                    fault_plan=FaultPlan(delay_worker_s={0: 0.6}),
                    straggler_after_s=0.05) as fleet:
        fut = fleet.submit(reqs[0])
        out = fleet.flush()
        assert fut.done()
        assert fleet.stats.straggler_redispatches == 1
        perm_first = np.array(fut.result(timeout=0).perm, copy=True)
        assert wait_until(lambda: fleet.stats.duplicate_results >= 1)
        np.testing.assert_array_equal(fut.result(timeout=0).perm,
                                      perm_first)
    assert_matches_both(out, reqs)
    assert fleet.stats.resolved == 1


# A worker heartbeats only between waves, and the port's CPU solve of a
# wave takes tens of milliseconds (the reference's jitted one a few), so
# the staleness tests give the port's fleet timeouts well above that.
def test_dropped_heartbeats_declare_death_and_zombie_hits_guard():
    reqs = make_reqs(1, seed0=120)
    with make_fleet(workers=2,
                    fault_plan=FaultPlan(delay_worker_s={0: 2.0},
                                         drop_heartbeats=frozenset({0})),
                    heartbeat_timeout_s=0.5) as fleet:
        fut = fleet.submit(reqs[0])
        out = fleet.flush()
        assert fut.done()
        assert fleet.stats.worker_deaths == 1
        assert fleet.stats.requeued == 1
        assert wait_until(lambda: fleet.stats.duplicate_results >= 1), \
            "zombie delivery never arrived"
        assert fleet.stats.resolved == 1
    assert_matches_both(out, reqs)


# ------------------------------------------------------------ circuit breaker
class _BrokenEngine(MappingEngine):
    """A worker engine whose every solve raises (a wedged device)."""

    def _solve_bucket(self, *args, **kwargs):
        raise RuntimeError("device wedged")


class _RefBrokenEngine(RefEngine):
    def _solve_bucket(self, *args, **kwargs):
        raise RuntimeError("device wedged")


def _breaker_run(fleet_cls, engine_cls, broken_cls, request_cls, kw):
    """Worker 0 fails every request; after two consecutive failures its
    breaker opens and the next waves go to worker 1 although worker 0
    has fewer outstanding requests and was assigned least recently."""
    fleet = fleet_cls(workers=2, breaker_failures=2, breaker_cooldown_s=60.0,
                      engine_factory=lambda wid: (broken_cls if wid == 0
                                                  else engine_cls)(
                          warm_start=False, **kw))
    try:
        reqs = make_reqs(6, seed0=210, cls=request_cls)
        futs = [fleet.submit(r) for r in reqs[:2]]      # one wave, worker 0
        with pytest.raises(RuntimeError, match="wedged"):
            fleet.flush()
        assert all(f.exception(timeout=0) is not None for f in futs)
        trips = fleet.stats.breaker_trips
        assert fleet.workers[0].consecutive_failures == 2
        served = {}
        for r in reqs[2:]:
            resp = fleet.map_one(r.C, r.M, seed=r.seed, job_id=r.job_id)
            served[r.job_id] = (resp.perm.tolist(), resp.objective)
        return (trips, fleet.stats.failed, fleet.stats.resolved,
                fleet.workers[0].outstanding, fleet.workers[1].completed,
                served)
    finally:
        fleet.stop()


def test_circuit_breaker_routes_around_a_failing_worker():
    got = _breaker_run(EngineFleet, MappingEngine, _BrokenEngine, MapRequest,
                       ENGINE_KW)
    want = _breaker_run(RefFleet, RefEngine, _RefBrokenEngine, RefRequest,
                        REF_KW)
    assert got == want
    trips, failed, resolved, _, w1_completed, _ = got
    assert (trips, failed, resolved, w1_completed) == (1, 2, 4, 4)


# ------------------------------------------------------------- shared cache
def test_shared_cache_serves_other_workers_and_survives_deaths():
    C, M = _instance(6, seed=140)
    C2, M2 = _instance(6, seed=141)
    with make_fleet(workers=1,
                    fault_plan=FaultPlan(kill_worker_at={0: 1})) as fleet:
        first = fleet.map_one(C, M, algorithm="psa", seed=140, job_id="a")
        assert fleet.stats.cache_hits == 0
        fleet.map_one(C2, M2, algorithm="psa", seed=141, job_id="c")
        assert fleet.stats.worker_deaths == 1
        assert not fleet.workers[0].alive
        waves = fleet.stats.dispatched_waves
        again = fleet.map_one(C, M, algorithm="psa", seed=140, job_id="b")
        assert fleet.stats.cache_hits == 1
        assert fleet.stats.dispatched_waves == waves
        assert again.cached and not first.cached
        np.testing.assert_array_equal(again.perm, first.perm)
        assert again.objective == first.objective
    want = reference_results([MapRequest(job_id="a", C=C, M=M, seed=140)])
    np.testing.assert_array_equal(first.perm, want["a"].perm)


# ------------------------------------------------------ property-based sweep
def _random_stream_random_kills(case_seed):
    rng = np.random.default_rng(case_seed)
    workers = int(rng.integers(1, 4))
    nreq = int(rng.integers(2, 9))
    kill = {w: int(rng.integers(0, 5)) for w in range(workers)
            if rng.random() < 0.5}
    sizes = [int(rng.integers(2, 7)) for _ in range(nreq)]
    cluster = ClusterState(instances.grid_distance_matrix((2, 2, 2)))
    free0 = cluster.num_free
    reqs, allocs = [], []
    for i, n in enumerate(sizes):
        alloc = cluster.allocate(f"p{i}", n)
        if alloc is None:
            for a in allocs:
                cluster.release(a)
            allocs = []
            alloc = cluster.allocate(f"p{i}", n)
        allocs.append(f"p{i}")
        C, _ = _instance(n, seed=1000 + i)
        reqs.append(MapRequest(job_id=f"p{i}", C=C, M=alloc.M_sub,
                               algorithm="psa", seed=i))
    with make_fleet(workers=workers,
                    fault_plan=FaultPlan(kill_worker_at=kill)) as fleet:
        futs = [fleet.submit(r) for r in reqs]
        out = fleet.flush()
        assert all(f.done() for f in futs)
    assert fleet.stats.resolved == nreq
    assert fleet.stats.failed == 0
    assert_matches_both(out, reqs)
    for r in reqs:
        assert sorted(out[r.job_id].perm.tolist()) == list(range(r.C.shape[0]))
    for a in allocs:
        cluster.release(a)
    assert cluster.num_free == free0


@pytest.mark.slow
@given(st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=4, deadline=None)
def test_random_streams_random_kills_lose_nothing(case_seed):
    _random_stream_random_kills(case_seed)


@pytest.mark.slow
@pytest.mark.parametrize("case_seed", [7, 1234, 99991])
def test_random_streams_random_kills_fixed_seeds(case_seed):
    _random_stream_random_kills(case_seed)


# ------------------------------------------- deadline wall + degradation
def test_deadline_wall_degrades_then_discards_late_result():
    C, M = _instance(6, seed=160)
    with make_fleet(workers=1,
                    fault_plan=FaultPlan(delay_worker_s={0: 2.0})) as fleet:
        req = MapRequest(job_id="d0", C=C, M=M, algorithm="psa",
                         seed=160, deadline_ms=250.0)
        t0 = time.monotonic()
        fut = fleet.submit(req)
        out = fleet.flush()
        elapsed = time.monotonic() - t0
        resp = fut.result(timeout=0)
        assert elapsed < 1.5               # deadline + pump, not the hang
        assert resp.degraded and resp.degrade_reason == "deadline_identity"
        assert resp.perm.tolist() == list(range(6))
        assert resp.objective == resp.baseline
        assert out["d0"].degraded
        assert fleet.stats.degraded == 1
        assert wait_until(lambda: fleet.stats.duplicate_results >= 1,
                          timeout=60.0), "late real result never arrived"
        assert fut.result(timeout=0) is resp
        assert fleet.stats.resolved == 1
        fut2 = fleet.submit(MapRequest(job_id="d1", C=C, M=M,
                                       algorithm="psa", seed=161,
                                       cache_seed=True, deadline_ms=250.0))
        fleet.flush()
        resp2 = fut2.result(timeout=0)
        assert resp2.degraded
        assert resp2.degrade_reason == "deadline_shape_cache"
        assert resp2.objective <= resp2.baseline
    # the shape tier's permutation is the real solve of d0 (tight tier:
    # a 250 ms deadline), the reference's bit for bit
    want = reference_results([req])["d0"]
    np.testing.assert_array_equal(resp2.perm, want.perm)
    assert resp2.objective == want.objective


def test_no_deadline_means_no_degradation():
    reqs = make_reqs(2, seed0=170)
    with make_fleet(workers=1,
                    fault_plan=FaultPlan(delay_worker_s={0: 0.3})) as fleet:
        [fleet.submit(r) for r in reqs]
        out = fleet.flush()
    assert fleet.stats.degraded == 0
    assert_matches_both(out, reqs)


# ----------------------------------------------- compiling grace period
@pytest.mark.parametrize("grace,deaths", [(5.0, 0), (0.0, 1)])
def test_compiling_grace_exempts_first_delivery_from_staleness(grace, deaths):
    """A worker silent for 1.2 s against a 0.4 s heartbeat timeout is a
    hang -- unless it has never delivered (a cold start looks exactly
    like this).  With the grace it survives; without, it is reaped and
    the request recovers elsewhere."""
    reqs = make_reqs(1, seed0=150)
    with make_fleet(workers=2, heartbeat_timeout_s=0.4,
                    compiling_grace_s=grace,
                    fault_plan=FaultPlan(delay_worker_s={0: 1.2})) as fleet:
        fut = fleet.submit(reqs[0])
        out = fleet.flush()
        assert fut.done()
        assert fleet.stats.worker_deaths == deaths
        assert fleet.stats.requeued == deaths
    assert_matches_both(out, reqs)


# ------------------------------------------------- cancel + backpressure
def test_cancel_before_dispatch_is_counted_and_skipped():
    reqs = make_reqs(2, seed0=180)
    with make_fleet(workers=1) as fleet:
        f0 = fleet.submit(reqs[0])
        f1 = fleet.submit(reqs[1])
        assert f1.cancel()
        assert not f1.cancel()
        assert f1.cancelled() and f1.done()
        with pytest.raises(MapCancelled):
            f1.result(timeout=0)
        out = fleet.flush()
        assert f0.done() and not f0.cancelled()
    assert "j1" not in out
    assert fleet.stats.cancelled == 1
    assert fleet.stats.resolved == 1
    assert fleet.stats.solver_calls == 1
    assert_matches_both(out, reqs[:1])


def test_max_pending_rejects_with_queue_full_future():
    reqs = make_reqs(3, seed0=190)
    with make_fleet(workers=1, max_pending=2) as fleet:
        f0 = fleet.submit(reqs[0])
        f1 = fleet.submit(reqs[1])
        f2 = fleet.submit(reqs[2])
        assert f2.done()
        with pytest.raises(QueueFull):
            f2.result(timeout=0)
        assert fleet.stats.rejected == 1
        out = fleet.flush()
        assert f0.done() and f1.done()
    assert_matches_both(out, reqs[:2])
    assert fleet.stats.resolved == 2 and fleet.stats.failed == 0
    with pytest.raises(ValueError, match="max_pending"):
        EngineFleet(workers=1, max_pending=0, **ENGINE_KW)


# ------------------------------------------------------------------ warmup
def test_fleet_warmup_forwards_the_reference_arguments():
    """``warmup`` takes the reference's keywords and forwards them to a
    live worker's engine, refusing what the engine refuses."""
    kw = dict(buckets=(8,), algorithms=("psa", "pga"),
              tiers=("default", "tight"), batch_sizes=None,
              warm_starts=(False, True), execute=None)
    with make_fleet(workers=2,
                    fault_plan=FaultPlan(kill_worker_at={0: 0})) as fleet:
        assert fleet.warmup(**kw) == 4
        assert fleet.workers[0].engine.stats.warmup_programs == 4
        fleet.map_one(*_instance(6, seed=5), seed=5)    # kills worker 0
        assert not fleet.workers[0].alive
        assert fleet.warmup(**kw) == 4                  # a live worker
        assert fleet.workers[1].engine.stats.warmup_programs == 4
        for bad, match in ((dict(buckets=(64,)), "bucket"),
                           (dict(algorithms=("nope",)), "algorithm"),
                           (dict(tiers=("loose",)), "tier")):
            with pytest.raises(ValueError, match=match):
                fleet.warmup(**bad)
            with pytest.raises(ValueError, match=match):
                RefEngine(**REF_KW).warmup(**bad)


# --------------------------------------------------- launch counts, threads
def test_thread_fleet_on_cpu_launches_no_kernel():
    """The CPU workers take the plain versions: no launch is counted,
    whichever thread solves."""
    ops.reset_launch_counts()
    with make_fleet(workers=3) as fleet:
        [fleet.submit(r) for r in make_reqs(9, seed0=300)]
        fleet.flush()
    assert set(ops.launch_counts().values()) == {0}
    assert not build.BRANCH_LAUNCHES
