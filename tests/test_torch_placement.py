"""The port's placement services against ``repro.launch.placement``:
``PlacementService.solve``, ``solve_batch``, ``submit`` + ``result``
(with the timeout-cancel race), the module functions over the default
service, the deprecation shims and a fleet-backed service under a kill
give the reference's results for the same key words, bit for bit on
integer-valued instances."""
import warnings

import numpy as np
import pytest

import jax
from repro.core import annealing as ref_annealing
from repro.core import genetic as ref_genetic
from repro.core import instances as ref_instances
from repro.launch import placement as ref_pl
from repro_torch.core import annealing, genetic
from repro_torch.launch import placement as pl
from repro_torch.serve import FaultPlan, MapCancelled

from _torch_serve import one_torch_thread  # noqa: F401

SMALL_SA = dict(max_neighbors=10, iters_per_exchange=8, num_exchanges=4,
                solvers=4, seed_with="identity")
SMALL_GA = dict(generations=15, pop_size=12, seed_identity=True)


@pytest.fixture(autouse=True)
def fresh_port_service():
    """The port's default service is a module singleton too: reset it
    around every test, as the suite's conftest resets the reference's."""
    pl.reset_default_service()
    yield
    pl.reset_default_service()


def _small(module="port", **kw):
    """A service on the small budgets (the presets' seeding kept)."""
    if module == "ref":
        return ref_pl.PlacementService(
            sa_cfg=ref_annealing.SAConfig(**SMALL_SA),
            ga_cfg=ref_genetic.GAConfig(**SMALL_GA), **kw)
    return pl.PlacementService(sa_cfg=annealing.SAConfig(**SMALL_SA),
                               ga_cfg=genetic.GAConfig(**SMALL_GA),
                               device="cpu", **kw)


def _ring_on_grid(n=8, seed=0):
    """Heavy ring traffic laid out badly over a 2x2x2 grid: integer
    flows and distances, so every objective sum is exact."""
    m = ref_instances.grid_distance_matrix((2, 2, 2))[:n, :n]
    order = np.random.default_rng(seed).permutation(n)
    c = np.zeros((n, n), np.float32)
    for i in range(n):
        c[order[i], order[(i + 1) % n]] = 100.0 + seed
    return c, m


def _key(k):
    """The reference's raw key for seed k and its words for the port."""
    ref = jax.random.PRNGKey(k)
    return ref, np.asarray(ref)


def _same(got, want):
    np.testing.assert_array_equal(got.perm, want.perm)
    assert (got.cost_before, got.cost_after, got.algorithm) == \
        (want.cost_before, want.cost_after, want.algorithm)
    assert got.gain == want.gain


def test_presets_and_seed_rule_match_reference():
    import dataclasses
    assert dataclasses.asdict(pl._FAST_SA) == \
        dataclasses.asdict(ref_pl._FAST_SA)
    assert dataclasses.asdict(pl._FAST_GA) == \
        dataclasses.asdict(ref_pl._FAST_GA)
    for k in (0, 3, 2 ** 31 + 5):
        ref, words = _key(k)
        assert pl._seed_from_key(words) == ref_pl._seed_from_key(ref) == k
        assert pl._seed_from_key(k) == ref_pl._seed_from_key(k) == k
    assert pl._seed_from_key(None) == ref_pl._seed_from_key(None) == 0


def test_default_budget_solve_matches_reference():
    """The launcher's own presets, once: PSA through the engine."""
    c, m = _ring_on_grid(seed=1)
    ref, words = _key(3)
    got = pl.PlacementService(device="cpu").solve(c, m, "psa", key=words)
    want = ref_pl.PlacementService().solve(c, m, "psa", key=ref)
    _same(got, want)
    assert got.gain > 0.3


@pytest.mark.parametrize("algorithm", ["psa", "pga", "pca"])
@pytest.mark.parametrize("key", [None, 5])
def test_solve_matches_reference(algorithm, key):
    c, m = _ring_on_grid(seed=2)
    ref_key, words = (None, None) if key is None else _key(key)
    got = _small().solve(c, m, algorithm, key=words)
    want = _small("ref").solve(c, m, algorithm, key=ref_key)
    _same(got, want)
    assert got.cost_after <= got.cost_before


@pytest.mark.parametrize("algorithm", ["psa", "identity"])
def test_solve_outside_the_engine_matches_reference(algorithm):
    """An explicit ``num_processes`` or config bypasses the engine:
    ``find_mapping`` with the key's words."""
    c, m = _ring_on_grid(seed=3)
    ref_key, words = _key(7)
    got = _small().solve(c, m, algorithm, key=words, num_processes=2,
                         sa_cfg=annealing.SAConfig(**SMALL_SA))
    want = _small("ref").solve(c, m, algorithm, key=ref_key,
                               num_processes=2,
                               sa_cfg=ref_annealing.SAConfig(**SMALL_SA))
    _same(got, want)


@pytest.mark.parametrize("key", [None, 11])
def test_solve_batch_matches_reference(key):
    insts = [_ring_on_grid(n, s) for n, s in ((8, 4), (6, 5), (7, 6))]
    ref_key, words = (None, None) if key is None else _key(key)
    svc = _small()
    got = svc.solve_batch(insts, "psa", key=words)
    want = _small("ref").solve_batch(insts, "psa", key=ref_key)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)
    assert svc.engine.stats.solver_batches == 1       # one wave


def test_submit_and_result_match_reference():
    c, m = _ring_on_grid(seed=8)
    ref_key, words = _key(2)
    svc, ref = _small(), _small("ref")
    fut = svc.submit(c, m, "psa", key=words, job_id="s")
    rfut = ref.submit(c, m, "psa", key=ref_key, job_id="s")
    svc.engine.flush()
    ref.engine.flush()
    _same(pl.PlacementService.result(fut), ref_pl.PlacementService.result(rfut))


def test_result_timeout_cancels_the_request():
    c, m = _ring_on_grid(seed=9)
    svc = _small()
    fut = svc.submit(c, m, "psa", job_id="abandoned")
    with pytest.raises(TimeoutError):
        pl.PlacementService.result(fut, timeout=0.01)
    assert fut.cancelled()
    with pytest.raises(MapCancelled):
        fut.result(timeout=0)
    assert svc.engine.flush() == {}                   # nothing left to solve
    assert svc.engine.stats.cancelled == 1 and svc.engine.stats.solver_calls == 0


class _RacingFuture:
    """A future whose result lands between the timeout and the cancel:
    the wait times out, but the cancel then loses the claim."""

    def __init__(self, resp):
        self.resp, self.cancels = resp, 0

    def result(self, timeout=None):
        if timeout:
            raise TimeoutError("not yet")
        return self.resp

    def cancel(self):
        self.cancels += 1
        return False


def test_result_returns_the_response_that_won_the_cancel_race():
    c, m = _ring_on_grid(seed=10)
    resp = _small().engine.map_one(c, m)
    got = pl.PlacementService.result(_RacingFuture(resp), timeout=1.0)
    want = ref_pl.PlacementService.result(_RacingFuture(resp), timeout=1.0)
    _same(got, want)
    np.testing.assert_array_equal(got.perm, resp.perm)


def test_module_functions_route_through_the_default_service():
    """``default_service()`` is on the card; here both default services
    are replaced by small-budget ones (the port's on the CPU)."""
    pl._SERVICE = _small()
    ref_pl._SERVICE = _small("ref")
    assert pl.default_service() is pl._SERVICE
    c, m = _ring_on_grid(seed=12)
    ref_key, words = _key(4)
    _same(pl.solve_placement(c, m, "pga", key=words),
          ref_pl.solve_placement(c, m, "pga", key=ref_key))
    assert pl.get_engine() is pl._SERVICE.engine
    assert pl.get_engine().stats.solver_calls == 1
    fut = pl.default_service().submit(c, m, "psa", job_id="queued")
    pl.reset_default_service()                 # drains the queued future
    assert fut.done() and pl._SERVICE is None
    assert sorted(pl.PlacementService.result(fut).perm.tolist()) == \
        list(range(8))


def test_default_service_runs_on_the_card():
    import torch
    if torch.cuda.is_available():
        assert pl.get_engine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            pl.get_engine()


def test_deprecated_shims_warn_and_match_reference():
    pl._SERVICE = _small()
    ref_pl._SERVICE = _small("ref")
    c, m = _ring_on_grid(seed=13)
    with pytest.warns(DeprecationWarning, match="submit_placement"):
        fut = pl.submit_placement(c, m, "psa", job_id="old")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rfut = ref_pl.submit_placement(c, m, "psa", job_id="old")
        ref_pl.get_engine().flush()
        rres = ref_pl.placement_result(rfut)
        rbatch = ref_pl.solve_placements([(c, m)], "psa")
    pl.get_engine().flush()
    with pytest.warns(DeprecationWarning, match="placement_result"):
        res = pl.placement_result(fut)
    _same(res, rres)
    with pytest.warns(DeprecationWarning, match="solve_placements"):
        batch = pl.solve_placements([(c, m)], "psa")
    assert len(batch) == 1
    _same(batch[0], rbatch[0])
    with pytest.warns(DeprecationWarning, match="reset_engine"):
        pl.reset_engine()
    assert pl._SERVICE is None


def test_fleet_backed_service_under_a_kill_matches_reference():
    insts = [_ring_on_grid(n, s) for n, s in ((8, 20), (6, 21), (8, 22),
                                               (7, 23))]
    ref_key, words = _key(6)
    svc = _small(workers=2, fault_plan=FaultPlan(kill_worker_at={0: 1}))
    try:
        got = svc.solve_batch(insts, "psa", key=words)
        fleet = svc.engine
        assert fleet.stats.worker_deaths == 1 and fleet.stats.failed == 0
        assert fleet.stats.requeued >= 1
    finally:
        svc.close()
    want = _small("ref").solve_batch(insts, "psa", key=ref_key)
    for g, w in zip(got, want):
        _same(g, w)
