"""The port's multilevel pipeline and the engine's large buckets against
``repro.core.multilevel`` and ``repro.serve.MappingEngine``, bit for bit
on the known-optimum torus and ring instances: the matchings, coarsening
and prolongation, ``solve_multilevel`` with a PSA and a PGA coarse solve,
and multilevel-routed requests with their cache hits."""
import dataclasses

import numpy as np
import pytest
import jax

from repro.core import annealing as jann
from repro.core import exact as jexact
from repro.core import multilevel as jml
from repro.serve.mapper import MappingEngine as RefEngine
from repro.serve.mapper import MapRequest as RefRequest
from repro_torch import convert
from repro_torch.core import exact, multilevel
from repro_torch.serve import MappingEngine, MapRequest

from _fixtures import GA_SMALL, SA_SMALL

# A tiny budget: coarsening to 8, small coarse and refinement solves.
ML_TINY = jml.MultilevelConfig(
    coarse_n=8,
    coarse_sa=dataclasses.replace(SA_SMALL, solvers=2),
    coarse_ga=dataclasses.replace(GA_SMALL, generations=6),
    refine_sa=dataclasses.replace(SA_SMALL, solvers=2, flows="sparse"),
    final_polish_rounds=8)
SA_KW = dict(max_neighbors=8, iters_per_exchange=6, num_exchanges=3,
             solvers=3)


def _port(cfg):
    return convert.multilevel_config_from_reference(dataclasses.asdict(cfg))


def _instance(spec, version=1):
    kind, dims = spec
    if kind == "ring":
        return jexact.make_ring(dims, version=version)
    return jexact.make_torus(dims, version=version)


def test_default_config_matches_reference():
    assert _port(jml.MultilevelConfig()) == multilevel.MultilevelConfig()
    assert _port(ML_TINY).refine_sa.flows == "sparse"


@pytest.mark.parametrize("spec", [("torus", (4, 4)), ("torus", (2, 3, 4)),
                                  ("ring", 14)])
def test_matchings_coarsening_and_prolongation_match_reference(spec):
    inst = _instance(spec, 2)
    C, M = inst.C, inst.M
    fp = multilevel.heavy_edge_matching(C)
    sp = multilevel.closest_pair_matching(M)
    np.testing.assert_array_equal(fp, jml.heavy_edge_matching(C))
    np.testing.assert_array_equal(sp, jml.closest_pair_matching(M))
    n = C.shape[0]
    assert sorted(fp.ravel().tolist()) == sorted(sp.ravel().tolist()) \
        == list(range(n))
    Cc, Mc = multilevel.coarsen(C, M, fp, sp)
    Cw, Mw = jml.coarsen(C, M, fp, sp)
    assert Cc.tobytes() == Cw.tobytes() and Mc.tobytes() == Mw.tobytes()
    pc = np.random.default_rng(n).permutation(n // 2)
    p = multilevel.prolong_perm(pc, fp, sp)
    np.testing.assert_array_equal(p, jml.prolong_perm(pc, fp, sp))
    assert sorted(p.tolist()) == list(range(n))
    with pytest.raises(ValueError, match="even"):
        multilevel.heavy_edge_matching(C[:-1, :-1])
    with pytest.raises(ValueError, match="even"):
        multilevel.closest_pair_matching(M[:-1, :-1])


def _same_result(want, got):
    np.testing.assert_array_equal(got.perm, np.asarray(want.perm))
    assert got.perm.dtype == np.int32
    assert got.objective == want.objective
    assert got.coarse_objective == want.coarse_objective
    assert got.levels == want.levels


@pytest.mark.parametrize("algorithm", ["psa", "pga"])
@pytest.mark.parametrize("dims", [(4, 4), (8, 8), (4, 4, 4)])
def test_solve_multilevel_matches_reference(dims, algorithm):
    inst = jexact.make_torus(dims)
    cfg = dataclasses.replace(ML_TINY, algorithm=algorithm)
    want = jml.solve_multilevel(inst.C, inst.M, jax.random.PRNGKey(3), cfg)
    got = multilevel.solve_multilevel(
        inst.C, inst.M, np.asarray(jax.random.PRNGKey(3)), _port(cfg),
        device="cpu")
    _same_result(want, got)
    n = inst.C.shape[0]
    assert [lv.n for lv in got.levels] == [16 * 2 ** i for i in range(
        len(got.levels))] and got.levels[-1].n == n
    for lv in got.levels:                     # warm starts never regress
        assert lv.f_refined <= lv.f_prolonged
    assert inst.optimum <= got.objective <= got.levels[-1].f_refined


@pytest.mark.parametrize("n", [9, 24])
def test_solve_multilevel_odd_order_matches_reference(n):
    """Order 9 solves directly; order 24 coarsens 24 -> 12 -> 6 -> 3 and
    stops at the odd order."""
    inst = jexact.make_ring(n)
    cfg = dataclasses.replace(ML_TINY, coarse_n=2)
    want = jml.solve_multilevel(inst.C, inst.M, jax.random.PRNGKey(1), cfg)
    got = multilevel.solve_multilevel(
        inst.C, inst.M, np.asarray(jax.random.PRNGKey(1)), _port(cfg),
        device="cpu")
    _same_result(want, got)
    assert [lv.n for lv in got.levels] == ([] if n == 9 else [6, 12, 24])


def test_solve_multilevel_rejects_unknown_algorithm():
    inst = exact.make_torus((4, 4))
    with pytest.raises(ValueError, match="algorithm"):
        multilevel.solve_multilevel(
            inst.C, inst.M, cfg=dataclasses.replace(_port(ML_TINY),
                                                    algorithm="pca"),
            device="cpu")


def _engines(**kw):
    base = dict(buckets=(8,), large_buckets=(16, 64), multilevel_min_n=16,
                num_processes=2, polish_rounds=10)
    base.update(kw)
    ref = RefEngine(sa_cfg=jann.SAConfig(**SA_KW), multilevel_cfg=ML_TINY,
                    **base)
    port = MappingEngine(sa_cfg=convert.sa_config_from_reference(
        dataclasses.asdict(jann.SAConfig(**SA_KW))),
        multilevel_cfg=_port(ML_TINY), device="cpu", **base)
    return ref, port


def test_engine_large_bucket_routing():
    ref, port = _engines()
    for n in (6, 8, 12, 15, 16, 40, 64, 100):
        assert port.bucket_for(n) == ref.bucket_for(n)
        assert port.large_bucket_for(n) == ref.large_bucket_for(n)
        assert port._route(n) == ref._route(n)
    assert port._route(12) is None              # below multilevel_min_n
    assert port.large_bucket_for(16) == 16
    assert port.large_bucket_for(40) == 64
    assert port.large_bucket_for(100) == 64     # largest label catches all
    _, collide = _engines(buckets=(8, 16))
    assert collide.bucket_for(16) == 16         # the dense bucket wins


def test_engine_digest_tags_multilevel_route():
    _, port = _engines()
    _, other = _engines()
    other.multilevel_cfg = dataclasses.replace(other.multilevel_cfg,
                                               final_polish_rounds=2)
    inst = exact.make_torus((4, 4))
    big = MapRequest(job_id="j", C=inst.C, M=inst.M)
    small = MapRequest(job_id="k", C=inst.C[:8, :8], M=inst.M[:8, :8])
    assert port.digest(big) != other.digest(big)        # cfg in the key
    assert port.digest(small) == other.digest(small)    # dense route: no tag


def test_engine_multilevel_solves_and_cache_hits_match_reference():
    """Three multilevel-routed orders, a small dense one and a repeat
    (a cache hit) through both engines give the same responses; the
    shape tier does not warm-start the multilevel route."""
    def drive(engine, cls):
        reqs = [cls(job_id=f"t{i}", C=inst.C, M=inst.M, seed=i)
                for i, inst in enumerate([
                    jexact.make_torus((4, 4)), jexact.make_torus((8, 8)),
                    jexact.make_ring(24), jexact.make_ring(6)])]
        futs = [engine.submit(r) for r in reqs]
        engine.flush()
        C2 = jexact.make_torus((4, 4), version=2).C
        warm = engine.submit(cls(job_id="same-M", C=C2, M=reqs[0].M, seed=7))
        hit = engine.submit(cls(job_id="again", C=reqs[1].C, M=reqs[1].M,
                                seed=9))
        engine.flush()
        return [f.result() for f in futs] + [warm.result(), hit.result()]

    ref, port = _engines()
    want, got = drive(ref, RefRequest), drive(port, MapRequest)
    for w, g in zip(want, got, strict=True):
        assert g.job_id == w.job_id
        np.testing.assert_array_equal(g.perm, w.perm)
        assert g.objective == w.objective
        assert (g.baseline, g.bucket, g.cached, g.warm_start, g.batch_size) \
            == (w.baseline, w.bucket, w.cached, w.warm_start, w.batch_size)
    assert [g.bucket for g in got] == [16, 64, 64, 8, 16, 64]
    assert got[-1].cached and not got[-2].warm_start
    assert port.stats.cache_hits == ref.stats.cache_hits == 1
    assert port.stats.solver_calls == ref.stats.solver_calls
