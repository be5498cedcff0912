"""The port's spans (``repro_torch.spans``) and the engine's dispatch
stamp, on the CPU with a tiny engine: the recorder off records nothing,
on it gives one ``engine.dispatch`` tree a flush, and the answers are
the same either way."""
import threading
import time
import tracemalloc

import numpy as np
import pytest

from repro_torch import spans
from repro_torch.core import annealing, genetic
from repro_torch.serve import MappingEngine, MapRequest

SA_KW = dict(max_neighbors=8, iters_per_exchange=6, num_exchanges=3,
             solvers=3)
ENGINE_KW = dict(buckets=(8, 16), polish_rounds=20)
GROUP_CHILDREN = ["engine.stage", "solver.psa", "solver.polish",
                  "engine.copy_back"]


def instance(n, seed):
    rng = np.random.RandomState(seed)
    C = rng.randint(0, 5, (n, n)).astype(np.float32)
    C = C + C.T
    np.fill_diagonal(C, 0)
    xy = rng.randint(0, 4, (n, 2))
    M = np.abs(xy[:, None] - xy[None]).sum(-1).astype(np.float32)
    return C, M


def requests(orders=(5, 8, 12, 16), seed0=0):
    out = []
    for i, n in enumerate(orders):
        C, M = instance(n, seed0 + i)
        out.append(MapRequest(job_id=f"j{seed0 + i}", C=C, M=M, seed=i + 1))
    return out


def engine(loop="event", num_exchanges=3, **kw):
    return MappingEngine(
        sa_cfg=annealing.SAConfig(**dict(SA_KW, loop=loop,
                                         num_exchanges=num_exchanges)),
        ga_cfg=genetic.GAConfig(generations=3, pop_size=8), device="cpu",
        **dict(ENGINE_KW, **kw))


def solve(eng, reqs):
    futs = [eng.submit(r) for r in reqs]
    eng.flush()
    return futs


def tree(records):
    kids = {}
    for s in records:
        kids.setdefault(s.parent, []).append(s)
    for v in kids.values():
        v.sort(key=lambda s: s.start_ns)
    return kids


@pytest.fixture(autouse=True)
def recorder_left_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def test_off_records_nothing_reads_no_clock_and_allocates_nothing(
        monkeypatch):
    assert not spans.enabled()
    for _ in range(10):                  # warm every freelist
        with spans.span("x", a=1) as s:
            s.set(b=2)

    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(time, "monotonic_ns", no_clock)
    assert spans.span("engine.dispatch") is spans.OFF
    assert spans.span("solver.round", e=3) is spans.OFF
    assert not spans.OFF
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        before, _ = tracemalloc.get_traced_memory()
        for _ in range(10_000):
            with spans.span("x") as s:
                s.set(b=2)
            with spans.span("y", e=1):
                pass
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after - before < 512 and peak - before < 2048
    solve(engine(), requests())
    assert spans.drain() == []


def test_on_records_parents_threads_and_clock():
    spans.enable()
    with spans.span("a", k=1) as a:
        t0 = time.monotonic_ns()
        with spans.span("b") as b:
            b.set(n=2)
        t1 = time.monotonic_ns()
    got = spans.drain()
    assert [s.name for s in got] == ["b", "a"]
    assert (a.parent, b.parent) == (None, a.id)
    assert a.attrs == {"k": 1} and b.attrs == {"n": 2}
    assert a.start_ns <= t0 <= b.start_ns <= b.end_ns <= t1 <= a.end_ns
    assert a.thread == b.thread
    assert spans.drain() == []


@pytest.mark.parametrize("loop", ["event", "fused"])
def test_one_dispatch_tree_a_flush(loop):
    spans.enable()
    reqs = requests()
    solve(engine(loop), reqs)
    records = spans.drain()
    kids = tree(records)
    (top,) = kids[None]
    assert top.name == "engine.dispatch"
    assert top.attrs == {"requests": 4, "groups": 2}
    under = [s.name for s in kids[top.id]]
    assert under == ["engine.cache_pass", "engine.group", "engine.respond",
                     "engine.group", "engine.respond"]
    assert kids[top.id][0].attrs == {"hits": 0, "misses": 4}
    groups = [s for s in kids[top.id] if s.name == "engine.group"]
    assert [(g.attrs["bucket"], g.attrs["batch"], g.attrs["jobs"])
            for g in groups] == [(8, 2, ["j0", "j1"]), (16, 2, ["j2", "j3"])]
    for g in groups:
        assert (g.attrs["algorithm"], g.attrs["tier"], g.attrs["warm"]) == \
            ("psa", "default", 0)
        assert [s.name for s in kids[g.id]] == GROUP_CHILDREN
        stage = kids[g.id][0]
        assert stage.attrs == {"batch": 2, "padded": 2}
        solver = kids[g.id][1]
        assert [s.name for s in kids[solver.id]] == \
            ["solver.init"] + ["solver.round"] * 3
        assert [s.attrs["e"] for s in kids[solver.id][1:]] == [0, 1, 2]
    by_id = {s.id: s for s in records}
    for s in records:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.thread == p.thread
    assert len(records) == 1 + 1 + 2 * (2 + 4 + 1 + 3)


@pytest.mark.parametrize("num_exchanges", [1, 4])
def test_a_round_span_per_exchange_a_group(num_exchanges):
    spans.enable()
    solve(engine(num_exchanges=num_exchanges), requests((5, 6, 12)))
    records = spans.drain()
    kids = tree(records)
    solvers = [s for s in records if s.name == "solver.psa"]
    assert len(solvers) == 2
    for s in solvers:
        assert [k.name for k in kids[s.id]].count("solver.round") == \
            num_exchanges


@pytest.mark.parametrize("algorithm", ["pga", "pca"])
def test_each_algorithm_has_its_solver_span(algorithm):
    spans.enable()
    reqs = [MapRequest(job_id=r.job_id, C=r.C, M=r.M, seed=r.seed,
                       algorithm=algorithm) for r in requests((6, 7))]
    solve(engine(), reqs)
    kids = tree(spans.drain())
    (group,) = [s for v in kids.values() for s in v
                if s.name == "engine.group"]
    assert [s.name for s in kids[group.id]] == \
        ["engine.stage", "solver." + algorithm, "solver.polish",
         "engine.copy_back"]


def test_exact_size_request_is_solved_and_polished_in_its_group():
    spans.enable()
    solve(engine(), requests((20,)))
    kids = tree(spans.drain())
    (group,) = [s for v in kids.values() for s in v
                if s.name == "engine.group"]
    assert group.attrs["bucket"] is None
    assert [s.name for s in kids[group.id]] == ["solver.psa", "solver.polish"]


def test_dispatch_stamp_lies_between_submit_and_resolution():
    eng = engine(flush_deadline_ms=1.0, max_pending=8)
    reqs = requests()
    with eng:
        t_submit = time.monotonic()
        futs = [eng.submit(r) for r in reqs]
        for f in futs:
            f.result(timeout=60)
    for f in futs:
        assert t_submit <= f.dispatched_at <= f.resolved_at
    again = solve(eng, reqs[:1])[0]
    assert again.result(timeout=1).cached and again.dispatched_at is None
    held = engine(max_pending=1)
    held.submit(reqs[0])
    refused = held.submit(reqs[1])
    assert refused.exception(timeout=1) is not None
    assert refused.dispatched_at is None


def test_flusher_thread_records_its_own_tree():
    spans.enable()
    eng = engine(flush_deadline_ms=1.0)
    with eng:
        futs = [eng.submit(r) for r in requests((5, 6))]
        for f in futs:
            f.result(timeout=60)
    records = spans.drain()
    tops = [s for s in records if s.parent is None]
    assert {s.name for s in tops} == {"engine.dispatch"}
    threads = {s.thread for s in records}
    assert len(threads) == 1 and threads != {threading.get_ident()}


@pytest.mark.parametrize("algorithm", ["psa", "pga", "pca"])
def test_answers_are_the_same_with_the_recorder_on_and_off(algorithm):
    reqs = [MapRequest(job_id=r.job_id, C=r.C, M=r.M, seed=r.seed,
                       algorithm=algorithm)
            for r in requests((5, 8, 12, 16, 20))]
    off = [f.result() for f in solve(engine("fused"), reqs)]
    spans.enable()
    on = [f.result() for f in solve(engine("fused"), reqs)]
    assert spans.drain()
    for a, b in zip(off, on, strict=True):
        np.testing.assert_array_equal(a.perm, b.perm)
        assert a.objective == b.objective
