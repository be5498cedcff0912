"""The port's ResourceManager against ``repro.serve.ResourceManager``: the
same trace on the same machine gives the same decisions -- start and
finish clocks, candidate policy, backfilling, nodes, permutation and
objective of every job -- and the same report apart from its two
wall-clock fields, with a warm-starting engine, with a thread fleet
under a kill, after recovery from a cut journal, and from a journal the
reference wrote."""
import dataclasses

import numpy as np
import pytest

from repro.core import instances as ref_instances
from repro.serve import MappingEngine as RefEngine
from repro.serve import ResourceManager as RefRM
from repro.serve import RMJournal as RefJournal
from repro.serve import rm as ref_rm
from repro.serve import trace as ref_trace
from repro_torch.core import annealing
from repro_torch.serve import (Candidate, ClusterState, EngineFleet,
                               FaultPlan, JobSpec, MappingEngine, MapResponse,
                               QueueFull, ResourceManager, RMJournal,
                               default_flows, dilation_score, objective_score,
                               synthetic_trace)
from repro_torch.serve.rm import QUEUED, RUNNING

from _fixtures import SA_SMALL
from _torch_serve import one_torch_thread  # noqa: F401

# tests/test_rm.py's engine, so the reference reuses its programs.
COMMON = dict(buckets=(8,), num_processes=2, max_batch=8)
PORT_SA = annealing.SAConfig(max_neighbors=10, iters_per_exchange=8,
                             num_exchanges=4, solvers=4)
assert dataclasses.asdict(PORT_SA) == dataclasses.asdict(SA_SMALL)
GRID = ref_instances.grid_distance_matrix((2, 2, 4))          # 16 nodes
TRACE_KW = dict(sizes=(3, 5, 8), weights=(2, 2, 1), arrival_rate=0.8,
                mean_run_s=6.0, seed=4)
WALLS = ("map_wall_p50_ms", "map_wall_p99_ms")


def _engine(**kw):
    return MappingEngine(**{**COMMON, "sa_cfg": PORT_SA, "device": "cpu",
                            **kw})


def _ref_engine(**kw):
    return RefEngine(**{**COMMON, "sa_cfg": SA_SMALL, **kw})


def _trace(num_jobs=10):
    return synthetic_trace(num_jobs, **TRACE_KW)


def _ref_trace(num_jobs=10):
    return ref_trace.synthetic_trace(num_jobs, **TRACE_KW)


def _decisions(rm):
    return {h.job_id: (h.state, h.start_s, h.finish_s, h.candidate_policy,
                       h.backfilled,
                       None if h.allocation is None
                       else h.allocation.nodes.tolist(),
                       None if h.response is None
                       else (h.response.perm.tolist(), h.response.objective,
                             h.response.baseline))
            for h in rm.handles}


def _report(rep, drop=WALLS):
    return {k: v for k, v in rep.asdict().items() if k not in drop}


def _replay(rm, specs):
    for s in specs:
        rm.submit_job(s)
    return rm.run()


# An engine whose answers depend on the request alone: no warm starts and
# no exact-digest cache (small jobs of the trace have equal flows, so a
# later job can be served a permutation an earlier job's seed found).
# Recovery rebuilds the manager, not the engine's history, so the
# recovery tests use it.
STATELESS = dict(warm_start=False, cache_size=0)


@pytest.fixture(scope="module")
def reference_replay():
    """The reference manager's replay with its default warm-starting
    engine (key True), with warm starts off (the fleet's contract; key
    False) and with a stateless engine (key "stateless")."""
    out = {}
    for key, kw in ((True, {}), (False, dict(warm_start=False)),
                    ("stateless", STATELESS)):
        rm = RefRM(GRID, _ref_engine(**kw))
        rep = _replay(rm, _ref_trace())
        out[key] = (_decisions(rm), rep)
    return out


# ------------------------------------------------------------ trace replay
def test_replay_with_warm_starts_matches_reference(reference_replay):
    rm = ResourceManager(GRID, _engine())
    rep = _replay(rm, _trace())
    want, ref_rep = reference_replay[True]
    assert _decisions(rm) == want
    assert _report(rep) == _report(ref_rep)
    assert rep.jobs == 10 and rep.backfilled > 0
    assert rm.engine.stats.warm_starts > 0            # the path under test
    assert rep.max_batches_per_wave == 1


def test_replay_on_a_thread_fleet_under_a_kill_matches_reference(
        reference_replay):
    fleet = EngineFleet(workers=2, fault_plan=FaultPlan(kill_worker_at={0: 3}),
                        **{**COMMON, "sa_cfg": PORT_SA, "device": "cpu"})
    try:
        rm = ResourceManager(GRID, fleet)
        rep = _replay(rm, _trace())
    finally:
        fleet.stop()
    want, ref_rep = reference_replay[False]
    assert _decisions(rm) == want
    assert _report(rep, WALLS + ("max_batches_per_wave",)) == \
        _report(ref_rep, WALLS + ("max_batches_per_wave",))
    assert fleet.stats.worker_deaths == 1 and fleet.stats.failed == 0
    assert rep.max_batches_per_wave <= 2


# --------------------------------------------------------------- recovery
def _journaled(tmp_path, name, rm_cls=ResourceManager, engine=None):
    path = tmp_path / name
    rm = rm_cls(GRID, engine if engine is not None
                else _engine(**STATELESS), journal=str(path))
    rep = _replay(rm, _trace() if rm_cls is ResourceManager else _ref_trace())
    rm._journal.close()
    return rm, rep, path


def _cut(path, tmp_path, k):
    lines = path.read_text().splitlines(keepends=True)
    cut = tmp_path / f"cut{k}.jsonl"
    cut.write_text("".join(lines[:k]))
    return cut, len(lines)


@pytest.mark.parametrize("frac", [0.0, 0.15, 0.3, 0.55, 0.8, 1.0])
def test_recover_from_a_cut_journal_then_continue(tmp_path, frac,
                                                  reference_replay):
    """Cut the journal after event k, recover with a fresh engine,
    resubmit the jobs whose arrival was never journaled (never
    acknowledged: all arrive at clock 0, before the first decision), run
    to the end: the decisions equal the uninterrupted replay's (and the
    reference's)."""
    rm, rep, path = _journaled(tmp_path, "full.jsonl")
    n = len(path.read_text().splitlines())
    k = int(round(frac * n))
    cut, _ = _cut(path, tmp_path, k)
    rm2 = ResourceManager.recover(GRID, cut, _engine(**STATELESS))
    known = {h.job_id for h in rm2.handles}
    for spec in _trace():
        if spec.job_id not in known:
            rm2.submit_job(spec)
    rep2 = rm2.run()
    assert _decisions(rm2) == _decisions(rm)
    assert _decisions(rm2) == reference_replay["stateless"][0]
    if k == n:                      # nothing left to decide
        assert rm2.clock == rm.clock
        assert rm2._busy_integral == rm._busy_integral
    assert _report(rep2, WALLS + ("candidate_waves",
                                  "max_batches_per_wave")) == \
        _report(rep, WALLS + ("candidate_waves", "max_batches_per_wave"))


def test_port_recovers_a_reference_journal(tmp_path, reference_replay):
    ref, ref_rep, path = _journaled(tmp_path, "ref.jsonl", RefRM,
                                    _ref_engine(**STATELESS))
    port = ResourceManager.recover(GRID, path, _engine(**STATELESS))
    back = RefRM.recover(GRID, path, _ref_engine(**STATELESS))
    assert _decisions(port) == _decisions(back) == _decisions(ref)
    assert (port.clock, port._busy_integral, port.stats.backfilled) == \
        (back.clock, back._busy_integral, back.stats.backfilled)
    assert port.cluster.num_free == 16
    # and a reference journal cut mid-run continues in the port exactly
    # as the reference ran it
    cut, n = _cut(path, tmp_path, 17)
    assert 17 < n
    port = ResourceManager.recover(GRID, cut, _engine(**STATELESS))
    port.run()
    assert _decisions(port) == reference_replay["stateless"][0]
    # the port's own journal events are the reference's, field for field
    mine, _, mine_path = _journaled(tmp_path, "port.jsonl")
    assert RMJournal.read_events(mine_path) == RefJournal.read_events(path)


def test_journal_torn_tail_recovers_committed_prefix(tmp_path):
    rm, _, path = _journaled(tmp_path, "j.jsonl")
    raw = path.read_bytes()
    torn = tmp_path / "torn.jsonl"
    torn.write_bytes(raw[:-10])           # tear the last (release) record
    events = RMJournal.read_events(torn)
    assert events == RefJournal.read_events(torn)
    assert len(events) == len(RMJournal.read_events(path)) - 1
    rm2 = ResourceManager.recover(GRID, torn, _engine())
    running = [h for h in rm2.handles if h.state == RUNNING]
    assert len(running) == 1
    assert rm2.cluster.num_free == 16 - running[0].spec.size
    done = {e["job_id"] for e in events if e["ev"] == "release"}
    assert {g.job_id for g in rm2.handles if g.done()} == done


# --------------------------------------------------------------- lifecycle
def _small():
    return ref_instances.grid_distance_matrix((2, 2, 2))


@pytest.mark.parametrize("package", ["ref", "port"])
def test_backfill_never_starves_queue_head(package):
    """EASY: a long later job must not delay the blocked head past its
    shadow; a short one may run in the hole -- in both packages."""
    if package == "ref":
        rm, spec = RefRM(_small(), _ref_engine(), candidates=1,
                         policies=("first_fit",)), ref_rm.JobSpec
    else:
        rm, spec = ResourceManager(_small(), _engine(), candidates=1,
                                   policies=("first_fit",)), JobSpec
    a = rm.submit_job(spec(job_id="a", size=4, run_s=10.0))
    head = rm.submit_job(spec(job_id="head", size=8, run_s=5.0,
                              arrival_s=1.0))
    long_j = rm.submit_job(spec(job_id="long", size=4, run_s=100.0,
                                arrival_s=2.0))
    short_j = rm.submit_job(spec(job_id="short", size=4, run_s=3.0,
                                 arrival_s=2.0))
    rm.run()
    assert a.start_s == 0.0
    assert short_j.backfilled and short_j.start_s == pytest.approx(2.0)
    assert not long_j.backfilled
    assert head.start_s == pytest.approx(10.0)
    assert long_j.start_s >= head.finish_s - 1e-9
    assert rm.stats.backfilled == 1


def test_lifecycle_priority_and_fifo_match_reference():
    def drive(rm, spec):
        h = rm.submit_job(spec(job_id="a", size=4, run_s=2.0))
        assert h.state == QUEUED
        with pytest.raises(RuntimeError):
            h.result()
        rm.schedule()
        assert h.state == RUNNING and h.wait_s == 0.0
        rm.submit_job(spec(job_id="lo", size=8, run_s=1.0, arrival_s=1.0))
        rm.submit_job(spec(job_id="hi", size=8, run_s=1.0, arrival_s=1.5,
                           priority=5))
        rm.submit_job(spec(job_id="tail", size=2, run_s=0.5, arrival_s=1.6))
        rep = rm.run().asdict()
        return _decisions(rm), rep

    for backfill in (True, False):
        kw = dict(candidates=2, backfill=backfill)
        got = drive(ResourceManager(_small(), _engine(), **kw), JobSpec)
        want = drive(RefRM(_small(), _ref_engine(), **kw), ref_rm.JobSpec)
        assert got[0] == want[0]
        assert _report_dict(got[1]) == _report_dict(want[1])
        assert got[0]["hi"][1] < got[0]["lo"][1]   # priority jumps the queue


def _report_dict(d):
    return {k: v for k, v in d.items() if k not in WALLS}


def test_candidate_wave_is_one_engine_batch_and_restores_occupancy():
    M = ref_instances.grid_distance_matrix((2, 2, 3))
    cl = ClusterState(M)
    cl.allocate("blocker", 5)
    before = cl.free_nodes().copy()
    eng = _engine()
    rm = ResourceManager(cl, eng, candidates=3)
    h = rm.submit_job(JobSpec(job_id="j", size=5, run_s=1.0))
    rm.run()
    assert h.num_candidates >= 2 and h.wave_batches == 1
    assert rm.stats.max_batches_per_wave == 1 and eng.stats.solver_batches == 1
    np.testing.assert_array_equal(cl.free_nodes(), before)


def test_submit_rejects_bad_specs_and_unschedulable_queue():
    rm = ResourceManager(_small(), _engine())
    with pytest.raises(TypeError):
        rm.submit_job("not a spec")
    with pytest.raises(ValueError):
        rm.submit_job(JobSpec(job_id="x", size=9))
    with pytest.raises(ValueError):
        rm.submit_job(JobSpec(job_id="x", size=2,
                              C=np.zeros((3, 3), np.float32)))
    with pytest.raises(ValueError):
        ResourceManager(_small(), _engine(max_batch=2), candidates=3)
    with pytest.raises(TypeError):
        JobSpec("j", 4)
    cl = ClusterState(_small())
    cl.allocate("hog", 8)
    rm = ResourceManager(cl, _engine(), candidates=1, policies=("first_fit",))
    rm.submit_job(JobSpec(job_id="j", size=4, run_s=1.0))
    with pytest.raises(RuntimeError, match="never be scheduled"):
        rm.run()


def test_max_pending_rejects_before_any_mutation(tmp_path):
    path = tmp_path / "bp.jsonl"
    rm = ResourceManager(_small(), _engine(), max_pending=2,
                         journal=str(path))
    rm.submit_job(JobSpec(job_id="a", size=4, run_s=1.0))
    rm.submit_job(JobSpec(job_id="b", size=4, run_s=1.0))
    with pytest.raises(QueueFull):
        rm.submit_job(JobSpec(job_id="c", size=4, run_s=1.0))
    assert [h.job_id for h in rm.handles] == ["a", "b"]
    assert [e["job_id"] for e in RMJournal.read_events(path)] == ["a", "b"]
    rm.run()
    assert all(h.done() for h in rm.handles)
    rm._journal.close()


def test_manager_without_an_engine_runs_on_the_card():
    """``ResourceManager(system)`` builds ``MappingEngine()``: the card,
    which raises without one instead of falling back to the CPU."""
    import torch
    if torch.cuda.is_available():
        rm = ResourceManager(_small())
        assert rm.engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ResourceManager(_small())


# ------------------------------------------------------------------ scores
@pytest.mark.parametrize("alpha", [0.0, 0.5, 2.0])
def test_dilation_score_matches_reference(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    n = 6
    nodes = np.arange(n, dtype=np.int64)
    M_sub = ref_instances.grid_distance_matrix((1, 2, 3))
    C = default_flows(n, 3)
    C[0, 5] = C[5, 0] = 0.0
    perm = rng.permutation(n).astype(np.int32)
    obj = float((C * M_sub[np.ix_(perm, perm)]).sum())
    kw = dict(job_id="j", perm=perm, objective=obj, baseline=obj + 1.0,
              algorithm="psa", n=n, bucket=8, cached=False, seconds=0.0)
    got = dilation_score(alpha)(MapResponse(**kw),
                                Candidate(policy="compact", nodes=nodes,
                                          M_sub=M_sub), C)
    want = ref_rm.dilation_score(alpha)(
        ref_rm.MapResponse(**kw),
        ref_rm.Candidate(policy="compact", nodes=nodes, M_sub=M_sub), C)
    assert got == want
    D = M_sub[np.ix_(perm, perm)]
    assert got == obj + alpha * float(D[C > 0].max())
    assert objective_score(MapResponse(**kw), None, C) == obj
    silent = np.zeros((n, n), np.float32)
    assert dilation_score(alpha)(MapResponse(**kw), Candidate(
        policy="slab", nodes=nodes, M_sub=M_sub), silent) == obj


def test_replay_with_dilation_score_matches_reference():
    specs, ref_specs = _trace(6), _ref_trace(6)
    rm = ResourceManager(GRID, _engine(warm_start=False),
                         score=dilation_score(3.0))
    ref = RefRM(GRID, _ref_engine(warm_start=False),
                score=ref_rm.dilation_score(3.0))
    assert _report(_replay(rm, specs)) == _report(_replay(ref, ref_specs))
    assert _decisions(rm) == _decisions(ref)
