"""The port's transport seam: length-prefixed frames and process-isolated
workers, pinned as ``tests/test_transport.py`` pins the reference's.

The frame layer is unit-tested against every way a pipe can lie, and its
bytes against the reference's.  The subprocess fleet then runs on the
CPU (``device="cpu"`` pickled to each child) under *real* faults -- the
child SIGKILLs itself, corrupts its own stdout, or is SIGSTOP'd into a
zombie, all by deterministic count -- and every recovered result is
checked bit for bit against a single port engine and against the
reference's engine."""
import io
import threading
from contextlib import contextmanager

import numpy as np
import pytest

from repro.serve import transport as ref_transport
from repro_torch.serve import EngineFleet, FaultPlan
from repro_torch.serve.transport import (_HEADER, _MAX_FRAME, FrameError,
                                         SubprocessWorker, read_frame,
                                         write_frame)

from _fixtures import instance as _instance
from _torch_serve import (ENGINE_KW, assert_matches_both, make_reqs,
                          one_torch_thread)  # noqa: F401


@contextmanager
def make_fleet(**kw):
    fleet = EngineFleet(transport="subprocess", **{**ENGINE_KW, **kw})
    try:
        yield fleet
    finally:
        if not fleet._shutdown:
            fleet.stop()


# ---------------------------------------------------------------- frames
def test_frame_round_trip_is_lossless():
    buf = io.BytesIO()
    C, M = _instance(6, seed=0)
    obj = ("result", 17, {"perm": np.arange(6), "C": C, "M": M,
                          "note": "payload"})
    write_frame(buf, obj)
    write_frame(buf, ("beat",))
    buf.seek(0)
    back = read_frame(buf)
    assert back[0] == "result" and back[1] == 17
    np.testing.assert_array_equal(back[2]["perm"], np.arange(6))
    assert back[2]["C"].tobytes() == C.tobytes()
    assert back[2]["M"].tobytes() == M.tobytes()
    assert read_frame(buf) == ("beat",)
    with pytest.raises(EOFError):
        read_frame(buf)


def test_frames_are_the_reference_frames():
    """The same bytes on the wire, readable by either package."""
    obj = ("wave", [(3, {"C": np.eye(3, dtype=np.float32)})])
    ours, theirs = io.BytesIO(), io.BytesIO()
    write_frame(ours, obj)
    ref_transport.write_frame(theirs, obj)
    assert ours.getvalue() == theirs.getvalue()
    assert (_HEADER.format, _MAX_FRAME) == (ref_transport._HEADER.format,
                                            ref_transport._MAX_FRAME)
    ours.seek(0)
    back = ref_transport.read_frame(ours)
    assert back[1][0][1]["C"].tobytes() == obj[1][0][1]["C"].tobytes()


def test_frame_writer_lock_serializes_concurrent_writers():
    buf = io.BytesIO()
    lock = threading.Lock()
    threads = [threading.Thread(target=write_frame,
                                args=(buf, ("beat", i), lock))
               for i in range(8)]
    [t.start() for t in threads]
    [t.join(timeout=10.0) for t in threads]
    assert not any(t.is_alive() for t in threads)
    buf.seek(0)
    assert sorted(read_frame(buf)[1] for _ in range(8)) == list(range(8))
    with pytest.raises(EOFError):
        read_frame(buf)


@pytest.mark.parametrize("raw,match", [
    (b"\x00\x00", "header"),                       # died mid-write
    (_HEADER.pack(100) + b"short", "payload"),
    (b"\xde\xad\xbe\xef" * 16, "implausible"),     # what corrupt_at writes
    (_HEADER.pack(24) + b"not a pickle, definitely", "undecodable"),
], ids=["truncated-header", "truncated-payload", "implausible-length",
        "undecodable"])
def test_corrupt_streams_are_frame_errors(raw, match):
    with pytest.raises(FrameError, match=match):
        read_frame(io.BytesIO(raw))
    with pytest.raises(ref_transport.FrameError, match=match):
        ref_transport.read_frame(io.BytesIO(raw))


# ------------------------------------------------------- construction rules
def test_subprocess_fleet_rejects_unpicklable_configs():
    with pytest.raises(ValueError, match="process boundary"):
        EngineFleet(workers=1, transport="subprocess",
                    engine_factory=lambda wid: None, **ENGINE_KW)
    with pytest.raises(ValueError, match="transport"):
        EngineFleet(workers=1, transport="carrier-pigeon", **ENGINE_KW)


# ----------------------------------------------------------- e2e: parity
def test_subprocess_fleet_matches_plain_and_reference_engines():
    reqs = make_reqs(5)
    with make_fleet(workers=1) as fleet:
        futs = [fleet.submit(r) for r in reqs]
        out = fleet.flush()
        assert all(f.done() for f in futs)
        assert fleet.stats.solver_batches == 2       # 5 requests, 4 a wave
    assert_matches_both(out, reqs)
    assert fleet.stats.worker_deaths == 0
    assert isinstance(fleet.workers[0], SubprocessWorker)
    assert fleet.workers[0]._proc.poll() is not None     # reaped


# --------------------------------------------------------- e2e: real faults
def test_sigkill_mid_wave_respawns_and_stays_bitwise():
    reqs = make_reqs(4, seed0=40)
    with make_fleet(workers=1,
                    fault_plan=FaultPlan(sigkill_worker_at={0: 1})) as fleet:
        futs = [fleet.submit(r) for r in reqs]
        out = fleet.flush()
        assert all(f.done() for f in futs)
    assert_matches_both(out, reqs)
    assert fleet.stats.worker_deaths == 1
    assert fleet.stats.respawns >= 1
    assert fleet.stats.requeued == 3
    assert fleet.stats.failed == 0
    assert fleet.stats.first_recovery_s is not None
    assert fleet.stats.first_recovery_s > 0.0


def test_corrupt_stdout_declares_worker_dead_and_recovers():
    reqs = make_reqs(3, seed0=60)
    with make_fleet(workers=1,
                    fault_plan=FaultPlan(corrupt_stdout_at={0: 1})) as fleet:
        [fleet.submit(r) for r in reqs]
        out = fleet.flush()
    assert_matches_both(out, reqs)
    assert fleet.stats.worker_deaths == 1
    assert fleet.stats.requeued == 2
    assert fleet.stats.failed == 0


@pytest.mark.slow
def test_sigstop_zombie_caught_by_staleness_detector():
    reqs = make_reqs(8, seed0=80)
    with make_fleet(workers=2, heartbeat_timeout_s=2.0,
                    fault_plan=FaultPlan(sigstop_worker_at={0: 1})) as fleet:
        futs = [fleet.submit(r) for r in reqs]
        out = fleet.flush()
        assert all(f.done() for f in futs)
        assert fleet.stats.worker_deaths == 1
        assert fleet.stats.requeued >= 1
        assert fleet.stats.failed == 0
    # stop() must reap the stopped process (SIGCONT + SIGKILL), not hang
    assert all(not w.alive for w in fleet.workers)
    assert all(w._proc is None or w._proc.poll() is not None
               for w in fleet.workers)
    assert_matches_both(out, reqs)


@pytest.mark.slow
def test_subprocess_fleet_shards_across_workers_bitwise():
    reqs = make_reqs(9, seed0=20)
    with make_fleet(workers=3) as fleet:
        [fleet.submit(r) for r in reqs]
        out = fleet.flush()
    assert_matches_both(out, reqs)
    assert fleet.stats.dispatched_waves == 3
    assert fleet.stats.worker_deaths == 0


@pytest.mark.slow
def test_per_worker_cache_dir_created_and_left_empty(tmp_path):
    """The port has no compilation cache: the child creates its
    directory (the reference's contract) and puts nothing there."""
    reqs = make_reqs(2, seed0=200)
    with make_fleet(workers=1, worker_cache_dir=str(tmp_path)) as fleet:
        [fleet.submit(r) for r in reqs]
        out = fleet.flush()
    assert_matches_both(out, reqs)
    w0 = tmp_path / "w0"
    assert w0.is_dir() and not any(w0.iterdir())


def test_worker_main_in_process_serves_a_wave_and_stops():
    """The child's loop driven through in-memory pipes: ready, a beat-free
    wave of two requests, stats, two results, then stop."""
    reqs = make_reqs(2, seed0=220)
    stdin = io.BytesIO()
    write_frame(stdin, dict(engine_kwargs=dict(ENGINE_KW, warm_start=False),
                            beats=False))
    write_frame(stdin, ("wave", [(7, reqs[0]), (8, reqs[1])]))
    write_frame(stdin, ("stop",))
    stdin.seek(0)
    out = io.BytesIO()
    from repro_torch.serve.transport import worker_main
    assert worker_main(stdin, out) == 0
    out.seek(0)
    frames = []
    while True:
        try:
            frames.append(read_frame(out))
        except EOFError:
            break
    assert [f[0] for f in frames] == ["ready", "stats", "result", "result"]
    assert frames[1][1:] == (1, 2)
    got = {f"j{f[1] - 7}": f[2] for f in frames[2:]}
    assert_matches_both(got, reqs)
