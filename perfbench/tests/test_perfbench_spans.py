"""The program's spans on the device trace's clock (``spansplit.py``): the
anchor, the idle split by span on synthetic events, the profiler's own
clock on the CPU, and the queue-wait reader."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from perfbench import devtrace, harness, spansplit

MS = 1_000_000
CUDA = "DeviceType.CUDA"


@pytest.fixture(autouse=True)
def recorder_left_off():
    from repro_torch import spans
    yield
    spans.disable()
    spans.drain()


def span(id, name, start, end, parent=None, thread=7):
    return SimpleNamespace(id=id, parent=parent, name=name, thread=thread,
                           start_ns=start, end_ns=end, attrs={})


def synthetic():
    """A 100 ms window on the profiler's clock, 1000 s ahead of the
    monotonic one: idle 0-10 before the dispatch (no span), 30-35 inside
    ``solver.round``, 50-55 inside ``solver.psa`` between rounds, 70-80
    inside ``engine.copy_back``, 90-95 in ``engine.respond`` and 95-100
    after the dispatch (no span); the operation before the window is left
    out, and the last span is another thread's."""
    off = 1000 * 1000 * MS
    events = [(devtrace.MARKER, "DeviceType.CPU", off, 100 * MS),
              ("early", CUDA, off - 20 * MS, 5 * MS),
              ("k", CUDA, off + 10 * MS, 20 * MS),
              ("k", CUDA, off + 35 * MS, 15 * MS),
              ("k", CUDA, off + 55 * MS, 15 * MS),
              ("copy", CUDA, off + 80 * MS, 10 * MS)]
    records = [
        span(1, "engine.dispatch", 10 * MS, 95 * MS),
        span(2, "engine.group", 10 * MS, 85 * MS, 1),
        span(3, "solver.psa", 12 * MS, 70 * MS, 2),
        span(4, "solver.round", 20 * MS, 48 * MS, 3),
        span(5, "solver.round", 56 * MS, 69 * MS, 3),
        span(6, "engine.copy_back", 70 * MS, 85 * MS, 2),
        span(7, "engine.respond", 85 * MS, 95 * MS, 1),
        span(8, "engine.dispatch", 0, 100 * MS, thread=8),
    ]
    return devtrace.reduce_events(events), records, off


def test_anchor_maps_the_monotonic_clock_and_refuses_a_broken_one():
    # the marker opens 10 ns after the stamp before it, 20 before the one
    # after; it closes 30 after the stamp before it, 10 before the one after
    a, why = spansplit.anchor((100, 130), (200 * MS, 200 * MS + 40),
                              (5010, 200 * MS + 4930))
    assert why == "" and a.disagreement_ns == 0
    assert 4880 <= a.offset_ns <= 4910 and a.width_ns == 30
    # a stamp 5 ms late at the start: the end's narrow bracket gives the
    # offset, and the two still agree
    a, _ = spansplit.anchor((100, 5 * MS), (200 * MS, 200 * MS + 40),
                            (5 * MS - 20 + 4900, 200 * MS + 4930))
    assert a.width_ns == 40 and 4890 <= a.offset_ns <= 4930
    # clocks 2 ms apart at the end: refused
    a, why = spansplit.anchor((100, 130), (200 * MS, 200 * MS + 40),
                              (5010, 202 * MS + 4930))
    assert a is None and "disagrees" in why


def test_idle_intervals_of_the_window():
    trace, _, off = synthetic()
    assert [(s - off, e - off) for s, e in spansplit.idle_intervals(trace)] \
        == [(0, 10 * MS), (30 * MS, 35 * MS), (50 * MS, 55 * MS),
            (70 * MS, 80 * MS), (90 * MS, 100 * MS)]


def test_idle_goes_to_the_innermost_flusher_span():
    trace, records, off = synthetic()
    split, a, why = spansplit.idle_split(
        trace, records[:-1], (0, 0), (100 * MS, 100 * MS),
        (off, off + 100 * MS))
    assert a.offset_ns == off and why == ""
    assert split == {"no span": 10 * MS + 5 * MS, "solver.round": 5 * MS,
                     "solver.psa": 5 * MS, "engine.copy_back": 10 * MS,
                     "engine.respond": 5 * MS}
    got = spansplit.shares(split, 100 * MS)
    assert got == {"engine.idle_share": pytest.approx(30.0),
                   "solver.idle_share": pytest.approx(10.0),
                   "rest": 0.0}
    idle = 100.0 * (1 - trace.busy_s / trace.window_s)
    assert sum(split.values()) / MS == pytest.approx(idle)


def test_the_thread_that_dispatches_most_of_the_window_is_the_flusher():
    trace, records, off = synthetic()
    assert spansplit.flusher_thread(records, (trace.t0, trace.t1), off) == 8
    split, _, _ = spansplit.idle_split(trace, records, (0, 0),
                                       (100 * MS, 100 * MS),
                                       (off, off + 100 * MS))
    assert split == {"engine.dispatch": 40 * MS}
    assert spansplit.flusher_thread(records[:-1], (trace.t0, trace.t1),
                                    off) == 7


def test_a_broken_anchor_or_no_dispatch_puts_nothing_down():
    trace, records, off = synthetic()
    split, a, why = spansplit.idle_split(trace, records, (0, 0),
                                         (100 * MS, 100 * MS),
                                         (off, off + 102 * MS))
    assert split is None and a is None and "disagrees" in why
    split, a, why = spansplit.idle_split(trace, records[2:6], (0, 0),
                                         (100 * MS, 100 * MS),
                                         (off, off + 100 * MS))
    assert split is None and "no engine.dispatch" in why


def test_overlap_of_interval_lists():
    assert spansplit.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spansplit.overlap([(0, 10)], [(10, 20)]) == 0


def test_program_span_brackets_the_profiler_event_on_the_cpu():
    """A program span around a ``record_function`` on the main thread,
    mapped through the marker's anchor, holds the profiler's event within
    the tolerance."""
    import torch
    from torch.profiler import record_function
    from repro_torch import spans
    spans.enable()
    tracer = spansplit.StampedTracer("cpu")
    tracer.start()
    tracer.begin()
    time.sleep(0.002)
    with spans.span("outer") as outer:
        with record_function("inner"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
            time.sleep(0.003)
    time.sleep(0.002)
    tracer.end()
    tracer.stop()
    tracer.reduce()
    a, why = spansplit.anchor(tracer.begin_ns, tracer.end_ns,
                              tracer.marker())
    assert a is not None, why
    (s, e), = [(s, s + d) for name, _, s, d in tracer.events
               if name == "inner"]
    tol = spansplit.ANCHOR_TOL_NS
    assert outer.start_ns + a.offset_ns <= s + tol
    assert outer.end_ns + a.offset_ns >= e - tol
    assert abs((outer.end_ns - outer.start_ns) - (e - s)) < tol


def test_traced_run_on_the_cpu(tiny_cell):
    """The tool's run of the tiny cell: right answers, a tree of spans a
    dispatch, the queue wait; no device trace on the CPU, so no split."""
    run, tracer, stream, records = spansplit.traced_run(
        tiny_cell, 3000000019, 0.5, "cpu", time.monotonic())
    out = spansplit.report(run, tracer, stream, records)
    assert out["correct"] and out["split"] is None
    sa = tiny_cell.config["sa"]
    assert out["spans_per_dispatch"] == 9 + sa["num_exchanges"]
    assert out["engine.queue_wait_p50_ms"] > 0
    assert out["engine.respond_s_median"] > 0
    assert stream.calls and tracer.marker() is not None
    assert set(out["next_pass"]["span_ms"]) >= {"engine.dispatch",
                                                "solver.round"}


def test_stretch_splits_spans_by_overlap_with_the_calls():
    records = [span(1, "a", 0, 10 * MS), span(2, "a", 20 * MS, 24 * MS),
               span(3, "a", 30 * MS, 36 * MS), span(4, "b", 50 * MS, 51 * MS)]
    got = spansplit.stretch(records, [(5 * MS, 22 * MS)])
    assert got == {"a": [7.0, 2, 6.0, 1], "b": [None, 0, 1.0, 1]}


def test_queue_wait_reads_the_dispatch_stamp(tiny_cell):
    run = harness.run_cell(tiny_cell, 3000000021, 0.5, False, "cpu")
    wait = harness.reader("engine.queue_wait_p50_ms")(run)
    latency = harness.reader("engine.latency_p50_ms")(run)
    assert 0 < wait < latency
    for a in run.window:
        assert a.t_submit <= a.future.dispatched_at <= a.future.resolved_at
        a.future = SimpleNamespace()         # a program without the stamp
    assert harness.reader("engine.queue_wait_p50_ms")(run) is None
