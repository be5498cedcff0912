"""The idle time of a traced dispatch put down to what the engine's
flusher thread was doing, from the program's spans (``repro_torch.spans``)
mapped onto the device trace's clock.

    python3 perfbench/spansplit.py --workload <cell> --seed <n> --seconds <s>

runs a cell as ``run.py --trace 1`` does, with two additions: the
program's span recorder is on from before the engine is made, and the
trace marker is stamped on the host's monotonic clock just outside its
start and end.  The spans run on ``time.monotonic_ns()``; the profiler's
events on its own clock, which follows the epoch clock.  Each end of the
marker is stamped just before and just after it, so each brackets the
offset between the two clocks; the two brackets have to lie within
``ANCHOR_TOL_NS`` of each other, or nothing is put down, and the
narrower one gives the offset.  (A stamp can lag its end of the marker
by the interpreter's switch interval, 5 ms, when the flusher thread
takes the interpreter lock between them; a bracket holds that lag.)  Each idle interval of the traced window goes to
the innermost span of the flusher thread that covers it (``no span``
between dispatches).  The split goes to standard error, with the cell's
end-to-end and per-layer readings and the times the load generator
spent making passes, and one JSON object to standard output.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                    str(Path(__file__).resolve().parents[1] / "src")]

from perfbench import (byname, devtrace, harness, reference,  # noqa: E402
                       traffic)

ANCHOR_TOL_NS = 1_000_000
NO_SPAN = "no span"


class StampedTracer(devtrace.Tracer):
    """The benchmark's tracer, each end of its marker stamped on the
    monotonic clock just before and just after (``begin_ns``, ``end_ns``)
    and its events kept after :meth:`reduce`."""

    def begin(self) -> None:
        t = time.monotonic_ns()
        super().begin()
        self.begin_ns = (t, time.monotonic_ns())

    def end(self) -> None:
        t = time.monotonic_ns()
        super().end()
        self.end_ns = (t, time.monotonic_ns())

    def reduce(self) -> Optional[devtrace.Trace]:
        self.events = [(e.name(), str(e.device_type()), e.start_ns(),
                        e.duration_ns())
                       for e in self._prof.profiler.kineto_results.events()]
        return devtrace.reduce_events(self.events)

    def marker(self) -> Optional[Tuple[int, int]]:
        """The marker's start and end on the profiler's clock."""
        return next(((s, s + d) for name, _, s, d in self.events
                     if name == devtrace.MARKER), None)


class StampedStream:
    """A traffic stream whose ``next_pass`` calls are stamped on the
    monotonic clock, in ``calls``."""

    def __init__(self, stream: traffic.Stream) -> None:
        self.stream = stream
        self.calls: List[Tuple[int, int]] = []

    def next_pass(self):
        t0 = time.monotonic_ns()
        out = self.stream.next_pass()
        self.calls.append((t0, time.monotonic_ns()))
        return out


class Anchor(NamedTuple):
    offset_ns: int          # profiler clock less monotonic clock
    disagreement_ns: int    # how far the end's bracket lies from the start's
    width_ns: int           # the width of the bracket that gave the offset


def anchor(begin: Tuple[int, int], end: Tuple[int, int],
           marker: Tuple[int, int]) -> Tuple[Optional[Anchor], str]:
    """The offset that maps the monotonic clock onto the profiler's, from
    the monotonic stamps just before and after each end of the marker
    (``begin``, ``end``) and the marker's start and end on the
    profiler's clock, or None and why."""
    brackets = [(k - after, k - before)
                for k, (before, after) in zip(marker, (begin, end))]
    (lo0, hi0), (lo1, hi1) = brackets
    apart = lo1 - hi0 if lo1 > hi0 else min(hi1 - lo0, 0)
    lo, hi = min(brackets, key=lambda b: b[1] - b[0])
    a = Anchor((lo + hi) // 2, apart, hi - lo)
    if abs(apart) > ANCHOR_TOL_NS:
        return None, (f"the marker's end disagrees with its start by "
                      f"{apart / 1e6:.3f} ms, over "
                      f"{ANCHOR_TOL_NS / 1e6:.3f} ms")
    return a, ""


def idle_intervals(trace: devtrace.Trace) -> List[Tuple[int, int]]:
    """The traced window's intervals with no device operation."""
    out, reach = [], trace.t0
    for _, s, e in trace.ops:
        if s > reach:
            out.append((reach, min(s, trace.t1)))
        reach = max(reach, e)
        if reach >= trace.t1:
            break
    if trace.t1 > reach:
        out.append((reach, trace.t1))
    return [(s, e) for s, e in out if e > s]


def _depths(records) -> Dict[int, int]:
    by_id = {r.id: r for r in records}
    depth: Dict[int, int] = {}

    def of(r) -> int:
        if r.id not in depth:
            p = by_id.get(r.parent)
            depth[r.id] = 0 if p is None else of(p) + 1
        return depth[r.id]

    for r in records:
        of(r)
    return depth


def flusher_thread(records, window: Tuple[int, int], offset_ns: int
                   ) -> Optional[int]:
    """The thread whose ``engine.dispatch`` spans cover most of the
    window."""
    cover: Dict[int, int] = defaultdict(int)
    for r in records:
        if r.name == "engine.dispatch":
            cover[r.thread] += max(0, min(r.end_ns + offset_ns, window[1])
                                   - max(r.start_ns + offset_ns, window[0]))
    return max(cover, key=cover.get) if cover else None


def intervals_by_span(intervals: Sequence[Tuple[int, int]], records,
                      offset_ns: int, thread: int) -> Dict[str, int]:
    """Nanoseconds of ``intervals`` (profiler clock) under each name of
    the innermost span of ``thread`` that covers them, ``NO_SPAN`` where
    none does."""
    if not intervals:
        return {}
    depth = _depths(records)
    lo, hi = intervals[0][0], intervals[-1][1]
    mine = sorted((r.start_ns + offset_ns, r.end_ns + offset_ns,
                   depth[r.id], r.name)
                  for r in records if r.thread == thread
                  and r.start_ns + offset_ns < hi and r.end_ns + offset_ns > lo)
    starts = [s for s, _, _, _ in mine]
    cuts = sorted({t for s, e, _, _ in mine for t in (s, e)})
    out: Dict[str, int] = defaultdict(int)
    for s, e in intervals:
        points = [s] + cuts[bisect.bisect_right(cuts, s):
                            bisect.bisect_left(cuts, e)] + [e]
        for a, b in zip(points, points[1:]):
            covering = [(d, name) for s0, e0, d, name in
                        mine[:bisect.bisect_right(starts, a)]
                        if e0 >= b]
            out[max(covering)[1] if covering else NO_SPAN] += b - a
    return dict(out)


def overlap(intervals: Sequence[Tuple[int, int]],
            others: Sequence[Tuple[int, int]]) -> int:
    """Nanoseconds that two lists of disjoint intervals share."""
    return sum(max(0, min(e, e2) - max(s, s2))
               for s, e in intervals for s2, e2 in others)


def shares(split: Dict[str, int], window_ns: int) -> Dict[str, float]:
    """The idle split as shares of the window, in %: the engine's (an
    ``engine.*`` span innermost, or none), the solver's (a ``solver.*``
    span innermost) and the rest."""
    def pct(names) -> float:
        return 100.0 * sum(split[n] for n in names) / window_ns
    engine = [n for n in split if n.startswith("engine.") or n == NO_SPAN]
    solver = [n for n in split if n.startswith("solver.")]
    return {"engine.idle_share": pct(engine),
            "solver.idle_share": pct(solver),
            "rest": pct(set(split) - set(engine) - set(solver))}


def idle_split(trace: devtrace.Trace, records, begin: Tuple[int, int],
               end: Tuple[int, int], marker: Tuple[int, int]
               ) -> Tuple[Optional[Dict[str, int]], Optional[Anchor], str]:
    """The traced window's idle nanoseconds by the innermost span of the
    flusher thread, with the anchor; None and why where the anchor breaks
    or no ``engine.dispatch`` span falls in the window."""
    a, why = anchor(begin, end, marker)
    if a is None:
        return None, None, why
    thread = flusher_thread(records, (trace.t0, trace.t1), a.offset_ns)
    if thread is None:
        return None, a, "no engine.dispatch span in the traced window"
    return (intervals_by_span(idle_intervals(trace), records, a.offset_ns,
                              thread), a, "")


def stretch(records, calls: Sequence[Tuple[int, int]]) -> Dict[str, list]:
    """For each span name: the median duration (ms) and count of the
    spans that overlapped one of ``calls``, then of those that did not:
    how far the load generator's work stretched the flusher's."""
    by: Dict[str, Tuple[list, list]] = defaultdict(lambda: ([], []))
    for r in records:
        hit = overlap([(r.start_ns, r.end_ns)], calls) > 0
        by[r.name][0 if hit else 1].append((r.end_ns - r.start_ns) * 1e-6)
    return {name: [statistics.median(d) if d else None, len(d),
                   statistics.median(o) if o else None, len(o)]
            for name, (d, o) in sorted(by.items())}


def dispatched_in(records, t_open: float, t_close: float) -> list:
    """The spans of every ``engine.dispatch`` that ended between two
    monotonic stamps (seconds), the dispatch's own included."""
    by_id = {r.id: r for r in records}

    def top(r):
        while r.parent in by_id:
            r = by_id[r.parent]
        return r

    def ended_inside(t) -> bool:
        return (t.name == "engine.dispatch"
                and t_open < t.end_ns * 1e-9 <= t_close)

    return [r for r in records if ended_inside(top(r))]


def traced_run(cell: harness.Cell, seed: int, seconds: float, device: str,
               t_start: float):
    """``harness.run_cell`` with the recorder on and the stamps: the run,
    its tracer, its stamped stream and every span recorded."""
    import torch
    from repro_torch import spans
    spans.enable()
    engine = harness.make_engine(cell.config, device)
    stream = StampedStream(traffic.Stream(cell.config, cell.mix, seed))
    loop = byname.load("loops", cell.mix["loop"]).Loop(
        engine, stream, cell.config, cell.mix)
    tracer = StampedTracer(device)
    tracer.warm()
    try:
        win = loop.run(seconds, tracer, device)
    finally:
        engine.stop()
    answers = loop.drain()
    if device == "cuda":
        torch.cuda.synchronize()
    spans.disable()
    print(win.log, file=sys.stderr)
    out = harness.Run(
        cell=cell, setup_s=win.t_open - t_start, t_open=win.t_open,
        t_close=win.t_close, window=win.answers, answers=answers,
        stats=harness._delta(win.before, win.after, True),
        launches=harness._delta(win.before, win.after, False),
        traced=win.traced)
    out.trace = tracer.reduce()
    harness.check(out)
    return out, tracer, stream, spans.drain()


def report(run: harness.Run, tracer: StampedTracer, stream: StampedStream,
           records) -> dict:
    """The split and the readings beside it."""
    out = {"correct": reference.judge(run.readings, run.limits)
           and run.failed == 0}
    for name in ("mappings_per_s", "engine.latency_p50_ms",
                 "engine.queue_wait_p50_ms", "solver.wave_s",
                 "device.idle_share"):
        out[name] = harness.reader(name)(run)
    window = dispatched_in(records, run.t_open, run.t_close)
    respond = [(r.end_ns - r.start_ns) * 1e-9 for r in window
               if r.name == "engine.respond"]
    out["engine.respond_s_median"] = (statistics.median(respond)
                                      if respond else None)
    dispatches = sum(r.name == "engine.dispatch" for r in window)
    out["spans_per_dispatch"] = len(window) / max(dispatches, 1)
    calls = [(s, e) for s, e in stream.calls
             if s * 1e-9 >= run.t_open and e * 1e-9 <= run.t_close]
    out["next_pass"] = {"calls": len(calls),
                        "s": sum(e - s for s, e in calls) * 1e-9,
                        "span_ms": stretch(window, calls)}
    trace = run.trace
    if trace is None:
        out["split"] = None
        print("spansplit: no device operation in the trace",
              file=sys.stderr)
        return out
    split, a, why = idle_split(trace, records, tracer.begin_ns,
                               tracer.end_ns, tracer.marker())
    if split is None:
        out["split"] = None
        print(f"spansplit: no split: {why}", file=sys.stderr)
        return out
    idle = idle_intervals(trace)
    window_ns = trace.t1 - trace.t0
    out.update(shares(split, window_ns))
    out["anchor_disagreement_ms"] = a.disagreement_ns * 1e-6
    out["idle_share_sum"] = 100.0 * sum(split.values()) / window_ns
    out["split"] = {k: v * 1e-9 for k, v in
                    sorted(split.items(), key=lambda kv: -kv[1])}
    out["idle_during_next_pass_s"] = overlap(
        idle, [(s + a.offset_ns, e + a.offset_ns)
               for s, e in stream.calls]) * 1e-9
    out["anchor_width_ms"] = a.width_ns * 1e-6
    print(f"spansplit: traced window {window_ns * 1e-9:.6f} s, idle "
          f"{out['idle_share_sum']:.4f}% (device.idle_share "
          f"{out['device.idle_share']}), anchors agree within "
          f"{abs(a.disagreement_ns) * 1e-6:.4f} ms, offset bracket "
          f"{a.width_ns * 1e-6:.4f} ms", file=sys.stderr)
    for name, s in out["split"].items():
        print(f"spansplit: idle under {name}: {s:.6f} s "
              f"({100.0 * s * 1e9 / window_ns:.4f}%)", file=sys.stderr)
    return out


def main(argv=None, device: str = "cuda") -> int:
    t_start = time.monotonic()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    cell = harness.load_cell(root, args.workload)
    out = report(*traced_run(cell, args.seed, args.seconds, device, t_start))
    print(json.dumps(out), flush=True)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
