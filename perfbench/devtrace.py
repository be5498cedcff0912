"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI)
over one dispatch, reduced in memory; nothing is written.

The traced window is a ``record_function`` marker on the benchmark's own
thread, from the window's close to the completion of the pass then in
flight, a full wave like those of the window.
CUPTI records every kernel, copy and fill of the process, whatever thread
launched it; the profiler's CPU side records only threads started after
it, which leaves out the engine's flusher, so an idle gap is named by the
device operation that ends it.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

MARKER = "perfbench.trace_window"
TOP = 10


class Tracer:
    """Start with :meth:`start`, mark the window with :meth:`begin` and
    :meth:`end`, then :meth:`stop` and :meth:`reduce` after the run."""

    def __init__(self, device: str) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._activities = [ProfilerActivity.CPU]
        if device == "cuda":
            self._activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=self._activities)
        self._mark = None

    def warm(self) -> None:
        """Start and stop a profiler once in set-up: the first start
        initialises CUPTI, which stalls every thread's launches for
        seconds, and would otherwise fall inside the window."""
        import torch
        from torch.profiler import profile
        with profile(activities=self._activities):
            if torch.cuda.is_available():
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def start(self) -> None:
        self._prof.start()

    def begin(self) -> None:
        from torch.profiler import record_function
        self._mark = record_function(MARKER)
        self._mark.__enter__()

    def end(self) -> None:
        self._mark.__exit__(None, None, None)

    def stop(self) -> None:
        self._prof.stop()

    def reduce(self) -> Optional["Trace"]:
        events = self._prof.profiler.kineto_results.events()
        return reduce_events(
            [(e.name(), str(e.device_type()), e.start_ns(), e.duration_ns())
             for e in events])


class Trace:
    """Device operations clipped to the traced window (seconds)."""

    def __init__(self, window: Tuple[int, int],
                 ops: List[Tuple[str, int, int]]) -> None:
        self.t0, self.t1 = window
        self.ops = ops                                  # (name, start, end) ns

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        busy, reach = 0, self.t0
        for _, s, e in self.ops:
            s, e = max(s, reach), min(e, self.t1)
            if e > s:
                busy += e - s
                reach = e
        return busy * 1e-9

    def kernel(self, part: str) -> Tuple[int, float]:
        """Launches and device seconds of the kernels whose name holds
        ``part``."""
        hits = [(s, e) for name, s, e in self.ops if part in name]
        return len(hits), sum(e - s for s, e in hits) * 1e-9

    def device_ops(self) -> List[List]:
        by = defaultdict(int)
        for name, s, e in self.ops:
            by[short(name)] += min(e, self.t1) - max(s, self.t0)
        return [[k, v * 1e-9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        """Idle time before each kind of device operation, summed."""
        by = defaultdict(int)
        reach = self.t0
        for name, s, e in self.ops:
            if s > reach:
                by["before " + short(name)] += s - reach
            reach = max(reach, e)
        if self.t1 > reach:
            by["window end"] += self.t1 - reach
        return [[k, v * 1e-9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:120]


def reduce_events(events: List[Tuple[str, str, int, int]]
                  ) -> Optional[Trace]:
    """``(name, device type, start ns, duration ns)`` events -> the
    device operations inside the marker; None without a marker or with
    no device operation in it."""
    marks = [(s, s + d) for name, dev, s, d in events if name == MARKER]
    if not marks:
        return None
    t0, t1 = marks[0]
    ops = sorted(((name, s, s + d) for name, dev, s, d in events
                  if "CUDA" in dev and s + d > t0 and s < t1),
                 key=lambda op: op[1])
    return Trace((t0, t1), ops) if ops else None


def summary(trace: Optional[Trace]) -> Dict[str, float]:
    if trace is None:
        return {}
    return {"busy_s": trace.busy_s, "window_s": trace.window_s}
