"""Runs one cell of ``BENCHMARK.json`` against the port's
``MappingEngine`` and builds its result line.

A cell's pieces are found by name, so that a later cell adds files and
edits none:

* its configuration: the ``file`` of its ``configs`` entry (engine and
  solver settings, instance family, precision, guarantees);
* its traffic mix: ``traffic/<traffic>.json``, read by ``traffic.py``;
* the mix's loop kind: ``loops/<loop>.py``, whose ``Loop`` drives the
  window and reports it as a ``Window``;
* the configuration's instance family: ``families/<family>.py``;
* its limits: ``cells/<workload>.json``, each with the readings it was
  set from;
* each metric: ``metrics/<name>.py``, a ``read(run)`` that returns a
  number, or None where it finds nothing to read.
"""
from __future__ import annotations

import json
import sys
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import byname, devtrace, reference, traffic

HERE = Path(__file__).resolve().parent
LATE_S = 60.0           # an answer may come this long after the close
FIRST_PASS_S = 900.0    # the first pass builds the kernels in a new checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])

    def mine(metric: dict) -> bool:
        return workload in metric.get("workloads", [workload])

    return Cell(
        name=workload, chips=int(w["chips"]),
        config=json.loads((root / entry["file"]).read_text()),
        mix=json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                       .read_text()),
        limits=json.loads((HERE / "cells" / f"{workload}.json")
                          .read_text())["limits"],
        end_to_end=[m for m in spec["end_to_end"] if mine(m)],
        per_layer=[m for m in spec["per_layer"] if mine(m)])


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return byname.load("metrics", name).read


@dataclass
class Answer:
    req: traffic.Request
    pass_no: int
    t_submit: float
    future: object = None
    t_done: Optional[float] = None
    perm: Optional[np.ndarray] = None
    objective: Optional[float] = None
    seconds: float = 0.0           # the response's group wall / batch size
    batch_size: int = 0
    bucket: Optional[int] = None
    error: Optional[str] = None
    f: Optional[int] = None        # the reference's F(perm), after the run
    ok: bool = False               # right on its own, by the reference


@dataclass
class Window:
    """What a loop reports of its window."""
    t_first: float                 # the first request sent
    t_open: float
    t_close: float
    answers: List[Answer]          # answered in the window
    before: Dict[str, int]         # counters at the opening
    after: Dict[str, int]          # and at the close
    traced: List[Answer]           # answered in the traced dispatch
    log: str                       # for standard error


@dataclass
class Run:
    cell: Cell
    setup_s: float
    t_open: float
    t_close: float
    window: List[Answer]           # answered in the window
    answers: List[Answer]          # every request sent
    stats: Dict[str, int]          # every EngineStats field over the window
    launches: Dict[str, int]       # kernel launches over the window
    trace: Optional[devtrace.Trace] = None
    traced: List[Answer] = field(default_factory=list)
    memory_peak_bytes: int = 0
    readings: Dict[str, float] = field(default_factory=dict)
    limits: Dict[str, float] = field(default_factory=dict)
    failed: int = 0


def make_engine(config: dict, device: str):
    """The configuration's engine: its ``engine`` settings, with the
    solvers' own from ``sa`` and ``ga`` (the engine's defaults for one
    that is not there)."""
    from repro_torch.core.annealing import SAConfig
    from repro_torch.core.genetic import GAConfig
    from repro_torch.serve.mapper import MappingEngine
    return MappingEngine(
        sa_cfg=SAConfig(**config["sa"]) if "sa" in config else None,
        ga_cfg=GAConfig(**config["ga"]) if "ga" in config else None,
        device=device, **config["engine"])


def counters(engine) -> Dict[str, int]:
    """Every ``EngineStats`` field and every kernel's launches, now."""
    from repro_torch.kernels import ops
    out = {"stats." + k: v for k, v in asdict(engine.stats).items()}
    out.update(ops.launch_counts())
    return out


def card_state(device: str) -> str:
    """The card's SM clock and temperature now, for the log."""
    if device != "cuda":
        return "no card"
    import torch
    try:
        return (f"SM clock {torch.cuda.clock_rate()} MHz, "
                f"{torch.cuda.temperature()} C")
    except ModuleNotFoundError:              # no pynvml
        return "clock not readable"


def _delta(a: Dict[str, int], b: Dict[str, int], prefix: bool):
    return {k.split(".", 1)[1] if prefix else k: b[k] - a[k]
            for k in b if k.startswith("stats.") == prefix}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> Run:
    """Set up, drive the window, stop the engine and check every answer."""
    import torch
    t_entry = time.monotonic()
    t_start = t_entry if t_start is None else t_start
    engine = make_engine(cell.config, device)
    stream = traffic.Stream(cell.config, cell.mix, seed)
    loop = byname.load("loops", cell.mix["loop"]).Loop(
        engine, stream, cell.config, cell.mix)
    tracer = devtrace.Tracer(device) if trace else None
    t_made = time.monotonic()
    if tracer is not None:
        tracer.warm()
    try:
        win = loop.run(seconds, tracer, device)
    finally:
        engine.stop()
    answers = loop.drain()
    if device == "cuda":
        torch.cuda.synchronize()
    print(f"setup {win.t_open - t_start:.3f} s: imports "
          f"{t_entry - t_start:.3f} s, engine and first pass's requests "
          f"{t_made - t_entry:.3f} s, profiler {win.t_first - t_made:.3f} "
          f"s, {win.log}", file=sys.stderr)
    run = Run(cell=cell, setup_s=win.t_open - t_start, t_open=win.t_open,
              t_close=win.t_close, window=win.answers, answers=answers,
              stats=_delta(win.before, win.after, True),
              launches=_delta(win.before, win.after, False),
              traced=win.traced,
              memory_peak_bytes=(torch.cuda.max_memory_allocated()
                                 if device == "cuda" else 0))
    if tracer is not None:
        run.trace = tracer.reduce()
    check(run)
    return run


def check(run: Run) -> None:
    """The reference over every answer that came; fills ``run.readings``,
    ``run.limits``, ``run.failed`` and each answer's ``f`` and ``ok``."""
    came = [a for a in run.answers if a.error is None]
    read, each = reference.check(
        [dict(C=a.req.C, M=a.req.M, optimum=a.req.optimum, perm=a.perm,
              objective=a.objective) for a in came],
        missing=len(run.answers) - len(came))
    for a, (f, ok) in zip(came, each):
        a.f, a.ok = f, ok
    run.readings, run.limits = read, reference.limits(run.cell.limits)
    run.failed = sum(not a.ok for a in run.answers)


def metrics(run: Run, trace: bool) -> Dict[str, dict]:
    """The cell's end-to-end metrics (``trace`` False) or its per-layer
    metrics (True), each left out where its reader finds nothing."""
    out = {}
    for m in (run.cell.per_layer if trace else run.cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(run: Run, device: str, trace: bool) -> dict:
    if device == "cuda":
        import torch
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    else:
        info = {"platform": "cpu", "kind": "cpu"}
    info.update(count=run.cell.chips,
                memory_peak_bytes=int(run.memory_peak_bytes))
    if trace:
        info.update(devtrace.summary(run.trace))
    return info


def result(run: Run, device: str, trace: bool) -> dict:
    """The result line: every key the contract reads, the compared
    numbers last."""
    out = {"correct": reference.judge(run.readings, run.limits)
           and run.failed == 0,
           "attempted": len(run.answers), "failed": run.failed,
           "metrics": metrics(run, trace),
           "device": device_info(run, device, trace)}
    if trace and run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["compared"] = {k: {"value": run.readings[k], "limit": run.limits[k]}
                       for k in run.limits}
    return out


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))
