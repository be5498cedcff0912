"""Resource-manager control plane: queue -> candidates -> wave -> commit.

The paper frames job mapping as one function *inside* a resource manager:
program graphs "are not known beforehand, hence the mapping must be done
in reasonable time while scheduling resources".  :class:`ResourceManager`
is that surrounding manager -- the blessed front door of the whole
service layer (``repro_torch.serve``, the port of ``repro.serve``):

  1. :meth:`ResourceManager.submit_job` takes a :class:`JobSpec` and
     returns a :class:`JobHandle`; jobs wait in a priority queue (FCFS
     within a priority level).
  2. Scheduling uses **EASY backfilling**: the queue head is started as
     soon as it fits; while it cannot fit, its *shadow time* (the
     earliest virtual time enough nodes come free, from the running
     jobs' runtimes) is computed and later-queued jobs may start out of
     order only if they cannot delay the head -- they either finish
     before the shadow time or fit into the nodes the head will not
     need.  The head is therefore never starved: it starts no later
     than the shadow time computed when it reached the front.
  3. Starting a job closes the allocate-*then*-map feedback loop: the
     cluster proposes K candidate free-node subsets
     (:meth:`~repro_torch.serve.cluster.ClusterState.candidate_subsets`:
     compact growth, topology-aware slab, even scatter), their union is
     **reserved**, all K induced-subgraph instances are submitted to the
     :class:`~repro_torch.serve.mapper.MappingEngine` and flushed as **one
     batched wave** (same order + algorithm + tier => one group => one
     solver dispatch), and the candidate whose mapped objective (or a
     custom ``score``, e.g. :func:`dilation_score`) is smallest is
     **promoted** into the job's allocation -- the scheduler lets the
     mapper pick the allocation, not just the permutation within it.
  4. Completions release the allocation, restoring exact occupancy, and
     trigger the next scheduling pass.

Time is an explicit virtual clock, so a recorded or synthetic workload
trace (``repro_torch.serve.trace``) replays deterministically and much faster
than wall time; only the mapping solves cost real compute, on the card
(the engine's device).  The control plane is single-threaded by design --
drive it from one thread via :meth:`run` / :meth:`schedule`; the engine
may still batch and cache internally however it likes.

The decisions (start and finish clocks, nodes, candidate policy,
backfilling, permutations and objectives) are the reference's for the
same trace, and the journal is the reference's format, so either package
recovers the other's journal.

Replay usage::

    from repro_torch.serve import JobSpec, ResourceManager

    rm = ResourceManager(M_system, candidates=3)   # MappingEngine() on cuda
    for spec in trace:                     # e.g. trace.parse_swf(path)
        rm.submit_job(spec)
    report = rm.run()                      # -> ReplayReport
    print(report.makespan_s, report.utilization, report.wait_p99_s)
"""
from __future__ import annotations

import heapq
import json
import math
import os
import time
from dataclasses import asdict, dataclass
from typing import (Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from repro_torch.serve.cluster import Candidate, ClusterState
from repro_torch.serve.fleet import EngineFleet
from repro_torch.serve.mapper import (MapRequest, MapResponse, MappingEngine,
                                      QueueFull)

DEFAULT_POLICIES = ("compact", "slab", "scatter")

# JobHandle lifecycle states.
PENDING = "pending"      # submitted, arrival time still in the future
QUEUED = "queued"        # in the priority queue, waiting for nodes
RUNNING = "running"      # mapped + allocated, running until finish_s
FINISHED = "finished"    # completed; allocation released

_EPS = 1e-9


def default_flows(n: int, seed: int = 0) -> np.ndarray:
    """Deterministic program graph for jobs whose trace carries no flow
    matrix (SWF traces record sizes and runtimes only): heavy ring
    traffic over the n processes plus sparse random background flows.
    Seeded by ``(n, seed)``, so a replayed trace always maps the same
    instances."""
    if n < 1:
        raise ValueError("n must be >= 1")
    rng = np.random.default_rng([n, seed])
    C = np.zeros((n, n), np.float32)
    for k in range(n):
        C[k, (k + 1) % n] = C[(k + 1) % n, k] = 100.0
    extra = rng.random((n, n)) < 0.1
    C += np.triu(extra * rng.integers(1, 10, (n, n)), 1).astype(np.float32)
    return np.triu(C, 1) + np.triu(C, 1).T


@dataclass(frozen=True, kw_only=True)
class JobSpec:
    """One job as the resource manager sees it.

    Stability contract: keyword-only and frozen; new fields are appended
    with defaults, existing fields are never renamed or reordered within
    a major version.

    ``C`` is the job's program (flow) graph; ``None`` synthesizes a
    deterministic one via :func:`default_flows` (trace formats like SWF
    carry no flows).  ``run_s`` doubles as the runtime estimate EASY
    backfilling reasons with and the virtual service time of a replay.
    ``algorithm=None`` inherits the manager's default; ``"auto"`` lets
    the engine's deadline policy pick from ``deadline_ms``.
    """
    job_id: str
    size: int
    run_s: float = 1.0
    arrival_s: float = 0.0
    C: Optional[np.ndarray] = None
    priority: int = 0
    algorithm: Optional[str] = None
    deadline_ms: Optional[float] = None
    seed: int = 0


class JobHandle:
    """Live view of one submitted job: state, times, and -- once the job
    started -- the winning candidate's allocation and mapping.

    ``wait_s`` is queue wait in virtual seconds (start - arrival);
    ``map_wall_s`` is the real wall time the candidate wave spent in the
    mapping engine (the paper's "reasonable time" budget)."""

    __slots__ = ("spec", "C", "seq", "state", "arrival_s", "start_s",
                 "finish_s", "response", "allocation", "candidate_policy",
                 "num_candidates", "wave_batches", "map_wall_s",
                 "backfilled")

    def __init__(self, spec: JobSpec, C: np.ndarray, seq: int,
                 arrival_s: float):
        self.spec = spec
        self.C = C
        self.seq = seq
        self.state = PENDING
        self.arrival_s = arrival_s
        self.start_s: Optional[float] = None
        self.finish_s: Optional[float] = None
        self.response: Optional[MapResponse] = None
        self.allocation = None
        self.candidate_policy: Optional[str] = None
        self.num_candidates = 0
        self.wave_batches = 0
        self.map_wall_s = 0.0
        self.backfilled = False

    @property
    def job_id(self) -> str:
        return self.spec.job_id

    @property
    def wait_s(self) -> Optional[float]:
        if self.start_s is None:
            return None
        return self.start_s - self.arrival_s

    def done(self) -> bool:
        return self.state == FINISHED

    def result(self) -> MapResponse:
        """The winning candidate's mapping; raises while still queued."""
        if self.response is None:
            raise RuntimeError(f"job {self.job_id!r} is not mapped yet "
                               f"(state={self.state})")
        return self.response

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"JobHandle({self.job_id!r}, size={self.spec.size}, "
                f"state={self.state})")


@dataclass
class RMStats:
    submitted: int = 0
    completed: int = 0
    backfilled: int = 0
    candidate_waves: int = 0       # allocate-then-map waves dispatched
    wave_candidates: int = 0       # candidate instances across all waves
    max_batches_per_wave: int = 0  # engine solver_batches per wave (<=1
    #                                proves single-dispatch waves)


def objective_score(resp: MapResponse, cand: Candidate,
                    C: np.ndarray) -> float:
    """Default candidate score: the mapped QAP objective."""
    del cand, C
    return resp.objective


def dilation_score(alpha: float = 1.0) -> Callable:
    """Congestion/dilation-weighted score: QAP objective plus ``alpha``
    times the worst node distance any communicating process pair is
    stretched over.  Penalises allocations whose best mapping still
    leaves one heavy edge crossing the machine ("Mapping Matters": the
    plain QAP sum can mispredict on 3-D topologies)."""

    def score(resp: MapResponse, cand: Candidate, C: np.ndarray) -> float:
        perm = np.asarray(resp.perm)
        D = cand.M_sub[np.ix_(perm, perm)]     # D[k, l] = dist(p[k], p[l])
        comm = np.asarray(C) > 0
        dil = float(D[comm].max()) if comm.any() else 0.0
        return resp.objective + alpha * dil

    return score


@dataclass(frozen=True)
class ReplayReport:
    """Workload-level metrics of one replay (virtual time unless noted)."""
    jobs: int
    makespan_s: float              # last finish - first arrival
    utilization: float             # busy node-seconds / (nodes * makespan)
    mean_wait_s: float
    wait_p50_s: float
    wait_p99_s: float
    mean_objective: float          # mean mapped QAP objective per job
    total_objective: float
    mean_improvement: float        # vs identity on the chosen allocation
    backfilled: int
    candidate_waves: int
    max_batches_per_wave: int
    map_wall_p50_ms: float         # real engine wall time per wave
    map_wall_p99_ms: float

    def asdict(self) -> dict:
        return asdict(self)


class RMJournal:
    """Append-only JSONL write-ahead log of resource-manager decisions.

    One JSON object per line, four event kinds, each stamped with the
    virtual clock ``t`` at which it was decided:

    - ``arrival``: the full :class:`JobSpec` (``C`` as a nested list, or
      ``null`` when the spec synthesized :func:`default_flows` -- the
      synthesis is deterministic in ``(size, seed)``, so it need not be
      stored);
    - ``map``: the winning mapping for a starting job (permutation,
      objective, baseline, resolved algorithm/tier, degraded flag) --
      written *before* its ``start`` so a start is never applied without
      its mapping;
    - ``start``: the committed allocation (physical node ids), start and
      finish clocks, candidate policy, backfill flag;
    - ``release``: the job's completion.

    Every append is flushed and ``fsync``'d before the in-memory state
    mutates (write-ahead), so after a crash the journal is a prefix of
    the decisions actually taken, with at most a truncated final line --
    which :meth:`read_events` tolerates by stopping at the first
    undecodable line.  :meth:`ResourceManager.recover` replays a journal
    into a fresh manager, reproducing queue contents, running set,
    ``ClusterState`` occupancy, and the busy-time integral exactly.
    """

    VERSION = 1

    def __init__(self, path: Union[str, os.PathLike], mode: str = "a"):
        self.path = os.fspath(path)
        self._f = open(self.path, mode, encoding="utf-8")

    def append(self, ev: dict) -> None:
        self._f.write(json.dumps(ev, separators=(",", ":")) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "RMJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def read_events(path: Union[str, os.PathLike]) -> List[dict]:
        """Parse a journal, tolerating a truncated tail: a crash mid-
        append leaves at most one partial last line, so parsing stops at
        the first undecodable line instead of failing."""
        events: List[dict] = []
        with open(os.fspath(path), encoding="utf-8") as f:
            for line in f:
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    break                      # torn tail write
                if not isinstance(ev, dict) or "ev" not in ev:
                    break
                events.append(ev)
        return events


class ResourceManager:
    """The control plane: priority queue + EASY backfilling +
    allocate-then-map candidate waves over one :class:`ClusterState` and
    one :class:`MappingEngine` (see the module docstring).

    ``system`` is the machine's distance matrix or an existing
    :class:`ClusterState`.  Without ``engine`` the manager builds
    ``MappingEngine()``, which runs on the card (``cuda``) and raises
    without one; pass ``MappingEngine(device="cpu")`` for the CPU.
    ``candidates``/``policies`` size the
    candidate wave (``candidates`` must stay <= the engine's
    ``max_batch`` for single-dispatch waves); ``score`` ranks
    (response, candidate) pairs -- default :func:`objective_score`,
    see :func:`dilation_score`.  An engine built by the manager is
    used synchronously (no flusher thread): every wave is flushed
    explicitly so its K instances ride one batched dispatch.

    ``engine`` may also be an :class:`~repro_torch.serve.fleet.EngineFleet`
    -- the submit/flush contract is identical, waves shard across the
    fleet's workers, and (with the fleet's default
    ``warm_start=False``) a replay is bitwise-identical to the
    single-engine run even under injected worker failures; only
    ``wave_batches`` can exceed 1 on a wave whose worker died and was
    re-solved elsewhere.
    """

    def __init__(self, system: Union[np.ndarray, ClusterState],
                 engine: Optional[Union[MappingEngine,
                                        EngineFleet]] = None, *,
                 candidates: int = 3,
                 policies: Sequence[str] = DEFAULT_POLICIES,
                 backfill: bool = True,
                 algorithm: str = "psa",
                 deadline_ms: Optional[float] = None,
                 score: Callable = objective_score,
                 clock: float = 0.0,
                 map_timeout_s: float = 600.0,
                 max_pending: Optional[int] = None,
                 journal: Optional[Union[str, os.PathLike,
                                         RMJournal]] = None):
        if isinstance(system, ClusterState):
            self.cluster = system
        else:
            self.cluster = ClusterState(np.asarray(system))
        self.engine = engine if engine is not None else MappingEngine()
        if candidates < 1:
            raise ValueError("candidates must be >= 1")
        if candidates > self.engine.max_batch:
            raise ValueError(
                f"candidates={candidates} exceeds the engine's "
                f"max_batch={self.engine.max_batch}; a wave would split "
                "into multiple dispatches")
        self.candidates = int(candidates)
        self.policies = tuple(policies)
        self.backfill = bool(backfill)
        self.algorithm = algorithm
        self.deadline_ms = deadline_ms
        self.score = score
        self.map_timeout_s = float(map_timeout_s)
        self.clock = float(clock)
        self.stats = RMStats()
        self.handles: List[JobHandle] = []
        self._queue: List[JobHandle] = []
        self._arrivals: List[Tuple[float, int, JobHandle]] = []   # heap
        self._running: List[Tuple[float, int, JobHandle]] = []    # heap
        self._seq = 0
        self._busy_integral = 0.0
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        self.max_pending = max_pending
        if journal is None or isinstance(journal, RMJournal):
            self._journal: Optional[RMJournal] = journal
        else:
            self._journal = RMJournal(journal)

    # ------------------------------------------------------------------ API
    def submit_job(self, spec: JobSpec) -> JobHandle:
        """Admit one job; returns its :class:`JobHandle`.  Arrivals in
        the virtual future stay ``pending`` until the clock reaches
        them; nothing is scheduled until :meth:`schedule` / :meth:`run`
        (so a burst of submissions schedules as one pass).

        With ``max_pending`` set, a submit that finds that many jobs
        already waiting (pending + queued, not yet started) raises
        :class:`~repro_torch.serve.mapper.QueueFull` *before* any state
        mutates: a rejected job leaves no handle, no journal record, and
        no ``ClusterState`` change."""
        if not isinstance(spec, JobSpec):
            raise TypeError("submit_job takes a JobSpec")
        if (self.max_pending is not None
                and len(self._queue) + len(self._arrivals)
                >= self.max_pending):
            raise QueueFull(
                f"resource manager at max_pending={self.max_pending} "
                f"waiting jobs")
        h = self._admit(spec)
        if self._journal is not None:
            self._journal.append({
                "ev": "arrival", "t": self.clock, "job_id": spec.job_id,
                "size": spec.size, "run_s": spec.run_s,
                "arrival_s": spec.arrival_s, "priority": spec.priority,
                "algorithm": spec.algorithm,
                "deadline_ms": spec.deadline_ms, "seed": spec.seed,
                "C": None if spec.C is None
                     else np.asarray(spec.C, np.float32).tolist()})
        return h

    def _admit(self, spec: JobSpec) -> JobHandle:
        """Validate + enqueue one job (shared by :meth:`submit_job` and
        journal recovery, which must not re-journal)."""
        if spec.size < 1 or spec.size > self.cluster.num_nodes:
            raise ValueError(f"job size {spec.size} not in "
                             f"[1, {self.cluster.num_nodes}]")
        if spec.run_s < 0:
            raise ValueError("run_s must be >= 0")
        if spec.C is None:
            C = default_flows(spec.size, spec.seed)
        else:
            C = np.asarray(spec.C, np.float32)
            if C.shape != (spec.size, spec.size):
                raise ValueError(f"C must be ({spec.size}, {spec.size}), "
                                 f"got {C.shape}")
        h = JobHandle(spec, C, self._seq, max(spec.arrival_s, self.clock))
        self._seq += 1
        self.stats.submitted += 1
        self.handles.append(h)
        if h.arrival_s > self.clock + _EPS:
            heapq.heappush(self._arrivals, (h.arrival_s, h.seq, h))
        else:
            h.state = QUEUED
            self._queue.append(h)
        return h

    def schedule(self) -> None:
        """Run one scheduling pass at the current virtual clock."""
        self._drain_arrivals()
        self._schedule_pass()

    def step(self) -> Optional[float]:
        """Advance the clock to the next event (arrival or completion),
        process it, and schedule.  Returns the new clock, or ``None``
        when no event is pending."""
        t_arr = self._arrivals[0][0] if self._arrivals else math.inf
        t_fin = self._running[0][0] if self._running else math.inf
        t = min(t_arr, t_fin)
        if math.isinf(t):
            return None
        self._advance(t)
        self._drain_completions()
        self._drain_arrivals()
        self._schedule_pass()
        return self.clock

    def run(self, until: Optional[float] = None) -> ReplayReport:
        """Drive scheduling until every submitted job finished (or the
        clock passes ``until``); returns the :class:`ReplayReport`."""
        self.schedule()
        while self._arrivals or self._running:
            if until is not None and min(
                    self._arrivals[0][0] if self._arrivals else math.inf,
                    self._running[0][0] if self._running else math.inf
            ) > until:
                break
            self.step()
        if self._queue and not self._running and not self._arrivals:
            stuck = [h.job_id for h in self._queue]
            raise RuntimeError(
                f"jobs {stuck} can never be scheduled: the idle cluster "
                "cannot host them (externally held nodes?)")
        return self.report()

    def report(self) -> ReplayReport:
        """Metrics over the jobs finished so far."""
        done = [h for h in self.handles if h.state == FINISHED]
        if not done:
            return ReplayReport(
                jobs=0, makespan_s=0.0, utilization=0.0, mean_wait_s=0.0,
                wait_p50_s=0.0, wait_p99_s=0.0, mean_objective=0.0,
                total_objective=0.0, mean_improvement=0.0, backfilled=0,
                candidate_waves=self.stats.candidate_waves,
                max_batches_per_wave=self.stats.max_batches_per_wave,
                map_wall_p50_ms=0.0, map_wall_p99_ms=0.0)
        t0 = min(h.arrival_s for h in done)
        t1 = max(h.finish_s for h in done)
        makespan = max(t1 - t0, _EPS)
        waits = np.array([h.wait_s for h in done])
        objs = np.array([h.response.objective for h in done])
        imps = np.array([h.response.improvement for h in done])
        walls = np.array([h.map_wall_s for h in done]) * 1e3
        return ReplayReport(
            jobs=len(done),
            makespan_s=float(makespan),
            utilization=float(self._busy_integral
                              / (self.cluster.num_nodes * makespan)),
            mean_wait_s=float(waits.mean()),
            wait_p50_s=float(np.percentile(waits, 50)),
            wait_p99_s=float(np.percentile(waits, 99)),
            mean_objective=float(objs.mean()),
            total_objective=float(objs.sum()),
            mean_improvement=float(imps.mean()),
            backfilled=self.stats.backfilled,
            candidate_waves=self.stats.candidate_waves,
            max_batches_per_wave=self.stats.max_batches_per_wave,
            map_wall_p50_ms=float(np.percentile(walls, 50)),
            map_wall_p99_ms=float(np.percentile(walls, 99)))

    # ------------------------------------------------------------- recovery
    @classmethod
    def recover(cls, system: Union[np.ndarray, ClusterState],
                journal_path: Union[str, os.PathLike],
                engine: Optional[Union[MappingEngine,
                                       EngineFleet]] = None, *,
                journal: Optional[Union[str, os.PathLike,
                                        RMJournal]] = None,
                **kwargs) -> "ResourceManager":
        """Rebuild a manager from a crash's journal: replay every logged
        decision (arrival -> admit, map+start -> allocate those exact
        nodes and restore the mapping, release -> free them) against a
        fresh :class:`ClusterState`, advancing the virtual clock to each
        event's stamp so occupancy *and* the busy-time integral match
        the original run exactly.

        After recovery: jobs that arrived but never started are queued
        (they will be scheduled afresh -- their mapping was never
        committed), started-but-unreleased jobs are running with their
        exact allocation and mapping, released jobs are finished.  The
        completed-job set, queue contents, and every node's occupancy
        are identical to the crashed manager's at its last fsync'd
        record; a torn final line is ignored (see
        :meth:`RMJournal.read_events`).

        ``journal`` (optional) attaches a journal for decisions *after*
        recovery; pass the same path to keep appending to it.  Other
        keyword arguments go to the constructor unchanged.
        """
        events = RMJournal.read_events(journal_path)
        rm = cls(system, engine, **kwargs)
        by_id: Dict[str, JobHandle] = {}
        maps: Dict[str, MapResponse] = {}
        for ev in events:
            rm._advance(ev["t"])
            kind = ev["ev"]
            if kind == "arrival":
                spec = JobSpec(
                    job_id=ev["job_id"], size=ev["size"],
                    run_s=ev["run_s"], arrival_s=ev["arrival_s"],
                    C=None if ev["C"] is None
                      else np.asarray(ev["C"], np.float32),
                    priority=ev["priority"], algorithm=ev["algorithm"],
                    deadline_ms=ev["deadline_ms"], seed=ev["seed"])
                by_id[spec.job_id] = rm._admit(spec)
            elif kind == "map":
                maps[ev["job_id"]] = MapResponse(
                    job_id=ev["job_id"],
                    perm=np.asarray(ev["perm"], np.int32),
                    objective=ev["objective"], baseline=ev["baseline"],
                    algorithm=ev["algorithm"], n=ev["n"],
                    bucket=ev["bucket"], cached=False, seconds=0.0,
                    batch_size=0, tier=ev["tier"],
                    degraded=ev["degraded"],
                    degrade_reason=ev["degrade_reason"])
            elif kind == "start":
                h = by_id[ev["job_id"]]
                rm._drain_arrivals()
                rm._queue.remove(h)
                h.allocation = rm.cluster.allocate_nodes(
                    h.job_id, np.asarray(ev["nodes"], np.int64))
                h.response = maps.pop(ev["job_id"])
                h.candidate_policy = ev["policy"]
                h.backfilled = ev["backfilled"]
                if h.backfilled:
                    rm.stats.backfilled += 1
                h.state = RUNNING
                h.start_s = ev["start_s"]
                h.finish_s = ev["finish_s"]
                heapq.heappush(rm._running, (h.finish_s, h.seq, h))
            elif kind == "release":
                # The journal's own record is authoritative; the drain
                # pops exactly the jobs whose finish the clock reached
                # (journal writes suppressed: rm._journal is still None
                # or the caller's, attached below).
                rm._drain_completions()
        # Orphan map records (crash between map and start) are dropped.
        if journal is not None:
            rm._journal = (journal if isinstance(journal, RMJournal)
                           else RMJournal(journal))
        return rm

    # ------------------------------------------------------------ internals
    def _advance(self, t: float) -> None:
        if t < self.clock - _EPS:
            raise ValueError("virtual clock cannot run backwards")
        busy = self.cluster.num_nodes - self.cluster.num_free
        self._busy_integral += busy * max(t - self.clock, 0.0)
        self.clock = max(self.clock, t)

    def _drain_completions(self) -> None:
        while self._running and self._running[0][0] <= self.clock + _EPS:
            _, _, h = heapq.heappop(self._running)
            self.cluster.release(h.job_id)
            h.state = FINISHED
            self.stats.completed += 1
            if self._journal is not None:
                self._journal.append({"ev": "release", "t": self.clock,
                                      "job_id": h.job_id})

    def _drain_arrivals(self) -> None:
        while self._arrivals and self._arrivals[0][0] <= self.clock + _EPS:
            _, _, h = heapq.heappop(self._arrivals)
            h.state = QUEUED
            self._queue.append(h)

    def _sort_queue(self) -> None:
        self._queue.sort(key=lambda h: (-h.spec.priority, h.arrival_s,
                                        h.seq))

    def _schedule_pass(self) -> None:
        """EASY backfilling at the current clock: start the head while it
        fits; once blocked, compute its shadow (time, spare) and start
        later jobs only if they cannot delay it."""
        self._sort_queue()
        while self._queue and self._try_start(self._queue[0]):
            self._queue.pop(0)
        if not self._queue or not self.backfill:
            return
        head = self._queue[0]
        shadow_t, spare = self._shadow(head.spec.size)
        i = 1
        while i < len(self._queue):
            j = self._queue[i]
            ends_by_shadow = self.clock + j.spec.run_s <= shadow_t + _EPS
            if ((ends_by_shadow or j.spec.size <= spare)
                    and j.spec.size <= self.cluster.num_free
                    and self._try_start(j, backfilled=True)):
                if not ends_by_shadow:
                    spare -= j.spec.size   # consumes the head's slack
                self.stats.backfilled += 1
                self._queue.pop(i)
            else:
                i += 1

    def _shadow(self, size: int) -> Tuple[float, int]:
        """Earliest virtual time ``size`` nodes are free given the
        running jobs' runtimes, and the spare node count at that time
        once the head's ``size`` is set aside (count-based EASY)."""
        free = self.cluster.num_free
        if free >= size:
            return self.clock, free - size
        for t, _, h in sorted(self._running):
            free += h.spec.size
            if free >= size:
                return t, free - size
        return math.inf, self.cluster.num_nodes   # cannot happen when the
        #                                           job fits the machine

    def _try_start(self, h: JobHandle, backfilled: bool = False) -> bool:
        """The allocate-then-map wave: carve K candidates, reserve their
        union, score all K induced subgraphs in one engine wave, promote
        the argmin candidate.  False when the job cannot start now."""
        spec = h.spec
        cands = self.cluster.candidate_subsets(
            spec.size, k=self.candidates, policies=self.policies)
        if not cands:
            return False
        tag = f"{spec.job_id}#wave"
        union = np.unique(np.concatenate([c.nodes for c in cands]))
        self.cluster.reserve(tag, union)
        committed = False
        try:
            algorithm = spec.algorithm or self.algorithm
            deadline = (spec.deadline_ms if spec.deadline_ms is not None
                        else self.deadline_ms)
            t0 = time.perf_counter()
            batches0 = self.engine.stats.solver_batches
            futs = [self.engine.submit(MapRequest(
                job_id=f"{spec.job_id}#c{i}", C=h.C, M=cand.M_sub,
                algorithm=algorithm, seed=spec.seed, deadline_ms=deadline))
                for i, cand in enumerate(cands)]
            if not self.engine.running:
                self.engine.flush()
            resps = [f.result(self.map_timeout_s) for f in futs]
            wave_batches = self.engine.stats.solver_batches - batches0
            h.map_wall_s = time.perf_counter() - t0
            scores = [self.score(r, c, h.C)
                      for r, c in zip(resps, cands)]
            best = int(np.argmin(scores))     # ties -> first policy wins
            h.allocation = self.cluster.promote(tag, spec.job_id,
                                                cands[best].nodes)
            committed = True
        finally:
            if not committed:
                self.cluster.cancel(tag)
        h.response = resps[best]
        h.candidate_policy = cands[best].policy
        h.num_candidates = len(cands)
        h.wave_batches = wave_batches
        h.backfilled = backfilled
        h.state = RUNNING
        h.start_s = self.clock
        h.finish_s = self.clock + spec.run_s
        heapq.heappush(self._running, (h.finish_s, h.seq, h))
        self.stats.candidate_waves += 1
        self.stats.wave_candidates += len(cands)
        self.stats.max_batches_per_wave = max(
            self.stats.max_batches_per_wave, wave_batches)
        if self._journal is not None:
            r = h.response
            # map strictly before start: recovery never applies a start
            # without its mapping (a crash between the two writes leaves
            # an orphan map record, which recovery ignores).
            self._journal.append({
                "ev": "map", "t": self.clock, "job_id": spec.job_id,
                "perm": np.asarray(r.perm).tolist(),
                "objective": float(r.objective),
                "baseline": float(r.baseline), "algorithm": r.algorithm,
                "n": int(r.n), "bucket": r.bucket, "tier": r.tier,
                "degraded": bool(r.degraded),
                "degrade_reason": r.degrade_reason})
            self._journal.append({
                "ev": "start", "t": self.clock, "job_id": spec.job_id,
                "nodes": np.asarray(h.allocation.nodes).tolist(),
                "start_s": h.start_s, "finish_s": h.finish_s,
                "policy": h.candidate_policy,
                "backfilled": h.backfilled})
        return True
