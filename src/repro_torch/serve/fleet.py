"""Distributed engine fleet: a coordinator sharding waves over worker
engines, with deterministic fault injection and failure recovery.

The port of ``repro/serve/fleet.py``.  Worker engines run where
``engine_kwargs["device"]`` says, the card by default; ``meshes=`` gives
thread workers instance meshes (``launch.mesh.Mesh``), round-robin.

One :class:`~repro_torch.serve.mapper.MappingEngine` process is the ceiling on
the ROADMAP's "millions of users" target: the paper's premise is that
mapping happens *inside* the resource manager's scheduling window, and a
real RM cannot stall its queue because one solver process died mid-wave.
:class:`EngineFleet` removes that ceiling while keeping the engine's
``submit() -> MapFuture`` contract, so it drops into
:class:`~repro_torch.serve.rm.ResourceManager` /
``launch.placement.PlacementService`` unchanged:

  1. The coordinator owns N workers behind the
     :class:`~repro_torch.serve.transport.WorkerTransport` seam:
     thread-backed :class:`EngineWorker` (default -- one private
     ``MappingEngine`` per worker thread) or
     process-backed :class:`~repro_torch.serve.transport.SubprocessWorker`
     (``transport="subprocess"`` -- a spawned interpreter per worker,
     real isolation from crashes, OOM kills, and the GIL).  Queued
     requests group by (bucket, algorithm, tier) exactly like the single
     engine, and each wave is dispatched to the live worker with the
     fewest outstanding requests (ties: least recently assigned) -- the
     ``weiyu0824/Idunno`` coordinator's fewest-resources-first rule.
  2. Failure recovery: a worker is dead when it says so (injected
     faults), when its wave raises unexpectedly at the transport
     boundary (thread exception, pipe EOF, corrupt frame stream), or
     when its heartbeat goes stale (``heartbeat_timeout_s``; a worker
     that has not yet delivered its first result gets
     ``compiling_grace_s`` on top, so a cold start -- a child importing
     torch and loading the kernels -- is never mistaken for a hang).
     Every unresolved request a dead worker held is requeued and
     re-dispatched to a surviving worker; when none survive, a fresh
     worker is respawned under exponential backoff
     with jitter (immediate respawn would hot-spin when worker startup
     itself crashes).  A :class:`~repro_torch.serve.mapper.MapFuture` is
     therefore never lost -- and a first-result-wins guard makes sure it
     is never resolved twice, even when a declared-dead "zombie" worker
     delivers late.
  3. Deadline enforcement: a request carrying ``deadline_ms`` is a hard
     wall, not a hint.  If no worker has answered when it expires, the
     coordinator resolves the future itself with a *degraded* mapping --
     the last known permutation for the same (order, system graph) from
     the shape tier if one exists and is no worse than identity
     (``degrade_reason="deadline_shape_cache"``), else the deterministic
     identity/as-allocated placement (``"deadline_identity"``) -- flagged
     ``MapResponse.degraded=True``.  The caller provably never blocks
     past its deadline (plus one monitor tick); the late real result is
     eaten by the first-result-wins guard but still warms the shared
     cache for the next identical request.
  4. A circuit breaker routes dispatch around a worker after
     ``breaker_failures`` *consecutive* request failures
     (``breaker_cooldown_s`` of open state, then half-open: one success
     resets it) -- a worker whose device wedged into a failing state
     stops eating waves other workers would serve.
  5. Straggler re-dispatch: a request in flight longer than
     ``straggler_after_s`` is duplicated to a second worker; the first
     result wins (``stats.duplicate_results`` counts the losers).
  6. A shared exact-digest cache tier sits above the workers: once any
     worker solved an instance, every later identical request is served
     by the coordinator without a dispatch -- a warm entry anywhere
     serves the whole fleet (workers keep their private caches too).
  7. Admission control: with ``max_pending`` set, a submit that finds
     that many requests queued+in flight is rejected with an
     already-failed :class:`~repro_torch.serve.mapper.QueueFull` future --
     explicit backpressure instead of unbounded queue growth.
  8. :class:`FaultPlan` is the injection seam that makes all of this
     deterministic and testable: ``kill_worker_at`` kills a worker after
     it completed exactly k requests (count-based, not timing-based),
     ``delay_worker_s`` slows a worker down, ``drop_heartbeats``
     silences one so the staleness detector -- not the worker --
     declares the death.  Subprocess workers add the *real* fault
     modes: ``sigkill_worker_at`` (SIGKILL, no cleanup),
     ``sigstop_worker_at`` (a genuine zombie process), and
     ``corrupt_stdout_at`` (garbage on the frame stream).

Determinism: workers default to ``warm_start=False`` so every solve is a
pure function of the request alone -- history-dependent shape-tier warm
starts would otherwise let sharding order, kills, and straggler
duplicates change results.  With that default the fleet is
bitwise-identical to a single ``MappingEngine(warm_start=False)`` on any
request set, for any worker count and either transport, under any
:class:`FaultPlan` that leaves the respawn path alive
(``tests/test_torch_fleet.py`` and ``tests/test_torch_transport.py`` pin
this, against the reference's engine too);
only deadline-degraded responses (flagged) are exempt.

Synchronous use mirrors the engine: without :meth:`EngineFleet.start`
(no dispatcher thread), :meth:`EngineFleet.flush` drives dispatch,
failure detection, and requeue inline until every submitted request is
resolved.  ``start()``/``stop()`` (or the context manager) run the same
logic in a background dispatcher with the engine's deadline/full-bucket
batching rules.  ``stop()`` drains, then shuts the workers down; a
stopped fleet does not accept further work.
"""
from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.serve.mapper import (MapCancelled, MapFuture, MappingEngine,
                                      MapRequest, MapResponse, QueueFull,
                                      validate_request)
from repro_torch.serve.transport import (DEFAULT_HEARTBEAT_INTERVAL_S,
                                         SubprocessWorker, WorkerBase)

TRANSPORTS = ("thread", "subprocess")

# Subprocess workers heartbeat from a dedicated child thread, so staleness
# detection is safe to enable by default: generous timeout, plus a first-
# delivery grace that covers a cold start (import, kernel build or load).
DEFAULT_SUBPROCESS_HEARTBEAT_TIMEOUT_S = 15.0
DEFAULT_SUBPROCESS_COMPILING_GRACE_S = 120.0


@dataclass(frozen=True)
class FaultPlan:
    """Deterministic fault injection, keyed by worker id.

    ``kill_worker_at[wid] = k``: worker ``wid`` dies after *completing*
    exactly ``k`` requests -- before delivering the (k+1)-th, even
    mid-wave -- leaving its remaining assignments to the requeue path.
    Count-based, so the same plan on the same request stream kills at
    the same request every run.  On the thread transport the worker
    thread exits; on the subprocess transport the child ``sys.exit``\\ s
    (clean EOF on the pipe).

    ``sigkill_worker_at`` / ``sigstop_worker_at`` / ``corrupt_stdout_at``
    (subprocess transport only; same count-based semantics): the child
    SIGKILLs itself (hard death, no cleanup), SIGSTOPs itself (a genuine
    zombie -- process alive, pipe open, heartbeats frozen; only the
    staleness detector can tell), or writes garbage into its stdout
    frame stream (the parent must declare the stream dead, never deliver
    junk).  The thread transport ignores these.

    ``delay_worker_s[wid]``: sleep this long before processing each
    wave (build stragglers and lose races deterministically).

    ``drop_heartbeats``: these workers stop heartbeating the moment they
    start; with a ``heartbeat_timeout_s`` configured the staleness
    detector declares them dead while they may still be solving
    -- which is exactly how a zombie delivery into the first-result-wins
    guard is produced on purpose.

    Respawned workers get fresh ids beyond the initial range, so a plan
    written for workers ``0..N-1`` never re-kills the replacements.
    """
    kill_worker_at: Mapping[int, int] = field(default_factory=dict)
    delay_worker_s: Mapping[int, float] = field(default_factory=dict)
    drop_heartbeats: frozenset = frozenset()
    sigkill_worker_at: Mapping[int, int] = field(default_factory=dict)
    sigstop_worker_at: Mapping[int, int] = field(default_factory=dict)
    corrupt_stdout_at: Mapping[int, int] = field(default_factory=dict)

    def kill_at(self, wid: int) -> Optional[int]:
        return self.kill_worker_at.get(wid)

    def delay_s(self, wid: int) -> float:
        return float(self.delay_worker_s.get(wid, 0.0))

    def beats(self, wid: int) -> bool:
        return wid not in self.drop_heartbeats

    def sigkill_at(self, wid: int) -> Optional[int]:
        return self.sigkill_worker_at.get(wid)

    def sigstop_at(self, wid: int) -> Optional[int]:
        return self.sigstop_worker_at.get(wid)

    def corrupt_at(self, wid: int) -> Optional[int]:
        return self.corrupt_stdout_at.get(wid)


@dataclass
class FleetStats:
    """Coordinator-level counters.  The first block mirrors
    :class:`~repro_torch.serve.mapper.EngineStats` so stream harnesses reading
    engine stats work unchanged (``warm_starts`` stays 0 under the
    fleet's deterministic ``warm_start=False`` default); the second
    block is fleet-specific fault accounting."""
    submitted: int = 0
    resolved: int = 0
    failed: int = 0
    cache_hits: int = 0            # shared-tier hits served by the coordinator
    warm_starts: int = 0
    solver_batches: int = 0        # summed from worker engines, per wave
    solver_calls: int = 0
    full_bucket_flushes: int = 0
    deadline_flushes: int = 0
    dispatched_waves: int = 0
    requeued: int = 0              # in-flight requests recovered from a death
    worker_deaths: int = 0
    respawns: int = 0
    straggler_redispatches: int = 0
    duplicate_results: int = 0     # late deliveries the first-wins guard ate
    cancelled: int = 0             # futures cancelled by their callers
    rejected: int = 0              # submits refused by max_pending
    degraded: int = 0              # deadline walls answered by the ladder
    breaker_trips: int = 0         # circuit breakers opened
    first_recovery_s: Optional[float] = None   # first death -> first requeued
    #                                            request resolved (latency)


@dataclass(eq=False)               # identity hash: instances live in sets
class _FleetPending:
    """One submitted request as the coordinator tracks it across
    dispatch, death, requeue, and (possibly duplicated) delivery."""
    req: MapRequest
    future: MapFuture
    algorithm: str                 # resolved by the deadline policy
    tier: str
    digest: str                    # shared-cache key (proto engine digest)
    shape_digest: str              # degradation-ladder key (order + M)
    t_submit: float
    resolved: bool = False
    dispatches: int = 0
    last_dispatch: float = 0.0
    requeued: bool = False         # survived a worker death at least once
    holders: Set[int] = field(default_factory=set)   # worker ids in flight


class EngineWorker(WorkerBase):
    """One thread-backed worker: a private ``MappingEngine`` fed waves
    through an inbox, heartbeating through the coordinator's lock.

    The engine is used synchronously (its flusher never starts): the
    worker submits a whole wave and flushes once, so a wave is a single
    batched dispatch exactly like the plain engine -- the RM's
    one-dispatch-per-candidate-wave invariant survives the fleet.

    This is the thread implementation of the
    :class:`~repro_torch.serve.transport.WorkerTransport` seam; see
    :class:`~repro_torch.serve.transport.SubprocessWorker` for the
    process-isolated one.
    """

    def __init__(self, fleet: "EngineFleet", wid: int,
                 engine: MappingEngine):
        super().__init__(fleet, wid)
        self.engine = engine
        self._thread = threading.Thread(
            target=self._run, name=f"fleet-worker-{wid}", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def enqueue_wave(self, wave: List[_FleetPending]) -> None:
        self.inbox.append(wave)            # caller holds (and notifies) lock

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread.is_alive():
            self._thread.join(timeout)

    # ------------------------------------------------------------- thread
    def _beat_locked(self) -> None:
        if self.fleet.fault_plan.beats(self.wid):
            self.last_beat = time.monotonic()

    def _run(self) -> None:
        fleet = self.fleet
        while True:
            with fleet._cond:
                self._beat_locked()
                while (self.alive and not fleet._shutdown
                       and not self.inbox):
                    fleet._cond.wait(timeout=fleet.tick_s)
                    self._beat_locked()
                if not self.alive or fleet._shutdown:
                    return
                wave = self.inbox.popleft()
            if not self._process(wave):
                return                         # injected death

    def _process(self, wave: List[_FleetPending]) -> bool:
        """Solve one wave and deliver per-request.  Returns False when an
        injected kill fired (the thread must exit)."""
        fleet = self.fleet
        plan = fleet.fault_plan
        delay = plan.delay_s(self.wid)
        if delay > 0:
            time.sleep(delay)
        kill_at = plan.kill_at(self.wid)
        with fleet._cond:
            if kill_at is not None and self.completed >= kill_at:
                fleet._declare_dead_locked(self)
                return False
        b0 = self.engine.stats.solver_batches
        c0 = self.engine.stats.solver_calls
        try:
            futs = [self.engine.submit(p.req) for p in wave]
            self.engine.flush()
        except BaseException as e:
            # A whole-wave failure is deterministic (it would fail on any
            # worker): fail the futures instead of requeueing forever.
            with fleet._cond:
                for p in wave:
                    fleet._fail_locked(self, p, e)
            return True
        with fleet._cond:
            fleet.stats.solver_batches += (
                self.engine.stats.solver_batches - b0)
            fleet.stats.solver_calls += (
                self.engine.stats.solver_calls - c0)
        for p, f in zip(wave, futs):
            with fleet._cond:
                if kill_at is not None and self.completed >= kill_at:
                    # Dies between deliveries: the rest of the wave stays
                    # undelivered and is requeued by the reap.
                    fleet._declare_dead_locked(self)
                    return False
                exc = f.exception(timeout=0)
                if exc is not None:
                    fleet._fail_locked(self, p, exc)
                else:
                    fleet._deliver_locked(self, p, f.result(timeout=0))
        return True


class EngineFleet:
    """Coordinator + N worker engines; a drop-in ``MappingEngine``
    replacement with failure recovery (see the module docstring).

    ``transport`` selects the worker backing: ``"thread"`` (default --
    workers share this interpreter) or ``"subprocess"``
    (each worker is a spawned interpreter speaking length-prefixed
    pickle frames over pipes; see ``repro_torch.serve.transport``).  The
    submit/flush surface and results are identical either way.

    ``engine_kwargs`` configure every worker engine (same signature as
    ``MappingEngine``; ``warm_start`` defaults to False for fleet-wide
    determinism -- see module docstring); alternatively pass
    ``engine_factory(wid) -> MappingEngine`` to build heterogeneous
    workers (thread transport only; all workers must then share
    digest-relevant config: buckets, tier budgets, policy, processes --
    the coordinator groups and caches with worker 0's config).
    ``engine_kwargs["device"]`` (a string or ``torch.device``; pickled to
    subprocess children) places every worker engine; without it they run
    on the card.

    ``heartbeat_timeout_s=None`` keeps the transport default: disabled
    for threads (injected faults and thread-boundary exceptions already
    cover in-process failure, and a cold first wave may sit in a
    kernel build far longer than any useful timeout) and
    ``DEFAULT_SUBPROCESS_HEARTBEAT_TIMEOUT_S`` for subprocesses (whose
    heartbeats come from a dedicated child thread, and whose SIGSTOP
    zombies are otherwise undetectable).  Pass ``0`` (or any value
    ``<= 0``) to disable explicitly.  ``compiling_grace_s`` (also
    per-transport by default) extends the timeout for a worker that has
    not delivered its first result yet, so a slow cold compile is not
    reaped as a hang.  A false positive is safe -- requeue plus the
    first-result-wins guard keep results exact -- just wasteful.

    ``max_pending`` bounds queued+in-flight requests (submit returns an
    already-failed ``QueueFull`` future beyond it); ``respawn_backoff_s``
    / ``respawn_backoff_max_s`` shape the exponential respawn backoff;
    ``breaker_failures`` / ``breaker_cooldown_s`` tune the per-worker
    circuit breaker; ``worker_cache_dir`` gives each subprocess worker
    ``<dir>/w<wid>``, which the child creates and leaves empty (the port
    has no compilation cache: children load the kernels the first build
    wrote; see ``repro_torch.serve.transport``).
    """

    def __init__(self, workers: int = 2, *,
                 transport: str = "thread",
                 fault_plan: Optional[FaultPlan] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 compiling_grace_s: Optional[float] = None,
                 straggler_after_s: Optional[float] = None,
                 max_dispatches: int = 2,
                 shared_cache_size: int = 1024,
                 tick_s: float = 0.02,
                 max_pending: Optional[int] = None,
                 respawn_backoff_s: float = 0.05,
                 respawn_backoff_max_s: float = 2.0,
                 breaker_failures: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 worker_cache_dir: Optional[str] = None,
                 heartbeat_interval_s: float = DEFAULT_HEARTBEAT_INTERVAL_S,
                 engine_factory: Optional[
                     Callable[[int], MappingEngine]] = None,
                 meshes: Optional[Sequence] = None,
                 **engine_kwargs):
        if workers < 1:
            raise ValueError("need at least one worker")
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}")
        self.transport = transport
        self.fault_plan = fault_plan or FaultPlan()
        if heartbeat_timeout_s is None and transport == "subprocess":
            heartbeat_timeout_s = DEFAULT_SUBPROCESS_HEARTBEAT_TIMEOUT_S
        if heartbeat_timeout_s is not None and heartbeat_timeout_s <= 0:
            heartbeat_timeout_s = None         # explicit disable
        self.heartbeat_timeout_s = heartbeat_timeout_s
        if compiling_grace_s is None:
            compiling_grace_s = (DEFAULT_SUBPROCESS_COMPILING_GRACE_S
                                 if transport == "subprocess" else 0.0)
        self.compiling_grace_s = float(compiling_grace_s)
        self.straggler_after_s = straggler_after_s
        self.max_dispatches = int(max_dispatches)
        self.shared_cache_size = int(shared_cache_size)
        self.tick_s = float(tick_s)
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        self.max_pending = max_pending
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.respawn_backoff_max_s = float(respawn_backoff_max_s)
        self.breaker_failures = int(breaker_failures)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.worker_cache_dir = worker_cache_dir
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        if transport == "subprocess":
            if engine_factory is not None or meshes:
                raise ValueError(
                    "subprocess transport configures workers via "
                    "engine kwargs only (factories/meshes cannot cross "
                    "the process boundary)")
            if "mesh" in engine_kwargs and engine_kwargs["mesh"] is not None:
                raise ValueError(
                    "subprocess transport cannot ship a device mesh")
            kwargs = dict(engine_kwargs)
            kwargs.setdefault("warm_start", False)
            self._engine_kwargs = kwargs
            self._factory = None
        elif engine_factory is None:
            kwargs = dict(engine_kwargs)
            kwargs.setdefault("warm_start", False)
            self._engine_kwargs = kwargs
            mesh_list = list(meshes) if meshes else []

            def engine_factory(wid: int) -> MappingEngine:
                kw = dict(kwargs)
                if mesh_list:
                    kw["mesh"] = mesh_list[wid % len(mesh_list)]
                return MappingEngine(**kw)
            self._factory = engine_factory
        elif engine_kwargs or meshes:
            raise ValueError(
                "pass either engine_factory or engine kwargs/meshes")
        else:
            self._engine_kwargs = None
            self._factory = engine_factory
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[_FleetPending] = []
        self._inflight: Set[_FleetPending] = set()
        self._cache: "OrderedDict[str, Tuple[np.ndarray, float]]" = \
            OrderedDict()
        # Degradation ladder, tier 1: latest real permutation per (order,
        # system graph), fed by deliveries; served when a deadline expires.
        self._shape_perms: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.stats = FleetStats()
        self.workers: List[WorkerBase] = []
        self._next_wid = 0
        self._assign_seq = 1
        self._respawn_attempts = 0         # consecutive; reset on delivery
        self._respawn_not_before = 0.0
        self._last_death_t: Optional[float] = None   # recovery-latency clock
        self._jitter = random.Random(0x5eed)
        self._dispatcher: Optional[threading.Thread] = None
        self._stop = False
        self._shutdown = False
        # Config/digest/grouping proxy.  Thread transport: worker 0's
        # engine (pure reads -- usable even after that worker dies).
        # Subprocess transport: a coordinator-local engine that never
        # solves (children own the real ones).
        if transport == "subprocess":
            self._proto = MappingEngine(**self._engine_kwargs)
        for _ in range(workers):
            self._spawn_worker_locked()
        if transport == "thread":
            self._proto = self.workers[0].engine

    # ------------------------------------------------------ engine surface
    @property
    def max_batch(self) -> int:
        return self._proto.max_batch

    @property
    def policy(self):
        return self._proto.policy

    @property
    def flush_deadline_ms(self) -> float:
        return self._proto.flush_deadline_ms

    def warmup(self, **kwargs) -> int:
        """Warm the engines with :meth:`MappingEngine.warmup`'s arguments.
        Thread transport: the kernel libraries are process-wide, so one
        worker's warmup covers every worker (and every respawn).
        Subprocess transport: the coordinator's proto engine runs the
        dummy waves (on its device: ``engine_kwargs["device"]``); on the
        card that builds the kernels into ``build/repro_torch_kernels/``
        before any child loads them."""
        if self.transport == "subprocess":
            return self._proto.warmup(**kwargs)
        for w in self.workers:
            if w.alive:
                return w.engine.warmup(**kwargs)
        return 0

    def submit(self, req: MapRequest) -> MapFuture:
        """Queue one request; non-blocking.  Same contract as
        :meth:`MappingEngine.submit`: the future is resolved by the
        background dispatcher (when started) or by the next
        :meth:`flush`; beyond ``max_pending`` it comes back already
        failed with :class:`~repro_torch.serve.mapper.QueueFull`."""
        validate_request(req)
        algorithm, tier = self._proto.policy.resolve(
            req.algorithm, req.deadline_ms)
        p = _FleetPending(
            req=req, future=MapFuture(), algorithm=algorithm, tier=tier,
            digest=self._proto.digest(req, algorithm, tier),
            shape_digest=self._proto.shape_digest(req),
            t_submit=time.monotonic())
        with self._cond:
            if self._shutdown:
                raise RuntimeError("fleet is stopped")
            if (self.max_pending is not None
                    and len(self._queue) + len(self._inflight)
                    >= self.max_pending):
                self.stats.rejected += 1
                p.future._fail(QueueFull(
                    f"fleet queue at max_pending={self.max_pending}"))
                return p.future
            self.stats.submitted += 1
            self._queue.append(p)
            self._cond.notify_all()
        return p.future

    def flush(self) -> Dict[str, MapResponse]:
        """Dispatch everything queued and pump monitor/requeue until all
        of it (and anything already in flight) is resolved; returns
        {job_id: response} and re-raises the first failure, exactly like
        the engine's ``flush()`` (cancelled futures are skipped, not
        re-raised)."""
        with self._cond:
            targets = list(self._queue) + [p for p in self._inflight
                                           if not p.resolved]
            ready, self._queue = self._queue, []
            self._dispatch_ready_locked(ready)
        while True:
            with self._cond:
                self._monitor_locked()
                if self._queue:                # requeued orphans
                    ready, self._queue = self._queue, []
                    self._dispatch_ready_locked(ready)
                if all(p.resolved for p in targets):
                    break
                self._cond.wait(timeout=self.tick_s)
        responses: Dict[str, MapResponse] = {}
        first_error: Optional[BaseException] = None
        for p in targets:
            exc = p.future.exception(timeout=0)
            if isinstance(exc, MapCancelled):
                continue                       # the caller abandoned it
            if exc is not None:
                first_error = first_error or exc
            else:
                responses[p.req.job_id] = p.future.result(timeout=0)
        if first_error is not None:
            raise first_error
        return responses

    def map_one(self, C: np.ndarray, M: np.ndarray, algorithm: str = "psa",
                job_id: str = "job", seed: int = 0,
                cache_seed: bool = False,
                deadline_ms: Optional[float] = None) -> MapResponse:
        """Single-request convenience path, mirroring the engine's."""
        fut = self.submit(MapRequest(job_id=job_id, C=np.asarray(C),
                                     M=np.asarray(M), algorithm=algorithm,
                                     seed=seed, cache_seed=cache_seed,
                                     deadline_ms=deadline_ms))
        if not self.running:
            self.flush()
        return fut.result()

    # --------------------------------------------------- dispatcher thread
    @property
    def running(self) -> bool:
        return self._dispatcher is not None and self._dispatcher.is_alive()

    def start(self) -> "EngineFleet":
        """Start the background dispatcher thread (idempotent)."""
        with self._cond:
            if self._shutdown:
                raise RuntimeError("fleet is stopped")
            if self.running:
                return self
            self._stop = False
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, name="fleet-dispatcher",
                daemon=True)
            self._dispatcher.start()
        return self

    def stop(self, flush_pending: bool = True) -> None:
        """Stop the dispatcher, drain (by default), then shut the workers
        down.  Same claim-under-the-lock hand-over as the engine's
        ``stop()``.  A stopped fleet rejects further submits."""
        with self._cond:
            self._stop = True
            dispatcher, self._dispatcher = self._dispatcher, None
            self._cond.notify_all()
        if dispatcher is not None:
            dispatcher.join()
        if flush_pending:
            self.flush()
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        for w in list(self.workers):
            w.shutdown()
        for w in list(self.workers):
            w.join(timeout=5.0)
        for w in list(self.workers):
            w.kill()                       # reap zombies (SIGSTOP'd children)

    def __enter__(self) -> "EngineFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _dispatch_loop(self) -> None:
        me = threading.current_thread()
        while True:
            with self._cond:
                if self._dispatcher is not me or self._stop:
                    return                 # stop() claimed the hand-over
                self._monitor_locked()
                ready, wait_s = self._take_ready_locked()
                if ready:
                    self._dispatch_ready_locked(ready)
                timeout = self.tick_s if wait_s is None \
                    else max(min(wait_s, self.tick_s), 0.001)
                self._cond.wait(timeout=timeout)

    def _take_ready_locked(self
                           ) -> Tuple[List[_FleetPending], Optional[float]]:
        """Engine-style batching for the dispatcher: take full groups and
        groups holding an overdue request; requeued requests (already
        dispatched once) count as overdue immediately -- recovery must
        not wait out a fresh flush deadline."""
        if not self._queue:
            return [], None
        now = time.monotonic()
        deadline_s = self.flush_deadline_ms / 1000.0
        counts: Dict[Tuple[Optional[int], str, str], int] = {}
        due = set()
        for p in self._queue:
            if p.resolved:                 # zombie delivery beat the requeue
                continue
            k = self._group_key(p)
            counts[k] = counts.get(k, 0) + 1
            if p.dispatches > 0 or now - p.t_submit >= deadline_s:
                due.add(k)
        if not counts:
            self._queue = []
            return [], None
        full = {k for k, c in counts.items() if c >= self.max_batch}
        take = full | due
        if take:
            ready = [p for p in self._queue
                     if not p.resolved and self._group_key(p) in take]
            self._queue = [p for p in self._queue
                           if not p.resolved
                           and self._group_key(p) not in take]
            self.stats.full_bucket_flushes += len(full)
            self.stats.deadline_flushes += len(due - full)
            return ready, None
        oldest = min(p.t_submit for p in self._queue if not p.resolved)
        return [], deadline_s - (now - oldest)

    # ------------------------------------------------- dispatch + recovery
    def _group_key(self, p: _FleetPending
                   ) -> Tuple[Optional[int], str, str]:
        return (self._proto._route(p.req.C.shape[0]), p.algorithm, p.tier)

    def _worker_spec(self, wid: int) -> Dict:
        """Child configuration for one subprocess worker: engine kwargs
        plus this worker's slice of the fault plan (the child executes
        its own faults -- real signals, deterministic counts)."""
        plan = self.fault_plan
        cache_dir = None
        if self.worker_cache_dir is not None:
            import os
            cache_dir = os.path.join(self.worker_cache_dir, f"w{wid}")
        return dict(
            wid=wid,
            engine_kwargs=self._engine_kwargs,
            heartbeat_s=self.heartbeat_interval_s,
            beats=plan.beats(wid),
            delay_s=plan.delay_s(wid),
            kill_at=plan.kill_at(wid),
            sigkill_at=plan.sigkill_at(wid),
            sigstop_at=plan.sigstop_at(wid),
            corrupt_at=plan.corrupt_at(wid),
            cache_dir=cache_dir)

    def _spawn_worker_locked(self) -> WorkerBase:
        wid = self._next_wid
        self._next_wid += 1
        if self.transport == "subprocess":
            w: WorkerBase = SubprocessWorker(self, wid,
                                             self._worker_spec(wid))
        else:
            w = EngineWorker(self, wid, self._factory(wid))
        self.workers.append(w)
        w.start()
        return w

    def _pick_worker_locked(self, exclude: Set[int] = frozenset()
                            ) -> Optional[WorkerBase]:
        live = [w for w in self.workers
                if w.alive and w.wid not in exclude]
        if not live:
            return None
        now = time.monotonic()
        closed = [w for w in live if now >= w.breaker_open_until]
        # All breakers open: degrade to least-bad rather than deadlock --
        # the breaker sheds load onto healthy peers, it never refuses the
        # last resort.
        pool = closed or live
        return min(pool, key=lambda w: (w.outstanding, w.last_assigned,
                                        w.wid))

    def _dispatch_ready_locked(self, ready: List[_FleetPending]) -> None:
        """Shared-cache pass, then group misses and assign waves
        fewest-outstanding-first (caller holds the lock)."""
        groups: Dict[Tuple[Optional[int], str, str],
                     List[_FleetPending]] = OrderedDict()
        for p in ready:
            if p.resolved:
                continue
            if p.future.done():            # cancelled by the caller
                p.resolved = True
                self._inflight.discard(p)
                self.stats.cancelled += 1
                continue
            hit = self._cache.get(p.digest)
            if hit is not None:
                self._cache.move_to_end(p.digest)
                perm, objective = hit
                self.stats.cache_hits += 1
                self._resolve_locked(
                    p, self._cached_response(p, perm, objective))
                continue
            groups.setdefault(self._group_key(p), []).append(p)
        for ps in groups.values():
            for i in range(0, len(ps), self.max_batch):
                self._assign_wave_locked(ps[i:i + self.max_batch])

    def _assign_wave_locked(self, wave: List[_FleetPending],
                            exclude: Set[int] = frozenset()
                            ) -> Optional[WorkerBase]:
        w = self._pick_worker_locked(exclude)
        if w is None:
            if exclude:
                return None        # straggler duplicate: never respawn for it
            now = time.monotonic()
            if now < self._respawn_not_before:
                # Backoff window after a failed generation of workers:
                # requeue; the dispatcher/flush pump retries next tick.
                self._queue.extend(wave)
                return None
            w = self._spawn_worker_locked()
            self.stats.respawns += 1
            self._respawn_attempts += 1
            backoff = min(
                self.respawn_backoff_s * (2 ** (self._respawn_attempts - 1)),
                self.respawn_backoff_max_s)
            # Deterministically-seeded jitter decorrelates respawn storms
            # without breaking test reproducibility.
            self._respawn_not_before = now + backoff * (
                1.0 + 0.5 * self._jitter.random())
        now = time.monotonic()
        for p in wave:
            p.holders.add(w.wid)
            p.dispatches += 1
            p.last_dispatch = now
            w.assigned.add(p)
            self._inflight.add(p)
        w.enqueue_wave(list(wave))
        w.outstanding += len(wave)
        w.last_assigned = self._assign_seq
        self._assign_seq += 1
        self.stats.dispatched_waves += 1
        self._cond.notify_all()
        return w

    def _monitor_locked(self) -> None:
        """Failure detector, deadline wall, and straggler re-dispatch
        (caller holds the lock); called from every flush pump tick and
        dispatcher tick."""
        now = time.monotonic()
        if self.heartbeat_timeout_s is not None:
            for w in list(self.workers):
                if not w.alive:
                    continue
                limit = self.heartbeat_timeout_s
                if w.completed == 0:
                    limit += self.compiling_grace_s   # cold compile != hang
                if now - w.last_beat > limit:
                    self._declare_dead_locked(w)
        # Deadline hard wall: queued or in flight, an expired request is
        # answered *now* by the degradation ladder; the real result, if it
        # ever lands, is eaten by the first-result-wins guard.
        for p in list(self._queue) + list(self._inflight):
            if p.resolved or p.req.deadline_ms is None:
                continue
            if (now - p.t_submit) * 1000.0 >= p.req.deadline_ms:
                self._degrade_locked(p)
        if self.straggler_after_s is not None:
            overdue = [p for p in list(self._inflight)
                       if not p.resolved
                       and p.dispatches < self.max_dispatches
                       and now - p.last_dispatch > self.straggler_after_s]
            for p in overdue:
                if self._assign_wave_locked([p], exclude=set(p.holders)):
                    self.stats.straggler_redispatches += 1

    def _declare_dead_locked(self, w: WorkerBase) -> None:
        if not w.alive:
            return
        w.alive = False
        self.stats.worker_deaths += 1
        self._reap_locked(w)

    def _reap_locked(self, w: WorkerBase) -> None:
        """Requeue every unresolved request a dead worker held, unless a
        straggler duplicate is still in flight elsewhere."""
        w.inbox.clear()
        orphans, w.assigned = w.assigned, set()
        w.outstanding = 0
        requeues = 0
        for p in orphans:
            p.holders.discard(w.wid)
            if p.resolved or p.holders:
                continue
            self._inflight.discard(p)
            p.requeued = True
            self._queue.append(p)
            requeues += 1
        self.stats.requeued += requeues
        if requeues and self._last_death_t is None:
            self._last_death_t = time.monotonic()   # recovery clock starts
        self._cond.notify_all()

    # -------------------------------------------------- delivery (workers)
    def _release_locked(self, w: WorkerBase, p: _FleetPending) -> None:
        w.assigned.discard(p)
        w.outstanding = max(0, w.outstanding - 1)
        w.completed += 1
        if self.fault_plan.beats(w.wid):
            w.last_beat = time.monotonic()
        p.holders.discard(w.wid)

    def _deliver_locked(self, w: WorkerBase, p: _FleetPending,
                        resp: MapResponse) -> None:
        self._release_locked(w, p)
        w.consecutive_failures = 0         # breaker half-open -> closed
        self._respawn_attempts = 0         # the fleet is producing again
        self._respawn_not_before = 0.0
        # Cache before the resolved guard: a real result that lost to a
        # deadline degrade (or a straggler duplicate) still warms both
        # tiers for the next identical / same-shape request.
        self._cache_put_locked(p.digest, resp.perm, resp.objective)
        self._shape_put_locked(p.shape_digest, resp.perm)
        if p.resolved:                     # first result won already
            self.stats.duplicate_results += 1
            return
        self._resolve_locked(p, resp)

    def _fail_locked(self, w: WorkerBase, p: _FleetPending,
                     exc: BaseException) -> None:
        self._release_locked(w, p)
        w.consecutive_failures += 1
        if (self.breaker_failures > 0
                and w.consecutive_failures >= self.breaker_failures):
            now = time.monotonic()
            if now >= w.breaker_open_until:
                w.breaker_open_until = now + self.breaker_cooldown_s
                self.stats.breaker_trips += 1
        if p.resolved:
            self.stats.duplicate_results += 1
            return
        p.resolved = True
        self._inflight.discard(p)
        if p.future._fail(exc):
            self.stats.failed += 1
        else:
            self.stats.cancelled += 1      # the caller cancelled first
        self._cond.notify_all()

    def _resolve_locked(self, p: _FleetPending, resp: MapResponse) -> None:
        p.resolved = True
        self._inflight.discard(p)
        if p.future._resolve(resp):
            self.stats.resolved += 1
            if (p.requeued and self._last_death_t is not None
                    and self.stats.first_recovery_s is None):
                self.stats.first_recovery_s = (
                    time.monotonic() - self._last_death_t)
        else:
            self.stats.cancelled += 1      # the caller cancelled first
        self._cond.notify_all()

    # ------------------------------------------------- deadline degradation
    def _degrade_locked(self, p: _FleetPending) -> None:
        """Answer an expired request from the degradation ladder: the
        shape tier's last real permutation for the same (order, system
        graph) when it exists and is no worse than identity, else the
        deterministic identity/as-allocated placement.  Flagged
        ``degraded=True`` with the reason code; never enters the exact
        cache (it is not a solve)."""
        req = p.req
        n = req.C.shape[0]
        C = np.asarray(req.C, np.float64)
        M = np.asarray(req.M, np.float64)
        baseline = float((C * M).sum())
        perm: Optional[np.ndarray] = None
        objective = baseline
        reason = "deadline_identity"
        hit = self._shape_perms.get(p.shape_digest)
        if hit is not None and hit.shape[0] == n:
            cand = float((C * M[np.ix_(hit, hit)]).sum())
            if cand <= baseline:           # never worse than identity
                perm, objective = hit, cand
                reason = "deadline_shape_cache"
        if perm is None:
            perm = np.arange(n, dtype=np.int32)
        resp = MapResponse(
            job_id=req.job_id, perm=np.array(perm, copy=True),
            objective=float(objective), baseline=baseline,
            algorithm=p.algorithm, n=n, bucket=self._proto._route(n),
            cached=False, seconds=0.0, batch_size=0, tier=p.tier,
            warm_start=False, degraded=True, degrade_reason=reason)
        self.stats.degraded += 1
        # Drop it from the queue slice it may still occupy; holders (if
        # any) deliver into the duplicate guard later.
        self._queue = [q for q in self._queue if q is not p]
        self._resolve_locked(p, resp)

    # -------------------------------------------------------- shared cache
    def _cache_put_locked(self, digest: str, perm: np.ndarray,
                          objective: float) -> None:
        self._cache[digest] = (np.array(perm, copy=True), float(objective))
        self._cache.move_to_end(digest)
        while len(self._cache) > self.shared_cache_size:
            self._cache.popitem(last=False)

    def _shape_put_locked(self, shape_digest: str, perm: np.ndarray) -> None:
        self._shape_perms[shape_digest] = np.array(perm, copy=True)
        self._shape_perms.move_to_end(shape_digest)
        while len(self._shape_perms) > self.shared_cache_size:
            self._shape_perms.popitem(last=False)

    def _cached_response(self, p: _FleetPending, perm: np.ndarray,
                         objective: float) -> MapResponse:
        """Shared-tier hit: same response shape the engine's exact tier
        produces (cached=True, zero amortized seconds, batch_size=0),
        including the never-worse-than-identity guard."""
        req = p.req
        n = req.C.shape[0]
        baseline = float((np.asarray(req.C, np.float64)
                          * np.asarray(req.M, np.float64)).sum())
        if objective > baseline:
            perm, objective = np.arange(n, dtype=np.int32), baseline
        return MapResponse(
            job_id=req.job_id, perm=np.array(perm, copy=True),
            objective=float(objective), baseline=baseline,
            algorithm=p.algorithm, n=n,
            bucket=self._proto._route(n), cached=True, seconds=0.0,
            batch_size=0, tier=p.tier, warm_start=False)

