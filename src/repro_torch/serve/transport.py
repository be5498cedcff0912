"""Worker transport seam: process-isolated fleet workers.

The port of ``repro/serve/transport.py``.  The thread-backed
:class:`~repro_torch.serve.fleet.EngineFleet` survives *thread* deaths,
but its workers share one interpreter: one GIL, one device set, one blast
radius -- a segfaulting or OOM-killed solver takes the coordinator (and
every queued job) with it.  This module puts the coordinator/worker split
behind an explicit transport seam so workers can live in their own
processes:

  1. :class:`WorkerTransport` is the protocol the coordinator codes
     against; :class:`WorkerBase` carries the coordinator-side bookkeeping
     every implementation shares (assignment set, heartbeat stamp, circuit
     breaker counters).  The thread-backed
     :class:`~repro_torch.serve.fleet.EngineWorker` is one implementation;
     :class:`SubprocessWorker` here is the other.
  2. :class:`SubprocessWorker` spawns a fresh interpreter running
     :func:`worker_main` (:data:`WORKER_COMMAND`), which builds its own
     private :class:`~repro_torch.serve.mapper.MappingEngine` and exchanges
     **length-prefixed pickle frames** over its stdin/stdout pipes
     (4-byte big-endian length + pickle payload; stderr passes through
     for tracebacks).  Parent->child frames: ``("wave", [(token, req),
     ...])`` and ``("stop",)``; child->parent: ``("ready",)``,
     ``("beat",)`` (a background heartbeat thread), ``("stats", batches,
     calls)`` and per-request ``("result", token, response)`` /
     ``("error", token, exc)``.
  3. Failure detection needs no cooperation from the child: a SIGKILL'd
     or crashed worker closes its stdout pipe (reader sees EOF), a
     corrupted stream raises :class:`FrameError` (pickle streams cannot
     be resynchronized, so the worker is declared dead and its requests
     requeued), and a SIGSTOP'd zombie freezes both its solve and its
     heartbeat thread, which the coordinator's staleness detector
     catches.  All three are injectable deterministically through
     :class:`~repro_torch.serve.fleet.FaultPlan` -- the *child* executes the
     fault on itself after completing exactly k requests, so recovery is
     exercised against real signals, not simulations.
  4. The child's engine runs where its ``engine_kwargs`` say: on the
     card (``cuda``) unless they carry ``device="cpu"``; a child that
     finds no card raises instead of carrying on on the CPU.  A child
     keeps its CUDA context and device memory until it exits, so a
     SIGSTOP'd one holds them until :meth:`SubprocessWorker.kill`.  There
     is no compilation cache to share: every child loads the kernel
     libraries the first build wrote under
     ``build/repro_torch_kernels/<hash>/`` (``kernels/build.py`` writes
     each through a per-process temporary file and ``os.replace``, so
     children that build at once are safe).  ``worker_cache_dir`` is kept
     for the reference's signature: the child creates its directory and
     puts nothing there.
  5. The frame stream is a duplicate of the child's fd 1, and fd 1
     itself is pointed at stderr when :func:`worker_main` starts, before
     it reads the spec or builds the engine, so nothing the child prints
     from then on -- Python, a C library, a compiler's output -- can land
     in the stream.

Determinism: the child engine runs the exact kwargs the fleet would give
a thread worker (``warm_start=False``), and pickle round-trips requests
and responses losslessly (numpy arrays bit-for-bit), so a subprocess
fleet stays bitwise-identical to a single engine -- under any fault plan
that leaves the respawn path alive (``tests/test_torch_transport.py``
pins this against both packages).
"""
from __future__ import annotations

import os
import pickle
import signal
import struct
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Protocol, Set

_HEADER = struct.Struct(">I")
_MAX_FRAME = 1 << 31            # sanity bound: a length beyond this is noise

# Child-side heartbeat interval; the coordinator's staleness timeout must
# be comfortably larger (the fleet default is 15 s for subprocess workers).
DEFAULT_HEARTBEAT_INTERVAL_S = 0.25


# What a spawned child runs.  -c (not -m): runpy would re-execute this
# module under __main__ while repro_torch.serve already imported it,
# double-defining classes.
WORKER_COMMAND = ("import sys; "
                  "from repro_torch.serve.transport import worker_main; "
                  "sys.exit(worker_main())")


class FrameError(RuntimeError):
    """The frame stream is corrupt (bad length or undecodable payload).

    A pickle stream has no framing to resynchronize on, so the only safe
    reaction is to declare the worker dead and requeue its requests."""


def write_frame(stream, obj: Any,
                lock: Optional[threading.Lock] = None) -> None:
    """Serialize one frame (4-byte big-endian length + pickle) and flush.

    ``lock`` serializes concurrent writers on one pipe (the child's
    heartbeat thread vs its delivery loop; partial interleaved frames
    would corrupt the stream for good)."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    data = _HEADER.pack(len(payload)) + payload
    if lock is None:
        stream.write(data)
        stream.flush()
    else:
        with lock:
            stream.write(data)
            stream.flush()


def read_frame(stream) -> Any:
    """Read one frame; raises ``EOFError`` on a cleanly closed pipe and
    :class:`FrameError` on garbage (truncated length/payload included --
    a worker that died mid-write looks corrupt, not clean)."""
    header = stream.read(_HEADER.size)
    if not header:
        raise EOFError("frame stream closed")
    if len(header) < _HEADER.size:
        raise FrameError("truncated frame header")
    (length,) = _HEADER.unpack(header)
    if length > _MAX_FRAME:
        raise FrameError(f"implausible frame length {length}")
    payload = stream.read(length)
    if len(payload) < length:
        raise FrameError("truncated frame payload")
    try:
        return pickle.loads(payload)
    except Exception as e:
        raise FrameError(f"undecodable frame: {e!r}") from e


class WorkerTransport(Protocol):
    """What the fleet coordinator requires of a worker, whatever its
    backing.  All mutable state is guarded by the *fleet's* lock; the
    methods below are called with that lock held unless noted.

    Implementations: :class:`~repro_torch.serve.fleet.EngineWorker` (thread)
    and :class:`SubprocessWorker` (process)."""

    wid: int
    alive: bool
    assigned: Set                  # _FleetPending instances in flight here
    outstanding: int
    completed: int
    last_beat: float
    last_assigned: int
    consecutive_failures: int      # circuit-breaker input
    breaker_open_until: float      # monotonic deadline the breaker is open

    def start(self) -> None: ...
    def enqueue_wave(self, wave: List) -> None: ...
    def shutdown(self) -> None: ...         # graceful stop signal
    def join(self, timeout: Optional[float] = None) -> None: ...
    def kill(self) -> None: ...             # forceful teardown (idempotent)


class WorkerBase:
    """Coordinator-side bookkeeping shared by every transport."""

    def __init__(self, fleet, wid: int):
        self.fleet = fleet
        self.wid = wid
        self.inbox: deque = deque()        # outbound waves; fleet lock
        self.assigned: Set = set()
        self.alive = True
        self.completed = 0                 # delivered results (fault counters)
        self.outstanding = 0
        self.last_beat = time.monotonic()
        self.last_assigned = 0             # dispatch tie-break sequence
        self.consecutive_failures = 0      # circuit breaker: reset on success
        self.breaker_open_until = 0.0

    def start(self) -> None:
        raise NotImplementedError

    def enqueue_wave(self, wave: List) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:            # pragma: no cover - thread no-op
        pass

    def join(self, timeout: Optional[float] = None) -> None:
        raise NotImplementedError

    def kill(self) -> None:                # pragma: no cover - thread no-op
        pass


def _portable_exc(exc: BaseException) -> BaseException:
    """An exception safe to pickle across the pipe (some carry
    unpicklable state; degrade those to a RuntimeError with the repr)."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:
        return RuntimeError(f"{type(exc).__name__}: {exc}")


class SubprocessWorker(WorkerBase):
    """One process-backed worker: a spawned interpreter running
    :func:`worker_main`, fed waves over stdin and read on a parent-side
    reader thread that calls the same ``_deliver_locked`` /
    ``_fail_locked`` coordinator callbacks as the thread transport.

    ``spec`` is the pickled child configuration: ``engine_kwargs`` (the
    child builds ``MappingEngine(**engine_kwargs)``), the per-worker
    fault slice (``delay_s`` / ``kill_at`` / ``sigkill_at`` /
    ``sigstop_at`` / ``corrupt_at`` / ``beats``), ``heartbeat_s``, and
    an optional ``cache_dir`` (created, left empty: see the module
    docstring).  A parent-side *writer* thread drains the outbound queue so
    ``enqueue_wave`` never blocks under the fleet lock, even when a
    SIGSTOP'd child stops draining its pipe.
    """

    def __init__(self, fleet, wid: int, spec: Dict[str, Any]):
        super().__init__(fleet, wid)
        self.spec = spec
        self._proc: Optional[subprocess.Popen] = None
        self._tokens: Dict[int, Any] = {}   # token -> _FleetPending
        self._next_token = 0
        self._closing = False               # graceful stop in progress
        self._wlock = threading.Lock()
        self._reader: Optional[threading.Thread] = None
        self._writer: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        env = dict(os.environ)
        # The child must import repro_torch from the same tree as the
        # parent, however the parent was launched.
        src_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
        cache_dir = self.spec.get("cache_dir")
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self._proc = subprocess.Popen(
            [sys.executable, "-c", WORKER_COMMAND],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=None, env=env)
        write_frame(self._proc.stdin, self.spec, self._wlock)
        self._reader = threading.Thread(
            target=self._read_loop, name=f"fleet-sub-r{self.wid}",
            daemon=True)
        self._writer = threading.Thread(
            target=self._write_loop, name=f"fleet-sub-w{self.wid}",
            daemon=True)
        self._reader.start()
        self._writer.start()

    def enqueue_wave(self, wave: List) -> None:
        """Caller holds the fleet lock.  Tokens tie each request to its
        pending across the pipe; the writer thread does the actual
        (possibly blocking) pipe write."""
        items = []
        for p in wave:
            token = self._next_token
            self._next_token += 1
            self._tokens[token] = p
            items.append((token, p.req))
        self.inbox.append(("wave", items))

    def shutdown(self) -> None:
        with self.fleet._cond:
            self._closing = True
            self.fleet._cond.notify_all()

    def join(self, timeout: Optional[float] = None) -> None:
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else 3600.0)
        for t in (self._writer, self._reader):
            if t is not None and t.is_alive():
                t.join(max(0.0, deadline - time.monotonic()))
        if self._proc is not None and self._proc.poll() is None:
            try:
                self._proc.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass

    def kill(self) -> None:
        """Forceful teardown: SIGCONT first (a SIGSTOP'd zombie cannot
        process SIGTERM while stopped... SIGKILL works regardless, but
        CONT keeps the process table clean on platforms that queue the
        stop), then SIGKILL, then reap.  Only ``EngineFleet.stop`` calls
        this, after the dispatcher has exited, so clearing ``alive`` here
        cannot race the staleness monitor."""
        self.alive = False
        proc = self._proc
        if proc is None:
            return
        if proc.poll() is None:
            for sig in (signal.SIGCONT, signal.SIGKILL):
                try:
                    proc.send_signal(sig)
                except (ProcessLookupError, OSError):
                    break
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:   # pragma: no cover
                pass
        for stream in (proc.stdin, proc.stdout):
            try:
                if stream is not None:
                    stream.close()
            except OSError:                     # pragma: no cover
                pass

    # ------------------------------------------------------- parent threads
    def _write_loop(self) -> None:
        fleet = self.fleet
        proc = self._proc
        while True:
            with fleet._cond:
                while (self.alive and not self._closing
                       and not fleet._shutdown and not self.inbox):
                    fleet._cond.wait(timeout=fleet.tick_s)
                if not self.alive or self._closing or fleet._shutdown:
                    break
                msg = self.inbox.popleft()
            try:
                write_frame(proc.stdin, msg, self._wlock)
            except (OSError, ValueError):
                # Broken pipe: the reader (EOF) or staleness detector
                # declares the death; just stop writing.
                return
        try:
            if self._closing or fleet._shutdown:
                write_frame(proc.stdin, ("stop",), self._wlock)
            proc.stdin.close()          # EOF fallback: child exits anyway
        except (OSError, ValueError):
            pass

    def _read_loop(self) -> None:
        fleet = self.fleet
        proc = self._proc
        try:
            while True:
                msg = read_frame(proc.stdout)
                kind = msg[0]
                if kind in ("beat", "ready"):
                    with fleet._cond:
                        if fleet.fault_plan.beats(self.wid):
                            self.last_beat = time.monotonic()
                elif kind == "stats":
                    with fleet._cond:
                        fleet.stats.solver_batches += msg[1]
                        fleet.stats.solver_calls += msg[2]
                elif kind == "result":
                    with fleet._cond:
                        p = self._tokens.pop(msg[1], None)
                        if p is not None:
                            # Same callback the thread transport uses;
                            # first-result-wins handles zombie deliveries
                            # from a declared-dead worker.
                            fleet._deliver_locked(self, p, msg[2])
                elif kind == "error":
                    with fleet._cond:
                        p = self._tokens.pop(msg[1], None)
                        if p is not None:
                            fleet._fail_locked(self, p, msg[2])
        except (EOFError, FrameError, OSError, ValueError):
            pass
        with fleet._cond:
            if not (self._closing or fleet._shutdown):
                fleet._declare_dead_locked(self)


# ---------------------------------------------------------------- child side
def _beat_loop(stream, lock: threading.Lock, interval_s: float,
               stop: threading.Event) -> None:
    while not stop.wait(interval_s):
        try:
            write_frame(stream, ("beat",), lock)
        except (OSError, ValueError):       # parent went away
            return


def worker_main(stdin=None, stdout=None) -> int:
    """Child entry point (spawned by :meth:`SubprocessWorker.start`):
    read the init spec, build a private engine, then serve waves until
    EOF/stop.

    Injected faults execute *between deliveries*, count-based on the
    number of completed requests -- exactly the thread transport's
    ``kill_worker_at`` semantics -- so the same plan on the same stream
    faults at the same request every run:

    - ``kill_at``: plain ``sys.exit`` (clean crash; parent sees EOF),
    - ``sigkill_at``: ``SIGKILL`` to self (no cleanup, no EOF flush
      races -- the hard death),
    - ``sigstop_at``: ``SIGSTOP`` to self (a genuine zombie: solve and
      heartbeats freeze, the pipe stays open; only the coordinator's
      staleness detector can tell),
    - ``corrupt_at``: write garbage bytes into the frame stream, then
      exit (the parent must fail the stream, not deliver junk).
    """
    stdin = stdin if stdin is not None else sys.stdin.buffer
    if stdout is None:
        # Frames go to a duplicate of fd 1; fd 1 itself goes to stderr, so
        # whatever prints (Python, a C library, nvcc) cannot land in the
        # frame stream.
        sys.stdout.flush()
        out = os.fdopen(os.dup(1), "wb")
        os.dup2(2, 1)
        sys.stdout = sys.stderr
    else:
        out = stdout
    spec = read_frame(stdin)
    cache_dir = spec.get("cache_dir")
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
    from repro_torch.serve.mapper import MappingEngine
    engine = MappingEngine(**spec["engine_kwargs"])
    wlock = threading.Lock()
    stop_beats = threading.Event()
    if spec.get("beats", True):
        threading.Thread(
            target=_beat_loop,
            args=(out, wlock, spec.get("heartbeat_s",
                                       DEFAULT_HEARTBEAT_INTERVAL_S),
                  stop_beats),
            daemon=True).start()
    write_frame(out, ("ready",), wlock)

    delay_s = float(spec.get("delay_s", 0.0))
    kill_at = spec.get("kill_at")
    sigkill_at = spec.get("sigkill_at")
    sigstop_at = spec.get("sigstop_at")
    corrupt_at = spec.get("corrupt_at")
    completed = 0
    stopped_once = False
    while True:
        try:
            msg = read_frame(stdin)
        except (EOFError, FrameError):
            break
        if msg[0] == "stop":
            break
        _, items = msg
        if delay_s > 0:
            time.sleep(delay_s)
        b0, c0 = engine.stats.solver_batches, engine.stats.solver_calls
        try:
            futs = [(token, engine.submit(req)) for token, req in items]
            engine.flush()
        except BaseException as e:
            # Whole-wave failure is deterministic (any worker would fail
            # it): report per request instead of dying.
            err = _portable_exc(e)
            for token, _ in items:
                write_frame(out, ("error", token, err), wlock)
            continue
        write_frame(out, ("stats", engine.stats.solver_batches - b0,
                          engine.stats.solver_calls - c0), wlock)
        for token, fut in futs:
            if kill_at is not None and completed >= kill_at:
                stop_beats.set()
                return 3
            if sigkill_at is not None and completed >= sigkill_at:
                out.flush()
                os.kill(os.getpid(), signal.SIGKILL)
            if (sigstop_at is not None and completed >= sigstop_at
                    and not stopped_once):
                stopped_once = True
                out.flush()
                os.kill(os.getpid(), signal.SIGSTOP)
                # Only reached if someone SIGCONTs the zombie: it keeps
                # delivering, exercising the first-result-wins guard.
            if corrupt_at is not None and completed >= corrupt_at:
                with wlock:
                    out.write(b"\xde\xad\xbe\xef" * 16)
                    out.flush()
                stop_beats.set()
                return 4
            exc = fut.exception(timeout=0)
            if exc is not None:
                write_frame(out, ("error", token, _portable_exc(exc)), wlock)
            else:
                write_frame(out, ("result", token, fut.result(timeout=0)),
                            wlock)
            completed += 1
    stop_beats.set()
    return 0


if __name__ == "__main__":                  # pragma: no cover - child entry
    sys.exit(worker_main())
