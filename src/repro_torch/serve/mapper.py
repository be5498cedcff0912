"""Async, deadline-aware mapping service on the card: the port of
``repro/serve/mapper.py``.

The resource manager submits a job's flow graph ``C`` and its
allocation's distance graph ``M`` and gets back a permutation:

  1. :meth:`MappingEngine.submit` is non-blocking and returns a
     :class:`MapFuture`; a background flusher thread (``start()`` /
     ``stop()``) dispatches a (bucket, algorithm, tier) group when it
     fills (``max_batch``) or when its oldest request reaches
     ``flush_deadline_ms``; ``flush()`` runs the same code synchronously.
  2. A :class:`DeadlinePolicy` picks algorithm and budget tier per request.
  3. Each instance is padded to the smallest bucket (32/64/128), the wave
     padded to a power of two, and solved by one batched call on the
     engine's device -- ``annealing.run_psa_batch``,
     ``genetic.run_pga_batch`` or ``composite.run_pca_batch`` -- then
     refined by ``mapping.polish_batch``.  Padding is exact: flows touching
     padded slots are zeroed and the solvers keep real processes on real
     nodes.
  4. Orders above every dense bucket and at least ``multilevel_min_n``
     (256) group under the large buckets 512/1024/4096 and are solved one
     at a time at exact size by ``core.multilevel.solve_multilevel``:
     host-side coarsening, a dense coarse solve, warm-started sparse SA
     on each level and a sparse final polish (kernels K1, K6 and K7).
  5. An exact-digest LRU serves repeats; a shape-tier (order + system
     graph) near miss warm-starts the solve from the cached permutation
     (not on the multilevel route, whose coarse solve is the seed).
  6. With ``mesh`` (a ``launch.mesh.Mesh`` of local devices) bucket waves
     dispatch through ``core.batch_sharded``, the instance axis split
     over ``mesh.shape[instance_axis]`` devices -- bitwise-identical
     results, one wave solved by N devices instead of one.

The same request gives the same permutation as the reference engine: the
solvers replay its random streams and arithmetic bit for bit.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core import (annealing, batch_sharded, composite, genetic, keys,
                    mapping as mapping_lib, multilevel)
from ..kernels import build
from ..launch.mesh import canonical_device

DEFAULT_BUCKETS = (32, 64, 128)

# Routing labels for the sparse/multilevel path: orders above the dense
# buckets (and >= multilevel_min_n) group under the smallest large bucket
# that holds them and solve via core.multilevel at exact size.
LARGE_BUCKETS = (512, 1024, 4096)

ALGORITHMS = ("psa", "pga", "pca")
AUTO = "auto"                       # algorithm chosen by the deadline policy

TIERS = ("default", "tight")


class QueueFull(RuntimeError):
    """Admission control: the engine queue is at ``max_pending``.
    :meth:`MappingEngine.submit` returns an already-failed future carrying
    it rather than raising."""


class MapCancelled(RuntimeError):
    """Raised by :meth:`MapFuture.result` after :meth:`MapFuture.cancel`."""


@dataclass(frozen=True, kw_only=True)
class MapRequest:
    """One job's mapping problem: program graph C, system graph M.

    Keyword-only and frozen, with the reference's fields in its order.
    ``cache_seed=True`` folds the seed into the cache digest (independent
    restarts); ``deadline_ms`` with ``algorithm="auto"`` lets the
    :class:`DeadlinePolicy` pick the algorithm and budget.
    """
    job_id: str
    C: np.ndarray              # (n, n) flow matrix
    M: np.ndarray              # (n, n) distance matrix
    algorithm: str = "psa"
    seed: int = 0
    cache_seed: bool = False
    deadline_ms: Optional[float] = None


@dataclass(frozen=True, kw_only=True)
class MapResponse:
    """One solved mapping (the reference's fields in its order)."""
    job_id: str
    perm: np.ndarray           # (n,) process -> node
    objective: float           # F(perm)
    baseline: float            # F(identity)
    algorithm: str             # resolved algorithm (policy applied)
    n: int
    bucket: Optional[int]      # padded size (None = solved at exact size)
    cached: bool
    seconds: float             # amortized wall time: group wall / batch_size
    batch_size: int = 1        # requests served by the dispatch (0 = cached)
    tier: str = "default"      # solver budget tier the policy picked
    warm_start: bool = False   # solve was seeded from a near-miss cache hit
    degraded: bool = False     # deadline fallback, not a real solve
    degrade_reason: str = ""

    @property
    def improvement(self) -> float:
        if self.baseline == 0:
            return 0.0
        return (self.baseline - self.objective) / self.baseline


class MapFuture:
    """Handle for one submitted request, resolved by a flush.

    Resolution is claimed under a per-future lock: exactly one of
    ``_resolve`` / ``_fail`` / :meth:`cancel` wins.  ``resolved_at`` is
    the ``time.monotonic()`` stamp of resolution.
    """

    __slots__ = ("_event", "_response", "_exception", "resolved_at",
                 "_claim", "_cancelled")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._response: Optional[MapResponse] = None
        self._exception: Optional[BaseException] = None
        self.resolved_at: Optional[float] = None
        self._claim = threading.Lock()
        self._cancelled = False

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        """Abandon the request; False when it already resolved."""
        return self._fail(MapCancelled("mapping request cancelled by caller"),
                          cancelled=True)

    def result(self, timeout: Optional[float] = None) -> MapResponse:
        if not self._event.wait(timeout):
            raise TimeoutError("mapping future not resolved within timeout")
        if self._exception is not None:
            raise self._exception
        if self._response is None:
            raise RuntimeError("future resolved without a response")
        return self._response

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError("mapping future not resolved within timeout")
        return self._exception

    def _resolve(self, response: MapResponse) -> bool:
        with self._claim:
            if self._event.is_set():
                return False
            self._response = response
            self.resolved_at = time.monotonic()
            self._event.set()
            return True

    def _fail(self, exc: BaseException, cancelled: bool = False) -> bool:
        with self._claim:
            if self._event.is_set():
                return False
            self._exception = exc
            self._cancelled = cancelled
            self.resolved_at = time.monotonic()
            self._event.set()
            return True


@dataclass(frozen=True)
class DeadlinePolicy:
    """Deadline -> (algorithm, solver-budget tier), after paper S5: PSA on
    the reduced "tight" budget at ``deadline_ms <= tight_ms``, the
    composite algorithm from ``slack_ms`` up, PSA otherwise.  An explicit
    algorithm is honoured; the deadline then only picks the tier."""
    tight_ms: float = 200.0
    slack_ms: float = 2000.0

    def resolve(self, algorithm: str,
                deadline_ms: Optional[float]) -> Tuple[str, str]:
        tier = "tight" if (deadline_ms is not None
                           and deadline_ms <= self.tight_ms) else "default"
        if algorithm != AUTO:
            return algorithm, tier
        if deadline_ms is None:
            return "psa", "default"
        if tier == "tight":
            return "psa", "tight"
        if deadline_ms >= self.slack_ms:
            return "pca", "default"
        return "psa", "default"


@dataclass
class EngineStats:
    submitted: int = 0
    cache_hits: int = 0
    warm_starts: int = 0       # solves seeded from a shape-tier near miss
    solver_batches: int = 0    # batched dispatches issued
    solver_calls: int = 0      # instances that went through a solver
    full_bucket_flushes: int = 0
    deadline_flushes: int = 0
    warmup_programs: int = 0   # dummy waves run by warmup()
    cancelled: int = 0
    rejected: int = 0          # submits refused by max_pending


@dataclass
class _Pending:
    req: MapRequest
    future: MapFuture
    algorithm: str             # resolved by the deadline policy
    tier: str
    t_submit: float            # time.monotonic()


def validate_request(req: MapRequest) -> None:
    """Reject malformed requests in the caller's thread."""
    if req.algorithm not in ALGORITHMS + (AUTO,):
        raise ValueError(f"algorithm must be one of {ALGORITHMS + (AUTO,)}")
    if req.C.shape != req.M.shape or req.C.shape[0] != req.C.shape[1]:
        raise ValueError("C and M must be square and same order")
    for name, a in (("C", req.C), ("M", req.M)):
        if not np.issubdtype(np.asarray(a).dtype, np.number) or \
                np.iscomplexobj(a):
            raise ValueError(f"{name} must be a real numeric matrix")


def _tighten_sa(cfg: annealing.SAConfig) -> annealing.SAConfig:
    """Reduced-budget SA for the tight deadline tier (~1/4 the work)."""
    return replace(cfg, num_exchanges=max(1, cfg.num_exchanges // 2),
                   solvers=max(1, cfg.solvers // 2))


def _tighten_ga(cfg: genetic.GAConfig) -> genetic.GAConfig:
    """Reduced-budget GA for the tight deadline tier (half the
    generations)."""
    return replace(cfg, generations=max(1, cfg.generations // 2))


class MappingEngine:
    """submit -> future; queue -> bucket -> batched solve -> two-tier cache.

    Runs its solves on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``).  Call :meth:`start` for the background flusher (or
    use the engine as a context manager); without it, :meth:`flush`.

    With ``mesh`` the bucket waves are sharded over the mesh's
    ``instance_axis`` (``core.batch_sharded``); ``device`` then stages
    the waves and polishes them, and is the mesh's first device (the
    default) or an error.
    """

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 cache_size: int = 256, num_processes: int = 2,
                 sa_cfg: Optional[annealing.SAConfig] = None,
                 ga_cfg: Optional[genetic.GAConfig] = None,
                 polish_rounds: int = 200,
                 flush_deadline_ms: float = 20.0,
                 max_batch: int = 32,
                 policy: Optional[DeadlinePolicy] = None,
                 warm_start: bool = True,
                 pad_batches: bool = True,
                 mesh=None,
                 instance_axis: str = batch_sharded.DEFAULT_AXIS,
                 large_buckets: Sequence[int] = LARGE_BUCKETS,
                 multilevel_min_n: int = 256,
                 multilevel_cfg: Optional[multilevel.MultilevelConfig] = None,
                 max_pending: Optional[int] = None,
                 device=None):
        # mesh: results are bitwise-equal to the unsharded path, so the
        # cache digest does not include the mesh.
        if mesh is not None:
            if instance_axis not in mesh.shape:
                raise ValueError(
                    f"mesh has no axis {instance_axis!r}; "
                    f"axes: {tuple(mesh.shape)}")
            first = mesh.devices.flat[0]
            if device is None:
                device = first
            elif canonical_device(resolve_device(device)) != first:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {first}")
        self.mesh = mesh
        self.instance_axis = instance_axis
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets:
            raise ValueError("need at least one size bucket")
        self.large_buckets = tuple(sorted(int(b) for b in large_buckets))
        self._large_set = frozenset(self.large_buckets) - frozenset(self.buckets)
        self.multilevel_min_n = int(multilevel_min_n)
        self.multilevel_cfg = multilevel_cfg or multilevel.MultilevelConfig()
        self.cache_size = int(cache_size)
        self.num_processes = int(num_processes)
        self.polish_rounds = int(polish_rounds)
        self.flush_deadline_ms = float(flush_deadline_ms)
        self.max_batch = int(max_batch)
        self.policy = policy or DeadlinePolicy()
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        self.max_pending = max_pending
        self.warm_start = bool(warm_start)
        self.pad_batches = bool(pad_batches)
        self.sa_cfg = sa_cfg or annealing.SAConfig(
            max_neighbors=25, iters_per_exchange=30, num_exchanges=20,
            solvers=8)
        self.ga_cfg = ga_cfg or genetic.GAConfig(generations=80, pop_size=32)
        self._tier_cfgs = {
            "default": (self.sa_cfg, self.ga_cfg),
            "tight": (_tighten_sa(self.sa_cfg), _tighten_ga(self.ga_cfg)),
        }
        self._queue: List[_Pending] = []
        # Exact tier: full-instance digest -> (perm, objective).
        self._cache: "OrderedDict[str, Tuple[np.ndarray, float]]" = OrderedDict()
        # Shape tier: (order, system-graph) digest -> latest perm.
        self._shape_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.stats = EngineStats()
        self._lock = threading.RLock()          # queue / cache / stats
        self._cond = threading.Condition(self._lock)
        self._dispatch_lock = threading.Lock()  # serializes solves
        self._flusher: Optional[threading.Thread] = None
        self._stop = False

    # ------------------------------------------------------------- plumbing
    def bucket_for(self, n: int) -> Optional[int]:
        """Smallest configured bucket holding an order-n instance."""
        for b in self.buckets:
            if n <= b:
                return b
        return None                      # oversize: solved at exact size

    def large_bucket_for(self, n: int) -> Optional[int]:
        """The multilevel path's routing label for order n, or None below
        ``multilevel_min_n``."""
        if n < self.multilevel_min_n or not self._large_set:
            return None
        for b in self.large_buckets:
            if b in self._large_set and n <= b:
                return b
        return max(self._large_set)

    def _route(self, n: int) -> Optional[int]:
        b = self.bucket_for(n)
        return b if b is not None else self.large_bucket_for(n)

    def digest(self, req: MapRequest, algorithm: Optional[str] = None,
               tier: str = "default") -> str:
        """Exact-tier cache key: the instance and everything that shapes
        its solution; the seed only with ``cache_seed``.  Multilevel-routed
        orders fold the multilevel config in (the ``|ml|`` tag)."""
        algorithm = algorithm or req.algorithm
        sa_cfg, ga_cfg = self._tier_cfgs[tier]
        h = hashlib.sha1()
        C = np.ascontiguousarray(req.C, dtype=np.float32)
        M = np.ascontiguousarray(req.M, dtype=np.float32)
        seed_part = f"|s{req.seed}" if req.cache_seed else ""
        n = C.shape[0]
        ml_part = ""
        if self.bucket_for(n) is None and self.large_bucket_for(n) is not None:
            ml_part = f"|ml|{self.multilevel_cfg}"
        h.update(f"{n}|{algorithm}|{tier}|{self.num_processes}|"
                 f"{self.polish_rounds}|{sa_cfg}|{ga_cfg}"
                 f"{seed_part}{ml_part}".encode())
        h.update(C.tobytes())
        h.update(M.tobytes())
        return h.hexdigest()

    def shape_digest(self, req: MapRequest) -> str:
        """Shape-tier key: order + system graph only (flows excluded)."""
        M = np.ascontiguousarray(req.M, dtype=np.float32)
        h = hashlib.sha1()
        h.update(f"{M.shape[0]}|".encode())
        h.update(M.tobytes())
        return h.hexdigest()

    def _cache_get(self, key: str) -> Optional[Tuple[np.ndarray, float]]:
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
        return hit

    def _cache_put(self, key: str, shape_key: str, perm: np.ndarray,
                   objective: float) -> None:
        perm = np.array(perm, copy=True)    # callers may mutate responses
        self._cache[key] = (perm, objective)
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        self._shape_cache[shape_key] = perm
        self._shape_cache.move_to_end(shape_key)
        while len(self._shape_cache) > self.cache_size:
            self._shape_cache.popitem(last=False)

    def _warm_perm(self, req: MapRequest) -> Optional[np.ndarray]:
        """Shape-tier near-miss lookup (call under the lock)."""
        if not self.warm_start or req.cache_seed or req.C.shape[0] < 2:
            return None
        return self._shape_cache.get(self.shape_digest(req))

    # --------------------------------------------------------------- warmup
    def warmup(self, buckets: Optional[Sequence[int]] = None,
               algorithms: Sequence[str] = ("psa",),
               tiers: Sequence[str] = ("default",),
               batch_sizes: Optional[Sequence[int]] = None,
               warm_starts: Sequence[bool] = (False, True),
               execute: Optional[bool] = None) -> int:
        """Build the kernels (on the card) and run one dummy wave through
        the solver of each (bucket, algorithm, tier) and the polish, so
        the first real wave pays neither the build nor first-use costs
        (the multilevel large buckets solve at exact size and are not
        warmed).  Returns the number of dummy waves run (also in
        ``stats.warmup_programs``).

        The arguments are the reference's and are validated as it
        validates them; ``batch_sizes``, ``warm_starts`` and ``execute``
        are otherwise ignored, since the kernels are built once and launch
        at any wave size, so there is no per-shape program to compile."""
        buckets = self.buckets if buckets is None else tuple(
            sorted(int(b) for b in buckets))
        for b in buckets:
            if b not in self.buckets:
                raise ValueError(f"unknown bucket {b}; have {self.buckets}")
        for a in algorithms:
            if a not in ALGORITHMS:
                raise ValueError(f"algorithm must be one of {ALGORITHMS}")
        for t in tiers:
            if t not in TIERS:
                raise ValueError(f"tier must be one of {TIERS}")
        if batch_sizes is None and not self.pad_batches:
            raise ValueError("pad_batches=False: pass batch_sizes= explicitly")
        if self.device.type == "cuda":
            build.build_all()
        rng = np.random.RandomState(0)
        for bucket in buckets:
            # event_width="auto": fill the measured width cache for this
            # bucket, so every later wave at it reads the tuned width (the
            # width never changes results)
            if any(self._tier_cfgs[t][0].event_width == "auto"
                   for t in tiers):
                annealing.autotune_event_width(bucket, device=self.device)
            A = rng.randint(1, 5, (bucket, bucket)).astype(np.float32)
            A = A + A.T
            np.fill_diagonal(A, 0)
            C = torch.as_tensor(A, device=self.device)[None]
            key = keys.prng_key(0, self.device)[None]
            nv = torch.full((1,), bucket, dtype=torch.int64, device=self.device)
            for algorithm in algorithms:
                for tier in tiers:
                    p, _ = self._dispatch(algorithm, tier, C, C, key, nv, None)
                    if self.polish_rounds > 0:
                        mapping_lib.polish_batch(C, C, p, key,
                                                 self.polish_rounds, nv,
                                                 device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        count = len(buckets) * len(algorithms) * len(tiers)
        with self._lock:
            self.stats.warmup_programs += count
        return count

    # ------------------------------------------------------------------ API
    def submit(self, req: MapRequest) -> MapFuture:
        """Queue one request; non-blocking.  With ``max_pending`` set, a
        submit finding the queue full gets an already-failed future
        (:class:`QueueFull`) and nothing is queued."""
        validate_request(req)
        algorithm, tier = self.policy.resolve(req.algorithm, req.deadline_ms)
        pending = _Pending(req=req, future=MapFuture(), algorithm=algorithm,
                           tier=tier, t_submit=time.monotonic())
        with self._cond:
            if (self.max_pending is not None
                    and len(self._queue) >= self.max_pending):
                self.stats.rejected += 1
                pending.future._fail(QueueFull(
                    f"engine queue at max_pending={self.max_pending}"))
                return pending.future
            self.stats.submitted += 1
            self._queue.append(pending)
            self._cond.notify_all()
        return pending.future

    def flush(self) -> Dict[str, MapResponse]:
        """Solve everything queued; returns {job_id: response}.  Raises the
        first group's error after failing that group's futures."""
        with self._cond:
            pending, self._queue = self._queue, []
        try:
            return self._flush_pending(pending, raise_errors=True)
        except BaseException as e:
            for p in pending:                # no future may be left hanging
                if not p.future.done():
                    p.future._fail(e)
            raise

    def map_one(self, C: np.ndarray, M: np.ndarray, algorithm: str = "psa",
                job_id: str = "job", seed: int = 0,
                cache_seed: bool = False,
                deadline_ms: Optional[float] = None) -> MapResponse:
        """Single-request convenience path (still padded + cached)."""
        fut = self.submit(MapRequest(job_id=job_id, C=np.asarray(C),
                                     M=np.asarray(M), algorithm=algorithm,
                                     seed=seed, cache_seed=cache_seed,
                                     deadline_ms=deadline_ms))
        if not self.running:
            self.flush()
        return fut.result()

    # -------------------------------------------------------- async flusher
    @property
    def running(self) -> bool:
        return self._flusher is not None and self._flusher.is_alive()

    def start(self) -> "MappingEngine":
        """Start the background flusher thread (idempotent)."""
        with self._cond:
            if self.running:
                return self
            self._stop = False
            self._flusher = threading.Thread(target=self._flush_loop,
                                             name="mapper-flusher",
                                             daemon=True)
            self._flusher.start()
        return self

    def stop(self, flush_pending: bool = True) -> None:
        """Stop the flusher; by default serve what is still queued.  The
        queue and the flusher handle are claimed together with the stop
        flag, under the lock, so a racing start()/submit() cannot strand a
        request."""
        with self._cond:
            self._stop = True
            flusher, self._flusher = self._flusher, None
            drained: List[_Pending] = []
            if flush_pending:
                drained, self._queue = self._queue, []
            self._cond.notify_all()
        if flusher is not None:
            flusher.join()
        if flush_pending:
            try:
                self._flush_pending(drained, raise_errors=True)
            except BaseException as e:
                for p in drained:
                    if not p.future.done():
                        p.future._fail(e)
                raise
            self.flush()    # requests that raced in after the claim

    def __enter__(self) -> "MappingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _group_key(self, p: _Pending) -> Tuple[Optional[int], str, str]:
        return (self._route(p.req.C.shape[0]), p.algorithm, p.tier)

    def _take_ready_locked(self) -> Tuple[List[_Pending], Optional[float]]:
        """Every full group plus every group holding an overdue request;
        returns (ready, seconds until the oldest deadline)."""
        if not self._queue:
            return [], None
        now = time.monotonic()
        deadline_s = self.flush_deadline_ms / 1000.0
        counts: Dict[Tuple[Optional[int], str, str], int] = {}
        overdue = set()
        for p in self._queue:
            k = self._group_key(p)
            counts[k] = counts.get(k, 0) + 1
            if now - p.t_submit >= deadline_s:
                overdue.add(k)
        full = {k for k, c in counts.items() if c >= self.max_batch}
        take = full | overdue
        if take:
            ready = [p for p in self._queue if self._group_key(p) in take]
            self._queue = [p for p in self._queue
                           if self._group_key(p) not in take]
            self.stats.full_bucket_flushes += len(full)
            self.stats.deadline_flushes += len(overdue - full)
            return ready, None
        oldest = min(p.t_submit for p in self._queue)
        return [], deadline_s - (now - oldest)

    def _flush_loop(self) -> None:
        me = threading.current_thread()
        while True:
            with self._cond:
                while (self._flusher is me and not self._stop
                       and not self._queue):
                    self._cond.wait()
                if self._flusher is not me or self._stop:
                    return
                ready, wait_s = self._take_ready_locked()
                if not ready:
                    self._cond.wait(timeout=wait_s)
                    continue
            try:
                self._flush_pending(ready, raise_errors=False)
            except BaseException as e:       # never die with futures pending
                for p in ready:
                    if not p.future.done():
                        p.future._fail(e)

    # ---------------------------------------------------------- solve paths
    def _flush_pending(self, pending: List[_Pending], raise_errors: bool
                       ) -> Dict[str, MapResponse]:
        """Cache pass, grouped batched solves, future resolution: the one
        code path of ``flush()`` and the flusher."""
        responses: Dict[str, MapResponse] = {}
        if not pending:
            return responses
        groups: Dict[Tuple[Optional[int], str, str],
                     "OrderedDict[str, List[_Pending]]"] = {}
        with self._lock:
            for p in pending:
                if p.future.done():          # cancelled while queued
                    self.stats.cancelled += 1
                    continue
                key = self.digest(p.req, p.algorithm, p.tier)
                hit = self._cache_get(key)
                if hit is not None:
                    perm, objective = hit
                    self.stats.cache_hits += 1
                    resp = self._respond(
                        p, perm, objective,
                        bucket=self._route(p.req.C.shape[0]),
                        cached=True, seconds=0.0, batch_size=0)
                    if p.future._resolve(resp):
                        responses[p.req.job_id] = resp
                    else:
                        self.stats.cancelled += 1
                    continue
                g = groups.setdefault(self._group_key(p), OrderedDict())
                g.setdefault(key, []).append(p)
        if not groups:
            return responses
        with self._dispatch_lock:
            first_error: Optional[BaseException] = None
            for (bucket, algorithm, tier), by_digest in groups.items():
                heads = [ps[0] for ps in by_digest.values()]
                try:
                    t0 = time.perf_counter()
                    with self._lock:
                        warms = [self._warm_perm(p.req) for p in heads]
                    if bucket is None:
                        solved = [self._solve_exact(p.req, algorithm, tier, w)
                                  for p, w in zip(heads, warms)]
                    elif bucket in self._large_set:
                        # one multilevel solve per head; shape-tier warm
                        # starts are ignored (the coarse solve is the seed)
                        solved = [self._solve_multilevel(p.req)
                                  for p in heads]
                        warms = [None] * len(heads)
                    else:
                        solved = self._solve_bucket(
                            bucket, algorithm, tier, [p.req for p in heads],
                            warms)
                    seconds = time.perf_counter() - t0
                except Exception as e:       # fail this group's futures only
                    for ps in by_digest.values():
                        for p in ps:
                            p.future._fail(e)
                    first_error = first_error or e
                    continue
                total = sum(len(ps) for ps in by_digest.values())
                per_instance = seconds / max(total, 1)
                with self._lock:
                    self.stats.warm_starts += sum(w is not None for w in warms)
                    for key, (perm, objective), w, p0 in zip(
                            by_digest, solved, warms, heads):
                        self._cache_put(key, self.shape_digest(p0.req),
                                        perm, objective)
                        for p in by_digest[key]:
                            resp = self._respond(
                                p, perm, objective, bucket=bucket,
                                cached=False, seconds=per_instance,
                                batch_size=total, warm_start=w is not None)
                            if p.future._resolve(resp):
                                responses[p.req.job_id] = resp
                            else:
                                self.stats.cancelled += 1
            if first_error is not None and raise_errors:
                raise first_error
        return responses

    def _respond(self, p: _Pending, perm: np.ndarray, objective: float,
                 bucket: Optional[int], cached: bool, seconds: float,
                 batch_size: int, warm_start: bool = False) -> MapResponse:
        req = p.req
        n = req.C.shape[0]
        baseline = float((np.asarray(req.C, np.float64)
                          * np.asarray(req.M, np.float64)).sum())
        if objective > baseline:
            # A mapping must never be worse than the trivial placement.
            perm, objective = np.arange(n, dtype=np.int32), baseline
        return MapResponse(job_id=req.job_id, perm=np.array(perm, copy=True),
                           objective=float(objective), baseline=baseline,
                           algorithm=p.algorithm, n=n, bucket=bucket,
                           cached=cached, seconds=seconds,
                           batch_size=batch_size, tier=p.tier,
                           warm_start=warm_start)

    def _dispatch(self, algorithm: str, tier: str, C, M, key, nv, ips):
        """One batched solve of a padded wave: ``(perms, fs)``, sharded
        over the mesh when the engine has one."""
        if self.mesh is None:
            return self._dispatch_local(algorithm, tier, C, M, key, nv, ips)
        sa_cfg, ga_cfg = self._tier_cfgs[tier]
        cfg = {"psa": sa_cfg, "pga": ga_cfg}.get(algorithm) or \
            composite.CompositeConfig(sa=sa_cfg, ga=ga_cfg)
        p, f, _ = batch_sharded._dispatch_sharded(
            algorithm, cfg, self.num_processes, True, C, M, key, nv, ips,
            self.mesh, self.instance_axis)
        return p, f

    def _dispatch_local(self, algorithm: str, tier: str, C, M, key, nv, ips):
        """One batched solve on the engine's device (a padded wave, or one
        unpadded instance as a batch of one): ``(perms, fs)``."""
        sa_cfg, ga_cfg = self._tier_cfgs[tier]
        kw = dict(n_valid=nv, init_perm=ips, device=self.device)
        if algorithm == "psa":
            p, f, _ = annealing.run_psa_batch(C, M, key, sa_cfg,
                                              self.num_processes, **kw)
        elif algorithm == "pga":
            p, f, _ = genetic.run_pga_batch(C, M, key, ga_cfg,
                                            self.num_processes, **kw)
        else:
            p, f, _ = composite.run_pca_batch(
                C, M, key, composite.CompositeConfig(sa=sa_cfg, ga=ga_cfg),
                self.num_processes, **kw)
        return p, f

    def _solve_bucket(self, bucket: int, algorithm: str, tier: str,
                      reqs: List[MapRequest],
                      warms: List[Optional[np.ndarray]]
                      ) -> List[Tuple[np.ndarray, float]]:
        """Pad every request to ``bucket`` and solve the wave in one
        batched call.  The wave is padded to a power of two (dummy rows
        replicate instance 0) and chunked at ``max_batch``; rows are
        independent, so real rows are unaffected."""
        if self.pad_batches and len(reqs) > self.max_batch:
            out = []
            for i in range(0, len(reqs), self.max_batch):
                out.extend(self._solve_bucket(
                    bucket, algorithm, tier, reqs[i:i + self.max_batch],
                    warms[i:i + self.max_batch]))
            return out
        B = len(reqs)
        Bp = 1 << (B - 1).bit_length() if self.pad_batches else B
        Cs = np.zeros((Bp, bucket, bucket), np.float32)
        Ms = np.zeros((Bp, bucket, bucket), np.float32)
        nvs = np.zeros(Bp, np.int64)
        seeds = np.zeros(Bp, np.int64)
        for i, req in enumerate(reqs):
            n = req.C.shape[0]
            Cs[i, :n, :n] = req.C
            Ms[i, :n, :n] = req.M
            nvs[i] = n
            seeds[i] = req.seed
        Cs[B:], Ms[B:], nvs[B:] = Cs[0], Ms[0], nvs[0]
        dev = self.device
        key = torch.stack([keys.prng_key(int(s), dev) for s in seeds])
        C_t = torch.as_tensor(Cs, device=dev)
        M_t = torch.as_tensor(Ms, device=dev)
        nv_t = torch.as_tensor(nvs, device=dev)
        ips = None
        if any(w is not None for w in warms):
            # all-(-1) rows: the solver's "no warm start" sentinel
            ips = np.full((Bp, bucket), -1, np.int32)
            for i, (req, w) in enumerate(zip(reqs, warms)):
                if w is not None:
                    n = req.C.shape[0]
                    ips[i, :n] = w
                    ips[i, n:] = np.arange(n, bucket, dtype=np.int32)
        perms, fs = self._dispatch(algorithm, tier, C_t, M_t, key, nv_t, ips)
        if self.polish_rounds > 0:
            perms, fs = mapping_lib.polish_batch(
                C_t, M_t, perms, keys.fold_in(key, 7), self.polish_rounds,
                nv_t, device=dev)
        with self._lock:
            self.stats.solver_batches += 1
            self.stats.solver_calls += B
        perms = perms.cpu().numpy()
        fs = fs.cpu().numpy()
        out = []
        for i, req in enumerate(reqs):
            n = int(nvs[i])
            if n < 2:                      # degenerate: nothing to optimise
                f_id = float((np.asarray(req.C, np.float64)
                              * np.asarray(req.M, np.float64)).sum())
                out.append((np.arange(n, dtype=np.int32), f_id))
                continue
            out.append((perms[i, :n].astype(np.int32), float(fs[i])))
        return out

    def _solve_exact(self, req: MapRequest, algorithm: str, tier: str,
                     warm: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, float]:
        """Orders above every bucket (and below the multilevel threshold)
        run unpadded, one at a time, still warm-started when possible."""
        dev = self.device
        C = torch.as_tensor(np.asarray(req.C, np.float32), device=dev)
        M = torch.as_tensor(np.asarray(req.M, np.float32), device=dev)
        key = keys.prng_key(req.seed, dev)
        p, f = self._dispatch_local(algorithm, tier, C[None], M[None],
                                    key[None], None,
                                    None if warm is None else warm[None])
        p, f = p[0], f[0]
        if self.polish_rounds > 0:
            p, f = mapping_lib.polish(C, M, p, keys.fold_in(key, 7),
                                      self.polish_rounds, device=dev)
        with self._lock:
            self.stats.solver_batches += 1
            self.stats.solver_calls += 1
        return p.cpu().numpy().astype(np.int32), float(f)

    def _solve_multilevel(self, req: MapRequest) -> Tuple[np.ndarray, float]:
        """A large-bucket request through ``core.multilevel`` at exact
        size; ``multilevel_cfg`` governs, not the tier's budgets."""
        res = multilevel.solve_multilevel(
            req.C, req.M, keys.prng_key(req.seed, self.device),
            self.multilevel_cfg, device=self.device)
        with self._lock:
            self.stats.solver_batches += 1
            self.stats.solver_calls += 1
        return np.asarray(res.perm, np.int32), float(res.objective)
