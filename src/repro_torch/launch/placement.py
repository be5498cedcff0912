"""Topology-aware device placement: the paper's technique as a launcher
feature.

The port of ``repro/launch/placement.py``.  At job launch -- exactly the
paper's deployment: the mapping search runs before the job starts --

  1. the step is lowered once with the default device order
     (``launch.lowering.lower_train_cell``); its collectives give the
     *program graph* C (logical-device traffic matrix,
     ``topology.traffic``);
  2. the machine gives the *system graph* M (torus hop distances,
     ``topology.tpu``);
  3. one of the paper's three parallel algorithms (PSA / PGA / PCA)
     solves the QAP functional (1) for a permutation p: logical ->
     physical;
  4. the mesh is rebuilt with the permuted device order
     (:func:`apply_placement`) and the job runs on it.

The predicted communication cost F(p) against F(identity) is the
placement gain.  :func:`traffic_from_compiled` also reads the reference's
input, HLO text (or an object with ``.as_text()``), through
``topology.hlocost``.

Public surface: :class:`PlacementService` is the explicit object owning
the engine; ``default_service()`` / ``reset_default_service()`` manage the
shared instance the convenience functions (``solve_placement``,
``get_engine``) route through.  The old module-global entry points --
``submit_placement``, ``placement_result``, ``solve_placements``,
``reset_engine`` -- remain as thin deprecation shims over the default
service.

``PlacementService(mesh=, instance_axis=)``, :meth:`PlacementService.
configure_mesh` and :func:`configure_engine_mesh` shard the engine's
bucket waves over an instance mesh (``launch.mesh.Mesh``,
``core.batch_sharded``) with bitwise-identical results.  The services
run on the card unless ``device="cpu"`` is passed, and give the
reference's answers for the same key words.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import annealing, genetic, mapping as mapping_lib
from repro_torch.serve.fleet import EngineFleet, FaultPlan
from repro_torch.serve.mapper import MapFuture, MapRequest, MappingEngine
from repro_torch.topology import hlocost, tpu, traffic as traffic_lib
from .lowering import LoweredCell, mesh_layout
from .mesh import Mesh


@dataclass
class PlacementResult:
    perm: np.ndarray
    cost_before: float        # F(identity) -- default device order
    cost_after: float         # F(p*)
    algorithm: str
    seconds: float

    @property
    def gain(self) -> float:
        return 0.0 if self.cost_before == 0 else \
            (self.cost_before - self.cost_after) / self.cost_before


def traffic_from_compiled(compiled, num_devices: int) -> np.ndarray:
    """Program graph C of a lowered step: a :class:`LoweredCell`'s
    collectives through ``traffic.traffic_matrix``; HLO text, or an
    object with ``.as_text()``, through the trip-count-aware
    ``hlocost.analyze``, as the reference reads its compiled step."""
    if isinstance(compiled, LoweredCell):
        return traffic_lib.traffic_matrix(compiled.collectives, num_devices)
    text = compiled if isinstance(compiled, str) else compiled.as_text()
    hc = hlocost.analyze(text, num_devices)
    c = np.zeros((num_devices, num_devices), np.float64)
    for op in hc.collective_ops:
        c += traffic_lib.traffic_matrix([op], num_devices).astype(np.float64)
    return c.astype(np.float32)


def system_graph_for_mesh(mesh) -> np.ndarray:
    """M of the torus that ``topology.tpu.spec_for_mesh_shape`` gives the
    mesh's shape (a ``launch.mesh.Mesh`` or a ``DeviceMesh``)."""
    spec = tpu.spec_for_mesh_shape(mesh_layout(mesh)[0])
    return tpu.distance_matrix(spec)


# Budget presets follow the paper's S5 conclusions: SA meets resource-manager
# timeouts for large graphs; GA/composite buy accuracy with more time.
# Chains are seeded with the as-allocated order (paper's greedy-init
# variant [9]) so the search refines the scheduler's placement rather than
# re-discovering it from random starts.
_FAST_SA = annealing.SAConfig(max_neighbors=25, iters_per_exchange=40,
                              num_exchanges=30, solvers=16,
                              seed_with="identity")
_FAST_GA = genetic.GAConfig(generations=120, pop_size=64, seed_identity=True)


def _seed_from_key(key) -> int:
    """The engine seed of a key: 0 for ``None``, else the last word of an
    int or of raw uint32 key words (the reference's rule for its legacy
    raw keys; the port has no typed keys)."""
    if key is None:
        return 0
    return int(np.asarray(key).reshape(-1)[-1])


def _result_from_response(resp) -> PlacementResult:
    return PlacementResult(perm=resp.perm, cost_before=resp.baseline,
                           cost_after=resp.objective,
                           algorithm=resp.algorithm, seconds=resp.seconds)


class PlacementService:
    """Explicit owner of one launcher-side :class:`MappingEngine`.

    The engine is built lazily (first use) with the launcher's fast
    budget presets, so repeated launches of the same job shape are
    served from its LRU cache and concurrent placements ride one bucket
    batch.  The module-level functions below are conveniences over
    ``default_service()``.

    With ``workers >= 1`` the service builds an
    :class:`~repro_torch.serve.fleet.EngineFleet` of that many worker
    engines instead of a single ``MappingEngine`` -- the submit/flush
    surface is identical, placements shard across the workers, and a
    worker death (injectable through ``fault_plan`` for tests) requeues
    its in-flight placements instead of losing them.
    ``transport="subprocess"`` runs those workers as isolated child
    processes (see ``repro_torch.serve.transport``).  The fleet runs with
    ``warm_start=False`` so results stay bitwise-identical to a
    single-engine service with warm starts disabled.

    ``device`` places the engine (or every fleet worker): the card by
    default, ``"cpu"`` for the plain PyTorch path.
    """

    def __init__(self, *, mesh=None,
                 instance_axis: str = "instances",
                 num_processes: int = 4,
                 sa_cfg: Optional[annealing.SAConfig] = None,
                 ga_cfg: Optional[genetic.GAConfig] = None,
                 workers: int = 0,
                 transport: str = "thread",
                 fault_plan: Optional[FaultPlan] = None,
                 device=None):
        self._mesh = mesh
        self._axis = instance_axis
        self._num_processes = num_processes
        self._sa_cfg = sa_cfg or _FAST_SA
        self._ga_cfg = ga_cfg or _FAST_GA
        self._workers = int(workers)
        self._transport = transport
        self._fault_plan = fault_plan
        self._device = device
        self._engine: Optional[Union[MappingEngine, EngineFleet]] = None

    @property
    def engine(self) -> Union[MappingEngine, EngineFleet]:
        if self._engine is None:
            kwargs = dict(
                num_processes=self._num_processes, sa_cfg=self._sa_cfg,
                ga_cfg=self._ga_cfg, device=self._device)
            if self._workers >= 1:
                if self._transport == "subprocess":
                    if self._mesh is not None:
                        raise ValueError("subprocess fleet workers cannot "
                                         "share the service's device mesh")
                    meshes = None
                else:
                    meshes = None if self._mesh is None else [self._mesh]
                self._engine = EngineFleet(
                    workers=self._workers, transport=self._transport,
                    fault_plan=self._fault_plan, meshes=meshes,
                    instance_axis=self._axis, **kwargs)
            else:
                self._engine = MappingEngine(
                    mesh=self._mesh, instance_axis=self._axis, **kwargs)
        return self._engine

    def configure_mesh(self, mesh, instance_axis: str = "instances") -> None:
        """Shard the engine's bucket waves over ``mesh``'s
        ``instance_axis`` (``core.batch_sharded``); ``None`` restores the
        single-device path.  Results are bitwise-identical either way, so
        this is purely a throughput knob.  Rebuilds the engine (the mesh
        is fixed at construction); queued futures are drained first."""
        self._mesh, self._axis = mesh, instance_axis
        self.close()

    def close(self) -> None:
        """Stop the engine (draining any queued futures, so no caller is
        left blocked) and drop it; the next use builds a fresh one."""
        if self._engine is not None:
            self._engine.stop()
            self._engine = None

    def solve(self, c: np.ndarray, m: np.ndarray, algorithm: str = "psa",
              key=None, num_processes: Optional[int] = None,
              sa_cfg: Optional[annealing.SAConfig] = None,
              ga_cfg: Optional[genetic.GAConfig] = None) -> PlacementResult:
        """Solve one placement.  The default-budget path routes through
        the engine (bucketed, batched, cached).  With an explicit ``key``
        the seed enters the cache digest, so different keys yield
        independent solves (best-of-k sweeps work) while repeating the
        same key stays cached; with ``key=None`` the cache is keyed by
        the instance alone.  An explicit ``num_processes`` or custom
        ``sa_cfg``/``ga_cfg`` bypasses the engine and solves directly
        (``core.mapping.find_mapping`` with ``key`` as its key words)."""
        if (num_processes is None and sa_cfg is None and ga_cfg is None
                and algorithm in ("psa", "pga", "pca")):
            resp = self.engine.map_one(np.asarray(c), np.asarray(m),
                                       algorithm=algorithm,
                                       seed=_seed_from_key(key),
                                       cache_seed=key is not None)
            return _result_from_response(resp)
        res = mapping_lib.find_mapping(
            c, m, algorithm, key=key,
            num_processes=(self._num_processes if num_processes is None
                           else num_processes),
            sa_cfg=sa_cfg or self._sa_cfg, ga_cfg=ga_cfg or self._ga_cfg,
            device=self._device)
        return PlacementResult(perm=res.perm, cost_before=res.baseline,
                               cost_after=res.objective, algorithm=algorithm,
                               seconds=res.seconds)

    def submit(self, c: np.ndarray, m: np.ndarray, algorithm: str = "psa",
               key=None, job_id: str = "plc",
               deadline_ms: Optional[float] = None) -> MapFuture:
        """Streaming form: queue one placement and return its
        :class:`MapFuture` immediately.  With the engine's flusher
        running (``service.engine.start()``) the future resolves when
        its bucket fills or the flush deadline passes; otherwise the
        caller flushes explicitly.  Wrap ``future.result()`` with
        :meth:`result` for the launcher-facing record."""
        return self.engine.submit(MapRequest(
            job_id=job_id, C=np.asarray(c), M=np.asarray(m),
            algorithm=algorithm, seed=_seed_from_key(key),
            cache_seed=key is not None, deadline_ms=deadline_ms))

    @staticmethod
    def result(future: MapFuture,
               timeout: Optional[float] = None) -> PlacementResult:
        """Resolve a :meth:`submit` future into a :class:`PlacementResult`.

        On timeout the future is *cancelled* before re-raising: an
        abandoned request must not sit in the engine's queue forever
        with nobody to collect it.  If the real result lands in the
        instant between the timeout and the cancel, the cancel loses the
        claim race and the (still readable) result is returned instead.
        """
        try:
            resp = future.result(timeout)
        except TimeoutError:
            if future.cancel():
                raise
            resp = future.result(timeout=0)   # lost the race: result stands
        return _result_from_response(resp)

    def solve_batch(self,
                    instances: Sequence[Tuple[np.ndarray, np.ndarray]],
                    algorithm: str = "psa", key=None
                    ) -> Tuple[PlacementResult, ...]:
        """Batched form over the future-based API: queue every (c, m)
        instance, flush once so all same-bucket placements ride one
        device dispatch, and collect each result from its future."""
        seed = _seed_from_key(key)
        futures = []
        for i, (c, m) in enumerate(instances):
            futures.append(self.engine.submit(MapRequest(
                job_id=f"plc{i}", C=np.asarray(c), M=np.asarray(m),
                algorithm=algorithm, seed=seed + i,
                cache_seed=key is not None)))
        if not self.engine.running:
            self.engine.flush()
        return tuple(_result_from_response(f.result()) for f in futures)


_SERVICE: Optional[PlacementService] = None


def default_service() -> PlacementService:
    """The shared launcher-wide :class:`PlacementService` (on the card);
    built on first use, torn down by :func:`reset_default_service`."""
    global _SERVICE
    if _SERVICE is None:
        _SERVICE = PlacementService()
    return _SERVICE


def reset_default_service() -> None:
    """Tear down the shared service (stop its engine's flusher, drop
    cache/stats, restore the default unsharded mesh).  Test fixtures call
    this so one test's cache/stats/mesh can never leak into another."""
    global _SERVICE
    if _SERVICE is not None:
        _SERVICE.close()
        _SERVICE = None


def get_engine() -> MappingEngine:
    """The default service's engine (see :class:`PlacementService`)."""
    return default_service().engine


def configure_engine_mesh(mesh, instance_axis: str = "instances") -> None:
    """Configure the default service's mesh sharding
    (:meth:`PlacementService.configure_mesh`)."""
    default_service().configure_mesh(mesh, instance_axis)


def solve_placement(c: np.ndarray, m: np.ndarray, algorithm: str = "psa",
                    key=None, num_processes: Optional[int] = None,
                    sa_cfg: Optional[annealing.SAConfig] = None,
                    ga_cfg: Optional[genetic.GAConfig] = None
                    ) -> PlacementResult:
    """One placement via the default service (:meth:`PlacementService.solve`)."""
    return default_service().solve(c, m, algorithm, key=key,
                                   num_processes=num_processes,
                                   sa_cfg=sa_cfg, ga_cfg=ga_cfg)


def apply_placement(mesh, perm: np.ndarray):
    """Rebuild the mesh with logical coordinate k backed by device
    ``perm[k]``: a :class:`~repro_torch.launch.mesh.Mesh` permutes its
    devices (or logical ids); a ``DeviceMesh`` is rebuilt with its ranks
    in the permuted order (on every rank, as any ``DeviceMesh``)."""
    perm = np.asarray(perm)
    if isinstance(mesh, Mesh):
        devices = np.asarray(mesh.devices).reshape(-1)[perm]
        return Mesh(devices.reshape(mesh.devices.shape), mesh.axis_names)
    from torch.distributed.device_mesh import DeviceMesh
    ranks = mesh.mesh.reshape(-1)[torch.as_tensor(perm, dtype=torch.long)]
    return DeviceMesh(mesh.device_type, ranks.reshape(mesh.mesh.shape),
                      mesh_dim_names=mesh.mesh_dim_names)


def place_job(compiled, mesh, algorithm: str = "psa", key=None,
              service: Optional[PlacementService] = None
              ) -> Tuple[object, PlacementResult]:
    """One-call integration used by ``launch.train``: C of ``compiled``,
    M of ``mesh``, one solve on ``service`` (default: the shared
    :func:`default_service`, on the card), and the placed mesh."""
    ndev = int(np.prod(mesh_layout(mesh)[0]))
    c = traffic_from_compiled(compiled, ndev)
    m = system_graph_for_mesh(mesh)
    svc = service if service is not None else default_service()
    result = svc.solve(c, m, algorithm, key=key)
    return apply_placement(mesh, result.perm), result


# ------------------------------------------------------- deprecation shims
def _warn_deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.launch.placement.{old} is deprecated; use {new} "
        f"instead", DeprecationWarning, stacklevel=3)


def submit_placement(c: np.ndarray, m: np.ndarray, algorithm: str = "psa",
                     key=None, job_id: str = "plc",
                     deadline_ms: Optional[float] = None) -> MapFuture:
    """Deprecated: use ``default_service().submit(...)``."""
    _warn_deprecated("submit_placement", "PlacementService.submit")
    return default_service().submit(c, m, algorithm, key=key, job_id=job_id,
                                    deadline_ms=deadline_ms)


def placement_result(future: MapFuture,
                     timeout: Optional[float] = None) -> PlacementResult:
    """Deprecated: use ``PlacementService.result(...)``."""
    _warn_deprecated("placement_result", "PlacementService.result")
    return PlacementService.result(future, timeout)


def solve_placements(instances: Sequence[Tuple[np.ndarray, np.ndarray]],
                     algorithm: str = "psa", key=None
                     ) -> Tuple[PlacementResult, ...]:
    """Deprecated: use ``default_service().solve_batch(...)``."""
    _warn_deprecated("solve_placements", "PlacementService.solve_batch")
    return default_service().solve_batch(instances, algorithm, key=key)


def reset_engine() -> None:
    """Deprecated: use :func:`reset_default_service`."""
    _warn_deprecated("reset_engine", "reset_default_service")
    reset_default_service()
