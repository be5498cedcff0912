"""A lowered cell: the collectives one rank's step issues, without
devices.

The reference lowers a cell with ``jax.jit(step, in_shardings=...)
.lower(abstract inputs).compile()`` and reads the program graph off the
compiled HLO (``launch.placement.traffic_from_compiled``).  The port's
counterpart runs logical coordinate 0's sharded step once on ``meta``
tensors over a ``parallel.collectives.MetaMesh`` -- parameters from
``Model.abstract()``, the optimizer state likewise, the batch from
``input_specs`` -- under ``collectives.record_collectives``.  Nothing is
communicated and no device memory is allocated; the step is SPMD, so
every coordinate issues the same collectives, and a live step under the
same recorder gives the same list (its *live trace*).

:func:`lower_cell` lowers a cell of any kind on any (data, model) or
(pod, data, model) mesh, the production (16, 16) and (2, 16, 16) among
them.  A train cell (:func:`lower_train_cell`): ZeRO-3 over the data
axes and, on a ``model`` axis above 1, the tensor-parallel collectives
of both passes.  A prefill or decode cell: the rank's serving step
(``data_parallel.make_serve_steps``) -- the parameters gathered over
data, then the forward's model-axis collectives, decode's flash-decoding
combine over the ``seq``-sharded KV caches among them -- and the
per-device bytes of the decode cache (``cache_bytes_per_device``, the
reference dry run's ``_sharded_bytes_per_device``).

With ``costs=True`` the same single run is also counted by
``topology.opcost.count_costs`` (the reference's HLO cost analysis):
``LoweredCell.cost`` holds its matrix-product FLOPs, HBM bytes and
collectives.  Counting is off by default: a Python dispatch mode slows
the lowering.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..models.api import Model, input_specs
from ..models.config import ModelConfig, ShapeCell
from ..models.param import tree_flatten
from ..parallel import collectives as coll
from ..parallel import data_parallel as dp
from ..parallel import sharding as sh
from ..topology import opcost
from ..topology.traffic import CollectiveOp
from ..train import optimizer as opt_lib


@dataclass
class LoweredCell:
    """The collectives of one rank's step on a mesh of ``num_devices``
    logical devices laid out as ``mesh_shape``, the seconds the
    lowering took, the cell's ``kind`` (train, prefill or decode), for
    a serving cell the bytes of the KV/state cache a device holds (0 for
    a train cell), and the step's counted work when lowered with
    ``costs=True``."""
    collectives: List[CollectiveOp]
    num_devices: int
    mesh_shape: Tuple[int, ...]
    seconds: float
    kind: str = "train"
    cache_bytes_per_device: int = 0
    cost: Optional[opcost.OpCost] = None


def _counting(costs: bool):
    return opcost.count_costs() if costs else contextlib.nullcontext()


def mesh_layout(mesh) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``(shape, axis names)`` of a ``launch.mesh.Mesh``, a
    ``DeviceMesh`` or a ``MetaMesh``."""
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names)
    return tuple(mesh.shape.values()), tuple(mesh.axis_names)


def lower_train_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
                     costs: bool = False, microbatch: int = 1) -> LoweredCell:
    """Lower ``cfg``'s sharded train step for ``cell`` on ``mesh``'s
    layout (any mesh: only its shape and axis names are read).  The
    optimizer and the microbatching issue no collective of their own, so
    the step is lowered with ``OptConfig(moment_dtype=cfg.opt_dtype)``:
    every configuration of them gives this trace (``microbatch`` changes
    the counted work alone)."""
    shape, names = mesh_layout(mesh)
    meta = coll.MetaMesh(shape, names)
    ocfg = opt_lib.OptConfig(moment_dtype=cfg.opt_dtype)
    t = time.perf_counter()
    sh.check_mesh(meta, cfg)
    axis, model_axis = dp.data_axis(meta), dp.model_axis(meta)
    model = Model(cfg, device="meta")
    shards = dp.param_layout(model, axis, model_axis).shard(model.abstract())
    opt_state = opt_lib.abstract_state(ocfg, shards)
    batch = dp.shard_batch(cfg, cell, input_specs(cfg, cell), axis)
    step = dp.make_data_parallel_step(
        model, ocfg, opt_lib.warmup_cosine(ocfg.lr, 1, 2), axis,
        microbatch=microbatch, model_axis=model_axis)
    with coll.record_collectives() as ops, _counting(costs) as cost:
        step(shards, opt_state, batch)
    return LoweredCell(collectives=list(ops), num_devices=meta.size(),
                       mesh_shape=shape, seconds=time.perf_counter() - t,
                       cost=cost)


def sharded_bytes(tree: Any, specs: Any, sizes: Dict[str, int]) -> int:
    """The bytes a device holds of ``tree`` sharded by ``specs`` (resolved
    to mesh axes) on a mesh of axis ``sizes``: each leaf's bytes over the
    product of the axes its spec names (the reference dry run's
    ``_sharded_bytes_per_device``)."""
    total = 0
    for leaf, spec in zip(tree_flatten(tree)[0], tree_flatten(specs)[0]):
        shards = 1
        for entry in spec:
            for a in (() if entry is None else (entry,)
                      if isinstance(entry, str) else entry):
                shards *= sizes[a]
        total += leaf.numel() * leaf.element_size() // shards
    return total


def lower_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
               costs: bool = False, microbatch: int = 1) -> LoweredCell:
    """Lower ``cfg``'s step for ``cell`` on ``mesh``'s layout: a train
    cell by :func:`lower_train_cell` (in ``microbatch`` microbatches); a
    prefill or decode cell by running logical coordinate 0's serving step
    once on ``meta`` -- prefill on the rank's rows of the cell's prompts,
    decode on the rank's part of ``Model.abstract_cache(global_batch,
    seq_len)`` at position ``seq_len - 1`` -- under the recorder."""
    if cell.kind == "train":
        return lower_train_cell(cfg, cell, mesh, costs, microbatch)
    shape, names = mesh_layout(mesh)
    meta = coll.MetaMesh(shape, names)
    t = time.perf_counter()
    sh.check_mesh(meta, cfg, cell)
    axis, model_axis = dp.data_axis(meta), dp.model_axis(meta)
    model = Model(cfg, device="meta")
    shards = dp.param_layout(model, axis, model_axis).shard(model.abstract())
    batch = dp.shard_batch(cfg, cell, input_specs(cfg, cell), axis)
    prefill, decode = dp.make_serve_steps(model, axis, model_axis,
                                          dp.splits_batch(axis, cell))
    whole = model.abstract_cache(cell.global_batch, cell.seq_len)
    # the rank's part of the cache is resident before the step: not counted
    cache = None if cell.kind == "prefill" else dp.cache_layout(
        model, cell, axis, model_axis).shard(whole)
    with coll.record_collectives() as ops, _counting(costs) as cost:
        if cell.kind == "prefill":
            prefill(shards, batch)
        else:
            decode(shards, cache, batch, cell.seq_len - 1)
    nbytes = sharded_bytes(whole, sh.resolve_tree(
        model.cache_specs(), dp.serve_rules(axis, cell)),
        dict(zip(names, shape)))
    return LoweredCell(collectives=list(ops), num_devices=meta.size(),
                       mesh_shape=shape, seconds=time.perf_counter() - t,
                       kind=cell.kind, cache_bytes_per_device=nbytes,
                       cost=cost)
