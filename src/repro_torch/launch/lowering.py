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

This covers the train step on any (data, model) or (pod, data, model)
mesh, the production (16, 16) and (2, 16, 16) among them: ZeRO-3 over
the data axes and, on a ``model`` axis above 1, the tensor-parallel
collectives of both passes.  The dry-run and roofline tools that lower
prefill and decode cells are later steps of ``ROADMAP.md``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Tuple

from ..models.api import Model, input_specs
from ..models.config import ModelConfig, ShapeCell
from ..parallel import collectives as coll
from ..parallel import data_parallel as dp
from ..parallel import sharding as sh
from ..topology.traffic import CollectiveOp
from ..train import optimizer as opt_lib


@dataclass
class LoweredCell:
    """The collectives of one rank's step on a mesh of ``num_devices``
    logical devices laid out as ``mesh_shape``, and the seconds the
    lowering took."""
    collectives: List[CollectiveOp]
    num_devices: int
    mesh_shape: Tuple[int, ...]
    seconds: float


def mesh_layout(mesh) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``(shape, axis names)`` of a ``launch.mesh.Mesh``, a
    ``DeviceMesh`` or a ``MetaMesh``."""
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names)
    return tuple(mesh.shape.values()), tuple(mesh.axis_names)


def lower_train_cell(cfg: ModelConfig, cell: ShapeCell,
                     mesh) -> LoweredCell:
    """Lower ``cfg``'s sharded train step for ``cell`` on ``mesh``'s
    layout (any mesh: only its shape and axis names are read).  The
    optimizer and the microbatching issue no collective of their own, so
    the step is lowered with ``OptConfig(moment_dtype=cfg.opt_dtype)`` in
    one microbatch: every configuration of them gives this trace."""
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
        model_axis=model_axis)
    with coll.record_collectives() as ops:
        step(shards, opt_state, batch)
    return LoweredCell(collectives=list(ops), num_devices=meta.size(),
                       mesh_shape=shape, seconds=time.perf_counter() - t)
