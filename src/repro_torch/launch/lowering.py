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
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

from ..models.api import Model, input_specs
from ..models.config import ModelConfig, ShapeCell
from ..models.param import tree_flatten
from ..parallel import collectives as coll
from ..parallel import data_parallel as dp
from ..parallel import sharding as sh
from ..topology.traffic import CollectiveOp
from ..train import optimizer as opt_lib


@dataclass
class LoweredCell:
    """The collectives of one rank's step on a mesh of ``num_devices``
    logical devices laid out as ``mesh_shape``, the seconds the
    lowering took, the cell's ``kind`` (train, prefill or decode) and,
    for a serving cell, the bytes of the KV/state cache a device holds
    (0 for a train cell)."""
    collectives: List[CollectiveOp]
    num_devices: int
    mesh_shape: Tuple[int, ...]
    seconds: float
    kind: str = "train"
    cache_bytes_per_device: int = 0


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


def _sharded_bytes_per_device(tree: Any, spec_tree: Any,
                             sizes: Dict[str, int], rules: sh.Rules) -> int:
    """The bytes a device holds of ``tree`` sharded by ``spec_tree``
    (logical specs resolved by ``rules``) on a mesh of axis ``sizes``:
    each leaf's bytes over the product of the axes its spec names (the
    reference dry run's ``_sharded_bytes_per_device``)."""
    total = 0
    for leaf, spec in zip(tree_flatten(tree)[0],
                          tree_flatten(sh.resolve_tree(spec_tree, rules))[0]):
        shards = 1
        for entry in spec:
            for a in (() if entry is None else (entry,)
                      if isinstance(entry, str) else entry):
                shards *= sizes[a]
        total += leaf.numel() * leaf.element_size() // shards
    return total


def lower_cell(cfg: ModelConfig, cell: ShapeCell, mesh) -> LoweredCell:
    """Lower ``cfg``'s step for ``cell`` on ``mesh``'s layout: a train
    cell by :func:`lower_train_cell`; a prefill or decode cell by running
    logical coordinate 0's serving step once on ``meta`` -- prefill on
    the rank's rows of the cell's prompts, decode on the rank's part of
    ``Model.abstract_cache(global_batch, seq_len)`` at position
    ``seq_len - 1`` -- under the recorder."""
    if cell.kind == "train":
        return lower_train_cell(cfg, cell, mesh)
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
    layout = dp.cache_layout(model, cell, axis, model_axis)
    with coll.record_collectives() as ops:
        if cell.kind == "prefill":
            prefill(shards, batch)
        else:
            decode(shards, layout.shard(whole), batch, cell.seq_len - 1)
    nbytes = _sharded_bytes_per_device(whole, model.cache_specs(),
                                      dict(zip(names, shape)),
                                      dp.serve_rules(axis, cell))
    return LoweredCell(collectives=list(ops), num_devices=meta.size(),
                       mesh_shape=shape, seconds=time.perf_counter() - t,
                       kind=cell.kind, cache_bytes_per_device=nbytes)
