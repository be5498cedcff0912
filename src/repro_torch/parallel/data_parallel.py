"""The data-parallel train step: the reference's ``jax.jit(train_step,
in_shardings=...)`` on a mesh whose ``model`` axis is 1.

Every rank runs the same step (SPMD) on its slice of the global batch.
The step follows the resolved specs (``Model.specs`` under
``sharding.rules_for_mesh``, whose ``fsdp`` and ``batch`` are ``data``,
or ("pod", "data") on a multi-pod mesh):

* a parameter whose spec names the data-parallel axes on one dim is held
  as its shard along that dim (ZeRO-3): all-gathered for use, its
  gradient reduce-scattered back to the shard;
* a replicated parameter is held whole, its gradient all-reduced;
* the optimizer state shards as the parameters (``optimizer.state_specs``)
  and AdamW updates each rank's shard;
* the batch is split on its rows as ``batch_partition_specs`` says.

The loss and the gradients are the global batch's mean (each rank's
local mean, summed over the ranks, over their number); the global
gradient norm adds the shards' squares over the ranks and the
replicated leaves' once, and clips as ``optimizer.apply`` clips.  Each
rank's batch is one MoE routing group (the reference passes
``num_groups`` = data-parallel width for the global batch).

Nothing in the step reads a value, so it runs on ``meta`` tensors over a
``collectives.MetaMesh``: that is how ``launch.lowering`` records its
collectives without devices.  The one-device ``train.step.make_train_step``
is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models.api import Model, batch_partition_specs
from ..models.config import ModelConfig, ShapeCell
from ..models.param import tree_flatten, tree_map, tree_unflatten
from ..train import optimizer as opt_lib
from ..train import step as step_lib
from . import collectives as coll
from . import sharding as sh

Array = torch.Tensor


def data_axis(mesh) -> coll.MeshAxis:
    """The mesh's data-parallel axis: its ("pod", "data") dims, or
    ("data",), taken together.  Raises for a mesh the step cannot run on
    (``sharding.check_data_parallel``: a ``model`` axis > 1)."""
    sh.check_data_parallel(mesh)
    return coll.MeshAxis(mesh, tuple(a for a in ("pod", "data")
                                     if a in mesh.mesh_dim_names))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_dim(spec: sh.PartitionSpec, axes: Tuple[str, ...]) -> Optional[int]:
    """The dim a resolved spec shards over the data-parallel ``axes``
    (``None``: replicated).  A dim may name ``model`` too (size 1 here);
    a spec that names only some of ``axes`` raises."""
    found = None
    for i, entry in enumerate(spec):
        named = [a for a in _entry_axes(entry) if a in axes]
        if not named:
            continue
        if tuple(named) != axes or found is not None:
            raise ValueError(f"spec {spec} does not shard one dim over "
                             f"{axes}")
        found = i
    return found


def spec_dims(specs: Any, axis: coll.MeshAxis) -> Any:
    """A tree of logical specs as shard dims over ``axis`` (ints or
    ``None``)."""
    rules = sh.rules_for_mesh(axis.mesh)
    return tree_map(lambda s: shard_dim(s, axis.dims),
                    sh.resolve_tree(specs, rules))


def shard_dims(model: Model, axis: coll.MeshAxis) -> Any:
    """The parameter tree's shard dims over ``axis``."""
    return spec_dims(model.specs(), axis)


def _take(x: Array, dim: Optional[int], size: int, index: int) -> Array:
    if dim is None:
        return x
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {size} shards")
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n).clone()


def shard_params(params: Any, dims: Any, axis: coll.MeshAxis) -> Any:
    """This rank's shards of a whole parameter (or moment) tree."""
    return tree_map(lambda p, d: _take(p, d, axis.size, axis.index),
                    params, dims)


def shard_batch(cfg: ModelConfig, cell: ShapeCell, batch: Dict[str, Array],
                axis: coll.MeshAxis) -> Dict[str, Array]:
    """This rank's rows of a global batch, as ``batch_partition_specs``
    splits it."""
    specs = sh.resolve_tree(batch_partition_specs(cfg, cell),
                            sh.rules_for_mesh(axis.mesh))
    return {k: _take(v, shard_dim(specs[k], axis.dims), axis.size,
                     axis.index) for k, v in batch.items()}


def gather_params(shards: Any, dims: Any, axis: coll.MeshAxis) -> Any:
    """The whole parameter tree from every rank's shards."""
    return tree_map(lambda p, d: p if d is None else
                    coll.all_gather(p, axis, d), shards, dims)


def make_loss_and_grads(model: Model, axis: coll.MeshAxis,
                        microbatch: int = 1) -> Callable:
    """Returns f(param shards, local batch) -> (the global batch's mean
    loss, the gradient shards of that mean) for this rank of the
    data-parallel ``axis`` (:func:`data_axis` of a ``DeviceMesh`` or a
    ``collectives.MetaMesh``)."""
    size = axis.size
    dims: List[Optional[int]] = tree_flatten(shard_dims(model, axis))[0]

    def global_loss_and_grads(params, batch):
        shards, treedef = tree_flatten(params)
        with torch.no_grad():
            full = [p if d is None else coll.all_gather(p, axis, d)
                    for p, d in zip(shards, dims)]
        leaves = [p.detach().requires_grad_(True) for p in full]
        del full
        # each rank's batch is one MoE routing group
        loss, grads = step_lib.loss_and_grads(model, leaves, treedef, batch,
                                              1, microbatch)
        del leaves
        with torch.no_grad():
            grads = [coll.all_reduce(g, axis) / size if d is None
                     else coll.reduce_scatter(g, axis, d) / size
                     for g, d in zip(grads, dims)]
            loss = coll.all_reduce(loss, axis) / size
        return loss, tree_unflatten(treedef, grads)

    return global_loss_and_grads


def make_data_parallel_step(model: Model, opt_cfg: opt_lib.OptConfig,
                            schedule: Callable[[Array], Array],
                            axis: coll.MeshAxis,
                            microbatch: int = 1) -> Callable:
    """Returns f(param shards, opt-state shards, local batch) -> (param
    shards, opt-state shards, metrics) for this rank of the data-parallel
    ``axis``.  ``metrics`` are the global batch's ``loss`` and
    ``grad_norm`` (before clipping), ``lr`` and ``step`` (after the
    update), as ``make_train_step``'s."""
    dims: List[Optional[int]] = tree_flatten(shard_dims(model, axis))[0]
    unclipped = dataclasses.replace(opt_cfg, grad_clip=0.0)
    loss_and_grads = make_loss_and_grads(model, axis, microbatch)

    def train_step(params, opt_state, batch):
        loss, grad_tree = loss_and_grads(params, batch)
        grads, treedef = tree_flatten(grad_tree)
        with torch.no_grad():
            sq = lambda ds: sum((torch.sum(torch.square(g.float()))
                                 for g, d in zip(grads, dims) if ds(d)),
                                torch.zeros((), dtype=torch.float32,
                                            device=loss.device))
            total = coll.all_reduce(sq(lambda d: d is not None), axis) \
                + sq(lambda d: d is None)
            gnorm = torch.sqrt(total)
            if opt_cfg.grad_clip > 0:
                scale = torch.clamp(opt_cfg.grad_clip
                                    / torch.clamp_min(gnorm, 1e-9), max=1.0)
                grads = [g * scale.to(g.dtype) for g in grads]
            lr = schedule(opt_state.step)
            params, opt_state = opt_lib.apply(
                unclipped, lr, params, tree_unflatten(treedef, grads),
                opt_state)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step": opt_state.step}
        return params, opt_state, metrics

    return train_step
