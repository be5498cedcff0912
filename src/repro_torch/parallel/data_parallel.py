"""The sharded train step: the reference's ``jax.jit(train_step,
in_shardings=...)`` on a mesh of ("pod",) "data" and "model" axes.

Every rank runs the same step (SPMD) on its slice of the global batch.
The step follows the resolved specs (``Model.specs`` under
``sharding.rules_for_mesh``, whose ``fsdp`` and ``batch`` are ``data``,
or ("pod", "data") on a multi-pod mesh, and whose ``tp`` and ``ep`` are
``model``):

* a parameter whose spec names the data-parallel axes on one dim is held
  as its shard along that dim (ZeRO-3): all-gathered for use, its
  gradient reduce-scattered back to the shard;
* a replicated parameter is held whole, its gradient all-reduced;
* on a ``model`` axis above 1 a parameter whose spec names ``model`` on a
  dim is held as its part along that dim too (``tp_blocks`` of them side
  by side for a fused weight; an MoE layer's ``E / m`` experts), never
  gathered over ``model``: the layers run on their parts and issue the
  tensor-parallel collectives (``parallel.tensor_parallel``), so every
  gradient comes out whole over ``model`` for what the rank holds;
* the optimizer state shards as the parameters (``optimizer.state_specs``)
  and AdamW updates each rank's shard;
* the batch is split on its rows as ``batch_partition_specs`` says; the
  ranks of one model group take the same rows.

The loss and the gradients are the global batch's mean (each rank's
local mean, summed over the data ranks, over their number); the global
gradient norm adds every element's square once over both axes, and
clips as ``optimizer.apply`` clips.  Each rank's batch is one MoE
routing group (the reference passes ``num_groups`` = data-parallel
width for the global batch).

:func:`make_serve_steps` gives a rank's serving steps on the same
layout: ``Model.prefill`` and ``Model.decode_step`` on the parameters
gathered over data, with no gradient, on the rank's rows of the batch
(all of them where the global batch does not split over data, as the
reference's ``rules["batch"] = None``); on a ``model`` axis the caches
are the rank's parts (:func:`cache_layout`: KV positions over ``seq``,
Mamba channels and RWKV heads over ``tp``) and the logits its columns
of the vocabulary (:func:`greedy_tokens` takes the whole vocabulary's
argmax).

Nothing in the step reads a value, so it runs on ``meta`` tensors over a
``collectives.MetaMesh``: that is how ``launch.lowering`` records its
collectives without devices.  The one-device ``train.step.make_train_step``
is unchanged, and on a ``model`` axis of 1 so is this step: it issues no
model-axis collective and makes no model-axis group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models import moe
from ..models.api import Model, batch_partition_specs
from ..models.config import ModelConfig, ShapeCell
from ..models.param import (param_tp_blocks, tree_flatten, tree_map,
                            tree_unflatten)
from ..train import optimizer as opt_lib
from ..train import step as step_lib
from . import collectives as coll
from . import sharding as sh
from . import tensor_parallel as tp

Array = torch.Tensor


def data_axis(mesh) -> coll.MeshAxis:
    """The mesh's data-parallel axis: its ("pod", "data") dims, or
    ("data",), taken together.  Raises for axes other than pod, data and
    model (``sharding.check_mesh``)."""
    sh.check_mesh(mesh)
    return coll.MeshAxis(mesh, tuple(a for a in ("pod", "data")
                                     if a in mesh.mesh_dim_names))


def model_axis(mesh) -> Optional[coll.MeshAxis]:
    """The mesh's ``model`` dim when it is above 1, else ``None`` (the
    data-parallel step)."""
    names = tuple(mesh.mesh_dim_names)
    if "model" not in names or mesh.mesh.shape[names.index("model")] == 1:
        return None
    return coll.MeshAxis(mesh, "model")


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_dim(spec: sh.PartitionSpec, axes: Tuple[str, ...]) -> Optional[int]:
    """The dim a resolved spec shards over ``axes``, the dims of a data
    or a model axis (``None``: replicated over them); a spec that names
    only some of ``axes`` raises."""
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


def spec_dims(specs: Any, axis: coll.MeshAxis,
              rules: Optional[sh.Rules] = None) -> Any:
    """A tree of logical specs as shard dims over ``axis`` (ints or
    ``None``), resolved by ``rules`` (default: the mesh's)."""
    return tree_map(lambda s: shard_dim(
        sh.named_sharding(axis.mesh, s, rules).spec, axis.dims), specs)


def shard_dims(model: Model, axis: coll.MeshAxis) -> Any:
    """The parameter tree's shard dims over ``axis``."""
    return spec_dims(model.specs(), axis)


def _take(x: Array, dim: Optional[int], size: int, index: int,
          blocks: int = 1) -> Array:
    if dim is None:
        return x
    if x.shape[dim] % (size * blocks):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {size} shards" + (
                             f" of {blocks} blocks" if blocks > 1 else ""))
    n = x.shape[dim] // (size * blocks)
    if blocks == 1:
        return x.narrow(dim, index * n, n).clone()
    return torch.cat([x.narrow(dim, (b * size + index) * n, n)
                      for b in range(blocks)], dim)


def _ones(dims: Any) -> Any:
    return tree_map(lambda d: 1, dims)


def shard_params(params: Any, dims: Any, axis: coll.MeshAxis,
                 blocks: Any = None) -> Any:
    """This rank's shards of a whole parameter (or moment) tree along
    ``dims`` over ``axis``: of each of a leaf's ``blocks`` (default 1)
    side by side along its dim."""
    blocks = _ones(dims) if blocks is None else blocks
    return tree_map(lambda p, d, k: _take(p, d, axis.size, axis.index, k),
                    params, dims, blocks)


def splits_batch(axis: coll.MeshAxis, cell: ShapeCell) -> bool:
    """Whether the ranks of the data ``axis`` hold different rows of
    ``cell``'s global batch: a train cell's always, a prefill or decode
    cell's where the batch splits whole (not ``long_500k``'s one
    sequence)."""
    return cell.kind == "train" or cell.global_batch % axis.size == 0


def serve_rules(axis: coll.MeshAxis, cell: ShapeCell) -> sh.Rules:
    """The mesh's rules for ``cell``: a cell whose batch does not split
    over data (:func:`splits_batch`) replicates its batch and caches over
    data, as the reference's dry run sets ``rules["batch"] = None``."""
    rules = sh.mesh_rules(axis.mesh)
    if not splits_batch(axis, cell):
        rules["batch"] = None
    return rules


def shard_batch(cfg: ModelConfig, cell: ShapeCell, batch: Dict[str, Array],
                axis: coll.MeshAxis) -> Dict[str, Array]:
    """This rank's rows of a global batch, as ``batch_partition_specs``
    splits it (:func:`serve_rules`)."""
    specs = sh.resolve_tree(batch_partition_specs(cfg, cell),
                            serve_rules(axis, cell))
    return {k: _take(v, shard_dim(specs[k], axis.dims), axis.size,
                     axis.index) for k, v in batch.items()}


def _gather(p: Array, d: Optional[int], axis: coll.MeshAxis,
            blocks: int) -> Array:
    if d is None:
        return p
    whole = coll.all_gather(p, axis, d)
    if blocks == 1:
        return whole
    # (position, block, part) -> (block, position, part)
    n = p.shape[d] // blocks
    return whole.unflatten(d, (axis.size, blocks, n)).transpose(
        d, d + 1).flatten(d, d + 2)


def gather_params(shards: Any, dims: Any, axis: coll.MeshAxis,
                  blocks: Any = None) -> Any:
    """The tree whole along ``dims`` over ``axis`` from every rank's
    shards (:func:`shard_params`' inverse)."""
    blocks = _ones(dims) if blocks is None else blocks
    return tree_map(lambda p, d, k: _gather(p, d, axis, k), shards, dims,
                    blocks)


class Layout:
    """Where the leaves of a tree of ``specs`` (``tp_blocks`` in
    ``blocks``) live on a mesh's ``data`` axis and its ``model`` axis
    (``None``: 1): each leaf's shard dim over each (``dims``,
    ``model_dims``)."""

    def __init__(self, specs: Any, blocks: Any, data: coll.MeshAxis,
                 model: Optional[coll.MeshAxis] = None,
                 rules: Optional[sh.Rules] = None):
        self.data, self.model, self.blocks = data, model, blocks
        self.dims = spec_dims(specs, data, rules)
        self.model_dims = None if model is None else \
            spec_dims(specs, model, rules)

    def shard(self, tree: Any) -> Any:
        """This rank's part of a whole tree."""
        out = shard_params(tree, self.dims, self.data)
        if self.model is None:
            return out
        return shard_params(out, self.model_dims, self.model, self.blocks)

    def gather(self, tree: Any) -> Any:
        """The whole tree from every rank's parts."""
        out = gather_params(tree, self.dims, self.data)
        if self.model is None:
            return out
        return gather_params(out, self.model_dims, self.model, self.blocks)


def param_layout(model: Model, axis: coll.MeshAxis,
                 model_axis: Optional[coll.MeshAxis] = None) -> Layout:
    """The parameter tree's :class:`Layout`."""
    return Layout(model.specs(), param_tp_blocks(model.decls()), axis,
                  model_axis)


def state_layout(model: Model, opt_cfg: opt_lib.OptConfig,
                 axis: coll.MeshAxis,
                 model_axis: Optional[coll.MeshAxis] = None) -> Layout:
    """The optimizer state's :class:`Layout` (``optimizer.state_specs``:
    the moments as their parameters)."""
    blocks = param_tp_blocks(model.decls())
    return Layout(opt_lib.state_specs(opt_cfg, model.specs()),
                  opt_lib.OptState(step=1, mu=blocks, nu=blocks), axis,
                  model_axis)


def cache_layout(model: Model, cell: ShapeCell, axis: coll.MeshAxis,
                 model_axis: Optional[coll.MeshAxis] = None) -> Layout:
    """The decode cache's :class:`Layout` (``Model.cache_specs``) for
    ``cell``: its rows over data (:func:`serve_rules`), KV positions over
    ``seq`` and Mamba channels and RWKV heads over ``tp``, on the model
    axis."""
    return Layout(model.cache_specs(), None, axis, model_axis,
                  serve_rules(axis, cell))


def make_serve_steps(model: Model, axis: coll.MeshAxis,
                     model_axis: Optional[coll.MeshAxis] = None,
                     batch_split: bool = True) -> Tuple[Callable, Callable]:
    """``(prefill, decode)`` for this rank of the data-parallel ``axis``
    and of ``model_axis``: ``prefill(param shards, local batch,
    cache_len=None) -> (logits, cache)`` and ``decode(param shards,
    cache, local batch, pos) -> (logits, cache)``, ``Model.prefill`` and
    ``Model.decode_step`` on the parameters gathered over data, with no
    gradient.  ``batch_split``: the ranks of ``axis`` hold different rows
    of the global batch (:func:`splits_batch`; else each the whole
    batch).  MoE routing groups are the reference's: prefill's are the
    global batch split in data-parallel-width parts (a split batch's
    rank routes its rows as one group), decode's the global batch whole
    (under a capped capacity a split batch's MoE input is gathered over
    data, ``moe.route_over``).  On a model axis the logits (B', V / m)
    are this rank's columns of the vocabulary and the cache its part
    (:func:`cache_layout`)."""
    if model_axis is not None:
        sh.check_mesh(model_axis.mesh, model.cfg)
    dims = shard_dims(model, axis)
    groups, route = (1, axis) if batch_split else (axis.size, None)

    @torch.no_grad()
    def prefill(params, batch, cache_len=None):
        whole = gather_params(params, dims, axis)
        with tp.use_model_axis(model_axis):
            return model.prefill(whole, batch, groups, cache_len)

    @torch.no_grad()
    def decode(params, cache, batch, pos):
        whole = gather_params(params, dims, axis)
        with tp.use_model_axis(model_axis), moe.route_over(route):
            return model.decode_step(whole, cache, batch, pos)

    return prefill, decode


def greedy_tokens(logits: Array,
                  model_axis: Optional[coll.MeshAxis] = None) -> Array:
    """The greedy tokens (B',) of a serving step's logits: the whole
    vocabulary's argmax, the lowest index on ties
    (``tensor_parallel.vocab_argmax`` over ``model_axis``)."""
    with tp.use_model_axis(model_axis):
        return tp.vocab_argmax(logits)


def make_loss_and_grads(model: Model, axis: coll.MeshAxis,
                        microbatch: int = 1,
                        model_axis: Optional[coll.MeshAxis] = None
                        ) -> Callable:
    """Returns f(param shards, local batch) -> (the global batch's mean
    loss, the gradient shards of that mean) for this rank of the
    data-parallel ``axis`` (:func:`data_axis` of a ``DeviceMesh`` or a
    ``collectives.MetaMesh``) and of ``model_axis`` (:func:`model_axis`
    of the same mesh)."""
    if model_axis is not None:
        sh.check_mesh(model_axis.mesh, model.cfg)
    size = axis.size
    dims: List[Optional[int]] = tree_flatten(shard_dims(model, axis))[0]

    def global_loss_and_grads(params, batch):
        shards, treedef = tree_flatten(params)
        with torch.no_grad():
            leaves = gather_params(shards, dims, axis)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        # each rank's batch is one MoE routing group
        with tp.use_model_axis(model_axis):
            loss, grads = step_lib.loss_and_grads(model, leaves, treedef,
                                                  batch, 1, microbatch)
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
                            microbatch: int = 1,
                            model_axis: Optional[coll.MeshAxis] = None
                            ) -> Callable:
    """Returns f(param shards, opt-state shards, local batch) -> (param
    shards, opt-state shards, metrics) for this rank of the data-parallel
    ``axis`` and of ``model_axis``.  ``metrics`` are the global batch's
    ``loss`` and ``grad_norm`` (before clipping), ``lr`` and ``step``
    (after the update), as ``make_train_step``'s."""
    layout = param_layout(model, axis, model_axis)
    dims: List[Optional[int]] = tree_flatten(layout.dims)[0]
    mdims: List[Optional[int]] = [None] * len(dims) if model_axis is None \
        else tree_flatten(layout.model_dims)[0]
    unclipped = dataclasses.replace(opt_cfg, grad_clip=0.0)
    loss_and_grads = make_loss_and_grads(model, axis, microbatch, model_axis)
    # each square once: summed over the axes a leaf is sharded on (the
    # identity over a model axis of 1, which keeps the data-parallel sums)
    over_model = (lambda t: t) if model_axis is None else \
        (lambda t: coll.all_reduce(t, model_axis))

    def train_step(params, opt_state, batch):
        loss, grad_tree = loss_and_grads(params, batch)
        grads, treedef = tree_flatten(grad_tree)
        with torch.no_grad():
            sq = lambda on_data, on_model: sum(
                (torch.sum(torch.square(g.float()))
                 for g, d, md in zip(grads, dims, mdims)
                 if (d is not None) == on_data
                 and (md is not None) == on_model),
                torch.zeros((), dtype=torch.float32, device=loss.device))
            total = coll.all_reduce(over_model(sq(True, True))
                                    + sq(True, False), axis) \
                + over_model(sq(False, True)) + sq(False, False)
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
