"""Train-step and serve-step factories.

The factories close over static configuration (model, optimizer config,
schedule, microbatching) and return plain functions of tensors; PyTorch
runs them eagerly, so there is nothing to compile.  The reference's
``repro/train/step.py``.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.api import Model
from ..models.param import tree_flatten, tree_unflatten
from . import optimizer as opt_lib

Array = torch.Tensor


def loss_and_grads(model: Model, leaves, treedef, batch, num_groups: int = 1,
                   microbatch: int = 1):
    """``(loss, grads)`` of ``batch`` at the parameter ``leaves`` (which
    require grad; ``treedef`` rebuilds the tree), as lists in leaf order:
    a leaf that takes no part gets zeros.  ``microbatch > 1`` splits the
    batch on its leading axis and sums the pieces' f32 gradients and
    losses in order, divided by ``microbatch``."""

    def one(mb):
        loss = model.loss(tree_unflatten(treedef, leaves), mb, num_groups)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    if microbatch == 1:
        return one(batch)
    b = next(iter(batch.values())).shape[0]
    if b % microbatch:
        raise ValueError(f"batch {b} does not split into "
                         f"{microbatch} microbatches")
    per = b // microbatch
    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves]
    for i in range(microbatch):
        mb_loss, mb_grads = one({k: v[i * per:(i + 1) * per]
                                 for k, v in batch.items()})
        grads = [acc + g for acc, g in zip(grads, mb_grads)]
        loss = loss + mb_loss
    return loss / microbatch, [g / microbatch for g in grads]


def make_train_step(model: Model, opt_cfg: opt_lib.OptConfig,
                    schedule: Callable[[Array], Array],
                    num_groups: int = 1,
                    microbatch: int = 1) -> Callable:
    """Returns f(params, opt_state, batch) -> (params, opt_state, metrics).

    ``metrics`` holds 0-d tensors ``loss``, ``grad_norm`` (before
    clipping), ``lr`` and ``step`` (after the update).  ``microbatch > 1``
    accumulates gradients (:func:`loss_and_grads`), trading step latency
    for activation memory.
    """

    def train_step(params, opt_state, batch):
        p_leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in p_leaves]
        loss, grads = loss_and_grads(model, leaves, treedef, batch,
                                     num_groups, microbatch)
        del leaves
        grads = tree_unflatten(treedef, grads)

        lr = schedule(opt_state.step)
        gnorm = opt_lib.global_norm(grads)
        params, opt_state = opt_lib.apply(opt_cfg, lr, params, grads,
                                          opt_state)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step": opt_state.step}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: Model, num_groups: int = 1) -> Callable:
    def serve_prefill(params, batch):
        return model.prefill(params, batch, num_groups)
    return serve_prefill


def make_decode_step(model: Model) -> Callable:
    def serve_step(params, cache, batch, pos):
        return model.decode_step(params, cache, batch, pos)
    return serve_step
