"""Hand-rolled optimizers: AdamW and SGD with momentum.

The reference's ``repro/train/optimizer.py`` on trees of tensors, with
its arithmetic in its order: moments updated in f32, the bias
corrections ``1 - b ** step`` in f32, and the decoupled weight decay
inside the ``lr *`` term.  The moment dtype comes from the model config
(``opt_dtype``): a bf16 moment is rounded to nearest even, as XLA
rounds.  Updates make new tensors; nothing is changed in place.
:func:`state_specs` gives the state's logical sharding: the moments
shard as their parameters do (``parallel.data_parallel`` updates each
rank's shard).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..models.param import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..parallel.sharding import PartitionSpec as P

Array = torch.Tensor


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | sgdm
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9        # sgdm
    grad_clip: float = 1.0       # global-norm clip; 0 disables
    moment_dtype: torch.dtype = torch.float32


class OptState(NamedTuple):
    step: Array     # 0-d int32
    mu: Any         # first moment  (adamw) / momentum (sgdm)
    nu: Any         # second moment (adamw) / unused 0-d f32 (sgdm)


def init(cfg: OptConfig, params: Any) -> OptState:
    """Zero moments beside ``params`` (on their devices)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    mu = tree_map(zeros, params)
    nu = tree_map(zeros, params) if cfg.kind == "adamw" else tree_map(
        lambda p: torch.zeros((), dtype=torch.float32, device=p.device),
        params)
    first = tree_leaves(params)
    device = first[0].device if first else None
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=mu, nu=nu)


def abstract_state(cfg: OptConfig, abstract_params: Any) -> OptState:
    """:func:`init` of meta tensors: the state's shapes and dtypes."""
    return init(cfg, abstract_params)


def state_specs(cfg: OptConfig, param_specs: Any) -> OptState:
    """The state's specs: moments as ``param_specs``, the step (and
    sgdm's unused second moment) replicated."""
    mu = param_specs
    nu = param_specs if cfg.kind == "adamw" else tree_map(
        lambda s: P(), param_specs)
    return OptState(step=P(), mu=mu, nu=nu)


def global_norm(tree: Any) -> Array:
    """``sqrt`` of the sum of every leaf's squares in f32, the leaves in
    the reference's order."""
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(l.float())) for l in leaves)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, Array]:
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


def _adamw(cfg: OptConfig, lr: Array, step_f: Array):
    def upd(p, g, m, v):
        gf = g.float()
        m32 = m.float() * cfg.b1 + gf * (1 - cfg.b1)
        v32 = v.float() * cfg.b2 + torch.square(gf) * (1 - cfg.b2)
        mhat = m32 / (1 - torch.pow(cfg.b1, step_f))
        vhat = v32 / (1 - torch.pow(cfg.b2, step_f))
        pf = p.float()
        pf = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                        + cfg.weight_decay * pf)
        return (pf.to(p.dtype), m32.to(cfg.moment_dtype),
                v32.to(cfg.moment_dtype))
    return upd


def apply(cfg: OptConfig, lr: Array, params: Any, grads: Any,
          state: OptState) -> Tuple[Any, OptState]:
    """One update: ``(new params, new state)``.  ``lr`` is a 0-d f32
    tensor (the schedule's value at ``state.step``)."""
    with torch.no_grad():
        step = state.step + 1
        if cfg.grad_clip > 0:
            grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        p_leaves, treedef = tree_flatten(params)
        g_leaves = tree_leaves(grads)
        m_leaves = tree_leaves(state.mu)
        if cfg.kind == "adamw":
            upd = _adamw(cfg, lr, step.float())
            out = [upd(p, g, m, v) for p, g, m, v in zip(
                p_leaves, g_leaves, m_leaves, tree_leaves(state.nu))]
            new = [tree_unflatten(treedef, [o[i] for o in out])
                   for i in range(3)]
            return new[0], OptState(step=step, mu=new[1], nu=new[2])
        if cfg.kind == "sgdm":
            def upd(p, g, m):
                gf = g.float() + cfg.weight_decay * p.float()
                m32 = m.float() * cfg.momentum + gf
                return ((p.float() - lr * m32).to(p.dtype),
                        m32.to(cfg.moment_dtype))
            out = [upd(p, g, m) for p, g, m in zip(p_leaves, g_leaves,
                                                   m_leaves)]
            return (tree_unflatten(treedef, [o[0] for o in out]),
                    OptState(step=step,
                             mu=tree_unflatten(treedef, [o[1] for o in out]),
                             nu=state.nu))
    raise ValueError(cfg.kind)


def warmup_cosine(lr: float, warmup: int, total: int, floor: float = 0.1
                  ) -> Callable[[Array], Array]:
    """Linear warmup to ``lr`` over ``warmup`` steps, then a cosine down
    to ``floor * lr`` at ``total``: ``schedule(step) -> 0-d f32``."""
    def schedule(step: Array) -> Array:
        s = torch.as_tensor(step).float()
        warm = lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return schedule
