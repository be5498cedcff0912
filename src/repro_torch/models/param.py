"""Parameter declarations: one source of truth for shapes and init.

Every layer declares its parameters as a tree (nested dicts and lists) of
:class:`PDecl`, with the reference's keys, shapes and ``(in, out)``
weight layouts, so a tree of the reference's arrays converts leaf for
leaf (``convert.lm_params_from_reference``).  From the declarations come
``init_params`` (tensors drawn from an explicit ``torch.Generator``) and
``count_params``.  The reference's sharding specs belong to its
``parallel/`` package and are not declared here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class PDecl:
    """Declaration of a single parameter tensor."""
    shape: Tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones | embed
    dtype: torch.dtype = torch.float32
    fan_in: Optional[int] = None   # for "normal": stddev = 1/sqrt(fan_in)


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree, dicts in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def stack(decls, n: int):
    """Prepend a layer dimension (the reference scans over it)."""
    return tree_map(lambda d: replace(d, shape=(n,) + tuple(d.shape)), decls)


def _init_one(d: PDecl, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    fan_in = d.fan_in if d.fan_in is not None else (
        d.shape[-2] if len(d.shape) >= 2 else d.shape[-1])
    std = 1.0 if d.init == "embed" else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.mul_(std).to(device=device, dtype=d.dtype)


def init_params(decls, generator: torch.Generator, device=None) -> Any:
    """Draw every leaf in declaration order from ``generator``: normal
    with std ``1/sqrt(fan_in)`` (``embed``: std 1) in f32, then cast to
    the leaf's dtype; ``zeros`` and ``ones`` as named.  The draws are made
    on the generator's device and land on ``device`` (default: the
    same)."""
    device = torch.device(device) if device is not None else generator.device
    return tree_map(lambda d: _init_one(d, generator, device), decls)


def count_params(decls) -> int:
    return int(sum(math.prod(d.shape) for d in tree_leaves(decls)))
