"""Parameter declarations: one source of truth for shapes and init.

Every layer declares its parameters as a tree (nested dicts and lists) of
:class:`PDecl`, with the reference's keys, shapes and ``(in, out)``
weight layouts, so a tree of the reference's arrays converts leaf for
leaf (``convert.lm_params_from_reference``).  From the declarations come
``init_params`` (tensors drawn from an explicit ``torch.Generator``),
``abstract_params`` (meta tensors: shapes and dtypes, no storage),
``param_specs`` (each leaf's logical ``PartitionSpec``, the reference's,
which ``parallel.sharding`` resolves against a mesh) and
``count_params``.

:func:`tree_flatten` and :func:`tree_unflatten` walk a tree in
``jax.tree_util``'s order -- dict keys sorted, lists and tuples (named
tuples such as ``train.optimizer.OptState`` too) in order -- so that a
sum over the leaves and a checkpoint's leaf numbering are the
reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..parallel.sharding import PartitionSpec as P


@dataclass(frozen=True)
class PDecl:
    """Declaration of a single parameter tensor."""
    shape: Tuple[int, ...]
    spec: P = P()
    init: str = "normal"      # normal | zeros | ones | embed
    dtype: torch.dtype = torch.float32
    fan_in: Optional[int] = None   # for "normal": stddev = 1/sqrt(fan_in)
    # the dim the spec shards over ``tp`` is this many equal blocks side
    # by side (Mamba's ``in_proj``: u and z), each sharded by itself
    tp_blocks: int = 1


def _rebuild(tree, children):
    """A list, tuple or named tuple of ``tree``'s type from ``children``."""
    if hasattr(tree, "_fields"):
        return type(tree)(*children)
    return type(tree)(children)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a tree of dicts, lists and tuples (dicts
    walked in insertion order, so draws made by ``fn`` follow the
    declarations).  With further trees of the same structure ``fn`` takes
    one leaf of each."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


class TreeDef:
    """The structure of a flattened tree: the tree with every leaf
    replaced by ``None``, dicts rebuilt with their keys sorted."""

    def __init__(self, skeleton: Any, num_leaves: int):
        self.skeleton = skeleton
        self.num_leaves = num_leaves

    def __repr__(self) -> str:
        return f"TreeDef({self.skeleton!r})"


# The walks below are module functions, not recursive closures: a nested
# function that calls itself is a reference cycle, which would keep every
# leaf it saw (whole parameter trees) alive until the garbage collector
# runs.

def _skeleton(t, leaves: List[Any]):
    if isinstance(t, dict):
        return {k: _skeleton(t[k], leaves) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return _rebuild(t, [_skeleton(v, leaves) for v in t])
    leaves.append(t)
    return None


def _fill(t, it):
    if isinstance(t, dict):
        return {k: _fill(v, it) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return _rebuild(t, [_fill(v, it) for v in t])
    return next(it)


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    """``(leaves, treedef)`` in ``jax.tree_util.tree_flatten``'s order."""
    leaves: List[Any] = []
    skeleton = _skeleton(tree, leaves)
    return leaves, TreeDef(skeleton, len(leaves))


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef``'s structure holding ``leaves`` in order."""
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{treedef.num_leaves}")
    return _fill(treedef.skeleton, iter(leaves))


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree in ``jax.tree_util``'s order."""
    return tree_flatten(tree)[0]


def stack(decls, n: int):
    """Prepend a layer dimension (the reference scans over it), unsharded
    in every spec."""
    return tree_map(lambda d: replace(d, shape=(n,) + tuple(d.shape),
                                      spec=P(None, *d.spec)), decls)


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


def abstract_params(decls) -> Any:
    """Meta tensors of every leaf's shape and dtype (no storage)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), decls)


def param_specs(decls) -> Any:
    """Every leaf's logical ``PartitionSpec``."""
    return tree_map(lambda d: d.spec, decls)


def param_tp_blocks(decls) -> Any:
    """Every leaf's ``tp_blocks``."""
    return tree_map(lambda d: d.tp_blocks, decls)


def count_params(decls) -> int:
    return int(sum(math.prod(d.shape) for d in tree_leaves(decls)))
