"""The tensor-parallel ``model`` axis of a training step.

The reference shards by spec (heads, ``ff`` and the vocabulary over
``tp``; Mamba's inner channels too) and lets XLA partition the step.
The port writes the partition out: each rank holds its columns of a
column-parallel weight and its rows of a row-parallel one, and the
layers call the helpers below where the reference constrains an
activation (``sharding.shard``):

* :func:`copy_to` (*f*) on the input of every column-parallel product
  and on a replicated parameter applied to this rank's part of a
  sharded activation (``q_norm``; ``k_norm``, whose whole k serves this
  rank's q heads only): the identity, its gradient summed over ``model``;
* :func:`reduce_from` (*g*) on the output of every row-parallel product:
  the sum over ``model``, its gradient passed through;
* :func:`gather` for k and v, which every rank uses whole to serve its
  own part (and q, where every rank attends with all heads): an
  all-gather, its gradient reduce-scattered;
* :func:`gather_replicated` for a tensor that every rank uses whole in
  the same replicated computation (RWKV's channel-mix gate): an
  all-gather, its gradient this rank's slice;
* :func:`all_max` (no gradient) for the vocab-parallel logsumexp;
* :func:`combine_softmax` (no gradient), decode's flash-decoding combine
  over a KV cache sharded over ``seq`` (each rank holds ``Sc / m``
  positions): the ranks' running maxima, one all-reduce of the rescaled
  sums and outputs, then their quotient;
* :func:`vocab_argmax` (no gradient), the greedy token of vocab-parallel
  logits: the whole vocabulary's first largest entry.

The axis is ambient (:func:`use_model_axis`) and process-wide, not per
thread: the autograd engine runs a backward on the card, and the forward
a checkpoint recomputes there, on its own device thread.  With no axis
in scope, or an axis of one position, every helper is the identity and
issues nothing, so the one-device and data-parallel steps and their
traces are unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from . import collectives as coll

Array = torch.Tensor

_axis: Optional[coll.MeshAxis] = None


@contextlib.contextmanager
def use_model_axis(axis: Optional[coll.MeshAxis]):
    """Make ``axis`` (the mesh's ``model`` dim, or ``None``) the ambient
    model axis for the body of a ``with``."""
    global _axis
    prev, _axis = _axis, axis
    try:
        yield axis
    finally:
        _axis = prev


def current_axis() -> Optional[coll.MeshAxis]:
    """The ambient model axis when it has more than one position, else
    ``None``."""
    return _axis if _axis is not None and _axis.size > 1 else None


def size() -> int:
    axis = current_axis()
    return 1 if axis is None else axis.size


def part(n: int) -> Tuple[int, int]:
    """``[lo, hi)``: this rank's equal part of ``n`` (all of it off a
    model axis)."""
    axis = current_axis()
    if axis is None:
        return 0, n
    w = n // axis.size
    return axis.index * w, (axis.index + 1) * w


def copy_to(x: Array) -> Array:
    axis = current_axis()
    return x if axis is None else coll.CopyToModel.apply(x, axis)


def reduce_from(x: Array) -> Array:
    axis = current_axis()
    return x if axis is None else coll.ReduceFromModel.apply(x, axis)


def gather(x: Array, dim: int) -> Array:
    axis = current_axis()
    return x if axis is None else coll.GatherFromModel.apply(x, axis, dim)


def gather_replicated(x: Array, dim: int) -> Array:
    axis = current_axis()
    return x if axis is None else coll.GatherReplicated.apply(x, axis, dim)


def all_max(x: Array) -> Array:
    axis = current_axis()
    return x if axis is None else coll.all_reduce(x.detach(), axis, op="max")


def combine_softmax(m: Array, l: Array, o: Array) -> Array:
    """The attention output ``o / l`` over every rank's positions, from
    this rank's running max ``m`` (..), softmax sum ``l`` (..) and
    unnormalised output ``o`` (.., hd) over its own: ``M`` the ranks'
    largest ``m``, then ``sum_r l_r exp(m_r - M)`` and
    ``sum_r o_r exp(m_r - M)`` summed in one all-reduce.  Off a model
    axis, ``o / l``."""
    axis = current_axis()
    if axis is None:
        return o / l[..., None]
    scale = torch.exp(m - all_max(m))
    sums = coll.all_reduce(torch.cat([o * scale[..., None],
                                      (l * scale)[..., None]], dim=-1), axis)
    return sums[..., :-1] / sums[..., -1:]


def vocab_argmax(logits: Array) -> Array:
    """The greedy token of ``logits`` (..., V'), this rank's ``V / m``
    columns of the vocabulary (all of it off a model axis): the index of
    the whole vocabulary's largest entry, the lowest index on ties (the
    reference's ``argmax``), by two max all-reduces of (.., ) values."""
    axis = current_axis()
    local = torch.argmax(logits, dim=-1)
    if axis is None:
        return local
    top = torch.gather(logits, -1, local[..., None])[..., 0]
    lo = axis.index * logits.shape[-1]
    best = all_max(top)
    # the lowest index among the ranks holding the largest value
    mine = torch.where(top == best, -(local + lo), -(axis.size
                                                      * logits.shape[-1]))
    return -all_max(mine)
