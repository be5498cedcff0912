"""Collectives of the sharded train step, their recorder, and int8
error-feedback gradient compression.

**The step's collectives.** :func:`all_gather`, :func:`reduce_scatter`
(a sum) and :func:`all_reduce` (a sum, or a max) act over a
:class:`MeshAxis`: one dim of a ``torch.distributed.device_mesh.
DeviceMesh``, or several taken together as one (("pod", "data") on a
multi-pod mesh).  :class:`CopyToModel`, :class:`ReduceFromModel`,
:class:`GatherFromModel` and :class:`GatherReplicated` are the
tensor-parallel ``model`` axis's under autograd
(``parallel.tensor_parallel``): each issues its backward's collective,
if any, through the same functions.  A
:class:`MetaMesh` stands in for a mesh and communicates nothing: the
collectives over its axes return ``meta`` tensors of the right shapes,
which is how a step is lowered without devices (``launch.lowering``).

**The recorder.** Inside :func:`record_collectives` every collective of
the process is appended to the yielded list as a
``topology.traffic.CollectiveOp``: the logical collective the step asks
for, named as HLO names it, with
HLO's bytes (the result a participant holds: the whole tensor of an
all-gather or all-reduce, the shard of a reduce-scatter) and the replica
groups in the mesh's logical device ids (positions in the mesh, not the
ranks that back them); a running ``topology.opcost`` counter gets each
one too.  A reduce-scatter calls the backend's own
``reduce_scatter_tensor`` on the backends of :data:`NATIVE_REDUCE_SCATTER`
(NCCL); gloo has none on CUDA tensors, so there it runs as an all-reduce
and the rank's slice, and is still recorded as the ``reduce-scatter`` of
the shard's bytes: the live trace of a step equals its lowered trace on
every backend.

**Compression.** ``compressed_allreduce_mean``: each rank quantises its
local gradient to int8 with a per-tensor scale, all-gathers the int8
payload and the scales, and dequantises and averages locally -- a quarter
of the wire bytes of an f32 all-reduce.  The quantisation error is fed
back into the next step's gradient (an error-feedback buffer), which
keeps SGD converging (Karimireddy et al.).  The reference's
``repro/parallel/collectives.py`` on ``torch.distributed``: its mesh
axis becomes a process group.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..topology import opcost
from ..topology.traffic import CollectiveOp

Array = torch.Tensor
MeshDim = Union[str, Sequence[str]]


class MetaMesh:
    """A mesh of logical device ids that communicates nothing: the
    ``DeviceMesh`` attributes the collectives read (``mesh``,
    ``mesh_dim_names``, ``device_type``, ``size``, ``get_coordinate``),
    seen from logical coordinate 0.  Every collective over it returns a
    ``meta`` tensor of its result's shape."""

    device_type = "meta"

    def __init__(self, shape: Sequence[int], mesh_dim_names: Sequence[str]):
        self.mesh = torch.arange(math.prod(shape)).reshape(tuple(shape))
        self.mesh_dim_names = tuple(mesh_dim_names)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return self.mesh.numel() if mesh_dim is None \
            else self.mesh.shape[mesh_dim]

    def get_coordinate(self) -> List[int]:
        return [0] * self.mesh.dim()


class MeshAxis:
    """One collective axis of ``mesh`` (a ``DeviceMesh`` or a
    :class:`MetaMesh`): its dim ``mesh_dim``, a name or a tuple of names
    taken together.  Holds the axis's ``size``, this rank's ``index``
    along it, its replica ``groups`` in logical ids, the process
    ``group`` (``None`` on a :class:`MetaMesh`) and ``order``, the group
    rank of each position of this rank's group (a process group numbers
    its members by global rank, a placed mesh by position).  Made once
    per mesh and axis: on a ``DeviceMesh`` several dims taken together
    make a new process group, which every rank of the world must make
    with it."""

    def __init__(self, mesh, mesh_dim: MeshDim):
        dims = (mesh_dim,) if isinstance(mesh_dim, str) else tuple(mesh_dim)
        self.mesh, self.dims = mesh, dims
        names = tuple(mesh.mesh_dim_names)
        missing = [d for d in dims if d not in names]
        if missing:
            raise ValueError(f"mesh {names} has no dim {missing[0]!r}")
        shape = tuple(mesh.mesh.shape)
        axes = [names.index(d) for d in dims]
        rest = [i for i in range(len(shape)) if i not in axes]
        sizes = [shape[i] for i in axes]
        self.size = math.prod(sizes)
        logical = np.arange(math.prod(shape)).reshape(shape)
        self.groups = logical.transpose(rest + axes).reshape(
            -1, self.size).tolist()
        coord = mesh.get_coordinate()
        self.index = int(np.ravel_multi_index(
            [coord[i] for i in axes], sizes)) if sizes else 0
        self.group = None
        self.order = list(range(self.size))
        if isinstance(mesh, MetaMesh):
            return
        ranks = mesh.mesh.permute(rest + axes).reshape(-1, self.size)
        if len(dims) == 1:
            self.group = mesh.get_group(dims[0])
        else:
            self.group, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
        mine = next(row for row in ranks.tolist() if dist.get_rank() in row)
        self.order = [dist.get_group_rank(self.group, r) for r in mine]


# Backends whose reduce_scatter_tensor ``reduce_scatter`` calls.  Gloo
# runs the all-reduce and slice; a CPU world that adds "gloo" here (its
# reduce_scatter_tensor takes CPU tensors in recent PyTorch) runs the NCCL
# path's shard order on the CPU.
NATIVE_REDUCE_SCATTER = {"nccl"}

# The open recorders of the process.  Not per thread: a backward on the
# card, and the forward that a checkpoint recomputes inside it, run on the
# autograd engine's device thread, and their collectives belong to the
# step that called ``torch.autograd.grad``.
_recorders: List[List[CollectiveOp]] = []
_recorders_lock = threading.Lock()


@contextlib.contextmanager
def record_collectives():
    """Yield a list to which every collective of this module issued in
    this process inside the ``with`` is appended, as a ``CollectiveOp``
    (a rank is one process, and runs one step at a time)."""
    ops: List[CollectiveOp] = []
    with _recorders_lock:
        _recorders.append(ops)
    try:
        yield ops
    finally:
        with _recorders_lock:
            _recorders.remove(ops)


def _record(kind: str, result: Array, axis: MeshAxis) -> None:
    op = CollectiveOp(kind=kind, bytes=result.numel() * result.element_size(),
                      groups=[list(g) for g in axis.groups])
    with _recorders_lock:
        for ops in _recorders:
            ops.append(op)
    opcost.add_collective(op)


def all_gather(x: Array, axis: MeshAxis, dim: int = 0) -> Array:
    """The shards of every position along ``axis`` concatenated on
    ``dim``, in position order."""
    shape = list(x.shape)
    shape[dim] *= axis.size
    if axis.group is None:
        out = x.new_empty(shape, device="meta")
    else:
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x.contiguous(), group=axis.group)
        out = torch.cat([parts[g] for g in axis.order], dim=dim)
    _record("all-gather", out, axis)
    return out


def reduce_scatter(x: Array, axis: MeshAxis, dim: int = 0) -> Array:
    """The sum of ``x`` over the positions along ``axis``, cut in equal
    slices on ``dim``; this rank keeps the slice of its position.  Off
    :data:`NATIVE_REDUCE_SCATTER`: an all-reduce, then the slice."""
    if x.shape[dim] % axis.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {axis.size} shards")
    chunk = x.shape[dim] // axis.size
    if axis.group is None:
        shape = list(x.shape)
        shape[dim] = chunk
        out = x.new_empty(shape, device="meta")
    elif dist.get_backend(axis.group) in NATIVE_REDUCE_SCATTER:
        # the backend slices by group rank, the mesh by position
        src = x.movedim(dim, 0)
        by_group_rank = [None] * axis.size
        for pos, g in enumerate(axis.order):
            by_group_rank[g] = src[pos * chunk:(pos + 1) * chunk]
        src = torch.cat(by_group_rank).contiguous()
        out = src.new_empty((chunk,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=axis.group)
        out = out.movedim(0, dim)
    else:
        total = x.clone()
        dist.all_reduce(total, group=axis.group)
        out = total.narrow(dim, axis.index * chunk, chunk).clone()
    _record("reduce-scatter", out, axis)
    return out


def all_reduce(x: Array, axis: MeshAxis, op: str = "sum") -> Array:
    """The sum (``op="max"``: the largest) of ``x`` over the positions
    along ``axis``."""
    if axis.group is None:
        out = x.new_empty(x.shape, device="meta")
    else:
        out = x.clone()
        dist.all_reduce(out, op=_REDUCE_OPS[op], group=axis.group)
    _record("all-reduce", out, axis)
    return out


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


# ----------------------------------------------- the model axis under autograd
# The tensor-parallel step's collectives (Megatron-LM's f, g and the
# gathers): each issues its backward's collective, if any, through the
# functions above too, so a step's recorded trace holds both passes.

class CopyToModel(torch.autograd.Function):
    """*f*: the identity forward, the gradients' sum over ``axis``
    backward.  On the input of a column-parallel product, and on a
    replicated parameter that acts on this rank's part of a sharded
    activation: each rank's gradient is a part of the whole."""

    @staticmethod
    def forward(ctx, x: Array, axis: MeshAxis) -> Array:
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: Array):
        return all_reduce(grad, ctx.axis), None


class ReduceFromModel(torch.autograd.Function):
    """*g*: the sum over ``axis`` forward, the identity backward.  On the
    output of a row-parallel product (the parts' sum)."""

    @staticmethod
    def forward(ctx, x: Array, axis: MeshAxis) -> Array:
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad: Array):
        return grad, None


class GatherFromModel(torch.autograd.Function):
    """The shards along ``dim`` gathered forward; backward, the
    gradients' sum over ``axis``, this rank's slice of it kept (a
    reduce-scatter).  For k and v, which every rank uses whole."""

    @staticmethod
    def forward(ctx, x: Array, axis: MeshAxis, dim: int) -> Array:
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad: Array):
        return reduce_scatter(grad.contiguous(), ctx.axis, ctx.dim), None, None


class GatherReplicated(torch.autograd.Function):
    """The shards along ``dim`` gathered forward; backward, this rank's
    slice of the gradient, with no collective.  For a tensor that every
    rank of ``axis`` uses whole in the same computation (RWKV's channel
    mix gate meeting the whole ``kv``): the gradient is then the same
    on every rank, whole already."""

    @staticmethod
    def forward(ctx, x: Array, axis: MeshAxis, dim: int) -> Array:
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad: Array):
        n = grad.shape[ctx.dim] // ctx.axis.size
        return grad.narrow(ctx.dim, ctx.axis.index * n, n), None, None


def quantize_int8(x: Array) -> Tuple[Array, Array]:
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: Array, scale: Array) -> Array:
    return q.float() * scale


def compressed_allreduce_mean(g: Array, err: Array,
                              group: Optional[dist.ProcessGroup] = None
                              ) -> Tuple[Array, Array]:
    """Error-feedback int8 all-reduce-mean over the ranks of ``group``
    (default: the world).  Every rank calls it with its own ``g`` and
    error buffer ``err`` (f32, ``g``'s shape).

    Returns (mean gradient f32, new error-feedback buffer).
    """
    g_corr = g.float() + err
    q, scale = quantize_int8(g_corr)
    new_err = g_corr - dequantize_int8(q, scale)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]          # int8 on the wire
    ss = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q.contiguous(), group=group)
    dist.all_gather(ss, scale.reshape(()).contiguous(), group=group)
    qs, ss = torch.stack(qs), torch.stack(ss)
    mean = torch.mean(qs.float() * ss.reshape((-1,) + (1,) * g.dim()), dim=0)
    return mean, new_err
