"""The work of a step run on ``meta``: matrix-product FLOPs and HBM bytes.

The port's counterpart of ``topology.hlocost`` for a cell lowered
without devices (``launch.lowering``): the reference reads FLOPs and
bytes off the compiled HLO, the port counts the aten ops of the one run
of logical coordinate 0's step under :func:`count_costs`, a
``TorchDispatchMode`` that sees every op below autograd, the backward's
(and a checkpoint's recompute) included.

* **FLOPs** are those of matrix products alone (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, convolutions, the fused attentions), by the
  formulas of ``torch.utils.flop_counter``'s registry, keyed by the
  product's dtype: ``hlocost``'s "2 M N K for every dot", elementwise
  work not counted.
* **HBM bytes** are each op's tensor inputs plus its outputs: the port
  runs eagerly and unfused, so every op reads its inputs and writes its
  outputs.  An argument an op only writes (``copy_``'s destination,
  ``fill_``, ``zero_``, an ``out=``) counts once, as an output; one
  whose shape alone it reads (``zeros_like``'s) not at all.
* Ops that only alias or describe a tensor cost nothing: views (every op
  whose results alias its inputs), ``t``, ``expand``, ``detach``,
  ``empty*``, ``new_empty`` (:data:`FREE_OPS`, the counterpart of
  ``hlocost._FREE_OPS``).
* Collectives (``parallel.collectives``, which report each one through
  :func:`add_collective`) count under ``collective_bytes``
  (``traffic.total_collective_bytes``), never under ``hbm_bytes``;
  ``c10d`` ops of a live step are skipped.

Code that computes nothing on ``meta`` (the attention's and the WKV
recurrence's chunk loops, the Mamba scan) reports the work its real
computation would count through :func:`add`.  The counters are
process-wide, as the collective recorder is: a step run on the card
runs its backward on the autograd engine's device thread.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .traffic import CollectiveOp, total_collective_bytes

# ops that allocate or reinterpret without moving bytes (views, whose
# results alias their inputs, are recognised by their schema)
FREE_OPS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "_unsafe_view"})

# ops that write their first argument without reading it, and ops that
# read only its shape
_WRITE_ONLY_SELF = frozenset({"copy_", "fill_", "zero_"})
_SHAPE_ONLY_SELF = frozenset({"zeros_like", "ones_like", "full_like",
                              "rand_like", "randn_like", "new_zeros",
                              "new_ones", "new_full"})

_DTYPE_NAMES = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.float64: "f64", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2", torch.int8: "s8", torch.int32: "s32",
    torch.int64: "s64",
}


def dtype_name(dtype: torch.dtype) -> str:
    """HLO's name of a dtype (``f32``, ``bf16``, ...)."""
    return _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


@dataclass
class OpCost:
    """What a counted run did: ``flops`` (matrix products, by dtype in
    ``flops_by_dtype``), ``hbm_bytes`` and, per op and input shapes,
    ``by_op[(name, shapes)] = [calls, bytes, flops]``.  The collectives
    reported to it are in ``collectives``; ``collective_bytes`` is their
    wire bytes summed over participants."""
    flops: float = 0.0
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    hbm_bytes: float = 0.0
    by_op: Dict[Tuple[str, str], List[float]] = field(default_factory=dict)
    collectives: List[CollectiveOp] = field(default_factory=list)

    @property
    def collective_bytes(self) -> int:
        return total_collective_bytes(self.collectives)

    def _add(self, name: str, shapes: str, flops: float, nbytes: float,
             dtype: Optional[str]) -> None:
        self.hbm_bytes += nbytes
        if flops:
            self.flops += flops
            self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) \
                + flops
        row = self.by_op.setdefault((name, shapes), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += nbytes
        row[2] += flops


_active: List[OpCost] = []
_lock = threading.Lock()


def add(name: str, flops: float, nbytes: float,
        dtype: torch.dtype = torch.float32, shapes: str = "") -> None:
    """Adds work computed elsewhere (a closed form of code that does not
    run on ``meta``) to every active counter: ``flops`` of products of
    ``dtype`` and ``nbytes`` of HBM traffic, as one call of ``name``."""
    with _lock:
        for cost in _active:
            cost._add(name, shapes, float(flops), float(nbytes),
                      dtype_name(dtype))


def add_collective(op: CollectiveOp) -> None:
    """Reports a collective the step issued to every active counter."""
    with _lock:
        for cost in _active:
            cost.collectives.append(op)


def active() -> bool:
    """Whether a counter is running (code that reports its own work can
    skip the arithmetic otherwise)."""
    return bool(_active)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _unread(func, args, kwargs) -> List[torch.Tensor]:
    """The arguments ``func`` does not read: those it only writes, and
    those whose shape alone it reads."""
    out = [v for k, v in kwargs.items()
           if k.startswith("out") and isinstance(v, torch.Tensor)]
    name = func._schema.name.split("::")[-1]
    if (name in _WRITE_ONLY_SELF or name in _SHAPE_ONLY_SELF) and args:
        out.append(args[0])
    return out


def op_cost(func, args, kwargs, out) -> Tuple[float, Optional[str], int]:
    """``(flops, the product's dtype, bytes)`` of one aten op call."""
    name = func._schema.name.split("::")[-1]
    if func.namespace in ("c10d", "_c10d_functional", "c10d_functional") \
            or name in FREE_OPS or _is_view(func):
        return 0.0, None, 0
    skip = {id(t) for t in _unread(func, args, kwargs)}
    ins = [t for t in tree_flatten((args, kwargs))[0]
           if isinstance(t, torch.Tensor) and id(t) not in skip]
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
    flops, dtype = 0.0, None
    counter = flop_registry.get(func._overloadpacket)
    if counter is not None:
        flops = float(counter(*args, **kwargs, out_val=out))
        dtype = dtype_name(outs[0].dtype) if outs else None
    return flops, dtype, nbytes


def _shapes(args, kwargs) -> str:
    return ",".join(str(tuple(t.shape)) for t in tree_flatten((args, kwargs))[0]
                    if isinstance(t, torch.Tensor))


class _Counter(TorchDispatchMode):
    """Adds every op it sees to its own :class:`OpCost` (a nested
    counter's mode sees the same ops)."""

    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops, dtype, nbytes = op_cost(func, args, kwargs, out)
        if nbytes or flops:
            with _lock:
                self.cost._add(func._schema.name.split("::")[-1],
                               _shapes(args, kwargs), flops, nbytes, dtype)
        return out


@contextlib.contextmanager
def count_costs() -> Iterator[OpCost]:
    """Counts the work of the ops run inside: yields the :class:`OpCost`
    it fills."""
    cost = OpCost()
    with _lock:
        _active.append(cost)
    try:
        with _Counter(cost):
            yield cost
    finally:
        with _lock:
            _active.remove(cost)
