"""Meshes: the instance mesh of local devices, and the LM stack's
production meshes of logical devices.

The port of ``repro/launch/mesh.py``.  The reference uses one JAX
``Mesh`` for two different programs; the port takes PyTorch's own form
of each:

* **Instances** (this module, ``core.batch_sharded``): a single-process
  :class:`Mesh` of local devices.  One engine splits a wave's instances
  across the devices of one axis and solves each slice on its device; no
  data passes between the slices.
* **Processes** (``core.distributed``): a
  ``torch.distributed.device_mesh.DeviceMesh`` of ranks, SPMD as MPI is.

A mesh may name one device more than once; its shards then share that
device.  That is how the CPU (``make_instance_mesh(4, device="cpu")``,
the counterpart of XLA's ``--xla_force_host_platform_device_count``) and
a single card (``make_mesh_with_devices([cuda:0] * 4, (4,),
("instances",))``) stand in for four devices.

``make_production_mesh`` builds the LM stack's meshes -- (16, 16) over
("data", "model"), (2, 16, 16) over ("pod", "data", "model") -- as grids
of logical device ids (0 .. n-1), which need no devices: a cell is
lowered against one on a single card (``launch.lowering``: ZeRO-3 over
``data``, tensor-parallel over ``model``), and
``launch.placement.apply_placement`` decides which physical device backs
each id.  :func:`activate_mesh` makes a mesh ambient
(:func:`current_mesh`), as the reference's does.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device


def canonical_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its card index filled in."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An n-dimensional grid of ``torch.device``s with named axes, as a
    ``jax.sharding.Mesh``: ``devices`` (a numpy object array),
    ``axis_names``, ``shape`` (an ordered name -> size mapping) and
    ``size``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"{arr.ndim}-d device grid with axis names "
                             f"{self.axis_names}")
        self.devices = arr

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh_with_devices(devices: Sequence, shape: Tuple[int, ...],
                           axes: Tuple[str, ...]) -> Mesh:
    """A mesh of ``devices`` (devices or names, in order) laid out as
    ``shape`` with axis names ``axes``."""
    flat = np.empty(len(devices), dtype=object)
    flat[:] = [canonical_device(d) for d in devices]
    return Mesh(flat.reshape(shape), axes)


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh as a grid of logical device ids (ints): 256
    single-pod, 512 over two pods."""
    shape, axes = production_shape(multi_pod)
    return Mesh(np.arange(int(np.prod(shape)), dtype=object).reshape(shape),
                axes)


_ambient = threading.local()


@contextlib.contextmanager
def activate_mesh(mesh):
    """Make ``mesh`` (a :class:`Mesh` or a ``DeviceMesh``) ambient for the
    body of a ``with``: :func:`current_mesh` returns it there."""
    prev = getattr(_ambient, "mesh", None)
    _ambient.mesh = mesh
    try:
        yield mesh
    finally:
        _ambient.mesh = prev


def current_mesh():
    """The innermost :func:`activate_mesh`'s mesh, else ``None``."""
    return getattr(_ambient, "mesh", None)


def _local_devices(device) -> list:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_local_mesh(axes: Tuple[str, ...] = ("data", "model"),
                    device=None) -> Mesh:
    """Smallest mesh over whatever devices exist: every card (``cuda``
    unless ``device`` says otherwise), or the one CPU, on the last
    axis."""
    avail = _local_devices(device)
    shape = (1,) * (len(axes) - 1) + (len(avail),)
    return make_mesh_with_devices(avail, shape, axes)


def make_instance_mesh(num_devices: Optional[int] = None,
                       axis: str = "instances", device=None) -> Mesh:
    """1-D mesh for sharding a solver wave's *instance* axis
    (``core.batch_sharded``).

    On ``cuda`` (the default) it takes the first ``num_devices`` cards
    (all of them by default) and refuses more than there are.  On the CPU
    it names the CPU ``num_devices`` times (once by default): N emulated
    devices that share the host, as XLA's host-device flag gives them.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        n = 1 if num_devices is None else int(num_devices)
        if n < 1:
            raise ValueError(f"num_devices={num_devices} must be >= 1")
        return make_mesh_with_devices([dev] * n, (n,), (axis,))
    avail = _local_devices(dev)
    n = len(avail) if num_devices is None else int(num_devices)
    if n < 1 or n > len(avail):
        raise ValueError(
            f"num_devices={num_devices} not in [1, {len(avail)}] -- to "
            "emulate more devices, name one card more than once: "
            f"make_mesh_with_devices(['cuda:0'] * {n}, ({n},), "
            f"({axis!r},))")
    return make_mesh_with_devices(avail[:n], (n,), (axis,))
