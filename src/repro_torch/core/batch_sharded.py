"""Mesh-sharded instance dispatch for the batched mapping solvers.

The port of ``repro/core/batch_sharded.py``.  ``run_psa_batch`` /
``run_pga_batch`` / ``run_pca_batch`` solve a wave of independent
instances on a leading batch axis of one device.  The wrappers here split
that axis over the devices of one axis of an instance mesh
(``launch.mesh.Mesh``, a single-process grid of local devices): each
device runs the plain batched solver (``_psa_impl`` / ``_pga_impl`` /
``_pca_impl``) on its slice of the wave, and no data passes between the
slices because instances never communicate.  This is one of the port's
two kinds of mesh; the other, a ``DeviceMesh`` of ranks joined by
collectives, is ``core.distributed``.

Each distinct device runs its slices in a thread of its own, so every
card is given its work before any is waited for and distinct cards
overlap.  Slices that share a device (a mesh that names one device more
than once) run in turn on it: threads would only contend for the
interpreter lock there, which made four CPU shards 20x slower than
one.  The outputs are gathered onto the mesh's first device.

Equality contract: instances are solved by exactly the per-instance
program regardless of which device hosts them, so

    run_psa_batch_sharded(...)[b] == run_psa_batch(...)[b]   (bitwise)

for every real instance b (``tests/test_torch_batch_sharded.py``).

The instance axis must divide evenly across the mesh axis, so waves are
padded up to a multiple of the axis size (``pad_to_mesh_multiple``):
dummy rows replicate instance 0 and are dropped before returning.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Tuple

import numpy as np
import torch

from . import annealing, composite, genetic

DEFAULT_AXIS = "instances"


def round_up_to_multiple(b: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``b``."""
    if m < 1:
        raise ValueError(f"multiple must be >= 1, got {m}")
    return -(-b // m) * m


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.array(x)                         # a writable copy for torch
    return torch.as_tensor(x.astype(np.int64) if x.dtype == np.uint32 else x)


def _replicate_row0(arr, total: int) -> torch.Tensor:
    arr = _tensor(arr)
    pad = total - arr.shape[0]
    if pad == 0:
        return arr
    return torch.cat([arr, arr[:1].expand((pad,) + arr.shape[1:])])


def pad_to_mesh_multiple(Cs, Ms, keys, n_valid, init_perm, multiple: int):
    """Pad the leading instance axis up to a multiple of the mesh axis
    size.

    Dummy rows replicate instance 0 (including its key / n_valid /
    warm-start row), so the padded wave only re-solves work that is being
    solved anyway and every row stays a well-formed instance.  Returns
    ``(Cs, Ms, keys, n_valid, init_perm, B)``, padded, with the original
    batch size B; callers slice ``[:B]`` off the solver outputs.  Inputs
    that need no padding come back as they were given.
    """
    B = Cs.shape[0]
    if B == 0:
        raise ValueError("empty instance batch")
    Bp = round_up_to_multiple(B, multiple)
    if Bp == B:
        return Cs, Ms, keys, n_valid, init_perm, B
    return (_replicate_row0(Cs, Bp), _replicate_row0(Ms, Bp),
            _replicate_row0(keys, Bp),
            None if n_valid is None else _replicate_row0(n_valid, Bp),
            None if init_perm is None else _replicate_row0(init_perm, Bp),
            B)


def _solve(kind: str, C, M, key, cfg, num_processes: int, exchange: bool,
           n_valid, init_perm):
    """The plain batched solver of ``kind`` on one slice of the wave."""
    if kind == "psa":
        return annealing._psa_impl(C, M, key, cfg, num_processes, exchange,
                                   n_valid, init_perm)
    if kind == "pga":
        return genetic._pga_impl(C, M, key, cfg, num_processes, n_valid,
                                 init_perm)
    if kind == "pca":
        return composite._pca_impl(C, M, key, cfg, num_processes, n_valid,
                                   init_perm)
    raise ValueError(f"unknown solver kind {kind!r}")


def _axis_devices(mesh, axis: str) -> list:
    """The devices along ``axis`` (at index 0 of every other axis, which
    would hold replicas), in order; ``ValueError`` for an unknown axis."""
    if axis not in mesh.shape:
        raise ValueError(
            f"mesh has no axis {axis!r}; axes: {tuple(mesh.shape)}")
    devs = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return list(devs.reshape(devs.shape[0], -1)[:, 0])


def _dispatch_sharded(kind: str, cfg, num_processes: int, exchange: bool,
                      Cs, Ms, keys, n_valid, init_perm, mesh, axis: str
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    devices = _axis_devices(mesh, axis)
    nshard = len(devices)
    Cs, Ms, keys, n_valid, init_perm, B = pad_to_mesh_multiple(
        Cs, Ms, keys, n_valid, init_perm, nshard)
    per = Cs.shape[0] // nshard

    def shard(i: int):
        dev = devices[i]
        rows = slice(i * per, (i + 1) * per)
        # a thread starts on the first card: a tensor made for "cuda"
        # without an index must land on this shard's
        with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
            C, M, k, nv, ip = annealing.wave_inputs(
                Cs[rows], Ms[rows], keys[rows],
                None if n_valid is None else n_valid[rows],
                None if init_perm is None else init_perm[rows], dev)
            return _solve(kind, C, M, k, cfg, num_processes, exchange, nv,
                          ip)

    by_device = {}
    for i, dev in enumerate(devices):
        by_device.setdefault(dev, []).append(i)
    outs = [None] * nshard

    def run(idx):
        for i in idx:
            outs[i] = shard(i)

    if len(by_device) == 1:
        run(range(nshard))
    else:
        with ThreadPoolExecutor(len(by_device),
                                thread_name_prefix="shard") as pool:
            for f in [pool.submit(run, idx) for idx in by_device.values()]:
                f.result()
    first = devices[0]
    return tuple(torch.cat([o[j].to(first) for o in outs])[:B]
                 for j in range(3))


def run_psa_batch_sharded(Cs, Ms, keys, cfg: annealing.SAConfig,
                          num_processes: int = 4, exchange: bool = True,
                          n_valid=None, init_perm=None, *, mesh,
                          axis: str = DEFAULT_AXIS):
    """``annealing.run_psa_batch`` with the instance axis sharded over
    ``mesh.shape[axis]`` devices.  Same arguments and return values as the
    unsharded entry point (plus ``mesh``/``axis``; the mesh names the
    devices); entry b is bitwise equal to the unsharded solve of instance
    b.  Outputs land on the mesh's first device."""
    return _dispatch_sharded("psa", cfg, num_processes, exchange,
                             Cs, Ms, keys, n_valid, init_perm, mesh, axis)


def run_pga_batch_sharded(Cs, Ms, keys, cfg: genetic.GAConfig,
                          num_processes: int = 4, n_valid=None,
                          init_perm=None, *, mesh, axis: str = DEFAULT_AXIS):
    """``genetic.run_pga_batch`` with the instance axis sharded over a mesh
    axis (see :func:`run_psa_batch_sharded` for the contract)."""
    return _dispatch_sharded("pga", cfg, num_processes, True,
                             Cs, Ms, keys, n_valid, init_perm, mesh, axis)


def run_pca_batch_sharded(Cs, Ms, keys, cfg: composite.CompositeConfig,
                          num_processes: int = 4, n_valid=None,
                          init_perm=None, *, mesh, axis: str = DEFAULT_AXIS):
    """``composite.run_pca_batch`` with the instance axis sharded over a
    mesh axis (see :func:`run_psa_batch_sharded` for the contract)."""
    return _dispatch_sharded("pca", cfg, num_processes, True,
                             Cs, Ms, keys, n_valid, init_perm, mesh, axis)
