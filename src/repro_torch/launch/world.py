"""Run one function on every rank of a fresh ``torch.distributed`` world.

``core.distributed`` is SPMD: every rank of a ``DeviceMesh`` calls the
same solver and the ranks meet in collectives.  :func:`run_world` starts
such a world on this host -- ``world_size`` spawned processes, a
``file://`` rendezvous in a temporary directory, a 1-D mesh whose dim
is ``"proc"`` (``core.distributed``'s default axis) -- calls
``fn(mesh, *args)`` on every rank and returns the
ranks' results in rank order.  Nothing on the host describes a cluster,
so the world's size, ranks and rendezvous are given here.

The world runs on ``cuda`` unless the caller asks for the CPU with
``device_type="cpu"``; without a card ``cuda`` raises, as every entry
point of the port does.  On ``cuda`` rank r runs on card
``r % torch.cuda.device_count()``, so one card holds all ranks of a world
larger than the card count.  The backend follows: NCCL when every rank
has a card of its own, else ``gloo`` (NCCL refuses several ranks on one
GPU, and has no CPU tensors).  Build the kernels before calling this
(``kernels.build.build_all``), or every rank builds them at once.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import resolve_device


def _rank_main(rank: int, world_size: int, backend: str, device_type: str,
               init_method: str, timeout_s: float, fn: Callable,
               args: Sequence, results) -> None:
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        from torch.distributed.device_mesh import DeviceMesh
        mesh = DeviceMesh(device_type, list(range(world_size)),
                          mesh_dim_names=("proc",))
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def default_backend(device_type: str, world_size: int) -> str:
    """NCCL when each of ``world_size`` ranks has a card of its own,
    else ``gloo``."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def run_world(fn: Callable, world_size: int, *,
              device_type: Optional[str] = None,
              backend: Optional[str] = None, args: Sequence = (),
              timeout_s: float = 300.0) -> List[Any]:
    """``[fn(mesh, *args) on rank r for r in range(world_size)]``.

    ``fn`` must be importable by name from a module (it is pickled to
    spawned processes) and return picklable values -- numpy arrays or
    plain numbers, not device tensors.  A rank that raises fails the
    world: the others are stopped and ``RuntimeError`` carries the
    rank's traceback.  So does a world that has not finished within
    ``timeout_s`` seconds.  ``device_type`` is ``cuda`` unless given;
    ``backend`` is :func:`default_backend`'s unless given.
    """
    device_type = resolve_device(device_type).type
    if backend is None:
        backend = default_backend(device_type, world_size)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="repro_world_")
    init_method = f"file://{os.path.join(store, 'rendezvous')}"
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world_size, backend, device_type, init_method, timeout_s, fn,
        tuple(args), results)) for r in range(world_size)]
    out: List[Any] = [None] * world_size
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        done = 0
        while done < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world_size} exited with code "
                        f"{procs[dead[0]].exitcode}") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"world of {world_size} ({backend}, {device_type}) "
                        f"not done within {timeout_s} s") from None
                continue
            done += 1
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
    return out
