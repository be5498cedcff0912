"""Shared benchmark utilities of the port's harness.

The harness mirrors ``benchmarks/`` file for file and runs the PyTorch
port (``repro_torch``): the same sweeps, instance orders, budgets, CSV
row names and derived fields.  Budgets scale by ``SCALE``
(``REPRO_BENCH_SCALE``, default 0.02; 1.0 is the full budget) and the
Table 1 runs per cell by ``RUNS`` (``REPRO_BENCH_RUNS``, default 3).

Everything runs on ``DEVICE`` (``REPRO_BENCH_DEVICE``, default ``cuda``)
unless a caller passes ``device=``; the scripts take ``--device``.  There
is no fallback: without a card, ``cuda`` raises, and the CPU runs only
when asked for (``REPRO_BENCH_DEVICE=cpu`` or ``--device cpu``).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import annealing, genetic, instances

SCALE = float(os.environ.get("REPRO_BENCH_SCALE", "0.02"))
RUNS = int(os.environ.get("REPRO_BENCH_RUNS", "3"))   # paper: 10
DEVICE = os.environ.get("REPRO_BENCH_DEVICE", "cuda")
BENCH_JSON = "BENCH_torch.json"


def device(name=None) -> torch.device:
    """The device a benchmark runs on: ``name``, else ``DEVICE``."""
    return resolve_device(name or DEVICE)


def instance_mesh(ap, shape, device_name):
    """``--mesh-shape N``: an N-device instance mesh on the benchmark's
    device (``core.batch_sharded``), or None.  On the CPU the N devices
    are the CPU named N times; on ``cuda`` N above the card count is a
    usage error, as the reference refuses N above ``jax.device_count()``."""
    if shape is None:
        return None
    from repro_torch.launch.mesh import make_instance_mesh
    try:
        return make_instance_mesh(shape, device=device(device_name))
    except ValueError as e:
        ap.error(f"--mesh-shape {shape}: {e}")


def scaled(n: int, lo: int = 2) -> int:
    return max(int(round(n * SCALE)), lo)


def get(n: int, device_name=None):
    """The order-``n`` paper instance: ``(C, M)`` on the benchmark's
    device and the ``QAPInstance`` (synthetic known-optimum taiXe unless
    ``data/qap`` holds the official file)."""
    inst = instances.get_instance(n)
    dev = device(device_name)
    return (torch.as_tensor(inst.C, device=dev),
            torch.as_tensor(inst.M, device=dev), inst)


def random_instance(n: int, seed: int):
    """Symmetric random (C, M) numpy pair with zero diagonals -- the shared
    instance recipe of the service benchmarks (mapper_throughput)."""
    rng = np.random.default_rng(seed)
    C = rng.integers(0, 10, (n, n)).astype(np.float32)
    M = rng.integers(1, 10, (n, n)).astype(np.float32)
    C, M = C + C.T, M + M.T
    np.fill_diagonal(C, 0)
    np.fill_diagonal(M, 0)
    return C, M


def synchronize() -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args) -> Tuple[float, object]:
    """One untimed call (first use of the kernels included), then the
    timed one: wall seconds to the end of its device work, and its
    output."""
    out = fn(*args)
    synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    synchronize()
    return time.perf_counter() - t0, out


def accuracy(f: float, f0: float) -> float:
    """Paper's A1 = 100 * (F - F0) / F0."""
    return 100.0 * (f - f0) / f0


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"


@dataclass(frozen=True)
class Row:
    """One CSV row of a paper experiment, with what it reports: the
    permutation behind ``f`` and the order of the instance, so a caller
    can recompute ``F(perm)`` and compare it with the optimum."""
    name: str
    seconds: float
    derived: str
    order: int
    perm: np.ndarray
    f: float

    def csv(self) -> str:
        return csv_row(self.name, self.seconds * 1e6, self.derived)


def solved(out) -> Tuple[np.ndarray, float]:
    """``(perm, f)`` of a solver's ``(best_perm, best_f, history)``."""
    return out[0].cpu().numpy(), float(out[1])


def sa_budget(num_exchanges: int = 50, ipe: int = 100, neighbors: int = 50,
              solvers: int = 25) -> annealing.SAConfig:
    return annealing.SAConfig(
        max_neighbors=neighbors,
        iters_per_exchange=max(int(ipe * SCALE ** 0.5), 2),
        num_exchanges=max(int(num_exchanges * SCALE ** 0.5), 2),
        solvers=solvers)


def ga_budget(generations: int = 200, pop: int = 0) -> genetic.GAConfig:
    return genetic.GAConfig(generations=scaled(generations, 5), pop_size=pop)


def write_bench_json(path: str, section: str, payload: Dict) -> None:
    """Merge one benchmark's results into a machine-readable JSON file
    (``BENCH_torch.json`` by default).  Each benchmark owns a top-level
    ``section`` key; sections written by other benchmarks are kept."""
    data: Dict = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError):
            data = {}                     # corrupt/partial file: start over
    data[section] = payload
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
