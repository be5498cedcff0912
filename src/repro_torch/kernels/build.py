"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``.  The
sources are compiled all at once, one ``nvcc`` process each, on first
use, into ``build/repro_torch_kernels/<hash>/`` at the root of the
checkout; the hash covers every source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.

Flags: ``sm_90a`` (Hopper), ``-O3``, no fast math.  ``-fmad=false`` keeps
each multiply and add rounded on its own, as the plain PyTorch versions
round them, so a kernel and its plain version agree bit for bit beyond
the integer-valued instances as well.  ``-Xptxas -v`` leaves each
kernel's register and shared-memory use in the build log.

Every launch also adds one to ``LAUNCHES[name]``: the count a run reads
to show that its work went through the kernel.  The wrappers validate
what they hand a kernel with :func:`check_mats` and :func:`check_args`
before any pointer leaves Python.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("qap_delta", "qap_objective", "qap_sa_step", "qap_ga_step",
           "qap_objective_sparse", "qap_delta_sparse", "selective_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: "collections.Counter[str]" = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_log: Dict[str, str] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns them by
    name.  Safe to call from several threads."""
    with _lock:
        if len(_libs) == len(KERNELS):
            return dict(_libs)
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in KERNELS:
            lib = out_dir / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, lib)
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            _log[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(_log[n] for n in failed))
        for name in KERNELS:
            _libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        return dict(_libs)


def build_log() -> Dict[str, str]:
    """nvcc's output (ptxas register/shared-memory report) per kernel
    compiled by this process; empty for libraries loaded from the cache."""
    return dict(_log)


def library(name: str) -> ctypes.CDLL:
    return _libs[name] if name in _libs else build_all()[name]


def check(err: int, name: str) -> None:
    """Raise on the ``cudaGetLastError()`` a launch function returned."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def check_mats(B: int, n: int, **mats: torch.Tensor) -> int:
    """Validate the matrices a kernel reads, the first one ``C``: each
    contiguous float32 of C's shape and device, ``(n, n)`` shared or
    ``(B0, n, n)`` with ``B0`` dividing the batch ``B``.  Returns ``B0``
    (1 when shared)."""
    C = next(iter(mats.values()))
    for name, X in mats.items():
        if X.dtype != torch.float32 or not X.is_contiguous() \
                or X.shape != C.shape or X.device != C.device:
            raise ValueError(f"{name} must be contiguous float32 of C's "
                             f"shape on C's device")
    if C.dim() not in (2, 3) or tuple(C.shape[-2:]) != (n, n):
        raise ValueError(f"C must be ({n}, {n}) or (B0, {n}, {n}), "
                         f"got {tuple(C.shape)}")
    b0 = C.shape[0] if C.dim() == 3 else 1
    if B % b0 != 0:
        raise ValueError(f"batched C/M leading dim {b0} must divide B={B}")
    return b0


def check_args(device: torch.device, *specs) -> None:
    """Validate ``(name, tensor, dtype, shape)`` specs: each tensor
    contiguous, of that dtype and shape, on ``device``."""
    for name, X, dt, shape in specs:
        if X.dtype != dt or tuple(X.shape) != tuple(shape) \
                or not X.is_contiguous() or X.device != device:
            raise ValueError(f"{name} must be contiguous {dt} {tuple(shape)} "
                             f"on C's device, got {X.dtype} "
                             f"{tuple(X.shape)}")


def key_words(keys: torch.Tensor) -> torch.Tensor:
    """uint32 key words held in int64 as the int32 bit pattern the kernels
    read."""
    return torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).to(torch.int32)
