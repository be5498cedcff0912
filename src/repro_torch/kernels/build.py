"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``.  The
sources are compiled all at once, one ``nvcc`` process each, on first
use, into ``build/repro_torch_kernels/<hash>/`` at the root of the
checkout; the hash covers every source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.

Flags: ``sm_90a`` (Hopper), ``-O3``, no fast math.  ``-fmad=false`` keeps
each multiply and add rounded on its own, as the plain PyTorch versions
round them.  That makes a kernel equal its plain version bit for bit on
any input only where it also sums in the plain version's order: K8
``selective_scan``'s final state does (its ``y`` sums the states in
another order and agrees to 2e-4), and so did K7 ``qap_delta_sparse`` on
every real-valued input of ``chip_kernels.py --probe``.  K1, K2, K4 (its
shared-memory branch), K5 and K6 sum in other orders and differed there
in the last bits; they agree bit for bit on
integer-valued instances, where every f32 sum is exact in any order,
and those are what the engine's parity rests on.  ``-Xptxas -v`` leaves
each kernel's register and shared-memory use in the build log.

Every launch also adds one to ``LAUNCHES[name]`` (:func:`count_launch`,
under a lock, since engines of a thread-backed fleet launch from several
threads): the count a run reads to show that its work went through the
kernel.  The wrappers validate
what they hand a kernel with :func:`check_mats` and :func:`check_args`
before any pointer leaves Python.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("qap_delta", "qap_objective", "qap_sa_step", "qap_ga_step",
           "qap_objective_sparse", "qap_delta_sparse", "selective_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

# The C functions of each library: name -> (return type, argument types),
# a letter each: "p" a pointer or the stream, "i" an int, "q" a long
# long, "f" a float.  Bound once, when the library is loaded.
SIGNATURES: Dict[str, Dict[str, str]] = {
    "qap_delta": {"qap_delta_launch": "i:pppppppiiiiip",
                  "qap_delta_smem_max_n": "i:"},
    "qap_objective": {"qap_objective_launch": "i:ppppqiqip"},
    "qap_sa_step": {"qap_sa_step_launch": "i:pppppppppppppppiiiiiip",
                    "qap_sa_step_smem_bytes": "q:ii"},
    "qap_ga_step": {"qap_ga_step_launch": "i:ppppppppiiiiiiffiip",
                    "qap_ga_step_smem_bytes": "i:iiii",
                    "qap_ga_step_smem_warps": "i:iiii"},
    "qap_objective_sparse": {"qap_objective_sparse_launch": "i:pppppqiiiqip"},
    "qap_delta_sparse": {"qap_delta_sparse_launch": "i:ppppppppiiiiiip"},
    "selective_scan": {"selective_scan_launch": "i:pppppppiiiiip"},
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong,
           "f": ctypes.c_float}

LAUNCHES: "collections.Counter[str]" = collections.Counter()
# Launches by branch, for the kernels with two (K1, K2, K4, K5:
# "qap_delta/smem", "qap_delta/l2", ...); cleared with LAUNCHES.
BRANCH_LAUNCHES: "collections.Counter[str]" = collections.Counter()
# Guards both counters: a Counter increment is a read then a write, so two
# threads launching at once would lose counts without it.
COUNT_LOCK = threading.Lock()

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
            _libs[name] = _bind(ctypes.CDLL(str(out_dir / f"lib{name}.so")),
                                SIGNATURES[name])
        return dict(_libs)


def _bind(lib: ctypes.CDLL, signatures: Dict[str, str]) -> ctypes.CDLL:
    for fn, sig in signatures.items():
        ret, args = sig.split(":")
        f = getattr(lib, fn)
        f.restype = _CTYPES[ret]
        f.argtypes = [_CTYPES[c] for c in args]
    return lib


def build_log() -> Dict[str, str]:
    """nvcc's output (ptxas register/shared-memory report) per kernel
    compiled by this process; empty for libraries loaded from the cache."""
    return dict(_log)


def library(name: str) -> ctypes.CDLL:
    return _libs[name] if name in _libs else build_all()[name]


@functools.lru_cache(maxsize=None)
def dense_smem_max_n() -> int:
    """The largest order K1, K2 and K4 take on their shared-memory branch
    (``kSmemMaxN`` of ``csrc/qap_dense_smem.cuh``); above it they take
    their L2 branch (K1 and K4 read the transposes there too).  K5's
    threshold also counts the population (``qap_ga_step.smem_branch``)."""
    return library("qap_delta").qap_delta_smem_max_n()


def count_launch(name: str, branch: Optional[str] = None) -> None:
    """Add one launch of kernel ``name`` (and of its ``branch``, for the
    kernels with two) to the counts, under :data:`COUNT_LOCK`."""
    with COUNT_LOCK:
        LAUNCHES[name] += 1
        if branch is not None:
            BRANCH_LAUNCHES[f"{name}/{branch}"] += 1


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
        if X.dtype != dt or X.shape != shape or X.device != device \
                or not X.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} {tuple(shape)} "
                             f"on C's device, got {X.dtype} "
                             f"{tuple(X.shape)}")


def key_words(keys: torch.Tensor) -> torch.Tensor:
    """uint32 key words held in int64 as their int32 bit pattern, the form
    a C interface of 32-bit words takes (K4 and K5 read the int64 words
    themselves)."""
    return torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).to(torch.int32)
