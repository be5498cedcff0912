"""PyTorch/CUDA port of the job-mapping system.

A second package beside the JAX reference ``repro``: the same layout
(``core/``, ``kernels/``, ``serve/``), the same algorithms and the same
random streams, written for PyTorch with hand-written CUDA kernels for an
NVIDIA H100 (``kernels/`` + ``csrc/``).  It imports neither ``jax`` nor
``repro``; the parity tests (``tests/test_torch_*.py``) run both packages
on the same numpy inputs.

Entry points (``core.annealing.run_psa*``, ``core.mapping``, the
``serve.MappingEngine``) run on ``cuda`` unless the caller passes
``device="cpu"``; lower-level functions work on whatever device their
tensors live on.
"""
from __future__ import annotations

import numpy as np
import torch


def as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy array, list or tensor as a ``dtype`` tensor on ``device``
    (uint32 arrays, such as raw key words, are widened to int64 first)."""
    if not isinstance(x, torch.Tensor):
        x = np.array(x)                     # a writable copy for torch
        if x.dtype == np.uint32:
            x = x.astype(np.int64)
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises instead of falling back to the CPU when no CUDA card is
    present -- a caller that wants the CPU says so with ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
