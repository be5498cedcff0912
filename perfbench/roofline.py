"""The H100's published peaks and the work a kernel's inputs need.

Peaks: NVIDIA's H100 SXM data sheet (700 W): 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores.  A bound is the larger of
bytes over the bandwidth and operations over the float32 rate; each input
byte is counted read once and each output byte written once.
"""
from __future__ import annotations

H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / H100_BYTES_PER_S, flops / H100_F32_PER_S)


def sa_step_bytes(b0: int, n: int, chains: int) -> int:
    """Bytes one K4 (``qap_sa_step``) launch needs at least: ``C`` and
    ``M`` of ``b0`` instances of padded order ``n`` read once; each of
    ``chains`` chains reads ``p``, ``best_p`` (int32, ``n`` each), ``f``,
    ``best_f``, its temperature and its valid order (4 bytes each) and its
    key (two int64 words), and writes ``p``, ``best_p``, ``f`` and
    ``best_f``.  The candidates a chain scores are known only inside the
    kernel (the acceptance cap stops a chain early), so the operations
    are not counted and the bound is the byte bound alone."""
    matrices = 4 * 2 * b0 * n * n
    per_chain = 4 * 4 * n + 4 * 4 + 16 + 4 * 2
    return matrices + chains * per_chain
