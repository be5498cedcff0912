"""Deterministic synthetic data pipeline.

Every batch is a pure function of ``(seed, step)``: any host can
recompute any shard at any time, so a restarted or re-assigned host
regenerates its shard from the step counter alone.  The generator is
numpy's Philox, as in the reference (``repro/train/data.py``), so the
port's batches are the reference's bit for bit.  Zipf-distributed token
streams with document boundaries (BOS) give losses LM-like structure.

:func:`to_device` moves a batch to a device as tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

BOS = 0


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 512
    frontend: Optional[str] = None    # audio|vision: emit embeds instead
    frontend_dim: int = 0


def host_slice(cfg: DataConfig, process_index: int, process_count: int):
    if cfg.global_batch % process_count:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {process_count} processes")
    per = cfg.global_batch // process_count
    return process_index * per, per


def batch_at(cfg: DataConfig, step: int, process_index: int = 0,
             process_count: int = 1) -> Dict[str, np.ndarray]:
    """The (host-local) batch for a given step; pure in (seed, step)."""
    start, per = host_slice(cfg, process_index, process_count)
    rng = np.random.Generator(np.random.Philox(key=cfg.seed, counter=step))
    # The *global* batch is generated and the host's rows sliced, so the
    # data is the same at any process count (elastic resizes keep it).
    toks = rng.zipf(cfg.zipf_a, size=(cfg.global_batch, cfg.seq_len + 1))
    toks = np.minimum(toks, cfg.vocab_size - 1).astype(np.int32)
    doc = rng.random((cfg.global_batch, cfg.seq_len + 1)) < 1.0 / cfg.mean_doc_len
    toks = np.where(doc, BOS, toks)
    rows = slice(start, start + per)
    out: Dict[str, np.ndarray] = {"labels": toks[rows, 1:]}
    if cfg.frontend:
        emb = rng.standard_normal((cfg.global_batch, cfg.seq_len,
                                   cfg.frontend_dim)).astype(np.float32)
        out["embeds"] = emb[rows]
    else:
        out["tokens"] = toks[rows, :-1]
    return out


def stream(cfg: DataConfig, start_step: int = 0, process_index: int = 0,
           process_count: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(cfg, step, process_index, process_count)
        step += 1


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays as tensors of the same dtypes on
    ``device``."""
    return {k: torch.from_numpy(np.require(v, requirements="C")).to(device)
            for k, v in batch.items()}
