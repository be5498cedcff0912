"""Batched LM serving engine: prefill + decode loop.

A fixed batch of prompts is prefilled together and decoded step by step
(greedy, or temperature sampling); the loop stops when every row has
produced ``eos_id`` or at the deadline.  The reference's
``repro/serve/engine.py`` on the port's :class:`~repro_torch.models.api.Model`:
the same control flow, greedy decoding by ``argmax``, and temperature
sampling by the Gumbel-max form of ``jax.random.categorical`` replayed on
the reference's key schedule (``PRNGKey(seed)`` for the first token, then
one ``split`` per step) through :mod:`repro_torch.core.keys`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from ..core import keys
from ..models.api import Model

F32_TINY = float(np.finfo(np.float32).tiny)


@dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 => greedy
    eos_id: int = 1
    seed: int = 0
    # Hard wall-clock budget for one generate() call: decode stops at the
    # first step past the deadline and returns what was produced so far
    # (eos-padded) -- a degraded-but-on-time answer.  None = no wall.
    deadline_ms: Optional[float] = None


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in f32 (its default "low" mode):
    ``-log(-log(u))`` of a uniform in ``[tiny, 1)``."""
    u = keys.uniform(key, shape)
    one = torch.tensor(1.0, dtype=torch.float32, device=u.device)
    tiny = torch.tensor(F32_TINY, dtype=torch.float32, device=u.device)
    u = torch.maximum(tiny, u * (one - tiny) + tiny)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the Gumbel-max
    draw, first index on ties."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)


@dataclass
class Engine:
    model: Model
    params: Any
    cfg: ServeConfig = field(default_factory=ServeConfig)

    def generate(self, tokens: np.ndarray) -> np.ndarray:
        """tokens (B, S) -> generated (B, max_new_tokens)."""
        t0 = time.monotonic()
        b, s = tokens.shape
        dev = self.model.device
        prompt = torch.as_tensor(np.asarray(tokens, np.int32), device=dev)
        logits, cache = self.model.prefill(
            self.params, {"tokens": prompt},
            cache_len=s + self.cfg.max_new_tokens)
        key = keys.prng_key(self.cfg.seed, dev)
        out: List[np.ndarray] = []
        done = np.zeros(b, bool)
        cur = self._sample(logits, key)
        for t in range(self.cfg.max_new_tokens):
            cur_np = cur.cpu().numpy()
            out.append(cur_np)
            done |= cur_np == self.cfg.eos_id
            if done.all():
                break
            if (self.cfg.deadline_ms is not None
                    and (time.monotonic() - t0) * 1000.0
                    >= self.cfg.deadline_ms):
                break                  # deadline wall: degrade, don't stall
            key, sub = keys.split(key).unbind(0)
            logits, cache = self.model.decode_step(
                self.params, cache, {"tokens": cur[:, None]}, s + t)
            cur = self._sample(logits, sub)
        gen = np.stack(out, axis=1)
        pad = self.cfg.max_new_tokens - gen.shape[1]
        if pad:
            gen = np.pad(gen, ((0, 0), (0, pad)), constant_values=self.cfg.eos_id)
        return gen

    def _sample(self, logits: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return categorical(key, logits / self.cfg.temperature).to(torch.int32)
