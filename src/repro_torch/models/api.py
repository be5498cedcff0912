"""Model facade: the config, the device, and the entry points.

``Model(cfg)`` runs on the card unless the caller passes
``device="cpu"`` (:func:`repro_torch.resolve_device`).  Parameters are a
plain tree (nested dicts and lists of tensors) with the reference's
structure; :meth:`Model.init` draws them from an explicit
``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from .. import resolve_device
from . import transformer
from .config import ModelConfig
from .param import count_params, init_params


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: Any = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    # --- parameters ------------------------------------------------------
    def decls(self):
        return transformer.model_decls(self.cfg)

    def init(self, generator: Optional[torch.Generator] = None,
             seed: int = 0) -> Any:
        """Random weights on the model's device, drawn leaf by leaf from
        ``generator`` (default: a generator on the model's device seeded
        with ``seed``).  A generator on another device draws there and
        the weights are moved: the same CPU generator gives the same
        weights to a model on the card and one on the CPU."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.decls(), generator, self.device)

    def num_params(self) -> int:
        return count_params(self.decls())

    # --- compute ----------------------------------------------------------
    def prefill(self, params, batch, num_groups: int = 1, cache_len=None):
        return transformer.prefill(params, batch, self.cfg, num_groups,
                                   cache_len)

    def decode_step(self, params, cache, batch, pos):
        return transformer.decode_step(params, cache, batch, pos, self.cfg)

    # --- caches -----------------------------------------------------------
    def make_cache(self, batch: int, seq_len: int):
        return transformer.make_cache(self.cfg, batch, seq_len, self.device)
