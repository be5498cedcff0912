"""Model facade: the config, the device, and the entry points.

``Model(cfg)`` runs on the card unless the caller passes
``device="cpu"`` (:func:`repro_torch.resolve_device`).  Parameters are a
plain tree (nested dicts and lists of tensors) with the reference's
structure; :meth:`Model.init` draws them from an explicit
``torch.Generator``.

:func:`input_specs` gives meta tensors with the shapes and dtypes of a
shape cell's inputs (no storage), :func:`make_concrete_batch` random
inputs of the same shapes.  The logical sharding specs -- ``Model.specs``
(every parameter's), ``Model.cache_specs`` (the decode cache's) and
:func:`batch_partition_specs` (a cell's inputs') -- are the reference's,
metadata that ``parallel.sharding`` resolves against a mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from . import transformer
from .config import ModelConfig, ShapeCell
from ..parallel.sharding import PartitionSpec as P
from .param import (abstract_params, count_params, init_params, param_specs,
                    tree_map)
from .transformer import FRONTEND_DIMS


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

    def abstract(self) -> Any:
        """The parameter tree as meta tensors (shapes and dtypes only)."""
        return abstract_params(self.decls())

    def specs(self) -> Any:
        """Every parameter's logical ``PartitionSpec``, in the parameter
        tree."""
        return param_specs(self.decls())

    def num_params(self) -> int:
        return count_params(self.decls())

    # --- compute ----------------------------------------------------------
    def loss(self, params, batch, num_groups: int = 1):
        return transformer.train_loss(params, batch, self.cfg, num_groups)

    def prefill(self, params, batch, num_groups: int = 1, cache_len=None):
        return transformer.prefill(params, batch, self.cfg, num_groups,
                                   cache_len)

    def decode_step(self, params, cache, batch, pos):
        return transformer.decode_step(params, cache, batch, pos, self.cfg)

    # --- caches -----------------------------------------------------------
    def make_cache(self, batch: int, seq_len: int):
        return transformer.make_cache(self.cfg, batch, seq_len, self.device)

    def abstract_cache(self, batch: int, seq_len: int):
        """The decode cache as meta tensors."""
        return transformer.make_cache(self.cfg, batch, seq_len, "meta")

    def cache_specs(self):
        return transformer.cache_spec_tree(self.cfg)


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Meta tensors of one (arch x shape) cell's inputs, with the
    reference's shapes and dtypes."""
    b, s = cell.global_batch, cell.seq_len
    tok = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")
    emb = lambda *shape: torch.empty(shape, dtype=torch.bfloat16,
                                     device="meta")
    fd = FRONTEND_DIMS[cfg.frontend] if cfg.frontend is not None else None
    if cell.kind == "train":
        if fd is not None:
            return {"embeds": emb(b, s, fd), "labels": tok(b, s)}
        return {"tokens": tok(b, s), "labels": tok(b, s)}
    if cell.kind == "prefill":
        return {"embeds": emb(b, s, fd)} if fd is not None \
            else {"tokens": tok(b, s)}
    # decode: one new token against a seq_len cache
    return {"embeds": emb(b, 1, fd)} if fd is not None \
        else {"tokens": tok(b, 1)}


def batch_partition_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, P]:
    """The logical specs of :func:`input_specs`' inputs: rows over
    ``batch``."""
    specs: Dict[str, P] = {}
    if cell.kind == "train":
        specs["labels"] = P("batch", None)
    if cfg.frontend is not None:
        specs["embeds"] = P("batch", None, None)
    else:
        specs["tokens"] = P("batch", None)
    return specs


def make_concrete_batch(cfg: ModelConfig, cell: ShapeCell,
                        generator: torch.Generator) -> Dict[str, Any]:
    """Random inputs matching :func:`input_specs`, drawn from
    ``generator`` on its device, in the specs' order: integers uniform in
    ``[0, vocab_size)``, floats standard normal (drawn in f32, then cast).
    The reference folds ``hash(name)`` into its key, which changes from
    process to process, so only the shapes, dtypes and ranges are its."""
    dev = generator.device

    def draw(spec: torch.Tensor) -> torch.Tensor:
        if not spec.dtype.is_floating_point:
            return torch.randint(0, cfg.vocab_size, tuple(spec.shape),
                                 generator=generator, dtype=spec.dtype,
                                 device=dev)
        return torch.randn(tuple(spec.shape), generator=generator,
                           dtype=torch.float32, device=dev).to(spec.dtype)

    return tree_map(draw, input_specs(cfg, cell))
