"""Carry state across from the JAX reference, from numpy only.

The reference's objects never enter the port: a caller turns them into
plain values (``dataclasses.asdict`` of a config, ``jax.random.key_data``
of keys, ``np.asarray`` of state arrays) and these functions build the
port's counterparts.  The parity tests use them to start the port from a
reference state in the middle of a run.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from . import as_tensor
from .core.annealing import SAConfig, SAState
from .core.composite import CompositeConfig
from .core.genetic import GAConfig, GAState
from .core.multilevel import MultilevelConfig
from .core.sparse import SparseFlows
from .models.config import ModelConfig, resolve_dtype
from .models.param import tree_map
from .train.optimizer import OptState


def sa_config_from_reference(fields: Mapping) -> SAConfig:
    """An :class:`SAConfig` from the reference config's fields (a dict,
    e.g. ``dataclasses.asdict(cfg)``)."""
    return SAConfig(**dict(fields))


def ga_config_from_reference(fields: Mapping) -> GAConfig:
    """A :class:`GAConfig` from the reference config's fields."""
    return GAConfig(**dict(fields))


def composite_config_from_reference(fields: Mapping) -> CompositeConfig:
    """A :class:`CompositeConfig` from the reference's nested fields
    (``{"sa": {...}, "ga": {...}}``, as ``dataclasses.asdict`` gives)."""
    return CompositeConfig(sa=sa_config_from_reference(fields["sa"]),
                           ga=ga_config_from_reference(fields["ga"]))


def multilevel_config_from_reference(fields: Mapping) -> MultilevelConfig:
    """A :class:`MultilevelConfig` from the reference's nested fields
    (``coarse_sa``, ``coarse_ga`` and ``refine_sa`` as dicts, as
    ``dataclasses.asdict`` gives)."""
    f = dict(fields)
    return MultilevelConfig(**dict(
        f, coarse_sa=sa_config_from_reference(f["coarse_sa"]),
        coarse_ga=ga_config_from_reference(f["coarse_ga"]),
        refine_sa=sa_config_from_reference(f["refine_sa"])))


def sparse_flows_from_reference(leaves: Sequence, device="cpu") -> SparseFlows:
    """A :class:`SparseFlows` from the reference's leaves as numpy arrays,
    in field order (``cols``, ``vals``, ``cols_t``, ``vals_t``, ``deg``,
    ``deg_t``: ``[np.asarray(x) for x in S]``)."""
    if len(leaves) != len(SparseFlows._fields):
        raise ValueError(f"need the {len(SparseFlows._fields)} leaves "
                         f"{SparseFlows._fields}")
    return SparseFlows(*(
        as_tensor(x, torch.float32 if name.startswith("vals") else torch.int32,
                  device)
        for name, x in zip(SparseFlows._fields, leaves)))


def keys_from_reference(words: np.ndarray, device="cpu") -> torch.Tensor:
    """Keys from ``(..., 2)`` uint32 words (``jax.random.key_data``)."""
    words = np.asarray(words)
    if words.shape[-1:] != (2,):
        raise ValueError(f"key words must end in a dim of 2, got {words.shape}")
    return as_tensor(words.astype(np.uint32), torch.int64, device)


def sa_state_from_reference(state: Mapping[str, np.ndarray],
                            device="cpu") -> SAState:
    """An :class:`SAState` from the reference state's arrays by field
    name (``p``, ``f``, ``best_p``, ``best_f``, ``temp``)."""
    return SAState(p=as_tensor(state["p"], torch.int32, device),
                   f=as_tensor(state["f"], torch.float32, device),
                   best_p=as_tensor(state["best_p"], torch.int32, device),
                   best_f=as_tensor(state["best_f"], torch.float32, device),
                   temp=as_tensor(state["temp"], torch.float32, device))


def ga_state_from_reference(state: Mapping[str, np.ndarray],
                            device="cpu") -> GAState:
    """A :class:`GAState` from the reference state's arrays by field name
    (``pop (..., P, N)``, ``fit (..., P)``); leading dims are flattened
    into the port's one island axis."""
    pop = np.asarray(state["pop"])
    fit = np.asarray(state["fit"])
    return GAState(pop=as_tensor(pop.reshape((-1,) + pop.shape[-2:]),
                                 torch.int32, device),
                   fit=as_tensor(fit.reshape((-1, fit.shape[-1])),
                                 torch.float32, device))


def model_config_from_reference(fields: Mapping) -> ModelConfig:
    """A :class:`ModelConfig` from the reference config's fields
    (``dataclasses.asdict(cfg)``).  Dtype fields go by name: a name such
    as ``"bf16"`` or ``"float32"``, or any object numpy reads as a dtype
    (``np.dtype(x).name``, e.g. the reference's ``jnp.bfloat16``)."""
    f = dict(fields)
    for name in ("compute_dtype", "param_dtype", "opt_dtype"):
        if name in f and not isinstance(f[name], str):
            f[name] = np.dtype(f[name]).name
        if name in f:
            f[name] = resolve_dtype(f[name])
    return ModelConfig(**f)


def lm_params_from_reference(tree: Any, device="cpu",
                             param_dtype=None) -> Any:
    """The port's LM parameter tree from the reference's, with leaves as
    numpy arrays (``jax.tree.map(np.asarray, params)``; bf16 leaves
    arrive as f32, e.g. ``np.asarray(x, np.float32)``).  The nested dicts
    and lists carry over as they are; each leaf becomes a tensor of
    ``param_dtype`` (a torch dtype or its name; default: f32) on
    ``device``."""
    dt = torch.float32 if param_dtype is None else resolve_dtype(param_dtype)
    return tree_map(lambda x: torch.as_tensor(
        np.array(x, np.float32)).to(device=device, dtype=dt), tree)


def opt_state_from_reference(state: Any, device="cpu", moment_dtype=None):
    """The port's :class:`train.optimizer.OptState` from the reference's,
    with leaves as numpy arrays (``jax.tree.map(np.asarray, state)``: a
    ``(step, mu, nu)`` tuple, or the reference's ``OptState`` of numpy
    arrays; bf16 moments as f32, e.g. ``np.asarray(x, np.float32)``).
    ``step`` becomes a 0-d int32 tensor; the moment trees keep their
    structure, each leaf a tensor of ``moment_dtype`` (a torch dtype or
    its name; default: f32) on ``device`` -- except the scalar ``nu``
    leaves of SGD-M, which are f32 in both packages."""
    step, mu, nu = state
    dt = torch.float32 if moment_dtype is None else resolve_dtype(moment_dtype)

    def leaf(x, dtype):
        x = np.array(x, np.float32)
        return torch.from_numpy(x).to(
            device=device, dtype=torch.float32 if x.ndim == 0 else dtype)

    return OptState(
        step=torch.from_numpy(np.array(step, np.int32)).to(device),
        mu=tree_map(lambda x: leaf(x, dt), mu),
        nu=tree_map(lambda x: leaf(x, dt), nu))
