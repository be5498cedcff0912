"""Logical->physical sharding rules (MaxText-style logical axis names).

Parameter declarations and activation constraints use *logical* axis names;
a step resolves them against its mesh:

  logical   meaning                          single-pod        multi-pod
  -------   ------------------------------   ---------------   ----------------
  batch     global data-parallel batch       ('data',)         ('pod', 'data')
  fsdp      weight shard (ZeRO-3 style)      ('data',)         ('pod', 'data')
  tp        tensor-parallel (heads/ff/vocab) ('model',)        ('model',)
  ep        expert-parallel (MoE experts)    ('model',)        ('model',)
  seq       sequence shard (SP / KV cache)   ('model',)        ('model',)

The reference's ``repro/parallel/sharding.py`` without JAX: a
:class:`PartitionSpec` is a plain tuple of entries (an axis name,
``None``, or a tuple of names), and the rules map it to mesh axes
(:func:`named_sharding`) for ``parallel.data_parallel``, which holds a
leaf whose resolved spec names ``data`` or ``model`` as its shard along
that dim.  The layers write the reference's activation constraints out
as ``parallel.tensor_parallel``'s collectives, so :func:`shard` is the
identity here.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

Axes = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, Axes]


def _canonical(entry: Axes) -> Axes:
    """An entry as ``jax.sharding.PartitionSpec`` keeps it: a sequence of
    one name is that name, an empty one ``None``."""
    if isinstance(entry, (list, tuple)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec:
    """A tuple of per-dimension entries -- an axis name, ``None`` or a
    tuple of names, canonical as the reference's ``jax.sharding.
    PartitionSpec`` keeps them -- equal to the same tuple.  Not a tuple
    itself, so that tree walks keep it as one leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries: Axes):
        self._entries = tuple(_canonical(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._entries == other._entries
        if isinstance(other, tuple):
            return self._entries == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


P = PartitionSpec

SINGLE_POD_RULES: Rules = {
    "batch": ("data",),
    "fsdp": ("data",),
    "tp": ("model",),
    "ep": ("model",),
    "seq": ("model",),
}

MULTI_POD_RULES: Rules = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "tp": ("model",),
    "ep": ("model",),
    "seq": ("model",),
}

_state = threading.local()


def _mesh_sizes(mesh) -> Dict[str, int]:
    """A mesh's axis sizes by name: a ``launch.mesh.Mesh`` (``shape``) or
    a ``DeviceMesh`` (``mesh_dim_names`` over ``mesh``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
    return dict(mesh.shape)


def whole_head_groups(cfg, m: int) -> bool:
    """Whether ``cfg``'s attention heads split over a ``model`` axis of
    ``m`` into whole groups of a kv head a rank, or parts of one group:
    then each rank's q heads attend with kv heads of their own
    (``models.layers``).  Otherwise, as with ``cfg.attn_dp``, every rank
    gathers q whole and attends with all heads."""
    h, g = cfg.num_heads, cfg.num_heads // cfg.num_kv_heads
    return not (h % m or ((h // m) % g and g % (h // m)))


def check_mesh(mesh, cfg=None, cell=None) -> None:
    """Raises ``ValueError`` for a mesh the port's steps cannot run on:
    an axis other than pod, data and model, and, given the model's
    ``cfg``, a ``model`` axis above 1 over which a part of the model
    does not split whole -- the experts where they shard over ``ep``
    (as ``tp``, the ``model`` axis), the RWKV heads, or the attention's
    q or kv columns -- and, given a prefill or decode ``cell``, a KV
    cache (``cell.seq_len`` positions, a windowed layer's ring
    ``min(window, seq_len)``) whose positions do not split whole over
    ``seq``."""
    sizes = _mesh_sizes(mesh)
    other = set(sizes) - {"pod", "data", "model"}
    if other:
        raise ValueError(f"mesh axes {sorted(other)} are neither pod, data "
                         "nor model")
    m = sizes.get("model", 1)
    if cfg is None or m == 1:
        return
    from ..models.moe import experts_on_ep
    from ..models.transformer import ATTN_CHARS
    where = f"{cfg.name} on a model axis of {m} ({sizes})"
    if experts_on_ep(cfg) and cfg.num_experts % m:
        raise ValueError(f"{where}: {cfg.num_experts} experts do not split "
                         "whole over ep")
    if "R" in cfg.layer_pattern and (cfg.d_model // cfg.rwkv_head_size) % m:
        raise ValueError(f"{where}: {cfg.d_model // cfg.rwkv_head_size} "
                         "RWKV heads do not split whole")
    hd = cfg.head_dim
    if any(ch in ATTN_CHARS for ch in cfg.layer_pattern) and (
            (cfg.num_heads * hd) % m or (cfg.num_kv_heads * hd) % m):
        raise ValueError(f"{where}: the q columns of {cfg.num_heads} heads "
                         f"or the kv columns of {cfg.num_kv_heads} heads "
                         f"(head_dim {hd}) do not split whole")
    if cell is not None and cell.kind != "train":
        from ..models.transformer import cache_lengths
        for n in cache_lengths(cfg, cell.seq_len):
            if n % m:
                raise ValueError(f"{where}: a KV cache of {n} positions "
                                 f"({cell.name}) does not split whole over "
                                 "seq")


@dataclass(frozen=True)
class NamedSharding:
    """A logical spec resolved against a mesh: ``spec`` names the mesh's
    axes (``jax.sharding.NamedSharding`` without devices)."""
    mesh: Any
    spec: "PartitionSpec"


def named_sharding(mesh, spec: PartitionSpec,
                   rules: Optional[Rules] = None) -> NamedSharding:
    """``spec`` resolved against ``mesh`` by ``rules`` (default: the
    mesh's, :func:`mesh_rules`)."""
    return NamedSharding(mesh, resolve_spec(spec, rules or mesh_rules(mesh)))


def mesh_rules(mesh) -> Rules:
    """The rules a step on ``mesh`` resolves its specs by: those set by
    :func:`use_rules`, else :func:`rules_for_mesh`'s."""
    rules = getattr(_state, "rules", None)
    return dict(rules) if rules is not None else rules_for_mesh(mesh)


def check_rules(mesh, rules: Rules) -> None:
    """Raises ``ValueError`` naming the first of ``rules`` that the port's
    layouts cannot take on ``mesh``.  They take the mesh's own rules
    (:func:`rules_for_mesh`) and ``fsdp`` set to ``None`` (weights and
    optimizer state replicated over the data axes, their gradients
    all-reduced); the layers split heads, experts and KV positions over
    ``model`` alone, and a rank's batch rows and weight shards over all
    the data axes together."""
    default = rules_for_mesh(mesh)
    for name, value in rules.items():
        if name not in default:
            raise ValueError(f"rule {name}={value!r}: no such logical axis "
                             f"(the port's are {sorted(default)})")
        canon = _canonical(value)
        if canon == _canonical(default[name]) or (name == "fsdp"
                                                  and canon is None):
            continue
        raise ValueError(
            f"rule {name}={value!r}: the port's layouts take {name}="
            f"{default[name]!r}" + (" or None" if name == "fsdp" else "")
            + f" on a mesh of axes {tuple(_mesh_sizes(mesh))}")


def rules_for_mesh(mesh, overrides: Optional[Rules] = None) -> Rules:
    rules = dict(MULTI_POD_RULES if "pod" in _mesh_sizes(mesh)
                 else SINGLE_POD_RULES)
    if overrides:
        rules.update(overrides)
    return rules


@contextlib.contextmanager
def use_rules(rules: Rules):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def current_rules() -> Rules:
    r = getattr(_state, "rules", None)
    return r if r is not None else SINGLE_POD_RULES


def resolve_spec(spec: PartitionSpec, rules: Optional[Rules] = None
                 ) -> PartitionSpec:
    """Map logical axis names in a PartitionSpec to physical mesh axes."""
    rules = rules or current_rules()
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, str):
            phys = rules.get(entry, entry)
            if phys is None:
                out.append(None)
            elif isinstance(phys, tuple) and len(phys) == 1:
                out.append(phys[0])
            else:
                out.append(phys)
        else:  # tuple of logical names
            flat = []
            for e in entry:
                phys = rules.get(e, e)
                if phys is None:
                    continue
                flat.extend(phys if isinstance(phys, tuple) else (phys,))
            out.append(tuple(flat) if flat else None)
    return PartitionSpec(*out)


def resolve_tree(spec_tree, rules: Optional[Rules] = None):
    from ..models.param import tree_map
    return tree_map(lambda s: resolve_spec(s, rules), spec_tree)


def shard(x, *logical: Axes):
    """Activation sharding constraint in logical axis names:
    ``shard(x, 'batch', None, 'tp')`` on a (B, S, D)-like tensor.

    The identity: a rank holds its batch rows whole, and the layers
    issue the tensor-parallel step's collectives themselves
    (``parallel.tensor_parallel``).  Under an ambient mesh
    (``launch.mesh.activate_mesh``) its axes are checked
    (:func:`check_mesh`)."""
    from ..launch.mesh import current_mesh
    mesh = current_mesh()
    if mesh is not None:
        check_mesh(mesh)
    return x
