"""Model assembly: layer-pattern plans, stacked layer groups, and the
prefill / decode entry points.

The reference's ``repro/models/transformer.py`` in PyTorch.  The
per-layer pattern string (config.py) is compressed into
``unit * repeats + rest`` exactly as there, and the parameter and cache
trees keep that shape: when ``repeats > 1`` every leaf of a ``unit``
position carries a leading layer axis, which the reference scans over and
which a Python loop walks here.  Jamba's ``mMmMaMmM`` is one super-block.

:func:`train_loss` is the training entry: :func:`forward_hidden` with
each layer (each repeat of the unit) under the config's ``remat`` mode
(:func:`_remat`), then ``layers.lm_loss``.

Every block of the pattern alphabet is served: attention, MLP, MoE,
Mamba and RWKV-6 (``R``, whose decode cache is a state, not a KV cache).
A model with a ``frontend`` (audio or vision) also takes ``embeds``
(B, S, ``FRONTEND_DIMS[frontend]``) in place of ``tokens``, projected to
``d_model`` by ``frontend.proj``; its ``embed`` table stays, for decode
over token ids.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import functools
from dataclasses import replace

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers, moe, rwkv, ssm
from .config import ModelConfig
from .param import PDecl, stack, tree_map
from ..parallel.sharding import PartitionSpec as P

FRONTEND_DIMS = {"audio": 128, "vision": 3200}   # EnCodec frames / InternViT patches

ATTN_CHARS = "TEGLWaA"
MOE_CHARS = "EWMA"
WINDOW_CHARS = "LW"


def layer_plan(pattern: str, scan_layers: bool = True) -> Tuple[str, int, str]:
    """pattern == unit * repeats + rest  (smallest unit with repeats >= 2)."""
    n = len(pattern)
    if scan_layers:
        for p in range(1, min(12, n) + 1):
            unit = pattern[:p]
            reps = n // p
            if reps >= 2 and (unit * (reps + 1))[:n] == pattern:
                return unit, reps, pattern[p * reps:]
    return pattern, 1, ""


def _window_for(cfg: ModelConfig, ch: str) -> Optional[int]:
    if ch == "L":
        return cfg.local_window
    if ch == "W":
        return cfg.sliding_window
    return None


# ---------------------------------------------------------------------------
# One block (mixer + ffn with pre-norms)
# ---------------------------------------------------------------------------

def block_decls(cfg: ModelConfig, ch: str) -> Dict[str, Any]:
    d = cfg.d_model
    if ch == "R":
        return {"norm1": layers.rmsnorm_decls(d), "tm": rwkv.rwkv_decls(cfg),
                "norm2": layers.rmsnorm_decls(d)}
    decls: Dict[str, Any] = {"norm1": layers.rmsnorm_decls(d),
                             "norm2": layers.rmsnorm_decls(d)}
    if ch in "mM":
        decls["mixer"] = ssm.mamba_decls(cfg)
    else:
        decls["mixer"] = layers.attn_decls(cfg)
    decls["ffn"] = moe.moe_decls(cfg) if ch in MOE_CHARS else layers.mlp_decls(cfg)
    return decls


def _ffn(params, x, cfg: ModelConfig, ch: str, num_groups: int):
    h = layers.rmsnorm(params["norm2"], x, cfg.norm_eps)
    if ch in MOE_CHARS:
        y = moe.moe_apply(params["ffn"], h, cfg, num_groups)
    else:
        y = layers.mlp(params["ffn"], h, cfg)
    return x + y


def block_train(params, x: torch.Tensor, cfg: ModelConfig, ch: str,
                positions: torch.Tensor, num_groups: int) -> torch.Tensor:
    if ch == "R":
        return _rwkv_block(params, x, cfg, None)[0]
    h = layers.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if ch in "mM":
        y = ssm.mamba_train(params["mixer"], h, cfg)
    else:
        y = layers.attention_train(params["mixer"], h, cfg,
                                   _window_for(cfg, ch), positions)
    return _ffn(params, x + y, cfg, ch, num_groups)


def _rwkv_block(params, x, cfg: ModelConfig, cache):
    """The ``R`` block: time-mix and channel-mix, each under a pre-norm,
    from ``cache`` (the token shifts and the state) or, when it is
    ``None`` (train, prefill), from zeros.  Returns (x, new cache)."""
    if cache is None:
        cache = rwkv.rwkv_make_cache(cfg, x.shape[0], x.device)
    h = layers.rmsnorm(params["norm1"], x, cfg.norm_eps)
    y, tm_xprev, s_last = rwkv.rwkv_time_mix(params["tm"], h, cfg,
                                             cache["tm_xprev"], cache["s"])
    x = x + y
    h = layers.rmsnorm(params["norm2"], x, cfg.norm_eps)
    y, cm_xprev = rwkv.rwkv_channel_mix(params["tm"], h, cfg,
                                        cache["cm_xprev"])
    return x + y, {"s": s_last, "tm_xprev": tm_xprev, "cm_xprev": cm_xprev}


def block_make_cache(cfg: ModelConfig, ch: str, batch: int, seq_len: int,
                     device=None):
    if ch == "R":
        return rwkv.rwkv_make_cache(cfg, batch, device)
    if ch in "mM":
        return ssm.mamba_make_cache(cfg, batch, device)
    return layers.make_cache(cfg, batch, seq_len, _window_for(cfg, ch), device)


def block_prefill(params, x, cfg, ch, positions, num_groups, cache_len=None):
    """Returns (x, cache)."""
    if ch == "R":
        return _rwkv_block(params, x, cfg, None)
    h = layers.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if ch in "mM":
        # Mamba prefill: one pass returns both outputs and the decode state.
        y, cache = ssm.mamba_train(params["mixer"], h, cfg, return_state=True)
    else:
        y, cache = layers.attention_prefill(params["mixer"], h, cfg,
                                            _window_for(cfg, ch), positions,
                                            cache_len)
    return _ffn(params, x + y, cfg, ch, num_groups), cache


def block_decode(params, x, cfg, ch, cache, pos, num_groups):
    """x (B, 1, D); returns (x, new_cache)."""
    if ch == "R":
        return _rwkv_block(params, x, cfg, cache)
    h = layers.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if ch in "mM":
        y, cache = ssm.mamba_decode(params["mixer"], h, cfg, cache)
    else:
        y, cache = layers.attention_decode(params["mixer"], h, cfg, cache, pos,
                                           _window_for(cfg, ch))
    return _ffn(params, x + y, cfg, ch, num_groups), cache


# ---------------------------------------------------------------------------
# Whole-model declarations
# ---------------------------------------------------------------------------

def model_decls(cfg: ModelConfig) -> Dict[str, Any]:
    unit, reps, rest = layer_plan(cfg.layer_pattern, cfg.scan_layers)
    decls: Dict[str, Any] = {}
    if cfg.frontend is not None:
        fd = FRONTEND_DIMS[cfg.frontend]
        decls["frontend"] = {"proj": PDecl((fd, cfg.d_model), P(None, "fsdp"))}
    decls["embed"] = layers.embed_decls(cfg)   # decode over token ids too
    unit_decls = [block_decls(cfg, ch) for ch in unit]
    decls["unit"] = [stack(d, reps) for d in unit_decls] if reps > 1 else unit_decls
    decls["rest"] = [block_decls(cfg, ch) for ch in rest]
    decls["final_norm"] = layers.rmsnorm_decls(cfg.d_model)
    decls["head"] = layers.head_decls(cfg)
    pdt = cfg.param_dtype
    if pdt != torch.float32:
        # serving mode: store weights directly in the compute dtype
        decls = tree_map(lambda d: replace(d, dtype=pdt), decls)
    return decls


def _embed_inputs(params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> torch.Tensor:
    if cfg.frontend is not None and "embeds" in batch:
        dt = cfg.compute_dtype
        return batch["embeds"].to(dt) @ params["frontend"]["proj"].to(dt)
    return layers.embed(params["embed"], batch["tokens"], cfg)


def _maybe_cast_params(params, cfg: ModelConfig):
    if not cfg.cast_params_once:
        return params
    dt = cfg.compute_dtype
    return tree_map(lambda p: p.to(dt) if (p.dtype == torch.float32
                                           and p.dim() >= 2) else p, params)


def _layer(tree, r: int):
    """Layer ``r`` of a stacked (leading layer axis) tree."""
    return tree_map(lambda t: t[r], tree)


def _stack_layers(trees):
    """A list of per-layer trees as one tree with a leading layer axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_layers([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _save_plain_matmuls(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of plain 2-D matrix products (``aten.mm``: every
    ``x @ w`` of a weight), recompute the rest (batched einsums among
    them)."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under the config's rematerialisation mode: ``none`` as it
    is; ``full`` recomputes everything in the backward; ``dots`` keeps
    the plain matrix products' outputs and recomputes the rest.  The
    mode changes memory only, never the numbers."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _save_plain_matmuls)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=context_fn)
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"unknown remat mode {cfg.remat!r}")


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def forward_hidden(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   num_groups: int = 1) -> torch.Tensor:
    """Embed -> all blocks -> final norm.  Returns hidden states (B, S, D).

    Each repeat of the unit, and each layer of the rest, runs under
    :func:`_remat` (the reference's ``jax.checkpoint`` around its scan
    body and around each rest layer)."""
    unit, reps, rest = layer_plan(cfg.layer_pattern, cfg.scan_layers)
    params = _maybe_cast_params(params, cfg)
    x = _embed_inputs(params, batch, cfg)
    positions = _positions(x.shape[0], x.shape[1], x.device)

    def unit_body(xc, pslices):
        for ch, p in zip(unit, pslices):
            xc = block_train(p, xc, cfg, ch, positions, num_groups)
        return xc

    unit_body = _remat(unit_body, cfg)
    for r in range(reps):
        pslices = [_layer(p, r) for p in params["unit"]] if reps > 1 \
            else params["unit"]
        x = unit_body(x, pslices)
    for ch, p in zip(rest, params["rest"]):
        x = _remat(functools.partial(block_train, cfg=cfg, ch=ch,
                                     positions=positions,
                                     num_groups=num_groups), cfg)(p, x)
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def train_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               num_groups: int = 1) -> torch.Tensor:
    """The mean next-token loss of ``batch`` (``labels`` (B, S) and
    ``tokens`` (B, S) or, with a frontend, ``embeds`` (B, S, fd)): a 0-d
    f32 tensor.  Under a model axis (``parallel.tensor_parallel.
    use_model_axis``, as ``parallel.data_parallel``'s step sets it),
    ``params`` are this rank's parts and the loss is the whole batch's,
    the same on every rank of the axis."""
    h = forward_hidden(params, batch, cfg, num_groups)
    return layers.lm_loss(params["head"], h, batch["labels"], cfg)


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            num_groups: int = 1, cache_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Any]:
    """Returns (last-token logits (B, V) f32, cache tree).  Under a
    model axis (``parallel.data_parallel.make_serve_steps``) the logits
    are this rank's ``V / m`` columns of the vocabulary (the reference's
    ``P("batch", "tp")``) and the cache its part (``cache_spec_tree``)."""
    unit, reps, rest = layer_plan(cfg.layer_pattern, cfg.scan_layers)
    x = _embed_inputs(params, batch, cfg)
    positions = _positions(x.shape[0], x.shape[1], x.device)

    per_rep = []
    for r in range(reps):
        pslices = [_layer(p, r) for p in params["unit"]] if reps > 1 \
            else params["unit"]
        rep_caches = []
        for ch, p in zip(unit, pslices):
            x, cache = block_prefill(p, x, cfg, ch, positions, num_groups,
                                     cache_len)
            rep_caches.append(cache)
        per_rep.append(rep_caches)
    caches: Dict[str, Any] = {"unit": per_rep[0], "rest": []}
    if reps > 1:
        caches["unit"] = [_stack_layers([rc[i] for rc in per_rep])
                          for i in range(len(unit))]
    for ch, p in zip(rest, params["rest"]):
        x, cache = block_prefill(p, x, cfg, ch, positions, num_groups,
                                 cache_len)
        caches["rest"].append(cache)
    h = layers.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = layers.logits_fn(params["head"], h, cfg)[:, 0]
    return logits, caches


def decode_step(params, cache: Any, batch: Dict[str, torch.Tensor], pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Any]:
    """One decode step: batch has 'tokens' (B, 1) or, with a frontend,
    'embeds' (B, 1, fd); ``pos`` the position of that token.  Attention
    caches are updated in place (``layers.attention_decode``); RWKV
    states are carried, and ignore ``pos``.  Under a model axis, as
    :func:`prefill`: the rank's vocabulary columns and cache part."""
    unit, reps, rest = layer_plan(cfg.layer_pattern, cfg.scan_layers)
    x = _embed_inputs(params, batch, cfg)

    per_rep = []
    for r in range(reps):
        pslices = [_layer(p, r) for p in params["unit"]] if reps > 1 \
            else params["unit"]
        cslices = [_layer(c, r) for c in cache["unit"]] if reps > 1 \
            else cache["unit"]
        rep_caches = []
        for ch, p, c in zip(unit, pslices, cslices):
            x, nc = block_decode(p, x, cfg, ch, c, pos, 1)
            rep_caches.append(nc)
        per_rep.append(rep_caches)
    new_caches: Dict[str, Any] = {"unit": per_rep[0], "rest": []}
    if reps > 1:
        new_caches["unit"] = [_stack_layers([rc[i] for rc in per_rep])
                              for i in range(len(unit))]
    for ch, p, c in zip(rest, params["rest"], cache["rest"]):
        x, nc = block_decode(p, x, cfg, ch, c, pos, 1)
        new_caches["rest"].append(nc)
    h = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = layers.logits_fn(params["head"], h, cfg)[:, 0]
    return logits, new_caches


# ---------------------------------------------------------------------------
# Cache constructor and specs
# ---------------------------------------------------------------------------

def make_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """A zero decode cache; under a model axis, this rank's part."""
    unit, reps, rest = layer_plan(cfg.layer_pattern, cfg.scan_layers)

    def one(ch):
        return block_make_cache(cfg, ch, batch, seq_len, device)
    unit_caches = [one(ch) for ch in unit]
    if reps > 1:
        unit_caches = [tree_map(
            lambda a: a.expand((reps,) + tuple(a.shape)).clone(), c)
            for c in unit_caches]
    return {"unit": unit_caches, "rest": [one(ch) for ch in rest]}


def cache_lengths(cfg: ModelConfig, seq_len: int):
    """The positions of each attention layer's KV cache for ``seq_len``
    (a windowed layer's ring: ``min(window, seq_len)``), as a sorted
    tuple of the distinct lengths."""
    out = set()
    for ch in set(cfg.layer_pattern) & set(ATTN_CHARS):
        w = _window_for(cfg, ch)
        out.add(min(w, seq_len) if w else seq_len)
    return tuple(sorted(out))


def block_cache_specs(cfg: ModelConfig, ch: str):
    if ch == "R":
        return rwkv.rwkv_cache_specs()
    if ch in "mM":
        return ssm.mamba_cache_specs()
    return layers.cache_specs(ch in WINDOW_CHARS)


def cache_spec_tree(cfg: ModelConfig):
    """The decode cache's logical specs, in :func:`make_cache`'s tree (a
    stacked unit's leading layer axis unsharded)."""
    unit, reps, rest = layer_plan(cfg.layer_pattern, cfg.scan_layers)

    def one(ch, stacked):
        specs = block_cache_specs(cfg, ch)
        if stacked:
            specs = tree_map(lambda s: P(None, *s), specs)
        return specs
    return {"unit": [one(ch, reps > 1) for ch in unit],
            "rest": [one(ch, False) for ch in rest]}
