"""Mixture-of-Experts layer: top-k routing with sort-based dispatch.

The reference's ``repro/models/moe.py`` in PyTorch.  Tokens are grouped,
argsorted by expert id within the group (stable, as ``jnp.argsort``),
packed into capacity-bounded per-expert buffers, run through every
expert with batched einsums, and combined back with the router weights
(``moe_combine="gather"``, the token side, or ``"scatter"``, the expert
side).  Top-k ties go to the lower expert id, as ``jax.lax.top_k``.

Capacity: ``cap = tokens_per_group * top_k / E * moe_capacity_factor``
(+1, at most the group size); overflow tokens are dropped.  A factor
``<= 0`` is dropless (``cap`` = group size).  A capped capacity makes a
token's drops depend on every token of its group, so decode routes the
global batch as one group, as the reference does: on a data axis above 1
(:func:`route_over`) the MoE input is gathered over data, routed whole,
and the rank keeps its own rows.

On a tensor-parallel ``model`` axis (``parallel.tensor_parallel``) the
experts shard as the reference declares them.  Where a 16-way axis
divides them (:func:`experts_on_ep`) each rank holds ``E / m`` whole
experts: the ranks of a model group route the same tokens alike, each
dispatches into its own experts' rows of the buffer, runs them, and
combines their contributions alone, and the partial combines are summed
over the group (*g*).  The tokens and the router weights enter that
part through *f*, so the router's gradient comes out whole.  Otherwise
each expert's ``ff`` columns shard, and the expert output is summed
before the combine.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from ..parallel import collectives as coll
from ..parallel import tensor_parallel as tp
from .config import ModelConfig
from .param import PDecl
from ..parallel.sharding import PartitionSpec as P


_route_axis: Optional[coll.MeshAxis] = None


@contextlib.contextmanager
def route_over(axis: Optional[coll.MeshAxis]):
    """In the body of a ``with``, every MoE layer routes its tokens as one
    group with those of the other ranks of ``axis`` (a data axis whose
    ranks hold different rows; ``None``: this rank's tokens alone)."""
    global _route_axis
    prev, _route_axis = _route_axis, axis
    try:
        yield axis
    finally:
        _route_axis = prev


def experts_on_ep(cfg: ModelConfig) -> bool:
    """The reference's rule: experts shard over 'ep' when a 16-way axis
    divides them, else each expert's ff dimension over 'tp'."""
    return cfg.num_experts > 0 and cfg.num_experts % 16 == 0


def moe_decls(cfg: ModelConfig) -> Dict[str, PDecl]:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    ep = experts_on_ep(cfg)
    ep_spec = P("ep", "fsdp", None) if ep else P(None, "fsdp", "tp")
    ep_spec_out = P("ep", None, "fsdp") if ep else P(None, "tp", "fsdp")
    return {
        "router": PDecl((d, e), P("fsdp", None)),
        "wg": PDecl((e, d, f), ep_spec, fan_in=d),
        "wi": PDecl((e, d, f), ep_spec, fan_in=d),
        "wo": PDecl((e, f, d), ep_spec_out, fan_in=f),
    }


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort)."""
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], ids[..., :k]


def _histogram(ids: torch.Tensor, e: int) -> torch.Tensor:
    """``bincount(ids, minlength=e)`` for ids in ``[0, e)``, as a
    scatter-add of ones: the same integers on the CPU and the card, and
    a shape alone on ``meta``."""
    return torch.zeros(e, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _dispatch_group(xg, idg, wg_, cfg: ModelConfig, cap: int, lo: int,
                    hi: int):
    """One group: xg (tg, d); idg/wg_ (tg, k) -> the buffer of experts
    ``[lo, hi)`` (hi - lo, cap, d) and what the combine needs.  Slots
    and drops are those of the whole buffer: rows of other experts are
    left out, not packed."""
    tg, d = xg.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dt = cfg.compute_dtype
    dev = xg.device
    flat_ids = idg.reshape(tg * k)
    order = torch.argsort(flat_ids, stable=True)          # local sort only
    sorted_ids = flat_ids[order]
    tok = order // k                                       # source token
    hist = _histogram(flat_ids, e)
    start = torch.cumsum(hist, 0) - hist                   # first slot per expert
    pos = torch.arange(tg * k, device=dev) - start[sorted_ids]   # rank within expert
    keep = pos < cap
    slot = torch.where(keep, pos, cap - 1)
    # this rank's experts: their entries, and each one's row here
    mine = (sorted_ids >= lo) & (sorted_ids < hi)
    row = torch.where(mine, sorted_ids - lo, 0)

    # Per-slot source token and router weight.  The reference scatters
    # every entry, the dropped ones as (token tg, weight 0) into slot
    # cap - 1, and the last write wins: a dropped entry follows the kept
    # ones of its expert, so an expert that overflows ends with slot
    # cap - 1 empty.  Here the kept entries are written (the dropped ones
    # into a spare column) and that last write is applied explicitly, so
    # the result does not depend on the order of colliding writes.
    wflat = wg_.reshape(tg * k)[order]
    col = torch.where(keep, pos, cap)
    tok_buf = torch.full((e, cap + 1), tg, dtype=torch.long, device=dev)
    tok_buf[sorted_ids, col] = tok
    w_buf = torch.zeros((e, cap + 1), dtype=torch.float32, device=dev)
    w_buf[sorted_ids, col] = wflat
    tok_buf, w_buf = tok_buf[lo:hi, :cap], w_buf[lo:hi, :cap]
    over = hist[lo:hi] > cap
    tok_buf[:, cap - 1] = torch.where(over, tg, tok_buf[:, cap - 1])
    w_buf[:, cap - 1] = torch.where(over, 0.0, w_buf[:, cap - 1])
    if cfg.moe_combine == "scatter":
        xg_pad = torch.cat([xg.to(dt), torch.zeros((1, d), dtype=dt,
                                                   device=dev)])
        buf = xg_pad[tok_buf]                              # (hi - lo, cap, d)
    else:
        buf = torch.zeros((hi - lo, cap, d), dtype=dt, device=dev)
        buf.index_put_((row, slot),
                       torch.where((keep & mine)[:, None], xg[tok].to(dt), 0),
                       accumulate=True)
    return buf, (row, slot, tok, keep & mine, order, tok_buf, w_buf)


def _combine_group(yg, wg_, meta, cfg: ModelConfig):
    """One group's expert outputs yg (hi - lo, cap, d) back to (tg, d):
    the contributions of the experts ``[lo, hi)`` that dispatched them."""
    row, slot, tok, used, order, tok_buf, w_buf = meta
    d = yg.shape[-1]
    tg, k = wg_.shape
    dt = cfg.compute_dtype
    if cfg.moe_combine == "scatter":
        # expert-side combine: weight and scatter-add into tg + 1 rows
        contrib = yg * w_buf[..., None].to(dt)             # (hi - lo, cap, d)
        out = torch.zeros((tg + 1, d), dtype=dt, device=yg.device)
        out.index_add_(0, tok_buf.reshape(-1), contrib.reshape(-1, d))
        return out[:tg]
    gathered = yg[row, slot]                               # (tg*k, d)
    gathered = torch.where(used[:, None], gathered, 0)
    wflat = wg_.reshape(tg * k)[order]
    out = torch.zeros((tg, d), dtype=dt, device=yg.device)
    out.index_add_(0, tok, gathered * wflat[:, None].to(dt))
    return out


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig,
              num_groups: int = 1) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D)."""
    route = _route_axis
    # dropless, a token's output does not depend on the rest of its group
    if route is not None and route.size > 1 and cfg.moe_capacity_factor > 0:
        rows = x.shape[0]
        with route_over(None):
            whole = moe_apply(params, coll.all_gather(x, route, 0), cfg, 1)
        return whole.narrow(0, route.index * rows, rows)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dt = cfg.compute_dtype
    t = b * s
    g = num_groups if t % num_groups == 0 else 1
    tg = t // g

    xf = x.reshape(g, tg, d)
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                  # (g, tg, E)
    w, ids = _top_k(probs, k)                              # (g, tg, k)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)

    if cfg.moe_capacity_factor <= 0:
        cap = tg          # dropless: worst case, every token picks one expert
    else:
        cap = min(int(tg * k / e * cfg.moe_capacity_factor) + 1, tg)

    ep = experts_on_ep(cfg) and tp.size() > 1
    lo, hi = tp.part(e) if ep else (0, e)
    if ep:
        # the tokens and their weights enter this rank's experts alone:
        # the gradients of both are parts of the whole
        xf, w = tp.copy_to(xf), tp.copy_to(w)
    groups = [_dispatch_group(xf[i], ids[i], w[i], cfg, cap, lo, hi)
              for i in range(g)]
    bufs = torch.stack([buf for buf, _ in groups])        # (g, E', cap, D)
    if not ep:
        bufs = tp.copy_to(bufs)

    hg = torch.nn.functional.silu(
        torch.einsum("gecd,edf->gecf", bufs, params["wg"].to(dt)))
    hu = torch.einsum("gecd,edf->gecf", bufs, params["wi"].to(dt))
    y = torch.einsum("gecf,efd->gecd", hg * hu, params["wo"].to(dt))
    if not ep:
        # each expert's ff over the model axis: y is the parts' sum, whole
        # before the combine, so the router's gradient is whole too
        y = tp.reduce_from(y)

    out = torch.stack([_combine_group(y[i], w[i], groups[i][1], cfg)
                       for i in range(g)])
    if ep:
        out = tp.reduce_from(out)              # the experts' parts summed
    return out.reshape(b, s, d)
