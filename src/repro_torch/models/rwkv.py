"""RWKV-6 ("Finch") block: attention-free time-mix + channel-mix.

The reference's ``repro/models/rwkv.py`` in PyTorch: the same parameter
tree, the same data-dependent decay (a low-rank projection of the
shifted input) and the same exact recurrence per head (state S in
R^{hd x hd}):

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

:func:`_wkv_scan` runs it one token at a time in the reference's order
of operations: no cumprod or log-space closed form, which would change
the arithmetic for decays near 0.  The reference scans chunks of
``CHUNK`` tokens; chunking does not change the numbers (the state is
carried exactly from chunk to chunk), so the port keeps only its rule:
a sequence longer than one chunk must be a whole number of chunks.
The state ``(B, H, hd, hd)``, ``r, k, v, w`` and ``u`` are f32 whatever
the compute dtype; decode is the same recurrence over one token.

bf16 compute: the reference's jitted elementwise chains here (the
token-shift mix, ``silu``, ``square(relu(k))``, ``sigmoid(r) * kv``,
``y * g``) round to bf16 after every op, as PyTorch does; XLA lowers
``jax.nn.sigmoid`` to ``1 / (1 + exp(-x))``, each op rounded
(:func:`_sigmoid`), and drops the last rounding of the decay's mix,
which is cast up to f32.  So in bf16 the port's values equal the
reference's bit for bit on the CPU, up to the order of the sums inside
products.

On a tensor-parallel ``model`` axis (``parallel.tensor_parallel``) a
rank runs its ``H / m`` heads.  Time mix: the token-shift mixes act on
the whole ``x``, then *f*; ``wr``, ``wk``, ``wv``, ``wg`` and
``decay_b`` are column-parallel (the rank's channels), and the
replicated ``decay_base``, ``bonus_u`` and ``ln_scale`` act on the
rank's slice through *f*; the recurrence and the group norm run on the
rank's heads and ``wo`` is row-parallel (*g*).  Channel mix: ``ck``
column- and ``cv`` row-parallel (*g*: ``kv`` whole); ``cr`` is
column-parallel over ``d``, and its output is gathered whole
(``tensor_parallel.gather_replicated``) to meet the whole ``kv``.  The
gate's product then feeds the replicated stream alike on every rank,
so its gradient is whole there: the gather's backward keeps the rank's
slice with no collective, and ``kv``'s *g* stays an all-reduce (slicing
``kv`` instead would leave it a part of its gradient, and need a
reduce-scatter forward and an all-gather backward in place of *g*).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .config import ModelConfig
from .param import PDecl
from ..parallel import tensor_parallel as tp
from ..parallel.sharding import PartitionSpec as P
from ..topology import opcost

CHUNK = 64
DECAY_RANK = 64


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    hd = cfg.rwkv_head_size
    h = cfg.d_model // hd
    return h, hd


def rwkv_decls(cfg: ModelConfig) -> Dict[str, PDecl]:
    d = cfg.d_model
    return {
        # time-mix
        "mu_r": PDecl((d,), P(None), init="zeros"),
        "mu_k": PDecl((d,), P(None), init="zeros"),
        "mu_v": PDecl((d,), P(None), init="zeros"),
        "mu_w": PDecl((d,), P(None), init="zeros"),
        "mu_g": PDecl((d,), P(None), init="zeros"),
        "wr": PDecl((d, d), P("fsdp", "tp")),
        "wk": PDecl((d, d), P("fsdp", "tp")),
        "wv": PDecl((d, d), P("fsdp", "tp")),
        "wg": PDecl((d, d), P("fsdp", "tp")),
        "wo": PDecl((d, d), P("tp", "fsdp")),
        "decay_base": PDecl((d,), P(None), init="zeros"),
        "decay_a": PDecl((d, DECAY_RANK), P("fsdp", None)),
        "decay_b": PDecl((DECAY_RANK, d), P(None, "tp"), fan_in=DECAY_RANK),
        "bonus_u": PDecl((d,), P(None), init="zeros"),
        "ln_scale": PDecl((d,), P(None), init="ones"),
        # channel-mix
        "cmu_k": PDecl((d,), P(None), init="zeros"),
        "cmu_r": PDecl((d,), P(None), init="zeros"),
        "ck": PDecl((d, cfg.d_ff), P("fsdp", "tp")),
        "cv": PDecl((cfg.d_ff, d), P("tp", "fsdp")),
        "cr": PDecl((d, d), P("fsdp", "tp")),
    }


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: concat previous timestep; x (B,S,D), x_prev (B,1,D)."""
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (xs - x) * mu.to(x.dtype)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA lowers it: ``1 / (1 + exp(-x))``."""
    return 1 / (1 + torch.exp(-x))


def _time_mix_inputs(params, x: torch.Tensor, xs: torch.Tensor,
                     cfg: ModelConfig):
    """(r, k, v, g, w, u): r, k, v, w (B, S, H', hd) f32, g (B, S, D') in
    the compute dtype, u (H', hd) f32 -- H' this rank's heads, D' their
    channels (all of them off a model axis)."""
    hd = cfg.rwkv_head_size
    b, s, d = x.shape
    dt = cfg.compute_dtype
    lo, hi = tp.part(d)

    def column(mu: str, w: str) -> torch.Tensor:
        return tp.copy_to(_mix(x, xs, params[mu])) @ params[w].to(dt)
    r, k, v, g = (column("mu_" + n, "w" + n) for n in "rkvg")
    g = g * _sigmoid(g)                                     # jax.nn.silu
    # the mix's last add in f32: XLA drops its rounding before the cast up
    xw = x.float() + ((xs - x) * params["mu_w"].to(x.dtype)).float()
    # Finch data-dependent decay (exact): w in (0, 1) per channel per token.
    dec = tp.copy_to(params["decay_base"].float())[lo:hi] + \
        tp.copy_to(torch.tanh(xw @ params["decay_a"].float())) @ \
        params["decay_b"].float()
    w = torch.exp(-torch.exp(torch.clamp(dec, -8.0, 4.0)))
    shp = (b, s, -1, hd)
    return (r.reshape(shp).float(), k.reshape(shp).float(),
            v.reshape(shp).float(), g, w.reshape(shp),
            tp.copy_to(params["bonus_u"].float())[lo:hi].reshape(-1, hd))


def wkv_cost(b: int, s: int, h: int, hd: int, c: int, backward: bool,
             s0_grad: bool = False, s_grad: bool = False) -> Tuple[int, int]:
    """``(flops, bytes)`` that ``topology.opcost`` counts for
    :func:`_wkv_scan` on f32 ``(b, s, h, hd)`` inputs in chunks of ``c``:
    its forward, or (``backward``) autograd's backward of it, ``r``,
    ``k``, ``v``, ``w`` and ``u`` needing gradients, ``s0`` if
    ``s0_grad``, and the last state having one if ``s_grad``.  The op by
    op sum of the loops as ``(calls, bytes a call)`` (one chunk's slices
    of ``k`` and ``v`` are the whole and need no gradient of their own): ``e`` the state,
    ``ev`` a token's row, ``ec`` a chunk's ``k v^T``, ``er`` a chunk's
    rows, ``es`` a whole input, ``hh`` ``u``."""
    f, n = 4, s // c
    e, ev, hh = b * h * hd * hd, b * h * hd, h * hd
    ec, er, es = c * e, c * ev, s * ev
    flops = 2 * b * h * hd * hd * s
    if not backward:
        return flops, sum(k * x for k, x in [
            (n, f * (2 * er + ec)), (n, f * (hh + 2 * ec)),     # kv, u kv
            (s * (b > 1), 2 * f * ev), (s, 3 * f * e),          # r_t, + u kv
            (s, f * (2 * ev + e)),                              # r_t @ ...
            (s, f * (ev + 2 * e)), (s, 3 * f * e),              # the state
            (1, 2 * f * es)])                                   # stack
    # the state's gradient reaches s0 only if it wants one, and the last
    # token's k, v and w only through a gradient of the last state
    sg, s0g = int(s_grad), int(s0_grad)
    back = s - 2 + s0g + sg
    return 2 * flops, sum(k * x for k, x in [
        (back, 3 * f * e), (2 * s + 2 * n - 5 + sg, 3 * f * es),    # sums
        (n * (2 * c - 1) - 1 + sg, 3 * f * ec), (n - 1, 3 * f * hh),
        (2 * s, f * (2 * ev + e)),                          # the bmms
        (back, f * (2 * e + ev)), (s - 1 + sg, 3 * f * e),  # w * state
        (n, f * (2 * ec + hh)), (2 * n, f * (2 * ec + er)),
        (n, 3 * f * ec),                                    # kv, u kv
        (s, 2 * f * ev), (2 * s - 1 + sg, f * (ev + es)),   # selects
        (2 * s - 1 + sg, f * (e + ec)), (2 * n * (n > 1), f * (er + es)),
        (s - 1 + sg, f * (e + ev)), (n, f * (ec + hh)),     # sums to size
        (2 * n, f * (ec + er)),
    ])


class _WKVShapes(torch.autograd.Function):
    """:func:`_wkv_scan` on ``meta`` tensors (a step lowered without
    devices, ``launch.lowering``): the outputs' shapes forward and the
    inputs' gradients' shapes backward, with nothing computed -- the
    recurrence issues no collective, and its thousands of per-token ops
    would only cost the lowering time.  Each pass reports to
    ``topology.opcost`` the work its real computation counts
    (:func:`wkv_cost`)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        b, s, h, hd = r.shape
        ctx.cost = (b, s, h, hd, min(CHUNK, s))
        if opcost.active():
            flops, nbytes = wkv_cost(*ctx.cost, False)
            opcost.add("wkv", flops, nbytes, shapes=str(ctx.cost))
        return r.new_empty((b, s, h * hd)), s0.new_empty(s0.shape)

    @staticmethod
    def backward(ctx, gy, gs):
        if opcost.active():
            flops, nbytes = wkv_cost(*ctx.cost, True,
                                     ctx.needs_input_grad[5], gs is not None)
            opcost.add("wkv_backward", flops, nbytes, shapes=str(ctx.cost))
        return tuple(torch.empty_like(x) if want else None for x, want
                     in zip(ctx.saved_tensors, ctx.needs_input_grad))


def _wkv_scan(r, k, v, w, u, s0):
    """Exact recurrence.  r, k, v, w: (B, S, H, hd) f32; u (H, hd);
    s0 (B, H, hd, hd).  Returns (y (B, S, H*hd), last state).

    Each chunk's ``k v^T`` and ``u k v^T`` are formed at once (the same
    products as one token at a time), then the tokens run in order."""
    b, s, h, hd = r.shape
    c = min(CHUNK, s)
    if s % c:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"WKV chunk {c} (CHUNK = {CHUNK})")
    if r.device.type == "meta":
        return _WKVShapes.apply(r, k, v, w, u, s0)
    state = s0
    ys = []
    for c0 in range(0, s, c):
        kv = k[:, c0:c0 + c, ..., :, None] * v[:, c0:c0 + c, ..., None, :]
        ukv = u[None, None, :, :, None] * kv               # (B, c, H, hd, hd)
        for t in range(c):
            rt = r[:, c0 + t, :, None, :]                  # (B, H, 1, hd)
            ys.append((rt @ (state + ukv[:, t]))[:, :, 0])
            state = w[:, c0 + t, ..., None] * state + kv[:, t]
    y = torch.stack(ys, dim=1)                             # (B, S, H, hd)
    return y.reshape(b, s, h * hd), state


def _group_norm(y: torch.Tensor, scale: torch.Tensor, h: int,
                eps: float) -> torch.Tensor:
    b, s, d = y.shape
    yh = y.reshape(b, s, h, d // h)
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)   # jnp.var: population
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return yh.reshape(b, s, d) * scale.to(y.dtype)


def rwkv_time_mix(params, x: torch.Tensor, cfg: ModelConfig,
                  x_prev: torch.Tensor, s0: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y, new_x_prev, new_state)."""
    h, hd = _dims(cfg)
    dt = cfg.compute_dtype
    lo, hi = tp.part(cfg.d_model)
    xs = _shift(x, x_prev)
    r, k, v, g, w, u = _time_mix_inputs(params, x, xs, cfg)
    y, s_last = _wkv_scan(r, k, v, w, u, s0)
    y = _group_norm(y, tp.copy_to(params["ln_scale"])[lo:hi],
                    h // tp.size(), cfg.norm_eps)
    y = tp.reduce_from((y.to(dt) * g) @ params["wo"].to(dt))
    return y, x[:, -1:], s_last


def rwkv_channel_mix(params, x: torch.Tensor, cfg: ModelConfig,
                     x_prev: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = cfg.compute_dtype
    xs = _shift(x, x_prev)
    k = tp.copy_to(_mix(x, xs, params["cmu_k"])) @ params["ck"].to(dt)
    k = torch.square(torch.relu(k))
    kv = tp.reduce_from(k @ params["cv"].to(dt))
    r = tp.copy_to(_mix(x, xs, params["cmu_r"])) @ params["cr"].to(dt)
    return _sigmoid(tp.gather_replicated(r, 2)) * kv, x[:, -1:]


def rwkv_make_cache(cfg: ModelConfig, batch: int, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Zero token shifts and a zero state of this rank's heads (all of
    them off a model axis)."""
    h, hd = _dims(cfg)
    return {"s": torch.zeros((batch, h // tp.size(), hd, hd),
                             dtype=torch.float32, device=device),
            "tm_xprev": torch.zeros((batch, 1, cfg.d_model),
                                    dtype=cfg.compute_dtype, device=device),
            "cm_xprev": torch.zeros((batch, 1, cfg.d_model),
                                    dtype=cfg.compute_dtype, device=device)}


def rwkv_cache_specs() -> Dict[str, P]:
    return {"s": P("batch", "tp", None, None),
            "tm_xprev": P("batch", None, None),
            "cm_xprev": P("batch", None, None)}
