"""Transformer substrate: norms, RoPE, GQA attention (all assigned
variants), SwiGLU MLP, embeddings and the LM head.

The reference's ``repro/models/layers.py`` in PyTorch: the same
parameter trees (``(in, out)`` weight layouts), the same arithmetic in
the same dtypes.  Attention comes in two forms, as there:

* train/prefill: memory-efficient blockwise causal attention
  (:func:`_mea`, online softmax over KV chunks, windowed masks for SWA
  layers), written out in plain PyTorch ops as the reference left it to
  XLA;
* decode: single-token attention over a (possibly ring/windowed) KV
  cache.

The reference's sharding constraints become, on a tensor-parallel
``model`` axis (``parallel.tensor_parallel``), this rank's heads, ``ff``
columns and vocabulary rows and the collectives around them: *f* on the
input of each column-parallel product, *g* on the output of each
row-parallel one, k and v gathered whole before ``k_norm`` and RoPE as
the reference orders it, and a vocab-parallel embedding and
cross-entropy.  Under ``cfg.attn_dp`` (the reference's batch-parallel
attention), or where the heads do not split into whole kv groups a
rank (``sharding.whole_head_groups``), q is gathered whole too: every
rank attends with all heads and keeps its own columns of the output for
the row-parallel ``wo``, which is what the reference's ``_dp_reshard``
computes.  Off such an axis every one of them is the identity.

Serving on a model axis shards each KV cache over ``seq``
(``cache_specs``): a rank holds ``Sc / m`` of its positions, all kv
heads.  Prefill keeps the rank's slice of the whole (padded or
ring-rolled) k and v; decode gathers q whole, writes the new k and v on
the rank that owns slot ``pos % Sc``, scores its own positions and joins
the ranks' partial softmaxes in the flash-decoding combine
(``tensor_parallel.combine_softmax``) before its columns of the output
meet the row-parallel ``wo``.
:func:`lm_loss` is the training loss: the cross-entropy chunked over the
sequence, each chunk recomputed in the backward.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .param import PDecl
from ..parallel import tensor_parallel as tp
from ..parallel.sharding import PartitionSpec as P
from ..parallel.sharding import whole_head_groups

NEG_INF = -2.0 ** 30   # large-but-finite: keeps fully-masked rows NaN-free


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_decls(d: int) -> Dict[str, PDecl]:
    return {"scale": PDecl((d,), P(None), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (NeoX half-rotation)
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exponent)
    ang = positions[..., None].float() * freqs                  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attn_decls(cfg: ModelConfig) -> Dict[str, PDecl]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    decls = {
        "wq": PDecl((d, h * hd), P("fsdp", "tp")),
        "wk": PDecl((d, kv * hd), P("fsdp", "tp")),
        "wv": PDecl((d, kv * hd), P("fsdp", "tp")),
        "wo": PDecl((h * hd, d), P("tp", "fsdp")),
    }
    if cfg.qkv_bias:
        decls |= {"bq": PDecl((h * hd,), P("tp"), init="zeros"),
                  "bk": PDecl((kv * hd,), P("tp"), init="zeros"),
                  "bv": PDecl((kv * hd,), P("tp"), init="zeros")}
    if cfg.qk_norm:
        decls |= {"q_norm": PDecl((hd,), P(None), init="ones"),
                  "k_norm": PDecl((hd,), P(None), init="ones")}
    return decls


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd), roped + normed.
    On a model axis q holds this rank's heads (all of them where
    :func:`_gathers_q`), and k and v are gathered whole."""
    b, s, _ = x.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    dt = cfg.compute_dtype
    x = tp.copy_to(x)
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if _gathers_q(cfg):
        q = tp.gather(q, 2)
    q = q.reshape(b, s, -1, hd)
    k = tp.gather(k, 2).reshape(b, s, kv, hd)
    v = tp.gather(v, 2).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        # both scales act on what serves this rank's q heads (or columns
        # of the output) alone: their gradients are parts of the whole
        q = rmsnorm({"scale": tp.copy_to(params["q_norm"])}, q, cfg.norm_eps)
        k = rmsnorm({"scale": tp.copy_to(params["k_norm"])}, k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mea(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         q_pos: torch.Tensor, kv_pos: torch.Tensor, cfg: ModelConfig,
         window: Optional[int]) -> torch.Tensor:
    """Memory-efficient attention: online softmax over KV chunks.

    q (B, Sq, H, hd); k, v (B, Skv, KV, hd); positions (Sq,) / (Skv,) give
    the causal/window masks.  Returns (B, Sq, H, hd) in the compute dtype.
    """
    if q.device.type == "meta":
        return _MEAShapes.apply(q, k, v, cfg.compute_dtype)
    b, sq0, h, hd = q.shape
    skv0, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qc = min(cfg.attn_q_chunk, sq0)
    kc = min(cfg.attn_kv_chunk, skv0)
    # pad to chunk multiples; padded KV slots get position 2^30 so the causal
    # mask excludes them, padded Q rows are sliced off at the end.
    pq = (-sq0) % qc
    pk = (-skv0) % kc
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        q_pos = F.pad(q_pos, (0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        kv_pos = F.pad(kv_pos, (0, pk), value=2 ** 30)
    sq, skv = sq0 + pq, skv0 + pk
    nq, nk = sq // qc, skv // kc
    scale = hd ** -0.5

    qr = q.reshape(b, nq, qc, kvh, g, hd)
    qpr = q_pos.reshape(nq, qc)
    kr = k.reshape(b, nk, kc, kvh, hd)
    vr = v.reshape(b, nk, kc, kvh, hd)
    kpr = kv_pos.reshape(nk, kc)

    outs = []
    for i in range(nq):                       # the reference's map over q chunks
        qb, qp = qr[:, i].float(), qpr[i]     # (b, qc, kvh, g, hd)
        acc = torch.zeros((b, qc, kvh, g, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, qc, kvh, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, qc, kvh, g), dtype=torch.float32, device=q.device)
        for j in range(nk):                   # its scan over kv chunks
            kb, vb, kp = kr[:, j].float(), vr[:, j].float(), kpr[j]
            s_ = torch.einsum("bqkgd,bskd->bqkgs", qb, kb) * scale
            mask = kp[None, :] <= qp[:, None]                     # causal
            if window is not None:
                mask &= kp[None, :] > qp[:, None] - window
            s_ = torch.where(mask[None, :, None, None, :], s_, NEG_INF)
            m_new = torch.maximum(m, s_.amax(dim=-1))
            p = torch.exp(s_ - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bqkgs,bskd->bqkgd", p, vb)
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs, dim=1).reshape(b, sq, h, hd)[:, :sq0]
    return out.to(cfg.compute_dtype)


class _MEAShapes(torch.autograd.Function):
    """:func:`_mea` on ``meta`` tensors (a step lowered without devices,
    ``launch.lowering``): the output's shape forward and the inputs'
    gradients' shapes backward, with nothing computed -- the chunk loops
    issue no collective, and at ``prefill_32k`` they would run thousands
    of ops a layer for nothing but the lowering's time."""

    @staticmethod
    def forward(ctx, q, k, v, dtype):
        ctx.shapes = (q, k, v)
        return q.new_empty(q.shape, dtype=dtype)

    @staticmethod
    def backward(ctx, grad):
        return tuple(torch.empty_like(x) for x in ctx.shapes) + (None,)


def _gathers_q(cfg: ModelConfig) -> bool:
    """On a model axis: whether every rank gathers q whole and attends
    with all heads (``attn_dp``, or heads that do not split into whole
    kv groups a rank)."""
    m = tp.size()
    return m > 1 and (cfg.attn_dp or not whole_head_groups(cfg, m))


def _attend(params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cfg: ModelConfig, window: Optional[int], positions: torch.Tensor
            ) -> torch.Tensor:
    """The attention of :func:`_project_qkv`'s q, k, v through the
    row-parallel ``wo``: (B, S, D), summed over a model axis.  A rank
    with its own q heads attends with the kv heads they use
    (``sharding.check_mesh`` has made them whole groups of a kv head
    each, or a part of one group); one with all heads keeps its columns
    of the output."""
    b, s = q.shape[:2]
    gathered = _gathers_q(cfg)
    if tp.size() > 1 and not gathered:
        lo, hi = tp.part(cfg.num_heads)
        g = cfg.num_heads // cfg.num_kv_heads
        kv = slice(lo // g, (hi - 1) // g + 1)
        k, v = k[:, :, kv], v[:, :, kv]
    w = window if (window is not None and window < s) else None
    pos1d = positions[0]                       # (S,) -- same across batch
    o = _mea(q, k, v, pos1d, pos1d, cfg, w).reshape(b, s, -1)
    if gathered:
        lo, hi = tp.part(o.shape[-1])
        o = o[..., lo:hi]
    return tp.reduce_from(o @ params["wo"].to(cfg.compute_dtype))


def attention_train(params, x: torch.Tensor, cfg: ModelConfig,
                    window: Optional[int], positions: torch.Tensor
                    ) -> torch.Tensor:
    """Causal self-attention over (B, S, D); returns (B, S, D)."""
    q, k, v = _project_qkv(params, x, cfg, positions)
    return _attend(params, q, k, v, cfg, window, positions)


def make_cache(cfg: ModelConfig, batch: int, seq_len: int,
               window: Optional[int], device=None) -> Dict[str, Any]:
    """A zero KV cache of ``seq_len`` positions (the ring of a windowed
    layer: ``min(window, seq_len)``); on a model axis, this rank's
    ``1 / m`` of them."""
    size = min(window, seq_len) if window else seq_len
    lo, hi = tp.part(size)
    kvshape = (batch, hi - lo, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kvshape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(kvshape, dtype=cfg.compute_dtype, device=device)}


def cache_specs(windowed: bool) -> Dict[str, P]:
    # KV caches are sequence-sharded over the tensor axis (flash-decoding).
    return {"k": P("batch", "seq", None, None),
            "v": P("batch", "seq", None, None)}


def attention_prefill(params, x: torch.Tensor, cfg: ModelConfig,
                      window: Optional[int], positions: torch.Tensor,
                      cache_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Like train, but also returns the KV cache (ring-rolled if windowed).

    ``cache_len`` >= S adds decode headroom; windowed layers cap the cache at
    the window size (ring buffer with slot = position % window).  On a
    model axis the cache is this rank's slice of those positions.
    """
    b, s, _ = x.shape
    cache_len = cache_len or s
    q, k, v = _project_qkv(params, x, cfg, positions)
    y = _attend(params, q, k, v, cfg, window, positions)

    if window and window < cache_len:
        keep = min(window, s)
        k_last, v_last = k[:, s - keep:], v[:, s - keep:]
        if s > window:
            # ring-order the last `window` entries: slot = pos % window
            shift = s % window
            cache = {"k": torch.roll(k_last, shift, dims=1),
                     "v": torch.roll(v_last, shift, dims=1)}
        else:
            pad = window - s
            cache = {"k": F.pad(k_last, (0, 0, 0, 0, 0, pad)),
                     "v": F.pad(v_last, (0, 0, 0, 0, 0, pad))}
    else:
        pad = cache_len - s
        cache = {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
                 "v": F.pad(v, (0, 0, 0, 0, 0, pad))}
    if tp.size() > 1:
        lo, hi = tp.part(cache["k"].shape[1])
        cache = {n: c[:, lo:hi].clone() for n, c in cache.items()}
    return y, cache


def attention_decode(params, x: torch.Tensor, cfg: ModelConfig,
                     cache: Dict[str, torch.Tensor], pos: int,
                     window: Optional[int]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: x (B, 1, D), cache (B, Sc, KV, hd), pos an int.

    The new key and value are written into the cache in place
    (``index_copy_`` at slot ``pos % Sc``, where the reference's
    ``dynamic_update_slice`` makes a new array); the returned cache is
    the same tensors.  On a model axis the cache is this rank's slice of
    the ``Sc`` positions (:func:`_decode_sharded`).
    """
    b = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kvh
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)
    if tp.size() > 1:
        return _decode_sharded(params, q, k_new, v_new, cfg, cache, pos)

    k, v = cache["k"], cache["v"]
    sc = k.shape[1]
    slot = torch.tensor([pos % sc], device=x.device)
    k.index_copy_(1, slot, k_new.to(k.dtype))
    v.index_copy_(1, slot, v_new.to(v.dtype))

    qv = q.reshape(b, kvh, g, hd)
    s_ = torch.einsum("bkgd,bskd->bkgs", qv.float(), k.float()) * (hd ** -0.5)
    valid = torch.arange(sc, device=x.device) < min(pos + 1, sc)  # ring: all valid once full
    s_ = torch.where(valid[None, None, None, :], s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    o = o.reshape(b, 1, h * hd).to(cfg.compute_dtype)
    return o @ params["wo"].to(cfg.compute_dtype), {"k": k, "v": v}


def _decode_sharded(params, q: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, cfg: ModelConfig,
                    cache: Dict[str, torch.Tensor], pos: int
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`attention_decode` on a model axis, the cache (B, Sc / m,
    KV, hd) this rank's positions ``[lo, hi)`` of ``Sc``: q gathered
    whole (the slice holds every kv head), the new k and v written on
    the rank that owns slot ``pos % Sc``, the rank's positions scored
    and masked by their global index, the flash-decoding combine, and
    this rank's columns of the output through the row-parallel ``wo``."""
    b = q.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if not _gathers_q(cfg):
        q = tp.gather(q, 2)
    k, v = cache["k"], cache["v"]
    sc = k.shape[1] * tp.size()
    lo, hi = tp.part(sc)
    slot = pos % sc
    if lo <= slot < hi:
        here = torch.tensor([slot - lo], device=q.device)
        k.index_copy_(1, here, k_new.to(k.dtype))
        v.index_copy_(1, here, v_new.to(v.dtype))

    qv = q.reshape(b, kvh, h // kvh, hd)
    s_ = torch.einsum("bkgd,bskd->bkgs", qv.float(), k.float()) * (hd ** -0.5)
    valid = torch.arange(lo, hi, device=q.device) < min(pos + 1, sc)
    s_ = torch.where(valid[None, None, None, :], s_, NEG_INF)
    m = s_.amax(dim=-1)
    p = torch.exp(s_ - m[..., None])
    o = tp.combine_softmax(m, p.sum(dim=-1),
                           torch.einsum("bkgs,bskd->bkgd", p, v.float()))
    o = o.reshape(b, 1, h * hd).to(cfg.compute_dtype)
    cols = slice(*tp.part(h * hd))
    y = tp.reduce_from(o[..., cols] @ params["wo"].to(cfg.compute_dtype))
    return y, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_decls(cfg: ModelConfig) -> Dict[str, PDecl]:
    d, f = cfg.d_model, cfg.d_ff
    decls = {"wi": PDecl((d, f), P("fsdp", "tp")),
             "wo": PDecl((f, d), P("tp", "fsdp"))}
    if cfg.mlp_gated:
        decls["wg"] = PDecl((d, f), P("fsdp", "tp"))
    return decls


def mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    x = tp.copy_to(x)
    if cfg.mlp_gated:
        h = F.silu(x @ params["wg"].to(dt)) * (x @ params["wi"].to(dt))
    else:   # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ params["wi"].to(dt), approximate="tanh")
    return tp.reduce_from(h @ params["wo"].to(dt))


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------

def embed_decls(cfg: ModelConfig) -> Dict[str, PDecl]:
    return {"embedding": PDecl((cfg.vocab_size, cfg.d_model), P("tp", "fsdp"),
                               init="embed", fan_in=cfg.d_model)}


def _local_ids(ids: torch.Tensor, vocab: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mine, row)``: which token ids fall in this rank's vocabulary
    rows, and each one's row there (0 for the others)."""
    lo, hi = tp.part(vocab)
    ids = ids.long()
    mine = (ids >= lo) & (ids < hi)
    return mine, torch.where(mine, ids - lo, 0)


def embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if tp.size() == 1:
        return params["embedding"][tokens.long()].to(cfg.compute_dtype)
    # vocab-parallel: this rank's rows looked up, the others' zeros, summed
    mine, rows = _local_ids(tokens, cfg.vocab_size)
    x = params["embedding"][rows].to(cfg.compute_dtype)
    return tp.reduce_from(torch.where(mine[..., None], x, 0))


def head_decls(cfg: ModelConfig) -> Dict[str, PDecl]:
    return {"w": PDecl((cfg.d_model, cfg.vocab_size), P("fsdp", "tp"))}


def logits_fn(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    return (h.to(dt) @ params["w"].to(dt)).float()


def _chunk_loss(head_params, hx: torch.Tensor, tx: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    logits = logits_fn(head_params, hx, cfg)            # (B, c, V) f32
    if tp.size() == 1:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, tx.long()[..., None])[..., 0]
        return (lse - tgt).sum()
    # vocab-parallel: logits holds this rank's columns of the vocabulary
    top = tp.all_max(logits.amax(dim=-1))
    mine, cols = _local_ids(tx, cfg.vocab_size)
    tgt = torch.gather(logits, -1, cols[..., None])[..., 0]
    sums = tp.reduce_from(torch.stack([
        torch.exp(logits - top[..., None]).sum(dim=-1),
        torch.where(mine, tgt, 0.0)]))
    return (top + torch.log(sums[0]) - sums[1]).sum()


def lm_loss(head_params, h: torch.Tensor, targets: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy, chunked over the sequence by
    ``cfg.loss_chunk``.  Each chunk runs under ``torch.utils.checkpoint``
    (the reference's ``jax.checkpoint``), so the backward recomputes its
    ``(B, c, V)`` f32 logits instead of keeping them; the chunks' sums
    are added in order, as the reference's scan does."""
    b, s, _ = h.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {c}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    h = tp.copy_to(h)
    for i in range(0, s, c):
        total = total + checkpoint(_chunk_loss, head_params, h[:, i:i + c],
                                   targets[:, i:i + c], cfg,
                                   use_reentrant=False)
    return total / (b * s)
