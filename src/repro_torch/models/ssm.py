"""Mamba selective-state-space layer (Jamba's 'm' layers).

The reference's ``repro/models/ssm.py`` in PyTorch.  The full-sequence
scan of :func:`mamba_train` runs ``kernels.ops.selective_scan``, which is
the CUDA kernel K8 on the card: the state ``h`` stays in registers for
the whole sequence, so neither the ``(B, S, d_inner, d_state)`` state
tensor nor the discretised ``a_bar``/``bx`` tensors are ever built, and
the final state comes back with ``y`` for the decode cache.  Both values
of ``mamba_fuse_proj`` compute the same ``y`` and ``h_last`` as the
reference's two branches (``_fused_scan``, and ``_scan_chunked`` plus the
C-projection), so both take this one path.  On a tensor-parallel
``model`` axis each rank runs its ``d_inner / m`` channels (``in_proj``
and ``dt_proj`` column-parallel, the conv and K8 on local channels,
``x_proj`` and ``out_proj`` row-parallel), and its decode cache holds
those channels of ``h`` and of the conv window.  Under autograd the scan's
gradient comes from the plain scan recomputed in the backward
(``kernels.selective_scan.SelectiveScan``), so training on the card
differentiates what the reference differentiates.  Decode is the O(1)
single-step recurrence with a ``(h, conv window)`` state in the cache.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel import tensor_parallel as tp
from .config import ModelConfig
from .param import PDecl
from ..parallel.sharding import PartitionSpec as P


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    di = cfg.mamba_expand * cfg.d_model
    dt_rank = max(cfg.d_model // 16, 1)
    return di, cfg.mamba_d_state, cfg.mamba_d_conv, dt_rank


def mamba_decls(cfg: ModelConfig) -> Dict[str, PDecl]:
    d = cfg.d_model
    di, n, k, dtr = _dims(cfg)
    return {
        "in_proj": PDecl((d, 2 * di), P("fsdp", "tp"), tp_blocks=2),
        "conv_w": PDecl((k, di), P(None, "tp"), fan_in=k),
        "conv_b": PDecl((di,), P("tp"), init="zeros"),
        "x_proj": PDecl((di, dtr + 2 * n), P("tp", None)),
        "dt_proj": PDecl((dtr, di), P(None, "tp"), fan_in=dtr),
        "dt_bias": PDecl((di,), P("tp"), init="zeros"),
        "a_log": PDecl((di, n), P("tp", None), init="zeros"),
        "d_skip": PDecl((di,), P("tp"), init="ones"),
        "out_proj": PDecl((di, d), P("tp", "fsdp")),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_params(params, x_in: torch.Tensor, cfg: ModelConfig):
    """Input projection: returns (u, z), each (B, S, di)."""
    xz = x_in @ params["in_proj"].to(cfg.compute_dtype)
    u, z = torch.chunk(xz, 2, dim=-1)
    return u, z


def _post_conv(params, u_conv: torch.Tensor, cfg: ModelConfig):
    """(u_act, dt, b, c, a): the activation and the data-dependent scan
    parameters, in f32 (``u_act`` in the compute dtype)."""
    di, n, k, dtr = _dims(cfg)
    u_act = F.silu(u_conv)
    # x_proj is row-parallel over the channels: (dt, B, C) is the parts'
    # sum, and every rank's channels take part in its gradient
    xdbc = tp.copy_to(tp.reduce_from(u_act.float() @ params["x_proj"].float()))
    dt, b, c = torch.split(xdbc, [dtr, n, n], dim=-1)
    dt = _softplus(dt @ params["dt_proj"].float()
                   + params["dt_bias"].float())                  # (B, S, di)
    a = -torch.exp(params["a_log"].float())                      # (di, n)
    return u_act, dt, b, c, a


def _conv(params, taps, cfg: ModelConfig) -> torch.Tensor:
    """The causal depthwise conv from its ``k`` input taps (oldest first):
    ``sum_i taps[i] * conv_w[i] + conv_b``, summed in f32 in tap order
    and rounded to the compute dtype once.  The reference writes the
    prefill form as a chain of compute-dtype ops and the decode form as
    an einsum; XLA keeps the chain in f32 inside its fusion, so both
    round once.  Here prefill and decode share this one form, so a
    token's conv is the same in both."""
    w = params["conv_w"].to(cfg.compute_dtype).float()
    acc = params["conv_b"].to(cfg.compute_dtype).float()
    acc = sum((x.float() * w[i] for i, x in enumerate(taps)),
              torch.zeros_like(acc)) + acc
    return acc.to(cfg.compute_dtype)


def mamba_train(params, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """x (B, S, D) -> (B, S, D); full-sequence selective scan (K8).

    ``return_state=True`` additionally returns the decode cache after the
    sequence (used by prefill -- one pass instead of two).
    """
    bsz, s, d = x.shape
    di, n, k, dtr = _dims(cfg)
    dt_ = cfg.compute_dtype
    u, z = _ssm_params(params, tp.copy_to(x), cfg)

    # causal depthwise conv over sequence
    u_pad = F.pad(u, (0, 0, k - 1, 0))
    conv = _conv(params, [u_pad[:, i:i + s] for i in range(k)], cfg)
    u_act, dt, b, c, a = _post_conv(params, conv, cfg)

    y, h_last = ops.selective_scan(u_act.float().contiguous(),
                                   dt.contiguous(), a.contiguous(),
                                   b.contiguous(), c.contiguous())
    y = y + u_act.float() * params["d_skip"].float()
    y = (y * F.silu(z.float())).to(dt_)
    out = tp.reduce_from(y @ params["out_proj"].to(dt_))
    if return_state:
        return out, {"h": h_last, "conv": u[:, s - (k - 1):].to(dt_)}
    return out


def mamba_make_cache(cfg: ModelConfig, batch: int, device=None
                     ) -> Dict[str, torch.Tensor]:
    """A zero decode state: ``h`` (B, di, n) and the conv window (B,
    k - 1, di); on a model axis, this rank's ``di / m`` channels."""
    di, n, k, _ = _dims(cfg)
    di //= tp.size()
    return {"h": torch.zeros((batch, di, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, k - 1, di), dtype=cfg.compute_dtype,
                                device=device)}


def mamba_cache_specs() -> Dict[str, P]:
    return {"h": P("batch", "tp", None), "conv": P("batch", None, "tp")}


def mamba_decode(params, x: torch.Tensor, cfg: ModelConfig,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step: x (B, 1, D); O(1) state update (on a model axis,
    of this rank's channels, ``out_proj``'s parts summed)."""
    dt_ = cfg.compute_dtype
    u, z = _ssm_params(params, tp.copy_to(x), cfg)     # (B, 1, di)

    window = torch.cat([cache["conv"], u], dim=1)      # (B, k, di)
    conv = _conv(params, [window[:, i] for i in range(window.shape[1])], cfg)
    u_act, dt, b, c, a = _post_conv(params, conv[:, None], cfg)

    # one step of the scan in K8's order of operations (and of its plain
    # version), so the decode state continues the prefill's exactly
    dt0 = dt[:, 0]
    a_bar = torch.exp(dt0[..., None] * a)                            # (B, di, n)
    bx = (dt0 * u_act[:, 0].float())[..., None] * b[:, 0, None, :]
    h = a_bar * cache["h"] + bx
    y = torch.zeros_like(dt0)
    for i in range(h.shape[-1]):
        y = y + h[..., i] * c[:, 0, i, None]
    y = y + u_act[:, 0].float() * params["d_skip"].float()
    y = (y * F.silu(z[:, 0].float())).to(dt_)
    out = tp.reduce_from(y @ params["out_proj"].to(dt_))[:, None]
    return out, {"h": h, "conv": window[:, 1:]}
