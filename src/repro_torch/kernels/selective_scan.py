"""The Mamba selective scan: the CUDA kernel K8 and its plain version.

Replaces the TPU kernel ``repro/kernels/selective_scan.py``
(``selective_scan_pallas``).  ``u``, ``dt`` ``(B, S, D)``, ``a``
``(D, N)``, ``b``, ``c`` ``(B, S, N)``, all read as f32:

    h_t = exp(dt_t * a) * h_{t-1} + (dt_t * u_t) * b_t,    h_0 = 0
    y_t = sum_n h_t[n] * c_t[n]

returns ``y (B, S, D)`` f32 and, unlike the TPU kernel, the final state
``h_last (B, D, N)`` f32 that a prefill hands to decode.  The
``(B, S, D, N)`` state tensor is never built.  The kernel
(``csrc/selective_scan.cu``) takes any ``S`` and ``D`` and ``N`` of 4 or
16 (the smoke configurations' and Jamba's ``d_state``).

Under autograd the scan is :class:`SelectiveScan`: its forward is K8 on
the card (the plain version on the CPU), and its backward recomputes
the plain version under ``torch.enable_grad()`` and differentiates that,
which is what the reference trains through (its Pallas scan has no
backward; its models differentiate the plain chunked scan).  A backward
kernel is later work and has no TPU counterpart.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build

# d_state values the kernel is instantiated for.
SUPPORTED_N = (4, 16)


def selective_scan_plain(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K8 (the sequential loop of
    ``repro.kernels.ref.selective_scan_ref``, plus ``h_last``), in the
    kernel's order of operations: ``dA = dt * a``, ``exp``;
    ``bx = (dt * u) * b``; ``h = a_bar * h + bx``; ``y`` summed over ``n``
    in order."""
    uf, dtf, af, bf, cf = (x.float() for x in (u, dt, a, b, c))
    bsz, s, d = u.shape
    n = a.shape[1]
    h = torch.zeros((bsz, d, n), dtype=torch.float32, device=u.device)
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=u.device)
    for t in range(s):
        dtt = dtf[:, t]                                        # (B, D)
        a_bar = torch.exp(dtt[..., None] * af)                 # (B, D, N)
        bx = (dtt * uf[:, t])[..., None] * bf[:, t, None, :]
        h = a_bar * h + bx
        yt = torch.zeros((bsz, d), dtype=torch.float32, device=u.device)
        for k in range(n):
            yt = yt + h[..., k] * cf[:, t, k, None]
        y[:, t] = yt
    return y, h


def selective_scan_cuda(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K8 on the card: same contract as
    :func:`selective_scan_plain`, every input a contiguous f32 CUDA
    tensor."""
    if u.dim() != 3 or a.dim() != 2:
        raise ValueError(f"u must be (B, S, D) and a (D, N), got "
                         f"{tuple(u.shape)} and {tuple(a.shape)}")
    B, S, D = u.shape
    N = a.shape[1]
    if N not in SUPPORTED_N:
        raise ValueError(f"the selective_scan kernel takes d_state in "
                         f"{SUPPORTED_N}, got {N}")
    f32 = torch.float32
    build.check_args(u.device, ("u", u, f32, (B, S, D)),
                     ("dt", dt, f32, (B, S, D)), ("a", a, f32, (D, N)),
                     ("b", b, f32, (B, S, N)), ("c", c, f32, (B, S, N)))
    y = torch.empty((B, S, D), dtype=f32, device=u.device)
    h_last = torch.empty((B, D, N), dtype=f32, device=u.device)
    if B * D == 0:
        return y, h_last
    err = build.library("selective_scan").selective_scan_launch(
        u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), B, S, D, N, u.device.index,
        torch.cuda.current_stream(u.device).cuda_stream)
    build.check(err, "selective_scan")
    build.count_launch("selective_scan")
    return y, h_last


class SelectiveScan(torch.autograd.Function):
    """The scan with a gradient: ``SelectiveScan.apply(u, dt, a, b, c)
    -> (y, h_last)``.  Forward: K8 for CUDA tensors, the plain version
    for CPU ones, and for ``meta`` ones (a step lowered without devices,
    ``launch.lowering``) the outputs' shapes, with nothing computed;
    any other device raises.  Backward: the plain version recomputed
    from the saved inputs and differentiated, so every input gets its
    gradient through both outputs (on ``meta``, the gradients'
    shapes)."""

    @staticmethod
    def forward(ctx, u, dt, a, b, c):
        ctx.save_for_backward(u, dt, a, b, c)
        ctx.set_materialize_grads(False)
        if u.is_cuda:
            return selective_scan_cuda(u, dt, a, b, c)
        if u.device.type == "meta":
            (bsz, s, d), n = u.shape, a.shape[1]
            return (u.new_empty((bsz, s, d), dtype=torch.float32),
                    u.new_empty((bsz, d, n), dtype=torch.float32))
        if u.device.type != "cpu":
            raise ValueError(f"selective_scan: unsupported device {u.device}")
        return selective_scan_plain(u, dt, a, b, c)

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        want = ctx.needs_input_grad
        if saved[0].device.type == "meta":
            return tuple(torch.empty_like(x) if w else None
                         for x, w in zip(saved, want))
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_(w)
                      for x, w in zip(saved, want)]
            outs = selective_scan_plain(*inputs)
            pairs = [(o, g) for o, g in zip(outs, (gy, gh)) if g is not None]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], [x for x, w in zip(inputs, want) if w],
                [g for _, g in pairs], allow_unused=True))
        return tuple(next(grads) if w else None for w in want)
