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

from ..topology import opcost
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


def scan_cost(bsz: int, s: int, d: int, n: int, backward: bool,
              h_grad: bool = True) -> int:
    """The bytes ``topology.opcost`` counts for :func:`selective_scan_plain`
    on contiguous f32 inputs (it does no matrix product): its forward,
    or (``backward``) :class:`SelectiveScan`'s backward -- the plain
    scan recomputed and differentiated for every input, ``h_grad``
    whether ``h_last`` has a gradient.  The op by op sum of the loops,
    as ``(calls, bytes a call)``: ``e`` a step's ``(B, D)``, ``en`` its
    ``(B, D, N)``, ``bn`` the step's ``b`` or ``c`` row."""
    f = 4
    e, en, bn, dn = bsz * d, bsz * d * n, bsz * n, d * n
    es, esn = bsz * s * d, bsz * s * n
    forward = [
        (1, f * en), (s, f * e),                           # h, each y_t
        (s, f * (e + dn + en)), (s, 2 * f * en),           # dt * a, exp
        (s, 3 * f * e), (s, f * (e + bn + en)),            # bx
        (s, 3 * f * en), (s, 3 * f * en),                  # h
        (n * s, f * (2 * e + bsz)), (n * s, 3 * f * e),    # y_t's terms
        (s, 2 * f * e),                                    # y[:, t] = y_t
    ]
    if not backward:
        return sum(k * x for k, x in forward)
    grads = [
        (s, 3 * f * e), (n * s - (not h_grad), 3 * f * en),
        (2 * (s - 1), 3 * f * es), ((n + 1) * s - 2, 3 * f * esn),
        (s - 1, 3 * f * dn),                               # sums
        (s, 2 * f * e), (s - 1, 2 * f * e), (s, 2 * f * es),   # clone, copies
        (n * s, f * (2 * e + bsz)), ((n + 2) * s, 3 * f * e),
        (s, f * (2 * en + bn)), (2 * s, f * (2 * en + e)),
        (3 * s - 1, 3 * f * en), (s, f * (2 * en + dn)),   # muls
        (n * s, f * (bsz + bn)), (n * s, f * (e + en)),
        (2 * s, f * (e + es)), ((n + 1) * s, f * (bn + esn)),  # selects
        (n * s, f * (e + bsz)), (s, f * (en + dn)), (s, f * (en + bn)),
        (2 * s, f * (en + e)),                             # sums to size
        (s - 1, f * e),                                    # zeros_like
    ]
    return sum(k * x for k, x in forward + grads)


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
    ``launch.lowering``) the outputs' shapes, with nothing computed but
    the plain version's work reported to ``topology.opcost``
    (:func:`scan_cost`, forward and backward);
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
            if opcost.active():
                opcost.add("selective_scan", 0, scan_cost(bsz, s, d, n, False),
                           shapes=str((bsz, s, d, n)))
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
            (bsz, s, d), n = saved[0].shape, saved[2].shape[1]
            if opcost.active():
                opcost.add("selective_scan_backward", 0,
                           scan_cost(bsz, s, d, n, True, gh is not None),
                           shapes=str((bsz, s, d, n)))
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
