"""The selective scan K8's plain version against the reference: its
oracle ``ref.selective_scan_ref``, its Pallas kernel in interpret mode,
and the Mamba layer's chunked scans (``ssm._fused_scan``,
``ssm._scan_chunked``), which also return the final state.

Inputs come from ``numpy.random.default_rng`` in the ranges of the JAX
package's own kernel test (``tests/test_kernels.py``).  Tolerance:
``1e-5 * max|y|`` (and ``1e-5 * max|h|`` for the final state), twenty
times tighter than that test's ``2e-4``.  Both sides run the same f32
recurrence; they differ only in the order of the sum over ``n`` (an
einsum or an associative scan on the reference's side) and in ``exp`` of
XLA against PyTorch's, a few ulps per step: at these shapes the
differences stay under ``6e-7 * max|y|``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref
from repro.kernels.selective_scan import selective_scan_pallas
from repro.models import ssm as jssm

from repro_torch.kernels import build, ops
from repro_torch.kernels.selective_scan import (SUPPORTED_N,
                                                selective_scan_cuda,
                                                selective_scan_plain)

BAR = 1e-5


def _inputs(shape, seed):
    bsz, s, d, n = shape
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((bsz, s, d)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (bsz, s, d)).astype(np.float32)
    a = (-rng.uniform(0.1, 1.0, (d, n))).astype(np.float32)
    b = rng.standard_normal((bsz, s, n)).astype(np.float32)
    c = rng.standard_normal((bsz, s, n)).astype(np.float32)
    return u, dt, a, b, c


def _plain(arrays):
    y, h = selective_scan_plain(*(torch.as_tensor(x) for x in arrays))
    return y.numpy(), h.numpy()


def _close(got, want, what):
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= BAR * scale, f"{what}: max err {err} > {BAR} * {scale}"


@pytest.mark.parametrize("shape", [(1, 1, 3, 4), (2, 17, 33, 4),
                                   (1, 40, 130, 16), (3, 64, 8, 16)])
def test_plain_matches_reference_oracle(shape):
    arrays = _inputs(shape, sum(shape))
    y, h = _plain(arrays)
    want = np.asarray(ref.selective_scan_ref(*map(jnp.asarray, arrays)))
    assert y.shape == shape[:3] and h.shape == (shape[0], shape[2], shape[3])
    _close(y, want, "y")


# The JAX kernel test's shapes (tests/test_kernels.py) and a ragged one:
# S = 49 and D = 200 are whole single blocks of the Pallas grid, which
# otherwise asserts S % 128 and D % 512.
@pytest.mark.parametrize("shape", [(1, 128, 512, 4), (2, 256, 512, 16),
                                   (2, 128, 1024, 16), (2, 49, 200, 4)])
def test_plain_matches_pallas_interpret(shape):
    arrays = _inputs(shape, sum(shape))
    y, _ = _plain(arrays)
    want = np.asarray(selective_scan_pallas(*map(jnp.asarray, arrays),
                                            interpret=True))
    _close(y, want, "y")


@pytest.mark.parametrize("shape,chunk", [((2, 48, 64, 4), 16),
                                         ((1, 96, 40, 16), 32)])
def test_final_state_matches_fused_scan(shape, chunk):
    u, dt, a, b, c = _inputs(shape, 7 + sum(shape))
    y, h = _plain((u, dt, a, b, c))
    h0 = jnp.zeros((shape[0], shape[2], shape[3]), jnp.float32)
    want_y, want_h = jssm._fused_scan(*map(jnp.asarray, (u, dt, b, c, a)), h0,
                                      chunk)
    _close(y, np.asarray(want_y), "y")
    _close(h, np.asarray(want_h), "h_last")


def test_final_state_matches_scan_chunked():
    u, dt, a, b, c = _inputs((2, 128, 48, 16), 11)
    y, h = _plain((u, dt, a, b, c))
    dtj, uj, aj, bj = map(jnp.asarray, (dt, u, a, b))
    a_bar = jnp.exp(dtj[..., None] * aj[None, None])
    bx = (dtj * uj)[..., None] * bj[:, :, None, :]
    want_y, want_h = jssm._scan_chunked(
        a_bar, bx, jnp.zeros((2, 48, 16), jnp.float32), jnp.asarray(c))
    _close(y, np.asarray(want_y), "y")
    _close(h, np.asarray(want_h), "h_last")


def test_ops_routes_cpu_tensors_to_plain():
    arrays = [torch.as_tensor(x) for x in _inputs((2, 9, 12, 4), 3)]
    before = build.LAUNCHES["selective_scan"]
    y, h = ops.selective_scan(*arrays)
    want_y, want_h = selective_scan_plain(*arrays)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert build.LAUNCHES["selective_scan"] == before


@pytest.mark.parametrize("n", [2, 8])
def test_kernel_wrapper_rejects_other_state_sizes(n):
    assert n not in SUPPORTED_N
    arrays = [torch.as_tensor(x) for x in _inputs((1, 4, 8, n), n)]
    with pytest.raises(ValueError, match="d_state"):
        selective_scan_cuda(*arrays)
