"""Kernels K1 (qap_delta) and K4 (qap_sa_step): the plain PyTorch versions
against the reference's oracles and its Pallas kernels in interpret mode,
bit for bit on integer-valued instances.  The CUDA kernels against the
plain versions on the card: ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref
from repro.kernels.qap_delta import qap_delta_pallas_batch
from repro.kernels.qap_sa_step import qap_sa_step_pallas_batch
from repro_torch.kernels import ops
from repro_torch.kernels.qap_delta import qap_delta_plain
from repro_torch.kernels.qap_sa_step import qap_sa_step_plain

from _fixtures import instance

B0, RPT, K = 3, 2, 9


def _wave(n, nv, shared, seed):
    """Integer instances zero-padded past ``nv``, and B0 * RPT chains whose
    permutations keep the padded tail on itself."""
    rng = np.random.default_rng(seed)
    mats = [instance(nv, seed + i) for i in range(1 if shared else B0)]
    Cs = np.zeros((len(mats), n, n), np.float32)
    Ms = np.zeros((len(mats), n, n), np.float32)
    for i, (C, M) in enumerate(mats):
        Cs[i, :nv, :nv], Ms[i, :nv, :nv] = C, M
    B = B0 * RPT
    ps = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    for r in range(B):
        ps[r, :nv] = rng.permutation(nv)
    pairs = np.zeros((B, K, 2), np.int32)
    for r in range(B):
        for k in range(K):
            pairs[r, k] = np.sort(rng.choice(nv, 2, replace=False))
    if shared:
        Cs, Ms = Cs[0], Ms[0]
    return Cs, Ms, ps, pairs


def _sa_inputs(n, nv, shared, seed):
    Cs, Ms, ps, _ = _wave(n, nv, shared, seed)
    rng = np.random.default_rng(seed + 1)
    Cb = Cs if not shared else np.broadcast_to(Cs, (B0, n, n))
    Mb = Ms if not shared else np.broadcast_to(Ms, (B0, n, n))
    inst = np.arange(B0 * RPT) // RPT
    fs = np.array([(Cb[i] * Mb[i][np.ix_(p, p)]).sum()
                   for i, p in zip(inst, ps)], np.float32)
    temps = np.linspace(5.0, 60.0, B0 * RPT).astype(np.float32)
    keys = rng.integers(0, 2 ** 32, (B0 * RPT, 2), dtype=np.uint64).astype(np.uint32)
    nvs = np.full(B0 * RPT, nv, np.int32)
    return Cs, Ms, ps, fs, temps, keys, nvs


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


CASES = [(16, 16, True), (16, 11, False), (40, 40, False), (40, 29, True)]


@pytest.mark.parametrize("n,nv,shared", CASES)
def test_qap_delta_plain_matches_ref_and_pallas(n, nv, shared):
    Cs, Ms, ps, pairs = _wave(n, nv, shared, seed=n + nv)
    got = qap_delta_plain(_t(Cs), _t(Ms), _t(ps), _t(pairs)).numpy()
    pallas = np.asarray(qap_delta_pallas_batch(
        jnp.asarray(Cs), jnp.asarray(Ms), jnp.asarray(ps), jnp.asarray(pairs),
        interpret=True))
    assert got.tobytes() == pallas.tobytes()
    for r in range(B0 * RPT):
        i = 0 if shared else r // RPT
        C, M = (Cs, Ms) if shared else (Cs[i], Ms[i])
        want = np.asarray(ref.qap_delta_ref(jnp.asarray(C), jnp.asarray(M),
                                            jnp.asarray(ps[r]),
                                            jnp.asarray(pairs[r])))
        assert got[r].tobytes() == want.tobytes()


@pytest.mark.parametrize("n,nv,shared", CASES)
def test_qap_sa_step_plain_matches_ref_and_pallas(n, nv, shared):
    Cs, Ms, ps, fs, temps, keys, nvs = _sa_inputs(n, nv, shared, seed=2 * n + nv)
    kw = dict(max_neighbors=K, max_success=3)
    got = qap_sa_step_plain(_t(Cs), _t(Ms), _t(ps), _t(fs), _t(ps), _t(fs),
                            _t(temps), _t(keys.astype(np.int64)), _t(nvs), **kw)
    pallas = qap_sa_step_pallas_batch(
        jnp.asarray(Cs), jnp.asarray(Ms), jnp.asarray(ps), jnp.asarray(fs),
        jnp.asarray(ps), jnp.asarray(fs), jnp.asarray(temps), jnp.asarray(keys),
        jnp.asarray(nvs), interpret=True, **kw)
    for g, w in zip(got, pallas):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    for r in range(B0 * RPT):
        i = 0 if shared else r // RPT
        C, M = (Cs, Ms) if shared else (Cs[i], Ms[i])
        want = ref.qap_sa_step_ref(
            jnp.asarray(C), jnp.asarray(M), jnp.asarray(ps[r]),
            jnp.asarray(fs[r]), jnp.asarray(ps[r]), jnp.asarray(fs[r]),
            jnp.asarray(temps[r]), jnp.asarray(keys[r]), jnp.int32(nv), **kw)
        for g, w in zip(got, want):
            assert g[r].numpy().tobytes() == np.asarray(w).tobytes()
    # the padded tail never moves
    np.testing.assert_array_equal(got[0][:, nv:].numpy(), ps[:, nv:])


def test_ops_take_the_plain_path_on_cpu_tensors():
    ops.reset_launch_counts()
    Cs, Ms, ps, pairs = _wave(16, 12, False, seed=5)
    got = ops.qap_delta(_t(Cs), _t(Ms), _t(ps), _t(pairs))
    want = qap_delta_plain(_t(Cs), _t(Ms), _t(ps), _t(pairs))
    assert torch.equal(got, want)
    Cs, Ms, ps, fs, temps, keys, nvs = _sa_inputs(16, 12, False, seed=6)
    args = (_t(Cs), _t(Ms), _t(ps), _t(fs), _t(ps), _t(fs), _t(temps),
            _t(keys.astype(np.int64)), _t(nvs))
    got = ops.qap_sa_step(*args, max_neighbors=K, max_success=4)
    want = qap_sa_step_plain(*args, max_neighbors=K, max_success=4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launch_counts() == {"qap_delta": 0, "qap_sa_step": 0}


def test_fused_step_fits_keeps_the_reference_cap():
    from repro.kernels import ops as jops
    for n in (8, 127, 128, 129, 640, 768, 769, 1024, 4096):
        assert ops.fused_step_fits(n) == jops.fused_step_fits(n)
