"""The port's dense QAP primitives against ``repro.core.qap``, bit for bit
on integer-valued instances."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import qap as jqap
from repro_torch.core import keys, qap

from _fixtures import instance


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _key(seed):
    return jax.random.PRNGKey(seed), keys.prng_key(seed)


@pytest.mark.parametrize("n", [6, 16, 40])
def test_objective_shared_and_batched(n):
    C, M = instance(n, n)
    rng = np.random.default_rng(n)
    ps = np.stack([rng.permutation(n) for _ in range(6)]).astype(np.int32)
    want = np.asarray(jqap.objective(jnp.asarray(C), jnp.asarray(M),
                                     jnp.asarray(ps)))
    got = qap.objective(_t(C), _t(M), _t(ps))
    assert want.tobytes() == got.numpy().tobytes()
    # instance-batched: (B0, N, N) matrices, (B0, R, N) permutations
    Cs = np.stack([instance(n, 100 + i)[0] for i in range(3)])
    Ms = np.stack([instance(n, 200 + i)[1] for i in range(3)])
    pr = ps[:6].reshape(3, 2, n)
    got = qap.objective(_t(Cs), _t(Ms), _t(pr))
    for b in range(3):
        w = np.asarray(jqap.objective(jnp.asarray(Cs[b]), jnp.asarray(Ms[b]),
                                      jnp.asarray(pr[b])))
        assert w.tobytes() == got[b].numpy().tobytes()


@pytest.mark.parametrize("n", [6, 16, 40])
def test_swap_delta_and_swap_positions(n):
    C, M = instance(n, 3 * n)
    rng = np.random.default_rng(n)
    p = rng.permutation(n).astype(np.int32)
    for a, b in [(0, 1), (n - 1, 0), (2, 2), (n // 2, n - 1)]:
        want = jqap.swap_delta(jnp.asarray(C), jnp.asarray(M), jnp.asarray(p),
                               a, b)
        got = qap.swap_delta(_t(C), _t(M), _t(p), a, b)
        assert np.asarray(want).tobytes() == got.numpy().tobytes()
        np.testing.assert_array_equal(
            np.asarray(jqap.swap_positions(jnp.asarray(p), a, b)),
            qap.swap_positions(_t(p), a, b).numpy())
    # batched rows, one pair each
    ps = np.stack([rng.permutation(n) for _ in range(5)]).astype(np.int32)
    a = rng.integers(0, n, 5)
    b = rng.integers(0, n, 5)
    got = qap.swap_delta(_t(C), _t(M), _t(ps), _t(a), _t(b))
    for i in range(5):
        want = jqap.swap_delta(jnp.asarray(C), jnp.asarray(M),
                               jnp.asarray(ps[i]), int(a[i]), int(b[i]))
        assert np.asarray(want).tobytes() == got[i].numpy().tobytes()


def test_masks():
    n = 10
    for nv in (0, 1, 4, 10):
        np.testing.assert_array_equal(np.asarray(jqap.valid_mask(n, nv)),
                                      qap.valid_mask(n, nv).numpy())
        valid = np.arange(n) < nv
        np.testing.assert_array_equal(
            np.asarray(jqap.masked_weights(jnp.asarray(valid))),
            qap.masked_weights(_t(valid)).numpy())
        C, _ = instance(n, nv)
        np.testing.assert_array_equal(
            np.asarray(jqap.mask_flows(jnp.asarray(C), nv)),
            qap.mask_flows(_t(C), nv).numpy())
    Cs = np.stack([instance(n, i)[0] for i in range(3)])
    nvs = np.array([2, 7, 10])
    got = qap.mask_flows(_t(Cs), _t(nvs))
    for i in range(3):
        np.testing.assert_array_equal(
            np.asarray(jqap.mask_flows(jnp.asarray(Cs[i]), int(nvs[i]))),
            got[i].numpy())


@pytest.mark.parametrize("n_valid", [0, 1, 2, 9, 16])
def test_masked_random_permutation(n_valid):
    for seed in range(8):
        jk, tk = _key(seed)
        np.testing.assert_array_equal(
            np.asarray(jqap.masked_random_permutation(jk, 16, n_valid)),
            qap.masked_random_permutation(tk, 16, n_valid).numpy())


@pytest.mark.parametrize("n_valid", [None, 0, 1, 2, 3, 16, 40])
def test_random_swap_pairs(n_valid):
    n = 40
    for seed in range(6):
        jk, tk = _key(seed)
        want = jqap.random_swap_pairs(jk, 33, n, n_valid)
        got = qap.random_swap_pairs(tk, 33, n, n_valid)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_random_permutation():
    for seed in range(5):
        jk, tk = _key(seed)
        np.testing.assert_array_equal(
            np.asarray(jqap.random_permutation(jk, 23)),
            qap.random_permutation(tk, 23).numpy())


@pytest.mark.parametrize("n", [2, 5, 64, 300])
def test_num_pairs_and_pair_from_index_exhaustive(n):
    num = n * (n - 1) // 2
    assert int(qap.num_pairs(n)) == int(jqap.num_pairs(n)) == num
    idx = np.arange(num, dtype=np.int32)
    ja, jb = jqap.pair_from_index(jnp.asarray(idx), n)
    ta, tb = qap.pair_from_index(_t(idx), n)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


def test_is_permutation_and_invert():
    ps = np.array([[2, 0, 1, 3], [0, 0, 1, 2], [3, 2, 1, 0], [0, 1, 2, 4]],
                  np.int32)
    np.testing.assert_array_equal(np.asarray(jqap.is_permutation(jnp.asarray(ps))),
                                  qap.is_permutation(_t(ps)).numpy())
    for p in ps[[0, 2]]:
        np.testing.assert_array_equal(np.asarray(jqap.invert(jnp.asarray(p))),
                                      qap.invert(_t(p)).numpy())


@pytest.mark.parametrize("n_valid", [None, 1, 7, 12])
def test_batched_random_permutations(n_valid):
    """The GA's initial populations: one key split ``batch`` ways."""
    for seed in range(3):
        jk, tk = _key(seed)
        if n_valid is None:
            want = jqap.random_permutations(jk, 5, 12)
            got = qap.random_permutations(tk, 5, 12)
        else:
            want = jqap.masked_random_permutations(jk, 5, 12, n_valid)
            got = qap.masked_random_permutations(tk, 5, 12, n_valid)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_compose_and_first_argmax():
    rng = np.random.default_rng(0)
    p, q = rng.permutation(9).astype(np.int32), rng.permutation(9).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jqap.compose(jnp.asarray(p), jnp.asarray(q))),
        qap.compose(_t(p), _t(q)).numpy())
    np.testing.assert_array_equal(qap.compose(_t(p), qap.invert(_t(p))).numpy(),
                                  np.arange(9))
    x = np.array([[1, 5, 5, 2], [3, 3, 3, 3], [0, 1, 2, 9]], np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.argmax(jnp.asarray(x), -1)),
                                  qap.first_argmax(_t(x)).numpy())
