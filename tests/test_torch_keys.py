"""The port's jax.random replica and Threefry counter stream against the
reference draws, bit for bit."""
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.kernels import prng as jprng
from repro_torch.core import keys
from repro_torch.kernels import prng

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1, -5]


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_fold_in(seed):
    k, tk = jax.random.PRNGKey(seed), keys.prng_key(seed)
    np.testing.assert_array_equal(_np(k), tk.numpy())
    for num in (1, 2, 3, 17):
        np.testing.assert_array_equal(_np(jax.random.split(k, num)),
                                      keys.split(tk, num).numpy())
    for d in (0, 7, 2 ** 31 + 5):
        np.testing.assert_array_equal(_np(jax.random.fold_in(k, d)),
                                      keys.fold_in(tk, d).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (50,), (3, 4), (2, 3, 5)])
def test_bits_and_uniform(seed, shape):
    k, tk = jax.random.PRNGKey(seed), keys.prng_key(seed)
    np.testing.assert_array_equal(_np(jax.random.bits(k, shape)),
                                  keys.bits(tk, shape).numpy())
    ju = np.asarray(jax.random.uniform(k, shape))
    tu = keys.uniform(tk, shape).numpy()
    assert tu.dtype == np.float32
    assert ju.tobytes() == tu.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("span", [1, 2, 128 * 127 // 2, 2 ** 16 + 3,
                                  70000, 2 ** 20 + 7])
def test_randint(seed, span):
    k, tk = jax.random.PRNGKey(seed), keys.prng_key(seed)
    want = np.asarray(jax.random.randint(k, (64,), 0, span))
    got = keys.randint(tk, (64,), 0, span)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("n", [1, 2, 37, 128])
def test_permutation(n):
    for seed in SEEDS:
        np.testing.assert_array_equal(
            np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)),
            keys.permutation(keys.prng_key(seed), n).numpy())


@pytest.mark.parametrize("n", [1625, 1626, 2048, 4096])
def test_permutation_two_rounds(n):
    """Above n = 1625 the sort-based shuffle runs two rounds: the orders
    of the multilevel route's finest levels (batched keys included)."""
    assert math.ceil(3 * math.log(n) / math.log(2 ** 32 - 1)) == \
        (1 if n <= 1625 else 2)
    jk = jax.random.split(jax.random.PRNGKey(n), 3)
    want = np.stack([np.asarray(jax.random.permutation(k, n)) for k in jk])
    got = keys.permutation(torch.as_tensor(np.asarray(jk).astype(np.int64)), n)
    np.testing.assert_array_equal(want, got.numpy())


def test_draws_vectorise_over_leading_key_dims():
    """A (3, 4, 2) key batch draws what 12 separate jax calls draw."""
    base = jax.random.PRNGKey(3)
    jk = jax.random.split(base, 12).reshape(3, 4, 2)
    tk = keys.split(keys.prng_key(3), 12).reshape(3, 4, 2)
    spans = np.arange(1, 13).reshape(3, 4) * 1000
    got_r = keys.randint(tk, (9,), 0, torch.as_tensor(spans)[..., None])
    got_u = keys.uniform(tk, (9,))
    got_s = keys.split(tk, 5)
    got_p = keys.permutation(tk, 20)
    for i in range(3):
        for j in range(4):
            k = jk[i, j]
            np.testing.assert_array_equal(
                np.asarray(jax.random.randint(k, (9,), 0, int(spans[i, j]))),
                got_r[i, j].numpy())
            np.testing.assert_array_equal(np.asarray(jax.random.uniform(k, (9,))),
                                          got_u[i, j].numpy())
            np.testing.assert_array_equal(_np(jax.random.split(k, 5)),
                                          got_s[i, j].numpy())
            np.testing.assert_array_equal(
                np.asarray(jax.random.permutation(k, 20)), got_p[i, j].numpy())


def test_threefry_and_uniform32_match_reference():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2 ** 32, (4, 257), dtype=np.uint64).astype(np.uint32)
    j0, j1 = jprng.threefry2x32(*(jnp.asarray(x) for x in w))
    t0, t1 = prng.threefry2x32(*(torch.as_tensor(x.astype(np.int64)) for x in w))
    np.testing.assert_array_equal(_np(j0), t0.numpy())
    np.testing.assert_array_equal(_np(j1), t1.numpy())
    ju = np.asarray(jprng.uniform32(j0))
    assert ju.tobytes() == prng.uniform32(t0).numpy().tobytes()


@pytest.mark.parametrize("n_valid", [0, 1, 2, 3, 16, 40, 128])
def test_sa_draws_match_reference(n_valid):
    for seed in (0, 9, 77):
        kd = _np(jax.random.PRNGKey(seed))
        ja, jb, ju = jprng.sa_draws(jnp.uint32(kd[0]), jnp.uint32(kd[1]), 25,
                                    n_valid)
        ta, tb, tu = prng.sa_draws(int(kd[0]), int(kd[1]), 25, n_valid)
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
        assert np.asarray(ju).tobytes() == tu.numpy().tobytes()


def test_sa_step_draws_batched_keys():
    jk = jax.random.split(jax.random.PRNGKey(5), 6)
    nv = np.array([2, 5, 16, 16, 9, 1])
    pairs, us = prng.sa_step_draws(torch.as_tensor(_np(jk)), 11,
                                   torch.as_tensor(nv))
    for i in range(6):
        jp, ju = jprng.sa_step_draws(jk[i], 11, jnp.int32(nv[i]))
        np.testing.assert_array_equal(np.asarray(jp), pairs[i].numpy())
        assert np.asarray(ju).tobytes() == us[i].numpy().tobytes()
