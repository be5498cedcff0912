"""The GA's draws and operators against the JAX package, bit for bit: the
counter stream's ``ga_draws``, both forms of the mutation gate over every
order the fused kernels take, order crossover (one-hot and scatter forms),
mutation, tournaments and the worst-member replacement under ties."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import ga_ops as jga
from repro.core import genetic as jgen
from repro.kernels import prng as jprng
from repro_torch import convert
from repro_torch.core import ga_ops, genetic
from repro_torch.kernels import prng


def _same(want, got, what=""):
    assert np.asarray(want).tobytes() == got.numpy().tobytes(), what


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _key_words(seed, count):
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed), count))


def _parents(rng, count, n, nvs):
    """``count`` pairs of permutations, random on the first ``nvs[i]``
    slots and identity on the tail."""
    p1 = np.tile(np.arange(n, dtype=np.int32), (count, 1))
    p2 = p1.copy()
    for i, nv in enumerate(nvs):
        p1[i, :nv], p2[i, :nv] = rng.permutation(nv), rng.permutation(nv)
    return p1, p2


@pytest.mark.parametrize("n_off,tournament,pop", [(16, 2, 32), (4, 3, 8),
                                                  (5, 1, 7)])
def test_ga_draws_match_reference(n_off, tournament, pop):
    kd = _key_words(n_off * tournament, 64)
    nvs = np.random.default_rng(pop).integers(0, 769, 64).astype(np.int32)
    want = jax.vmap(lambda k, v: jprng.ga_draws(
        k[0], k[1], n_off, tournament, jga.MAX_MUT, pop, v))(kd, nvs)
    tk = convert.keys_from_reference(kd)
    got = prng.ga_draws(tk[:, 0], tk[:, 1], n_off, tournament, ga_ops.MAX_MUT,
                        pop, _t(nvs))
    for name, w, g in zip(prng.GADraws._fields, want, got):
        _same(w, g, name)
    step = prng.ga_step_draws(tk, n_off, tournament, ga_ops.MAX_MUT, pop,
                              _t(nvs))
    assert all(torch.equal(a, b) for a, b in zip(step, got))


@pytest.mark.parametrize("p_mutation", [0.001, 0.0137, 0.3, 1 / 3, 0.9])
def test_mutation_gate_matches_xla(p_mutation):
    """Both forms the reference computes -- ``ga_ops.mutation_gate``
    (counter regime) and ``swap_mutation``'s masked host form -- jitted,
    over every valid order 1..768; and the unpadded host form, a Python
    float rounded to f32."""
    nv = np.arange(1, 769, dtype=np.int32)
    counter = jax.jit(jax.vmap(lambda v: jga.mutation_gate(p_mutation, v)))(nv)
    host = jax.jit(jax.vmap(
        lambda v: jnp.minimum(p_mutation * v / jga.MAX_MUT, 1.0)))(nv)
    got = ga_ops.mutation_gate(p_mutation, _t(nv))
    _same(counter, got, "counter form")
    _same(host, got, "masked host form")
    for n in (1, 27, 125, 768):
        want = jnp.minimum(p_mutation * n / jga.MAX_MUT, 1.0)
        assert np.float32(want) == np.float32(
            ga_ops.f32(min(p_mutation * n / ga_ops.MAX_MUT, 1.0)))


@pytest.mark.parametrize("n", [16, 40])
def test_ox_apply_matches_reference(n):
    rng = np.random.default_rng(n)
    count = 300
    nvs = rng.integers(1, n + 1, count).astype(np.int32)
    nvs[:20] = n
    nvs[20:25] = 1
    p1, p2 = _parents(rng, count, n, nvs)
    cuts = np.sort(np.stack([rng.integers(0, nvs), rng.integers(0, nvs)], 1),
                   axis=1).astype(np.int32)
    cuts[25:35, 1] = cuts[25:35, 0]                      # empty segments
    want = jax.vmap(jga.ox_apply)(cuts[:, 0], cuts[:, 1], p1, p2, nvs)
    got = ga_ops.ox_apply(_t(cuts[:, 0]), _t(cuts[:, 1]), _t(p1), _t(p2),
                          _t(nvs))
    _same(want, got)


@pytest.mark.parametrize("masked", [True, False])
def test_order_crossovers_match_reference(masked):
    """Both host-regime crossovers with the reference's key tree (cuts by
    ``randint`` over a traced bound), one-hot and scatter forms."""
    n, count = 16, 200
    rng = np.random.default_rng(int(masked))
    nvs = (rng.integers(1, n + 1, count) if masked
           else np.full(count, n)).astype(np.int32)
    p1, p2 = _parents(rng, count, n, nvs)
    kd = _key_words(7, count)
    tk = convert.keys_from_reference(kd)
    for jfn, pfn in ((jgen.order_crossover, genetic.order_crossover),
                     (jgen._order_crossover_scatter,
                      genetic._order_crossover_scatter)):
        if masked:
            want = jax.vmap(jfn)(kd, p1, p2, nvs)
            got = pfn(tk, _t(p1), _t(p2), _t(nvs))
        else:
            want = jax.vmap(jfn)(kd, p1, p2)
            got = pfn(tk, _t(p1), _t(p2))
        _same(want, got, jfn.__name__)


@pytest.mark.parametrize("masked", [True, False])
def test_mutations_match_reference(masked):
    n, count = 16, 200
    rng = np.random.default_rng(3)
    nvs = (rng.integers(1, n + 1, count) if masked
           else np.full(count, n)).astype(np.int32)
    p, _ = _parents(rng, count, n, nvs)
    ii = rng.integers(0, nvs[:, None], (count, 4)).astype(np.int32)
    jj = rng.integers(0, nvs[:, None], (count, 4)).astype(np.int32)
    jj[:10] = ii[:10]                                    # i == j: no-op
    us = rng.random((count, 4)).astype(np.float32)
    gate = jga.mutation_gate(0.2, nvs)
    want = jax.vmap(jga.mutation_apply)(p, ii, jj, us, gate)
    got = ga_ops.mutation_apply(_t(p), _t(ii), _t(jj), _t(us),
                                ga_ops.mutation_gate(0.2, _t(nvs)))
    _same(want, got, "mutation_apply")
    kd = _key_words(11, count)
    tk = convert.keys_from_reference(kd)
    for pm in (0.05, 0.2):
        if masked:
            want = jax.jit(jax.vmap(lambda k, q, v: jgen.swap_mutation(
                k, q, pm, v)))(kd, p, nvs)
            got = genetic.swap_mutation(tk, _t(p), pm, _t(nvs))
        else:
            want = jax.jit(jax.vmap(lambda k, q: jgen.swap_mutation(
                k, q, pm)))(kd, p)
            got = genetic.swap_mutation(tk, _t(p), pm)
        _same(want, got, f"swap_mutation p={pm}")


def test_tournaments_under_ties():
    """Fitness with many equal values: the first minimum among the
    candidates wins, for given candidates and for drawn ones."""
    rng = np.random.default_rng(5)
    B, P, K, t = 6, 8, 10, 3
    fit = rng.integers(0, 3, (B, P)).astype(np.float32)
    idx = rng.integers(0, P, (B, K, t)).astype(np.int32)
    want = jax.vmap(lambda f, ix: jax.vmap(
        lambda i: jga.tournament_pick(f, i))(ix))(fit, idx)
    _same(want, ga_ops.tournament_pick(_t(fit), _t(idx)), "pick")
    kd = _key_words(13, B * K).reshape(B, K, 2)
    want = jax.vmap(lambda f, ks: jax.vmap(
        lambda k: jgen.tournament_select(k, f, t))(ks))(fit, kd)
    got = genetic.tournament_select(convert.keys_from_reference(kd), _t(fit), t)
    _same(want, got, "select")


@pytest.mark.parametrize("n_off", [1, 3, 8])
def test_worst_replacement_under_ties(n_off):
    """``worst_slots`` (ties at the cut to the higher index) and the
    replacement with its elitism guard; ``n_off == pop`` replaces every
    member, so the guard fires where the children are all worse."""
    rng = np.random.default_rng(n_off)
    B, P, n = 12, 8, 6
    fit = rng.integers(0, 4, (B, P)).astype(np.float32)
    fit[0] = 2.0                                         # one big tie
    pop = np.stack([np.stack([rng.permutation(n) for _ in range(P)])
                    for _ in range(B)]).astype(np.int32)
    children = np.stack([np.stack([rng.permutation(n) for _ in range(n_off)])
                         for _ in range(B)]).astype(np.int32)
    child_fit = rng.integers(0, 6, (B, n_off)).astype(np.float32)
    child_fit[1::2] += 10.0                              # all worse: guard
    want = jax.vmap(lambda f: jgen.worst_slots(f, n_off))(fit)
    _same(want, genetic.worst_slots(_t(fit), n_off).int(), "worst_slots")
    want = jax.vmap(jgen._replace_worst)(
        jgen.GAState(pop=jnp.asarray(pop), fit=jnp.asarray(fit)),
        jnp.asarray(children), jnp.asarray(child_fit))
    got = genetic._replace_worst(genetic.GAState(_t(pop), _t(fit)),
                                 _t(children), _t(child_fit))
    _same(want.pop, got.pop, "pop")
    _same(want.fit, got.fit, "fit")
