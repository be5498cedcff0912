"""The port's composite algorithm (PCA) against ``repro.core.composite``,
bit for bit: the SA seeding stage, whole ``run_pca_batch`` / ``run_pca``
solves (padded, warm-started, unpadded on known-optimum instances), and
the numpy copy of ``core/exact.py`` that builds those instances."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import annealing as jann
from repro.core import composite as jcomp
from repro.core import exact as jexact
from repro.core import genetic as jgen
from repro.core import qap as jqap
from repro_torch import convert
from repro_torch.core import composite, exact, keys

from _fixtures import instance, padded_batch

PCA_TEST = jcomp.CompositeConfig(
    sa=jann.SAConfig(max_neighbors=6, iters_per_exchange=4, num_exchanges=2,
                     solvers=0),
    ga=jgen.GAConfig(generations=4, pop_size=8, p_mutation=0.2))


def _port(cfg):
    return convert.composite_config_from_reference(dataclasses.asdict(cfg))


def _same(want, got, what=""):
    assert np.asarray(want).tobytes() == got.numpy().tobytes(), what


def test_seed_population_matches_reference():
    """Stage 1 on a padded instance with a warm start: no exchanges, no
    ``seed_with``, the chains' best as the populations."""
    n, nv = 16, 11
    cfg = dataclasses.replace(PCA_TEST, sa=dataclasses.replace(
        PCA_TEST.sa, seed_with="identity", solvers=3))
    C, M = instance(nv, 5)
    Cp = np.zeros((n, n), np.float32)
    Mp = np.zeros((n, n), np.float32)
    Cp[:nv, :nv], Mp[:nv, :nv] = C, M
    warm = np.arange(n, dtype=np.int32)
    warm[:nv] = np.random.default_rng(2).permutation(nv)
    key = jax.random.PRNGKey(8)
    Cm = jqap.mask_flows(jnp.asarray(Cp), jnp.int32(nv))
    want = jcomp.seed_population(Cm, jnp.asarray(Mp), key, cfg, 2,
                                 jnp.int32(nv), jnp.asarray(warm))
    got = composite.seed_population(
        torch.as_tensor(np.array(Cm))[None], torch.as_tensor(Mp)[None],
        keys.prng_key(8)[None], _port(cfg), 2, torch.tensor([nv]),
        torch.as_tensor(warm)[None])
    _same(want.pop.reshape(-1, 3, n), got.pop, "pop")
    _same(want.fit.reshape(-1, 3), got.fit, "fit")


@pytest.mark.parametrize("loop,ev,solvers", [("event", "wide", 0),
                                             ("fused", "fused", 3)])
def test_run_pca_batch_matches_reference(loop, ev, solvers):
    """The engine's shape of call: padded instances, warm-started rows,
    and (second case) a fixed number of SA solvers, so that the GA runs on
    populations smaller than ``pop_size``."""
    sizes = [8, 12, 16, 16]
    Cs, Ms, nvs, ks = padded_batch(sizes, bucket=16, seed0=20)
    cfg = jcomp.CompositeConfig(
        sa=dataclasses.replace(PCA_TEST.sa, loop=loop, solvers=solvers),
        ga=dataclasses.replace(PCA_TEST.ga, eval=ev))
    ips = np.full((4, 16), -1, np.int32)
    for i in (0, 3):
        n = sizes[i]
        ips[i, :n] = np.random.default_rng(i).permutation(n)
        ips[i, n:] = np.arange(n, 16)
    want = jcomp.run_pca_batch(Cs, Ms, ks, cfg, num_processes=2, n_valid=nvs,
                               init_perm=jnp.asarray(ips))
    got = composite.run_pca_batch(np.asarray(Cs), np.asarray(Ms), np.asarray(ks),
                                  _port(cfg), 2, n_valid=np.asarray(nvs),
                                  init_perm=ips, device="cpu")
    for name, w, g in zip(("perm", "f", "history"), want, got):
        _same(w, g, name)


@pytest.mark.parametrize("make", [lambda: exact.make_ring(10, version=3),
                                  lambda: exact.make_torus((3, 4))],
                         ids=["ring10", "torus3x4"])
def test_run_pca_on_known_optimum_instances(make):
    inst = make()
    key = jax.random.PRNGKey(1)
    want = jcomp.run_pca(jnp.asarray(inst.C), jnp.asarray(inst.M), key,
                         PCA_TEST, num_processes=2)
    got = composite.run_pca(inst.C, inst.M, np.asarray(key), _port(PCA_TEST),
                            2, device="cpu")
    for name, w, g in zip(("perm", "f", "history"), want, got):
        _same(w, g, name)
    assert float(got[1]) >= inst.optimum


def test_exact_copy_matches_reference():
    for mine, theirs in ((exact.make_ring(9, 2), jexact.make_ring(9, 2)),
                         (exact.make_torus((2, 3, 4), 1, max_flow=5),
                          jexact.make_torus((2, 3, 4), 1, max_flow=5))):
        assert mine.name == theirs.name and mine.optimum == theirs.optimum
        for a, b in ((mine.C, theirs.C), (mine.M, theirs.M),
                     (mine.opt_perm, theirs.opt_perm)):
            np.testing.assert_array_equal(a, b)
    C, M = instance(6, 4)
    f, p = exact.brute_force(C, M)
    jf, jp = jexact.brute_force(C, M)
    assert f == jf and p.tolist() == jp.tolist()
    assert exact.branch_and_bound(C, M)[0] == f
