"""The port's PGA against ``repro.core.genetic``, bit for bit: one
generation from a reference state in the middle of a run, for every
generation realisation and draw regime the reference allows, and whole
``run_pga_batch`` / ``run_pga`` solves (padded, warm-started, unpadded)."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import genetic as jgen
from repro_torch import convert
from repro_torch.core import exact, genetic

from _fixtures import instance, padded_batch

GA_TEST = jgen.GAConfig(generations=5, pop_size=8, p_mutation=0.2)


def _port(cfg, **changes):
    return convert.ga_config_from_reference(
        dataclasses.asdict(dataclasses.replace(cfg, **changes)))


def _same(want, got, what=""):
    assert np.asarray(want).tobytes() == got.numpy().tobytes(), what


@pytest.mark.parametrize("ev,rng", [("wide", "host"), ("wide", "counter"),
                                    ("fused", "host"), ("fused", "counter"),
                                    ("island", "host")])
def test_generation_step_from_reference_state(ev, rng):
    """Start the port from a reference population and key taken mid-run
    (two generations in), then take two more generations on both sides;
    fitness ties come from duplicated members."""
    n, nv, procs = 16, 13, 2
    cfg = dataclasses.replace(GA_TEST, eval=ev, rng=rng, crossover="oxs",
                              tournament=3, p_crossover=0.8)
    C, M = instance(nv, 23)
    Cp = np.zeros((n, n), np.float32)
    Mp = np.zeros((n, n), np.float32)
    Cp[:nv, :nv], Mp[:nv, :nv] = C, M
    Cj, Mj, nvj = jnp.asarray(Cp), jnp.asarray(Mp), jnp.int32(nv)
    state = jax.vmap(lambda k: jgen.init_island(Cj, Mj, k, cfg, nvj))(
        jax.random.split(jax.random.PRNGKey(4), procs))
    state = jgen.GAState(pop=state.pop.at[:, 1].set(state.pop[:, 0]),
                         fit=state.fit.at[:, 1].set(state.fit[:, 0]))
    step = jax.jit(lambda s, k: jgen.generation_step(Cj, Mj, s, k, cfg, procs,
                                                     nvj))
    for i in range(2):
        state, _ = step(state, jax.random.PRNGKey(30 + i))
    ported = convert.ga_state_from_reference(
        {k: np.asarray(v) for k, v in state._asdict().items()})
    pcfg = _port(cfg)
    for i in range(2):
        key = jax.random.PRNGKey(40 + i)
        state, best = step(state, key)
        ported, got_best = genetic.generation_step(
            torch.as_tensor(Cp), torch.as_tensor(Mp), ported,
            convert.keys_from_reference(np.asarray(key)[None]), pcfg, procs,
            torch.tensor([nv]))
        _same(best, got_best[0], "history entry")
    _same(state.pop.reshape(-1, cfg.pop_size, n), ported.pop, "pop")
    _same(state.fit.reshape(-1, cfg.pop_size), ported.fit, "fit")


def _check_solve(want, got):
    for name, w, g in zip(("perm", "f", "history"), want, got):
        _same(w, g, name)


@pytest.mark.parametrize("ev,rng,warm", [("wide", "host", True),
                                         ("fused", "counter", True),
                                         ("island", "host", False)])
def test_run_pga_batch_matches_reference(ev, rng, warm):
    sizes = [8, 12, 16, 16]
    Cs, Ms, nvs, keys = padded_batch(sizes, bucket=16)
    cfg = dataclasses.replace(GA_TEST, eval=ev, rng=rng)
    ips = None
    if warm:      # warm rows 1 and 3, cold sentinel rows 0 and 2
        ips = np.full((4, 16), -1, np.int32)
        for i in (1, 3):
            n = sizes[i]
            ips[i, :n] = np.random.default_rng(i).permutation(n)
            ips[i, n:] = np.arange(n, 16)
    want = jgen.run_pga_batch(Cs, Ms, keys, cfg, num_processes=2, n_valid=nvs,
                              init_perm=None if ips is None else jnp.asarray(ips))
    got = genetic.run_pga_batch(np.asarray(Cs), np.asarray(Ms), np.asarray(keys),
                                _port(cfg), 2, n_valid=np.asarray(nvs),
                                init_perm=ips, device="cpu")
    _check_solve(want, got)


def test_run_pga_unpadded_seed_identity_on_a_known_optimum():
    """The unpadded path (jax.random.permutation starts, the Python-float
    mutation gate), ``seed_identity`` and the default population size on a
    ring instance whose optimum is known."""
    inst = exact.make_ring(12, version=2)
    cfg = dataclasses.replace(GA_TEST, pop_size=0, seed_identity=True,
                              generations=4, p_mutation=0.3)
    key = jax.random.PRNGKey(9)
    want = jgen.run_pga(jnp.asarray(inst.C), jnp.asarray(inst.M), key, cfg,
                        num_processes=3)
    got = genetic.run_pga(inst.C, inst.M, np.asarray(key), _port(cfg), 3,
                          device="cpu")
    _check_solve(want, got)
    assert float(got[1]) >= inst.optimum


def test_fused_equals_wide_counter_and_routing():
    """``eval="fused"`` is the ``"wide"`` counter-regime generation in one
    launch: the same solve; above the fused cap it runs as that path."""
    Cs, Ms, nvs, keys = padded_batch([6, 9], bucket=12, seed0=5)
    args = (np.asarray(Cs), np.asarray(Ms), np.asarray(keys))
    fused = genetic.run_pga_batch(*args, _port(GA_TEST, eval="fused"), 2,
                                  n_valid=np.asarray(nvs), device="cpu")
    wide = genetic.run_pga_batch(*args, _port(GA_TEST, rng="counter"), 2,
                                 n_valid=np.asarray(nvs), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(fused, wide))
    cfg = _port(GA_TEST, eval="fused")
    for n in (8, 64, 768, 769, 4096):
        assert genetic.resolved_eval(cfg, n) == jgen.resolved_eval(
            dataclasses.replace(GA_TEST, eval="fused"), n)
    assert genetic.resolved_eval(_port(GA_TEST, eval="island"), 64) == "island"


def test_config_errors():
    C, M = instance(6, 1)
    key = np.zeros(2, np.uint32)
    for bad, err in ((dict(eval="bogus"), ValueError),
                     (dict(rng="bogus"), ValueError),
                     (dict(eval="island", rng="counter"), ValueError),
                     (dict(flows="sparse"), TypeError),
                     (dict(flows="bogus"), ValueError)):
        with pytest.raises(err):
            genetic.run_pga(C, M, key, _port(GA_TEST, **bad), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            genetic.run_pga(C, M, key, _port(GA_TEST))
