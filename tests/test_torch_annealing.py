"""The port's PSA against ``repro.core.annealing``, bit for bit: the
temperature formulas in the form XLA compiles them to, one temperature
step from a reference state in every loop x draw regime, and whole
``run_psa_batch`` / ``run_psa`` solves."""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import annealing as jann
from repro.core import qap as jqap
from repro_torch import convert
from repro_torch.core import annealing, qap, sparse

from _fixtures import SA_SMALL, instance, padded_batch

CONFIGS = [jann.SAConfig(),
           jann.SAConfig(max_neighbors=25, iters_per_exchange=30,
                         num_exchanges=20, solvers=8),
           SA_SMALL,
           jann.SAConfig(mu=0.7, phi=0.11, t_final=0.01, iters_per_exchange=7,
                         num_exchanges=3)]


def _port(cfg, **changes):
    return convert.sa_config_from_reference(
        dataclasses.asdict(dataclasses.replace(cfg, **changes)))


def _kd(k):
    return convert.keys_from_reference(np.asarray(k))


@pytest.mark.parametrize("cfg", CONFIGS)
def test_initial_temperature_and_beta_match_xla(cfg):
    n, B = 16, 48
    Cs, Ms, nvs, _ = padded_batch([5 + i % 12 for i in range(B)], n, seed0=3)
    Cs = jax.vmap(jqap.mask_flows)(Cs, nvs)
    jkeys = jax.random.split(jax.random.PRNGKey(1), B)
    beta = jax.jit(jax.vmap(functools.partial(jann.make_beta, cfg=cfg)))(
        Cs, Ms, jkeys, n_valid=nvs)
    temp = jax.jit(jax.vmap(lambda c, m, k, v: jann.init_chain(
        c, m, k, cfg, n_valid=v).temp))(Cs, Ms, jkeys, nvs)
    tC, tM = torch.as_tensor(np.array(Cs)), torch.as_tensor(np.array(Ms))
    tk = _kd(jkeys)
    tnv = torch.as_tensor(np.array(nvs), dtype=torch.int64)
    pcfg = _port(cfg)
    assert np.asarray(beta).tobytes() == \
        annealing.make_beta(tC, tM, tk, pcfg, tnv).numpy().tobytes()
    p = qap.masked_random_permutation(tk, n, tnv)
    got_t = annealing.initial_temperature(qap.objective(tC, tM, p), cfg.mu, cfg.phi)
    assert np.asarray(temp).tobytes() == got_t.numpy().tobytes()


@pytest.mark.parametrize("schedule", ["cauchy", "linear"])
def test_cool_matches_xla(schedule):
    cfg = jann.SAConfig(schedule=schedule)
    rng = np.random.default_rng(0)
    temps = (rng.random(50000) * 1000).astype(np.float32)
    for beta in (np.float32(3.3e-3), np.float32(0.1709), np.float32(2.5e-7)):
        want = jax.jit(lambda t, b: jann.cool(t, cfg, b))(temps, beta)
        got = annealing.cool(torch.as_tensor(temps), _port(cfg),
                             torch.tensor(beta))
        assert np.asarray(want).tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("loop", ["event", "scan", "fused"])
@pytest.mark.parametrize("rng", ["host", "counter"])
def test_temperature_step_from_reference_state(loop, rng):
    """Start the port from a reference SAState taken mid-run (three steps
    in), then take two more steps on both sides."""
    n, nv, B = 16, 13, 6
    cfg = dataclasses.replace(SA_SMALL, max_neighbors=12, max_success=4,
                              loop=loop, rng=rng)
    C, M = instance(nv, 71)
    Cp = np.zeros((n, n), np.float32)
    Mp = np.zeros((n, n), np.float32)
    Cp[:nv, :nv], Mp[:nv, :nv] = C, M
    Cj, Mj = jnp.asarray(Cp), jnp.asarray(Mp)
    nvs = jnp.full((B,), nv, jnp.int32)
    init = jax.vmap(lambda k: jann.init_chain(Cj, Mj, k, cfg, n_valid=jnp.int32(nv)))(
        jax.random.split(jax.random.PRNGKey(2), B))
    beta = jann.make_beta(Cj, Mj, jax.random.PRNGKey(3), cfg, jnp.int32(nv))
    step = jax.jit(jax.vmap(lambda s, k, v: jann.temperature_step(
        Cj, Mj, s, k, cfg, beta, v)))
    state = init
    for i in range(3):
        state = step(state, jax.random.split(jax.random.PRNGKey(10 + i), B), nvs)
    ported = convert.sa_state_from_reference(
        {k: np.asarray(v) for k, v in state._asdict().items()})
    pcfg = _port(cfg)
    tbeta = torch.tensor(np.asarray(beta))
    for i in range(2):
        keys = jax.random.split(jax.random.PRNGKey(20 + i), B)
        state = step(state, keys, nvs)
        ported = annealing.temperature_step(
            torch.as_tensor(Cp), torch.as_tensor(Mp), ported, _kd(keys), pcfg,
            tbeta, torch.as_tensor(np.asarray(nvs)))
    for name, want, got in zip(state._fields, state, ported):
        assert np.asarray(want).tobytes() == got.numpy().tobytes(), name


def _check_solve(want, got):
    for name, w, g in zip(("perm", "f", "history"), want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes(), name


@pytest.mark.parametrize("loop,rng,warm", [("event", "host", True),
                                           ("fused", "counter", True),
                                           ("scan", "counter", False)])
def test_run_psa_batch_matches_reference(loop, rng, warm):
    sizes = [8, 12, 16, 16]
    Cs, Ms, nvs, keys = padded_batch(sizes, bucket=16)
    cfg = dataclasses.replace(SA_SMALL, loop=loop, rng=rng)
    ips = None
    if warm:      # warm rows 1 and 3, cold sentinel rows 0 and 2
        ips = np.full((4, 16), -1, np.int32)
        for i in (1, 3):
            n = sizes[i]
            ips[i, :n] = np.random.default_rng(i).permutation(n)
            ips[i, n:] = np.arange(n, 16)
    want = jann.run_psa_batch(Cs, Ms, keys, cfg, num_processes=2, n_valid=nvs,
                              init_perm=None if ips is None else jnp.asarray(ips))
    got = annealing.run_psa_batch(np.asarray(Cs), np.asarray(Ms), np.asarray(keys),
                                  _port(cfg), 2, n_valid=np.asarray(nvs),
                                  init_perm=ips, device="cpu")
    _check_solve(want, got)


def test_run_psa_unpadded_identity_seed_linear_no_exchange():
    """The unpadded path (jax.random.permutation starts), seed_with=
    "identity", the linear schedule and exchange=False."""
    C, M = instance(12, 8)
    cfg = dataclasses.replace(SA_SMALL, seed_with="identity", schedule="linear")
    key = jax.random.PRNGKey(4)
    want = jann.run_psa(jnp.asarray(C), jnp.asarray(M), key, cfg,
                        num_processes=2, exchange=False)
    got = annealing.run_psa(C, M, np.asarray(key), _port(cfg), 2,
                            exchange=False, device="cpu")
    _check_solve(want, got)


def test_entry_points_need_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    C, M = instance(6, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        annealing.run_psa(C, M, np.zeros(2, np.uint32), annealing.SAConfig())


def test_sparse_flows_not_ported():
    """Sparse flows are ported: ``flows="sparse"`` wants a SparseFlows C
    (a dense one raises, as in the reference) and then solves exactly as
    the dense path does."""
    C, M = instance(6, 1)
    key = np.zeros(2, np.uint32)
    cfg = annealing.SAConfig(max_neighbors=6, iters_per_exchange=3,
                             num_exchanges=2, solvers=2)
    with pytest.raises(TypeError, match="SparseFlows"):
        annealing.run_psa(C, M, key, dataclasses.replace(cfg, flows="sparse"),
                          device="cpu")
    want = annealing.run_psa(C, M, key, cfg, device="cpu")
    got = annealing.run_psa(sparse.from_dense(C), M, key,
                            dataclasses.replace(cfg, flows="sparse"),
                            device="cpu")
    for w, g in zip(want, got):
        assert torch.equal(w, g)
