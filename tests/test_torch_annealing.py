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


@pytest.mark.parametrize("start", ["random", "masked", "identity"])
def test_init_chain_matches_reference(start):
    """``init_chain`` over a leading batch of chain keys equals the
    reference's under ``jit(vmap)``: random, padded (``n_valid``) and
    identity-seeded starts (T0 in XLA's folded form)."""
    n, nv, chains = 16, 11, 9
    C, M = instance(n, 21)
    cfg = SA_SMALL
    jkeys = jax.random.split(jax.random.PRNGKey(6), chains)
    ident = np.roll(np.arange(n, dtype=np.int32), 3)
    kw = {"random": {}, "masked": {"n_valid": nv},
          "identity": {"identity": ident}}[start]
    want = jax.jit(jax.vmap(lambda k: jann.init_chain(
        jnp.asarray(C), jnp.asarray(M), k, cfg,
        **{k_: jnp.asarray(v) for k_, v in kw.items()})))(jkeys)
    port_kw = {k_: torch.as_tensor(v) for k_, v in kw.items()}
    got = annealing.init_chain(torch.as_tensor(C), torch.as_tensor(M),
                               _kd(jkeys), _port(cfg), **port_kw)
    for name, w, g in zip(want._fields, want, got):
        assert g.shape[0] == chains, name
        assert np.asarray(w).tobytes() == g.numpy().tobytes(), name


@pytest.mark.parametrize("warm", [True, False])
def test_seed_chain0_and_adopt_best_match_reference(warm):
    """``seed_chain0`` on a (processes, solvers) chain grid, warm and with
    the cold sentinel (a -1 first entry), then ``_adopt_best`` of a
    broadcast best, against the reference's."""
    n, procs, solvers = 12, 3, 4
    C, M = instance(n, 23)
    Cj, Mj = jnp.asarray(C), jnp.asarray(M)
    cfg = SA_SMALL
    ckeys = jax.random.split(jax.random.PRNGKey(8), procs * solvers) \
        .reshape(procs, solvers, 2)
    init = jax.jit(jax.vmap(jax.vmap(
        lambda k: jann.init_chain(Cj, Mj, k, cfg))))(ckeys)
    ip = np.random.default_rng(5).permutation(n).astype(np.int32)
    if not warm:
        ip[0] = -1
    want = jax.jit(lambda st, k, p: jann.seed_chain0(
        Cj, Mj, st, k, cfg, procs, p, jann.init_chain))(
            init, ckeys[0, 0], jnp.asarray(ip))
    tC, tM = torch.as_tensor(C), torch.as_tensor(M)
    ported = annealing.SAState(*(torch.as_tensor(np.array(x)) for x in init))
    got = annealing.seed_chain0(tC, tM, ported, _kd(ckeys[0, 0]), _port(cfg),
                                procs, torch.as_tensor(ip),
                                annealing.init_chain)
    for name, w, g in zip(want._fields, want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes(), name
    # adopt the best of the grid, broadcast to every chain
    flat = want.best_f.reshape(-1)
    i = int(jnp.argmin(flat))
    bp = jnp.broadcast_to(want.best_p.reshape(-1, n)[i], want.p.shape)
    bf = jnp.broadcast_to(flat[i], want.f.shape)
    adopted = jax.jit(jann._adopt_best)(want, bp, bf)
    got = annealing._adopt_best(got, torch.as_tensor(np.array(bp)),
                                torch.as_tensor(np.array(bf)))
    for name, w, g in zip(adopted._fields, adopted, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes(), name
