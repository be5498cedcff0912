"""K4's exchange round on the CPU: the plain round (``qap_sa_step_plain``
with ``steps`` and a ``Cooling``) against the solver's loop of single
temperature steps (``annealing._chain_round``, which runs that loop off
the card), bit for bit.  The card's one-launch round is held to the same
loop in ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import annealing, keys, qap
from repro_torch.kernels import ops
from repro_torch.kernels.qap_sa_step import Cooling, qap_sa_step_plain

B0, R, N = 3, 4, 16
NV = (16, 13, 11)       # the last two padded in the order-16 bucket


def _wave(seed):
    """Integer instances padded past ``NV``, ``B0 * R`` chains from random
    starts at temperatures from 0.5 to 400, Cauchy betas and round
    keys."""
    rng = np.random.default_rng(seed)
    Cs = np.zeros((B0, N, N), np.float32)
    Ms = np.zeros((B0, N, N), np.float32)
    for i, nv in enumerate(NV):
        C = rng.integers(0, 10, (nv, nv)).astype(np.float32)
        M = rng.integers(1, 10, (nv, nv)).astype(np.float32)
        Cs[i, :nv, :nv], Ms[i, :nv, :nv] = C + C.T, M + M.T
    C, M = torch.as_tensor(Cs), torch.as_tensor(Ms)
    nv = torch.as_tensor(NV).repeat_interleave(R)
    ck = keys.split(keys.prng_key(seed), B0 * R)
    p = qap.masked_random_permutation(ck, N, nv)
    f = qap.objective(C, M, p.view(B0, R, N)).reshape(-1)
    temp = torch.linspace(0.5, 400.0, B0 * R)
    beta = torch.as_tensor(rng.uniform(0.05, 0.5, B0 * R).astype(np.float32))
    rk = keys.split(keys.prng_key(seed + 1), B0 * R)
    return C, M, annealing.SAState(p, f, p, f, temp), beta, rk, nv


@pytest.mark.parametrize("loop", ["fused", "event", "scan"])
@pytest.mark.parametrize("schedule,q,t_final", [("cauchy", 0.95, 0.5),
                                                 ("linear", 0.5, 0.2)])
@pytest.mark.parametrize("max_neighbors,max_success", [(12, 4), (12, 0),
                                                       (0, 10), (30, 1)])
def test_plain_round_equals_the_loop_of_single_steps(loop, schedule, q,
                                                     t_final, max_neighbors,
                                                     max_success):
    """Every field, the temperatures included, the same bits, with
    padded instances and ``t_final`` reached within the round."""
    cfg = annealing.SAConfig(max_neighbors=max_neighbors,
                             max_success=max_success, schedule=schedule, q=q,
                             t_final=t_final, iters_per_exchange=9,
                             num_exchanges=2, solvers=R, loop=loop,
                             rng="counter")
    C, M, state, beta, rk, nv = _wave(7)
    nv32 = nv.to(torch.int32)
    want = annealing._chain_round((C, M, None, None), state, rk, cfg, beta,
                                  nv, nv32)
    temp = torch.empty_like(state.temp)
    got = qap_sa_step_plain(
        C, M, state.p, state.f, state.best_p, state.best_f, state.temp, rk,
        nv32, max_neighbors=max_neighbors, max_success=max_success, steps=9,
        cooling=Cooling(schedule, annealing._f32(q), annealing._f32(t_final),
                        beta),
        temp_out=temp)
    for name, w, g in zip(annealing.SAState._fields, want, (*got, temp)):
        assert w.numpy().tobytes() == g.numpy().tobytes(), name
    assert (temp == annealing._f32(t_final)).any()       # the clamp held
    assert (temp > annealing._f32(t_final)).any()        # and not everywhere
    if max_success and max_neighbors:
        assert not torch.equal(got[0], state.p)


def test_round_of_one_step_is_the_single_step_at_its_split_key():
    C, M, state, beta, rk, nv = _wave(3)
    nv32 = nv.to(torch.int32)
    kw = dict(max_neighbors=20, max_success=5)
    temp = torch.empty_like(state.temp)
    cooling = Cooling("cauchy", 0.95, 0.001, beta)
    got = qap_sa_step_plain(C, M, *state[:4], state.temp, rk, nv32, steps=1,
                            cooling=cooling, temp_out=temp, **kw)
    want = qap_sa_step_plain(C, M, *state[:4], state.temp,
                             keys.split(rk, 1)[:, 0], nv32, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(temp, annealing.cool(
        state.temp, annealing.SAConfig(), beta).clamp_min(0.001))


def test_ops_round_on_cpu_tensors_is_the_plain_round_and_launches_nothing():
    ops.reset_launch_counts()
    C, M, state, beta, rk, nv = _wave(11)
    nv32 = nv.to(torch.int32)
    kw = dict(max_neighbors=10, max_success=3, steps=4,
              cooling=Cooling("linear", 0.9, 0.01, beta))
    t_ops, t_plain = torch.empty_like(state.temp), torch.empty_like(state.temp)
    got = ops.qap_sa_step(C, M, *state[:4], state.temp, rk, nv32,
                          temp_out=t_ops, **kw)
    want = qap_sa_step_plain(C, M, *state[:4], state.temp, rk, nv32,
                             temp_out=t_plain, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(t_ops, t_plain)
    assert not ops.sa_round_fits(state.p)
    assert sum(ops.launch_counts().values()) == 0
    assert sum(ops.branch_counts().values()) == 0


@pytest.mark.parametrize("bad", ["steps", "schedule", "temp_out"])
def test_a_malformed_round_is_refused(bad):
    C, M, state, beta, rk, nv = _wave(5)
    kw = dict(steps=3, cooling=Cooling("cauchy", 0.95, 0.001, beta),
              temp_out=torch.empty_like(state.temp))
    if bad == "steps":
        kw["steps"] = 0
    elif bad == "schedule":
        kw["cooling"] = kw["cooling"]._replace(schedule="geometric")
    else:
        kw["temp_out"] = None
    with pytest.raises(ValueError, match="round"):
        qap_sa_step_plain(C, M, *state[:4], state.temp, rk,
                          nv.to(torch.int32), max_neighbors=5, max_success=2,
                          **kw)


@pytest.mark.parametrize("loop", ["fused", "event", "scan"])
def test_round_spans_count_one_step_a_launch_off_the_card(loop):
    """Off the card every level is its own call: ``solver.round`` says
    ``steps=1``."""
    cfg = annealing.SAConfig(max_neighbors=6, iters_per_exchange=3,
                             num_exchanges=2, solvers=2, loop=loop)
    C, M, state, *_ = _wave(2)
    assert annealing._round_steps(cfg, state.p) == 1
    spans.enable()
    try:
        annealing.anneal_chains(C, M, keys.split(keys.prng_key(4), B0), cfg,
                                1, True)
    finally:
        records = spans.drain()
        spans.disable()
    rounds = [s for s in records if s.name == "solver.round"]
    assert [(s.attrs["e"], s.attrs["steps"]) for s in rounds] == [(0, 1),
                                                                  (1, 1)]
