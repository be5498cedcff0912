"""The CUDA kernels against their plain PyTorch versions, and the engine
on the card against the engine on the CPU.  Every test needs a CUDA
device and skips without one.  The file imports neither JAX nor the
reference package, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import (annealing, exact, genetic, instances,
                              multilevel, sparse)
from repro_torch.core.keys import split as split_key
from repro_torch.core.qap import mask_flows
from repro_torch.kernels import build, ops
from repro_torch.kernels.qap_delta import qap_delta_plain
from repro_torch.kernels.qap_ga_step import qap_ga_step_plain, smem_branch
from repro_torch.kernels.qap_objective import qap_objective_plain
from repro_torch.kernels.qap_sa_step import Cooling, qap_sa_step_plain
from repro_torch.kernels.qap_sparse import (objective_sparse_launch,
                                            qap_delta_sparse_plain,
                                            qap_objective_sparse_cuda,
                                            qap_objective_sparse_plain)
from repro_torch import configs
from repro_torch.kernels.selective_scan import (selective_scan_cuda,
                                                selective_scan_plain)
from repro_torch.models.api import Model
from repro_torch.serve import Engine, MappingEngine, MapRequest, ServeConfig

pytestmark = pytest.mark.gpu

B0, RPT, K = 4, 8, 25
# (n, nv, shared): K1 and K4 take orders up to 169 on their shared-memory
# branch and 200 and 256 on their L2 branch (200: the service's exact-size
# range, an order-193 request padded); 32 is the engine's smallest bucket.
CASES = [(16, 16, True), (16, 11, False), (40, 29, True), (128, 125, False),
         (32, 27, False), (169, 160, True), (256, 250, False),
         (200, 193, False)]
# K1/K4 block splits, (n, nv, shared, chains per instance, candidates):
# the polish shape, one shared instance with many chains, an odd chain
# count (a block's last warps unused), the first order past the
# shared-memory threshold (rows not 16-byte aligned: 170 words), and the
# polish shape on the L2 branch at order 200.
SPLIT_CASES = [(128, 125, False, 1, 256), (64, 64, True, 128, 25),
               (128, 125, False, 5, 25), (32, 27, True, 5, 25),
               (170, 170, False, 3, 25), (200, 193, False, 1, 256)]
DENSE_CASES = [c + (RPT, K) for c in CASES] + SPLIT_CASES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(n, nv, shared, seed, device, rpt=RPT, k=K, insts=B0):
    """Integer instances zero-padded past ``nv``; insts * rpt chains whose
    permutations keep the padded tail on itself, with ``k`` candidate
    pairs each, objectives, temperatures, key words and valid orders."""
    rng = np.random.default_rng(seed)
    b0 = 1 if shared else insts
    Cs = np.zeros((b0, n, n), np.float32)
    Ms = np.zeros((b0, n, n), np.float32)
    for i in range(b0):
        C = rng.integers(0, 10, (nv, nv)).astype(np.float32)
        M = rng.integers(1, 10, (nv, nv)).astype(np.float32)
        Cs[i, :nv, :nv], Ms[i, :nv, :nv] = C + C.T, M + M.T
    B = insts * rpt
    ps = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    for r in range(B):
        ps[r, :nv] = rng.permutation(nv)
    pairs = np.sort(np.stack([rng.choice(nv, 2, replace=False)
                              for _ in range(B * k)]), axis=1)
    inst = np.arange(B) // rpt if not shared else np.zeros(B, int)
    fs = np.array([(Cs[i] * Ms[i][np.ix_(p, p)]).sum()
                   for i, p in zip(inst, ps)], np.float32)
    temps = np.linspace(5.0, 500.0, B).astype(np.float32)
    keys = rng.integers(0, 2 ** 32, (B, 2), dtype=np.uint64).astype(np.int64)
    if shared:
        Cs, Ms = Cs[0], Ms[0]
    t = lambda x: torch.as_tensor(x, device=device)
    return (t(Cs), t(Ms), t(ps), t(pairs.reshape(B, k, 2).astype(np.int32)),
            t(fs), t(temps), t(keys), t(np.full(B, nv, np.int32)))


def _launched_on(kernel, n, before, smem=None):
    """One launch of ``kernel`` since ``before`` (``ops.branch_counts()``),
    on the branch order ``n`` selects (or ``smem`` says, where the order
    alone does not decide it)."""
    if smem is None:
        smem = n <= build.dense_smem_max_n()
    branch = "smem" if smem else "l2"
    after = ops.branch_counts()
    return {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {f"{kernel}/{branch}": 1}


@pytest.mark.parametrize("n,nv,shared,rpt,k", DENSE_CASES)
def test_qap_delta_kernel_matches_plain(cuda, n, nv, shared, rpt, k):
    C, M, p, pairs, *_ = _inputs(n, nv, shared, n + nv, cuda, rpt, k)
    before = ops.launch_counts()["qap_delta"]
    branches = ops.branch_counts()
    got = ops.qap_delta(C, M, p, pairs)
    assert ops.launch_counts()["qap_delta"] == before + 1
    assert _launched_on("qap_delta", n, branches)
    assert torch.equal(got, qap_delta_plain(C, M, p, pairs))


@pytest.mark.parametrize("n,nv,shared,rpt,k", DENSE_CASES)
def test_qap_sa_step_kernel_matches_plain(cuda, n, nv, shared, rpt, k):
    C, M, p, _, f, temp, keys, nv_t = _inputs(n, nv, shared, 2 * n + nv,
                                              cuda, rpt, k)
    args = (C, M, p, f, p.clone(), f.clone(), temp, keys, nv_t)
    kw = dict(max_neighbors=k, max_success=6)
    before = ops.launch_counts()["qap_sa_step"]
    branches = ops.branch_counts()
    got = ops.qap_sa_step(*args, **kw)
    assert ops.launch_counts()["qap_sa_step"] == before + 1
    assert _launched_on("qap_sa_step", n, branches)
    want = qap_sa_step_plain(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _islands(n, nv, shared, seed, device, pop=32, insts=B0, rpt=RPT):
    """insts * rpt islands of ``pop`` members over integer instances, with
    duplicated members (fitness ties), exact F, key words, valid orders."""
    C, M, *_ = _inputs(n, nv, shared, seed, device, insts=insts)
    rng = np.random.default_rng(seed)
    B = insts * rpt
    pops = np.tile(np.arange(n, dtype=np.int32), (B, pop, 1))
    for r in range(B):
        for j in range(pop):
            pops[r, j, :nv] = rng.permutation(nv)
    pops[:, 1] = pops[:, 0]
    pops = torch.as_tensor(pops, device=device)
    fits = qap_objective_plain(C, M, pops)
    keys = rng.integers(0, 2 ** 32, (B, 2), dtype=np.uint64).astype(np.int64)
    return (C, M, pops, fits, torch.as_tensor(keys, device=device),
            torch.full((B,), nv, dtype=torch.int32, device=device))


@pytest.mark.parametrize("n,nv,shared", CASES)
def test_qap_objective_kernel_matches_plain(cuda, n, nv, shared):
    C, M, pops, *_ = _islands(n, nv, shared, 3 * n + nv, cuda)
    before = ops.launch_counts()["qap_objective"]
    branches = ops.branch_counts()
    got = ops.qap_objective(C, M, pops)
    assert ops.launch_counts()["qap_objective"] == before + 1
    assert _launched_on("qap_objective", n, branches)
    assert torch.equal(got, qap_objective_plain(C, M, pops))


@pytest.mark.parametrize("crossover", ["ox", "oxs"])
@pytest.mark.parametrize("n,nv,shared", CASES)
def test_qap_ga_step_kernel_matches_plain(cuda, n, nv, shared, crossover):
    C, M, pops, fits, keys, nvs = _islands(n, nv, shared, 5 * n + nv, cuda)
    # 16 children: one warp each; 32: more children than the 16 warps
    for kw in (dict(n_off=16, tournament=2, p_crossover=1.0, p_mutation=0.001),
               dict(n_off=32, tournament=3, p_crossover=0.7, p_mutation=0.3)):
        before = ops.launch_counts()["qap_ga_step"]
        branches = ops.branch_counts()
        got = ops.qap_ga_step(C, M, pops, fits, keys, nvs, crossover=crossover,
                              **kw)
        assert ops.launch_counts()["qap_ga_step"] == before + 1
        assert _launched_on("qap_ga_step", n, branches, smem_branch(
            pops.shape[1], n, kw["n_off"], kw["tournament"]))
        want = qap_ga_step_plain(C, M, pops, fits, keys, nvs,
                                 crossover=crossover, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("n,nv", [(64, 45), (32, 27)])
def test_ga_kernels_at_a_three_request_wave(cuda, n, nv):
    """K2 and K5 at the 64 and 32 buckets' 3-request waves: 3 instances
    of 2 islands each, 32 members, 16 children, both on the shared-memory
    branch."""
    C, M, pops, fits, keys, nvs = _islands(n, nv, False, 7 * n + nv, cuda,
                                           insts=3, rpt=2)
    kids = pops[:, :16].contiguous()
    branches = ops.branch_counts()
    got = ops.qap_objective(C, M, kids)
    assert _launched_on("qap_objective", n, branches, True)
    assert torch.equal(got, qap_objective_plain(C, M, kids))
    kw = dict(n_off=16, tournament=2, p_crossover=1.0, p_mutation=0.001)
    before = ops.launch_counts()["qap_ga_step"]
    branches = ops.branch_counts()
    got = ops.qap_ga_step(C, M, pops, fits, keys, nvs, **kw)
    assert ops.launch_counts()["qap_ga_step"] == before + 1
    assert _launched_on("qap_ga_step", n, branches, True)
    for g, w in zip(got, qap_ga_step_plain(C, M, pops, fits, keys, nvs, **kw)):
        assert torch.equal(g, w)


def _k5_l2_matches_plain(C, M, pops, fits, keys, nvs, **kw):
    """K5 on its L2 branch, once, equal to its plain version bit for bit."""
    P, n = pops.shape[1:]
    assert not smem_branch(P, n, kw["n_off"], kw["tournament"])
    branches = ops.branch_counts()
    got = ops.qap_ga_step(C, M, pops, fits, keys, nvs, **kw)
    assert _launched_on("qap_ga_step", n, branches, False)
    for g, w in zip(got, qap_ga_step_plain(C, M, pops, fits, keys, nvs, **kw)):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("crossover", ["ox", "oxs"])
@pytest.mark.parametrize("n_off", [100, 200])
def test_qap_ga_step_l2_kernel_at_pop_equal_to_the_order(cuda, n_off,
                                                         crossover):
    """The GA at its default pop_size (the order): 2 islands of 200
    members of an order-193 request padded into 200, 100 children or
    every member replaced (the elitism guard fires)."""
    C, M, pops, fits, keys, nvs = _islands(200, 193, False, 11 + n_off, cuda,
                                           pop=200, insts=1, rpt=2)
    _k5_l2_matches_plain(C, M, pops, fits, keys, nvs, n_off=n_off,
                         tournament=2, p_crossover=0.9, p_mutation=0.2,
                         crossover=crossover)


def test_qap_ga_step_l2_kernel_at_table1_fused_shape(cuda):
    """Table 1's fused PGA: 4 islands of 128 members, 64 children, at
    order 256."""
    C, M, pops, fits, keys, nvs = _islands(256, 256, True, 13, cuda, pop=128,
                                           insts=1, rpt=4)
    _k5_l2_matches_plain(C, M, pops, fits, keys, nvs, n_off=64, tournament=2,
                         p_crossover=1.0, p_mutation=0.01)


def test_qap_ga_step_l2_kernel_scores_children_as_k2(cuda):
    """On real-valued flows K5's L2 branch gives each new member K2's F of
    it, bit for bit, and the same bits on a second call."""
    C, M, pops, fits, keys, nvs = _islands(200, 200, False, 17, cuda,
                                           insts=2, rpt=2)
    g = torch.Generator(device=cuda).manual_seed(17)
    C = C * torch.rand(C.shape, generator=g, device=cuda)
    M = M * torch.rand(M.shape, generator=g, device=cuda)
    fits = ops.qap_objective(C, M, pops)
    kw = dict(n_off=16, tournament=2, p_crossover=1.0, p_mutation=0.1)
    pop1, fit1 = ops.qap_ga_step(C, M, pops, fits, keys, nvs, **kw)
    pop2, fit2 = ops.qap_ga_step(C, M, pops, fits, keys, nvs, **kw)
    assert torch.equal(pop1, pop2) and torch.equal(fit1, fit2)
    new = (pop1 != pops).any(-1)
    assert int(new.sum()) > 0
    assert torch.equal(fit1[new], ops.qap_objective(C, M, pop1)[new])


# K4's L2 orders: the first past the threshold (rows not 16-byte
# aligned), the exact-size 200, 256, each side of a row slot's growth
# (257, 384 and 385: a slot holds whole groups of 128 words) and the fused
# cap 768, the L2 branch's last order.
@pytest.mark.parametrize("n,nv", [(170, 170), (200, 193), (256, 256),
                                  (257, 250), (384, 384), (385, 385),
                                  (768, 760)])
def test_qap_sa_step_l2_kernel_across_its_plan(cuda, n, nv):
    """K4's L2 branch bit for bit against its plain version on integer
    instances across its orders, a block a chain, 26 chains over two
    instances."""
    C, M, p, _, f, temp, keys, nv_t = _inputs(n, nv, False, n + 3, cuda, 13,
                                              K, insts=2)
    args = (C, M, p, f, p.clone(), f.clone(), temp, keys, nv_t)
    kw = dict(max_neighbors=K, max_success=8)
    branches = ops.branch_counts()
    got = ops.qap_sa_step(*args, **kw)
    assert _launched_on("qap_sa_step", n, branches)
    for g, w in zip(got, qap_sa_step_plain(*args, **kw)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k,max_success", [(K, 0), (0, 8), (1, 8)])
def test_qap_sa_step_l2_kernel_with_few_candidates(cuda, k, max_success):
    """K4's L2 branch with nothing to score (no candidate, or a cap of no
    swap: the state comes back as it went in) and with one candidate, bit
    for bit against its plain version at order 200."""
    C, M, p, _, f, temp, keys, nv_t = _inputs(200, 193, False, 11, cuda, 5,
                                              max(k, 1), insts=2)
    args = (C, M, p, f, p.clone(), f.clone(), temp, keys, nv_t)
    kw = dict(max_neighbors=k, max_success=max_success)
    branches = ops.branch_counts()
    got = ops.qap_sa_step(*args, **kw)
    assert _launched_on("qap_sa_step", 200, branches)
    for g, w in zip(got, qap_sa_step_plain(*args, **kw)):
        assert torch.equal(g, w)
    if k == 0 or max_success == 0:
        assert torch.equal(got[0], p) and torch.equal(got[1], f)


def test_qap_sa_step_l2_kernel_is_deterministic(cuda):
    """On real-valued flows K4's L2 branch gives the same bits on two
    calls."""
    C, M, p, _, f, temp, keys, nv_t = _inputs(256, 256, False, 5, cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    C = C * torch.rand(C.shape, generator=g, device=cuda)
    M = M * torch.rand(M.shape, generator=g, device=cuda)
    f = ops.qap_objective(C, M, p.view(B0, RPT, -1)).reshape(-1)
    args = (C, M, p, f, p.clone(), f.clone(), temp * 0.01, keys, nv_t)
    kw = dict(max_neighbors=K, max_success=10)
    first = ops.qap_sa_step(*args, **kw)
    for a, b in zip(first, ops.qap_sa_step(*args, **kw)):
        assert torch.equal(a, b)
    assert not torch.equal(first[0], p)


# K4's round, (n, nv, schedule, max_neighbors, max_success): the dense
# buckets, the cell's order 125 padded into 128, the branch's last order;
# then the acceptance cap at 0 and 1 and no candidate at all.
ROUND_STEPS, ROUND_CHAINS = 100, 250      # 250: an instance's last block
ROUND_CASES = ([(n, nv, schedule, 50, 10)
                for n, nv in ((32, 32), (64, 64), (128, 125), (128, 128),
                              (169, 169))
                for schedule in ("cauchy", "linear")]
               + [(128, 125, schedule, k, cap)
                  for schedule in ("cauchy", "linear")
                  for k, cap in ((50, 0), (50, 1), (0, 10))])


def _round_inputs(n, nv, schedule, seed, device):
    """Two integer instances of 250 chains each, at 5 to 500 degrees,
    Cauchy betas from 1e-4 to 0.05 and round keys; a cooling whose
    ``t_final`` some chains reach within the round and others do not."""
    C, M, p, _, f, temp, keys, nv_t = _inputs(n, nv, False, seed, device,
                                              ROUND_CHAINS, 1, insts=2)
    g = torch.Generator(device=device).manual_seed(seed)
    beta = 1e-4 + 0.05 * torch.rand(p.shape[0], generator=g, device=device)
    q = annealing._f32(0.95)
    return (C, M, p, f, temp, keys, nv_t,
            Cooling(schedule, q, annealing._f32(1.0), beta))


@pytest.mark.parametrize("n,nv,schedule,k,max_success", ROUND_CASES)
def test_qap_sa_step_round_is_single_steps_with_the_hosts_cooling(
        cuda, n, nv, schedule, k, max_success):
    """One round launch against 100 single-step launches with the step
    keys split and the temperature cooled and clamped on the host between
    them: p, f, best_p, best_f and the temperature, bit for bit."""
    C, M, p, f, temp, keys, nv_t, cooling = _round_inputs(n, nv, schedule,
                                                          n + k, cuda)
    kw = dict(max_neighbors=k, max_success=max_success)
    branches = ops.branch_counts()
    t_round = torch.empty_like(temp)
    got = ops.qap_sa_step(C, M, p, f, p.clone(), f.clone(), temp, keys, nv_t,
                          steps=ROUND_STEPS, cooling=cooling,
                          temp_out=t_round, **kw)
    moved = {key: v - branches[key] for key, v in ops.branch_counts().items()
             if v != branches[key]}
    assert moved == {"qap_sa_step/smem_round": 1}
    step_keys = split_key(keys, ROUND_STEPS)
    state, t = (p, f, p.clone(), f.clone()), temp
    for step in range(ROUND_STEPS):
        state = ops.qap_sa_step(C, M, *state, t,
                                step_keys[:, step].contiguous(), nv_t, **kw)
        if schedule == "linear":
            t = t * cooling.q
        else:
            t = t / (cooling.beta.double() * t.double() + 1.0).float()
        t = t.clamp_min(cooling.t_final)
    for g, w in zip((*got, t_round), (*state, t)):
        assert torch.equal(g, w)
    assert (t_round == cooling.t_final).any() and \
        (t_round > cooling.t_final).any()
    if k and max_success:
        assert not torch.equal(got[0], p)


def test_qap_sa_step_round_is_the_plain_round(cuda):
    """The round launch against its plain version on integer instances,
    and its refusal of an order past the shared-memory branch."""
    C, M, p, f, temp, keys, nv_t, cooling = _round_inputs(128, 125, "cauchy",
                                                          3, cuda)
    kw = dict(max_neighbors=50, max_success=10, steps=20)
    t_card = torch.empty_like(temp)
    got = ops.qap_sa_step(C, M, p, f, p.clone(), f.clone(), temp, keys, nv_t,
                          cooling=cooling, temp_out=t_card, **kw)
    args = [x.cpu() for x in (C, M, p, f, p, f, temp, keys, nv_t)]
    t_cpu = torch.empty_like(args[6])
    want = qap_sa_step_plain(*args, cooling=cooling._replace(
        beta=cooling.beta.cpu()), temp_out=t_cpu, **kw)
    for g, w in zip((*got, t_card), (*want, t_cpu)):
        assert torch.equal(g.cpu(), w)
    C, M, p, _, f, temp, keys, nv_t = _inputs(200, 193, False, 1, cuda)
    with pytest.raises(ValueError, match="shared-memory branch"):
        ops.qap_sa_step(C, M, p, f, p.clone(), f.clone(), temp, keys, nv_t,
                        cooling=cooling._replace(beta=temp.clone()),
                        temp_out=torch.empty_like(temp), **kw)


def _round_wave(n, nv, device):
    """Three padded integer instances and their keys, for
    ``anneal_chains``."""
    C, M, *_ = _inputs(n, nv, False, n, device, insts=3)
    C = mask_flows(C, torch.full((3,), nv, device=device))
    key = torch.as_tensor([[0, 11], [0, 12], [0, 13]], dtype=torch.int64,
                          device=device)
    return C, M, key, torch.full((3,), nv, dtype=torch.int64, device=device)


ROUND_CFG = annealing.SAConfig(max_neighbors=50, iters_per_exchange=20,
                               num_exchanges=3, solvers=25, loop="fused")


def test_fused_anneal_chains_is_its_loop_of_single_steps(cuda, monkeypatch):
    """PSA's body with a round a launch against the same body stepping
    each temperature level with its own launch (the loop ``_chain_round``
    keeps for the L2 branch): every chain's state and the history, bit
    for bit, at the cell's order 125 in the 128 bucket."""
    C, M, key, nv = _round_wave(128, 125, cuda)
    out = {}
    for steps in ("round", "single"):
        if steps == "single":
            monkeypatch.setattr(annealing, "_round_steps",
                                lambda cfg, p: 1)
        before = ops.branch_counts()
        out[steps] = annealing.anneal_chains(C, M, key, ROUND_CFG, 2, True,
                                             nv)
        moved = {k: v - before[k] for k, v in ops.branch_counts().items()
                 if v != before[k]}
        e, i = ROUND_CFG.num_exchanges, ROUND_CFG.iters_per_exchange
        assert moved == ({"qap_sa_step/smem_round": e} if steps == "round"
                         else {"qap_sa_step/smem": e * i})
    (state, hist), (state1, hist1) = out["round"], out["single"]
    for g, w in zip((*state, hist), (*state1, hist1)):
        assert torch.equal(g, w)


def test_round_counts_one_launch_an_exchange_and_tags_its_span(cuda):
    """A fused PSA solve at order 125 makes ``num_exchanges`` round
    launches and no other K4 launch; each ``solver.round`` span says
    ``steps=iters_per_exchange``."""
    from repro_torch import spans
    C, M, key, nv = _round_wave(128, 125, cuda)
    ops.reset_launch_counts()
    spans.enable()
    try:
        annealing.run_psa_batch(C, M, key, ROUND_CFG, 2, n_valid=nv,
                                device="cuda")
    finally:
        records = spans.drain()
        spans.disable()
    branches = ops.branch_counts()
    assert branches["qap_sa_step/smem_round"] == ROUND_CFG.num_exchanges
    assert ops.launch_counts()["qap_sa_step"] == ROUND_CFG.num_exchanges
    assert [s.attrs["steps"] for s in records if s.name == "solver.round"] \
        == [ROUND_CFG.iters_per_exchange] * ROUND_CFG.num_exchanges


def test_l2_orders_and_temperature_step_launch_a_step_at_a_time(cuda):
    """Order 200 (K4's L2 branch) runs a launch a temperature level, and
    so does ``temperature_step`` at order 128."""
    C, M, key, nv = _round_wave(200, 193, cuda)
    ops.reset_launch_counts()
    annealing.run_psa_batch(C, M, key, ROUND_CFG, 1, n_valid=nv,
                            device="cuda")
    e, i = ROUND_CFG.num_exchanges, ROUND_CFG.iters_per_exchange
    branches = ops.branch_counts()
    assert branches["qap_sa_step/l2"] == e * i
    assert branches["qap_sa_step/smem_round"] == 0
    C, M, p, _, f, temp, keys, nv_t = _inputs(128, 125, False, 2, cuda)
    state = annealing.SAState(p, f, p.clone(), f.clone(), temp)
    ops.reset_launch_counts()
    annealing.temperature_step(C, M, state, keys, ROUND_CFG, 1e-3,
                               nv_t.long())
    assert ops.branch_counts()["qap_sa_step/smem"] == 1
    assert ops.launch_counts()["qap_sa_step"] == 1


def test_qap_delta_unstaged_l2_kernel_matches_plain(cuda):
    """The first order whose rows K1's L2 branch cannot stage takes the
    same kernel reading its rows in place, counted apart."""
    from repro_torch.kernels.qap_delta import l2_plan
    n = 11618
    assert l2_plan(n)[1] == 0 and l2_plan(n - 1)[1] > 0
    rng = np.random.default_rng(n)
    g = torch.Generator(device=cuda).manual_seed(n)
    C = torch.randint(0, 10, (n, n), generator=g, device=cuda).float()
    M = torch.randint(1, 10, (n, n), generator=g, device=cuda).float()
    p = torch.as_tensor(np.stack([rng.permutation(n) for _ in range(2)]),
                        dtype=torch.int32, device=cuda)
    pairs = torch.as_tensor(np.sort(np.stack(
        [rng.choice(n, 2, replace=False) for _ in range(2 * 16)]), axis=1)
        .reshape(2, 16, 2).astype(np.int32), device=cuda)
    branches = ops.branch_counts()
    got = ops.qap_delta(C, M, p, pairs)
    after = ops.branch_counts()
    assert {k: after[k] - branches[k] for k in after
            if after[k] != branches[k]} == {"qap_delta/l2_unstaged": 1}
    assert torch.equal(got, qap_delta_plain(C, M, p, pairs))


def test_qap_objective_l2_kernel_at_the_dense_baseline(cuda):
    """K2 at sparse_scale's dense baseline, 8 permutations of one
    order-4096 instance, 0/1 entries (F < 2^24: exact)."""
    n = 4096
    g = torch.Generator(device=cuda).manual_seed(n)
    C = torch.randint(0, 2, (n, n), generator=g, device=cuda).float()
    M = torch.randint(0, 2, (n, n), generator=g, device=cuda).float()
    perms = torch.stack([torch.randperm(n, generator=g, device=cuda)
                         for _ in range(8)]).int()[None].contiguous()
    branches = ops.branch_counts()
    got = ops.qap_objective(C, M, perms)
    assert _launched_on("qap_objective", n, branches)
    want = qap_objective_plain(C, M, perms)
    assert float(want.max()) < 2 ** 24
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [200, 343])
def test_qap_objective_l2_kernel_is_deterministic(cuda, n):
    """On real-valued flows K2's L2 branch gives the same bits on a second
    call and for each permutation alone (its tiles depend on the order
    alone), within 1e-5 of the plain version."""
    rng = np.random.default_rng(n)
    C = torch.as_tensor(rng.random((2, n, n)).astype(np.float32) * 7.3,
                        device=cuda)
    M = torch.as_tensor(rng.random((2, n, n)).astype(np.float32) * 3.1,
                        device=cuda)
    perms = torch.as_tensor(np.stack([np.stack([rng.permutation(n)
                                                for _ in range(12)])
                                      for _ in range(4)]),
                            dtype=torch.int32, device=cuda)
    got = ops.qap_objective(C, M, perms)
    assert torch.equal(got, ops.qap_objective(C, M, perms))
    for b in range(4):
        for j in range(12):
            alone = ops.qap_objective(C[b // 2], M[b // 2],
                                      perms[b, j][None, None].contiguous())
            assert torch.equal(alone[0, 0], got[b, j])
    want = qap_objective_plain(C, M, perms)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    C, M, p, pairs, *_ = _inputs(16, 16, True, 0, cuda)
    with pytest.raises(ValueError, match="int32"):
        ops.qap_delta(C, M, p.long(), pairs)
    with pytest.raises(ValueError, match="divide"):
        ops.qap_delta(torch.stack([C] * 3), torch.stack([M] * 3), p, pairs)
    # an order neither branch of K4 takes: past the fused cap, its L2
    # branch's lanes no longer hold a chain's permutation in registers
    n = 769
    big = torch.empty((n, n), device=cuda)
    p_big = torch.arange(n, dtype=torch.int32, device=cuda)[None]
    one = torch.ones(1, device=cuda)
    with pytest.raises(ValueError, match=f"order {n}"):
        ops.qap_sa_step(big, big, p_big, one, p_big, one, one,
                        torch.zeros((1, 2), dtype=torch.int64, device=cuda),
                        torch.full((1,), n, dtype=torch.int32, device=cuda),
                        max_neighbors=K, max_success=6, CT=big, MT=big)
    del big
    C, M, pops, fits, keys, nvs = _islands(16, 16, True, 0, cuda, pop=4)
    with pytest.raises(ValueError, match="int32"):
        ops.qap_objective(C, M, pops.long())
    with pytest.raises(ValueError, match="n_off"):
        ops.qap_ga_step(C, M, pops, fits, keys, nvs, n_off=5, tournament=2,
                        p_crossover=1.0, p_mutation=0.1)


@pytest.mark.parametrize("loop", ["event", "fused"])
def test_engine_on_card_matches_engine_on_cpu(cuda, loop):
    cfg = annealing.SAConfig(max_neighbors=25, iters_per_exchange=10,
                             num_exchanges=4, solvers=4, loop=loop)
    reqs = [MapRequest(job_id=f"n{n}-v{v}", C=inst.C, M=inst.M, seed=v)
            for n in (27, 45) for v in (1, 2)
            for inst in [instances.make_taie(n, version=v)]]
    out = {}
    for device in ("cuda", "cpu"):
        engine = MappingEngine(sa_cfg=cfg, polish_rounds=50, device=device)
        futs = [engine.submit(r) for r in reqs]
        engine.flush()
        out[device] = [f.result() for f in futs]
    for g, c in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(g.perm, c.perm)
        assert g.objective == c.objective


@pytest.mark.parametrize("algorithm,ga_eval", [("pga", "wide"), ("pga", "fused"),
                                               ("pca", "wide")])
def test_ga_engine_on_card_matches_engine_on_cpu(cuda, algorithm, ga_eval):
    sa = annealing.SAConfig(max_neighbors=25, iters_per_exchange=10,
                            num_exchanges=4, solvers=8)
    ga = genetic.GAConfig(generations=20, pop_size=32, eval=ga_eval)
    reqs = [MapRequest(job_id=f"n{n}-v{v}", C=inst.C, M=inst.M, seed=v,
                       algorithm=algorithm)
            for n in (27, 45) for v in (1, 2)
            for inst in [instances.make_taie(n, version=v)]]
    out = {}
    for device in ("cuda", "cpu"):
        engine = MappingEngine(sa_cfg=sa, ga_cfg=ga, polish_rounds=50,
                               device=device)
        futs = [engine.submit(r) for r in reqs]
        engine.flush()
        out[device] = [f.result() for f in futs]
    for g, c in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(g.perm, c.perm)
        assert g.objective == c.objective


@pytest.mark.parametrize("algorithm", ["psa", "pga"])
def test_oversize_engine_on_card_matches_engine_on_cpu(cuda, algorithm):
    """A 200-process request (a 10 x 20 torus allocation) has no dense
    bucket and lies below the multilevel route: the engine solves it at
    its own size, every K1 and K2 launch on the L2 branch, card == CPU."""
    sa = annealing.SAConfig(max_neighbors=25, iters_per_exchange=10,
                            num_exchanges=4, solvers=4)
    ga = genetic.GAConfig(generations=20, pop_size=32)
    inst = exact.make_torus((10, 20))
    req = MapRequest(job_id="torus200", C=inst.C, M=inst.M, seed=3,
                     algorithm=algorithm)
    out = {}
    for device in ("cuda", "cpu"):
        engine = MappingEngine(sa_cfg=sa, ga_cfg=ga, polish_rounds=50,
                               device=device)
        ops.reset_launch_counts()
        fut = engine.submit(req)
        engine.flush()
        out[device] = fut.result()
        if device == "cuda":
            counts, branches = ops.launch_counts(), ops.branch_counts()
            assert out[device].bucket is None
            assert counts["qap_delta"] == branches["qap_delta/l2"] > 0
            assert counts["qap_objective"] == branches["qap_objective/l2"]
            assert (counts["qap_objective"] > 0) == (algorithm == "pga")
    np.testing.assert_array_equal(out["cuda"].perm, out["cpu"].perm)
    assert out["cuda"].objective == out["cpu"].objective
    assert inst.optimum <= out["cuda"].objective <= out["cuda"].baseline


@pytest.mark.parametrize("algorithm", ["psa", "pga", "pca"])
def test_four_shard_engine_on_one_card_matches_unsharded(cuda, algorithm):
    """A mesh that names cuda:0 four times: a three-request wave pads to
    four shards and trims back, every response equal to the unsharded
    engine's on the card."""
    from repro_torch.launch.mesh import (canonical_device, make_instance_mesh,
                                         make_mesh_with_devices)
    with pytest.raises(ValueError, match="num_devices"):
        make_instance_mesh(torch.cuda.device_count() + 1)
    mesh = make_mesh_with_devices([torch.device("cuda", 0)] * 4, (4,),
                                  ("instances",))
    sa = annealing.SAConfig(max_neighbors=25, iters_per_exchange=10,
                            num_exchanges=4, solvers=8)
    ga = genetic.GAConfig(generations=20, pop_size=32)
    reqs = [MapRequest(job_id=f"n{n}-v{v}", C=inst.C, M=inst.M, seed=v,
                       algorithm=algorithm)
            for n in (27, 45) for v in (1, 2, 3)
            for inst in [instances.make_taie(n, version=v)]]
    out = {}
    for name, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
        engine = MappingEngine(sa_cfg=sa, ga_cfg=ga, polish_rounds=50, **kw)
        # the unsharded engine's "cuda" is the current card, cuda:0
        assert canonical_device(engine.device) == torch.device("cuda", 0)
        futs = [engine.submit(r) for r in reqs]
        engine.flush()
        out[name] = [f.result() for f in futs]
    for g, c in zip(out["mesh"], out["plain"]):
        np.testing.assert_array_equal(g.perm, c.perm)
        assert g.objective == c.objective


# (n, D): ragged lane edges (D = 1, 31, 33), both sides of K7's lane-group
# edges (8 lanes a candidate up to D = 8, 16 up to 16, a warp above), and
# the multilevel route's widths (D = 6 at its finest 4096 level, 46 at its
# coarsest).
SPARSE_CASES = [(130, 1), (130, 8), (130, 9), (130, 16), (130, 17),
                (130, 33), (1000, 6), (1000, 31), (1000, 32), (4096, 6),
                (4096, 46)]


def _sparse_inputs(n, D, shared, seed, device, chains=8, perms=4, k=K,
                   insts=2):
    """Integer ELL flows of max degree exactly D (a circulant with some
    entries zeroed, row 0 kept full), one shared instance or ``insts``,
    integer distances, ``chains`` permutations, ``perms`` more per chain
    row, and ``k`` candidate pairs each."""
    rng = np.random.default_rng(seed)
    b0 = 1 if shared else insts
    offsets = rng.choice(np.arange(1, n), D, replace=False)
    rows = np.repeat(np.arange(n), D)
    cols = (rows + np.tile(offsets, n)) % n
    Cs = np.zeros((b0, n, n), np.float32)
    Ms = np.zeros((b0, n, n), np.float32)
    for i in range(b0):
        w = rng.integers(1, 10, rows.size).astype(np.float32)
        w[D:][rng.random(rows.size - D) < 0.2] = 0.0
        Cs[i, rows, cols] = w
        M = rng.integers(1, 10, (n, n)).astype(np.float32)
        Ms[i] = M + M.T
    S = sparse.from_dense(Cs[0] if shared else Cs, width=D, device=device)
    assert S.max_degree == D
    ps = np.stack([rng.permutation(n) for _ in range(chains)]).astype(np.int32)
    many = np.stack([rng.permutation(n) for _ in range(chains * perms)])
    pairs = np.sort(np.stack([rng.choice(n, 2, replace=False)
                              for _ in range(chains * k)]), axis=1)
    t = lambda x: torch.as_tensor(x, device=device)
    return (S, t(Ms[0] if shared else Ms), t(ps),
            t(many.astype(np.int32).reshape(chains, perms, n)),
            t(pairs.reshape(chains, k, 2).astype(np.int32)))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("n,D", SPARSE_CASES)
def test_qap_objective_sparse_kernel_matches_plain(cuda, n, D, shared):
    S, M, _, perms, _ = _sparse_inputs(n, D, shared, n + D, cuda)
    before = ops.launch_counts()["qap_objective_sparse"]
    got = ops.qap_objective(S, M, perms)
    assert ops.launch_counts()["qap_objective_sparse"] == before + 1
    assert torch.equal(got, qap_objective_sparse_plain(S, M, perms))


@functools.lru_cache(maxsize=None)
def _torus_levels():
    """The multilevel route's 4096 torus, coarsened at the default
    MultilevelConfig: ``[(C, M, ...), ...]``, orders 4096 ... 128 with
    ELL widths 6, 12, 22, 30, 38, 46."""
    inst = exact.make_torus((16, 16, 16))
    return multilevel.coarsen_levels(inst.C, inst.M,
                                     multilevel.MultilevelConfig())[0]


def _level_inputs(level, per, shared, device, real=False):
    """Level ``level`` of the torus as shared leaves or the engine's
    one-instance batch, and ``per`` random permutations ``(1, per, N)``;
    ``real`` scales C and M by uniform weights (no sum exact)."""
    C, M = _torus_levels()[level][:2]
    n = C.shape[0]
    rng = np.random.default_rng(n + per)
    if real:
        C = C * rng.random(C.shape).astype(np.float32)
        M = M * rng.random(M.shape).astype(np.float32)
    S = sparse.from_dense(C if shared else C[None], device=device)
    Mt = torch.as_tensor(M if shared else M[None], device=device)
    perms = np.stack([rng.permutation(n) for _ in range(per)])
    return S, Mt, torch.as_tensor(perms.astype(np.int32).reshape(1, per, n),
                                  device=device)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("per", [1, 4, 256])
@pytest.mark.parametrize("level", range(6))
def test_qap_objective_sparse_kernel_at_the_torus_levels(cuda, level, per,
                                                         shared):
    """K6 at every level of the multilevel route's 4096 torus, at the
    route's 1 x 1 (``make_beta``, ``_seed_chain0``) and 1 x 4 (chain
    start), which take 16-block clusters, and at 1 x 256, which takes one
    block a permutation; shared and batched: one launch a call, equal to
    the plain version bit for bit."""
    S, M, perms = _level_inputs(level, per, shared, cuda)
    before = ops.launch_counts()["qap_objective_sparse"]
    got = ops.qap_objective_sparse(S, M, perms)
    assert ops.launch_counts()["qap_objective_sparse"] == before + 1
    assert torch.equal(got, qap_objective_sparse_plain(S, M, perms))


@pytest.mark.parametrize("level", [0, 5])
def test_qap_objective_sparse_kernel_is_deterministic(cuda, level):
    """On real-valued flows and distances K6 sums in a fixed order: two
    calls give the same bits, a permutation scored alone the same bits
    as in a batch of four (the same cluster on the card), and the result
    is within 1e-5 of the plain version's largest |F|."""
    S, M, perms = _level_inputs(level, 4, False, cuda, real=True)
    n = perms.shape[-1]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert objective_sparse_launch(n, 1, sms)[1] == \
        objective_sparse_launch(n, 4, sms)[1]
    got = qap_objective_sparse_cuda(S, M, perms)
    assert torch.equal(qap_objective_sparse_cuda(S, M, perms), got)
    for j in range(4):
        one = qap_objective_sparse_cuda(S, M, perms[:, j:j + 1].contiguous())
        assert torch.equal(one[0, 0], got[0, j])
    want = qap_objective_sparse_plain(S, M, perms)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("n,D", SPARSE_CASES)
def test_qap_delta_sparse_kernel_matches_plain(cuda, n, D, shared):
    S, M, p, _, pairs = _sparse_inputs(n, D, shared, 2 * n + D, cuda)
    before = ops.launch_counts()["qap_delta_sparse"]
    got = ops.qap_delta(S, M, p, pairs)
    assert ops.launch_counts()["qap_delta_sparse"] == before + 1
    assert torch.equal(got, qap_delta_sparse_plain(S, M, p, pairs))
    assert torch.equal(ops.qap_delta_sparse(S, M, p, pairs), got)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("n,D", [(130, 8), (130, 9), (1000, 32),
                                 (4096, 6), (4096, 46)])
def test_qap_delta_sparse_kernel_at_the_polish_shape(cuda, n, D, shared):
    """K7 at the polish's one permutation x 256 candidates, shared leaves
    and the engine's one-instance batch, bit for bit."""
    S, M, p, _, pairs = _sparse_inputs(n, D, shared, 3 * n + D, cuda,
                                       chains=1, k=256, insts=1)
    before = ops.launch_counts()["qap_delta_sparse"]
    got = ops.qap_delta_sparse(S, M, p, pairs)
    assert ops.launch_counts()["qap_delta_sparse"] == before + 1
    assert torch.equal(got, qap_delta_sparse_plain(S, M, p, pairs))


def test_sparse_flows_take_no_transposes_on_the_card(cuda):
    """K7 reads M alone: a solve on sparse flows makes no M^T."""
    S, M, _, _, _ = _sparse_inputs(130, 6, False, 1, cuda)
    assert ops.transposes(S, M) == (None, None)
    C = sparse.to_dense(S)
    CT, MT = ops.transposes(C, M)
    assert torch.equal(CT, C.transpose(1, 2)) and torch.equal(MT, M.transpose(1, 2))


def test_sparse_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    S, M, p, perms, pairs = _sparse_inputs(130, 6, True, 0, cuda)
    with pytest.raises(ValueError, match="int32"):
        ops.qap_objective_sparse(S, M, perms.long())
    with pytest.raises(ValueError, match="int32"):
        ops.qap_delta_sparse(S, M, p.long(), pairs)
    with pytest.raises(ValueError, match="cols"):
        ops.qap_delta_sparse(S._replace(cols=S.cols.long()), M, p, pairs)
    with pytest.raises(ValueError, match="divide"):
        ops.qap_delta_sparse(S, torch.stack([M] * 3), p, pairs)


def test_multilevel_engine_on_card_matches_engine_on_cpu(cuda):
    cfg = multilevel.MultilevelConfig(coarse_n=16)
    reqs = [MapRequest(job_id=f"torus{i}", C=inst.C, M=inst.M, seed=i)
            for i, inst in enumerate([exact.make_torus((8, 8)),
                                      exact.make_torus((4, 4, 4), version=2)])]
    out = {}
    for device in ("cuda", "cpu"):
        engine = MappingEngine(buckets=(32,), large_buckets=(64,),
                               multilevel_min_n=64, multilevel_cfg=cfg,
                               device=device)
        ops.reset_launch_counts()
        futs = [engine.submit(r) for r in reqs]
        engine.flush()
        out[device] = [f.result() for f in futs]
        counts = ops.launch_counts()
        launched = counts["qap_delta_sparse"] > 0 and \
            counts["qap_objective_sparse"] > 0 and counts["qap_delta"] > 0
        assert launched == (device == "cuda"), counts
    for g, c, r in zip(out["cuda"], out["cpu"], reqs):
        np.testing.assert_array_equal(g.perm, c.perm)
        assert g.objective == c.objective and g.bucket == 64
        assert float(r.C.sum()) <= g.objective <= g.baseline


def test_resource_manager_on_card_matches_cpu(cuda):
    """A small trace through the manager: one engine on the card, a
    subprocess fleet on the card whose worker 0 SIGKILLs itself, and one
    engine on the CPU make the same decisions."""
    from repro_torch.serve import (EngineFleet, FaultPlan, ResourceManager,
                                   synthetic_trace)
    kw = dict(sa_cfg=annealing.SAConfig(max_neighbors=10, iters_per_exchange=8,
                                        num_exchanges=4, solvers=4),
              buckets=(8, 16), polish_rounds=20, warm_start=False)
    M = exact.torus_distance_matrix((4, 4, 2))

    def replay(engine):
        rm = ResourceManager(M, engine, map_timeout_s=120.0)
        for spec in synthetic_trace(6, sizes=(4, 8, 16), arrival_rate=0.5,
                                    mean_run_s=20.0, seed=1):
            rm.submit_job(spec)
        rm.run()
        return {h.job_id: (h.start_s, h.allocation.nodes.tolist(),
                           h.response.perm.tolist(), h.response.objective)
                for h in rm.handles}

    ops.reset_launch_counts()
    card = replay(MappingEngine(**kw))
    assert ops.launch_counts()["qap_delta"] > 0
    fleet = EngineFleet(workers=2, transport="subprocess",
                        fault_plan=FaultPlan(sigkill_worker_at={0: 2}), **kw)
    try:
        assert replay(fleet) == card
    finally:
        fleet.stop()
    assert fleet.stats.worker_deaths == 1 and fleet.stats.failed == 0
    assert replay(MappingEngine(device="cpu", **kw)) == card


def _scan_args(shape, device):
    bsz, s, d, n = shape
    rng = np.random.default_rng(sum(shape))
    u = torch.as_tensor(rng.standard_normal((bsz, s, d)), dtype=torch.float32)
    dt = torch.as_tensor(rng.uniform(0.001, 0.1, (bsz, s, d)),
                         dtype=torch.float32)
    a = torch.as_tensor(-rng.uniform(0.1, 1.0, (d, n)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((bsz, s, n)), dtype=torch.float32)
    c = torch.as_tensor(rng.standard_normal((bsz, s, n)), dtype=torch.float32)
    return [x.to(device) for x in (u, dt, a, b, c)]


# (B, S, D, N) across K8's tiling (32-step chunks, 32-channel blocks): one
# chunk and a ragged one, a single ragged channel block, B = 1, and both
# d_states.
SCAN_CASES = [(1, 31, 33, 16), (1, 32, 32, 4), (1, 65, 70, 16),
              (3, 33, 8, 4), (2, 96, 1000, 16)]


@pytest.mark.parametrize("shape", SCAN_CASES)
def test_selective_scan_across_the_tiling_matches_plain(cuda, shape):
    """K8 from aligned inputs and from a misaligned ``u``: y within
    2e-4 * max|y| of the plain version, h_last equal to it (h is updated
    in the plain version's order; only y's sum over the states is
    reordered)."""
    args = _scan_args(shape, cuda)
    want_y, want_h = selective_scan_plain(*args)
    # u one float past a 16-byte line: the kernel stages 4 bytes a copy
    odd = torch.empty(args[0].numel() + 1, device=cuda)[1:].view(
        args[0].shape).copy_(args[0])
    for u in (args[0], odd):
        before = ops.launch_counts()["selective_scan"]
        y, h = selective_scan_cuda(u, *args[1:])
        torch.cuda.synchronize()
        assert ops.launch_counts()["selective_scan"] == before + 1
        assert float((y - want_y).abs().max()) <= \
            2e-4 * float(want_y.abs().max())
        assert torch.equal(h, want_h)


@pytest.mark.parametrize("shape", [(2, 49, 200, 4), (2, 130, 1024, 16)])
def test_selective_scan_kernel_matches_plain(cuda, shape):
    """K8 at a ragged shape (S and D not multiples of the kernel's 32-step
    chunk and 32-channel block) and at Jamba's d_state of 16: within
    2e-4 * max|y| of the plain version (the JAX kernel test's bar), the
    final state too."""
    args = _scan_args(shape, cuda)
    before = ops.launch_counts()["selective_scan"]
    y, h = ops.selective_scan(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["selective_scan"] == before + 1
    want_y, want_h = selective_scan_plain(*args)
    for got, want in ((y, want_y), (h, want_h)):
        assert float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())
    with pytest.raises(ValueError, match="float32"):
        ops.selective_scan(args[0].double(), *args[1:])


@pytest.mark.parametrize("shape", [(2, 49, 200, 4), (2, 130, 1024, 16)])
def test_selective_scan_gradient_on_the_card_matches_plain(cuda, shape):
    """K8 under autograd: its outputs carry a ``grad_fn`` (no gradient
    through the scan is dropped), the forward is one K8 launch, and every
    input's gradient is within 2e-4 of its largest magnitude of autograd
    through the plain scan on the same inputs."""
    args = [x.requires_grad_(True) for x in _scan_args(shape, cuda)]
    rng = np.random.default_rng(1)
    gy = torch.as_tensor(rng.standard_normal(tuple(args[0].shape)),
                         dtype=torch.float32, device=cuda)
    gh = torch.as_tensor(rng.standard_normal(
        (shape[0], shape[2], shape[3])), dtype=torch.float32, device=cuda)
    before = ops.launch_counts()["selective_scan"]
    y, h = ops.selective_scan(*args)
    assert y.grad_fn is not None and h.grad_fn is not None
    assert ops.launch_counts()["selective_scan"] == before + 1
    got = torch.autograd.grad((y, h), args, (gy, gh))
    plain_args = [x.detach().requires_grad_(True) for x in args]
    want = torch.autograd.grad(selective_scan_plain(*plain_args), plain_args,
                               (gy, gh))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 2e-4 * float(w.abs().max())


def test_jamba_train_loss_grads_on_card_match_cpu(cuda):
    """Jamba's SMOKE width in f32: ``Model.loss`` and every weight's
    gradient on the card within 1e-4 of the CPU's (of the leaf's largest
    magnitude); the card's forward launches K8 once per Mamba layer and
    again in each layer's recomputation, and every Mamba weight gets a
    nonzero gradient."""
    from repro_torch.models.param import tree_flatten, tree_unflatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.smoke_config("jamba_v0_1_52b").with_overrides(
        compute_dtype=torch.float32)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 49))
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    out = {}
    for device in ("cuda", "cpu"):
        leaves, treedef = tree_flatten(params)
        leaves = [l.to(device).requires_grad_(True) for l in leaves]
        batch = {k: torch.as_tensor(v, dtype=torch.int32, device=device)
                 for k, v in (("tokens", toks[:, :-1]),
                              ("labels", toks[:, 1:]))}
        ops.reset_launch_counts()
        loss = Model(cfg, device=device).loss(tree_unflatten(treedef, leaves),
                                              batch)
        grads = torch.autograd.grad(loss, leaves)
        mamba = sum(ch in "mM" for ch in cfg.layer_pattern)
        assert ops.launch_counts()["selective_scan"] == (
            2 * mamba if device == "cuda" else 0)
        out[device] = (loss.detach().cpu(), [g.cpu() for g in grads],
                       tree_unflatten(treedef, [g.cpu() for g in grads]))
    (lc, gc, tc), (lp, gp, _) = out["cuda"], out["cpu"]
    assert abs(float(lc) - float(lp)) <= 1e-5 * abs(float(lp))
    for a, b in zip(gc, gp):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    for ch, p in zip(cfg.layer_pattern, tc["unit"]):
        if ch in "mM":
            assert all(bool(g.abs().max() > 0) for g in p["mixer"].values())


def test_lm_engine_on_card_matches_engine_on_cpu(cuda):
    """Jamba's SMOKE width in f32, weights drawn once on the CPU: the
    card's greedy tokens equal the CPU's and its prefill logits agree to
    1e-4 * max|logit| (sums in other orders, no TF32); the card's prefill
    launches K8 once per Mamba layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.smoke_config("jamba_v0_1_52b").with_overrides(
        compute_dtype=torch.float32)
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, (2, 49)).astype(np.int32)
    out, logits = {}, {}
    for device in ("cuda", "cpu"):
        model = Model(cfg, device=device)
        params = model.init(torch.Generator().manual_seed(0))
        ops.reset_launch_counts()
        logits[device], _ = model.prefill(
            params, {"tokens": torch.as_tensor(prompts, device=device)})
        launches = ops.launch_counts()["selective_scan"]
        assert launches == (cfg.layer_pattern.count("m")
                            + cfg.layer_pattern.count("M")
                            if device == "cuda" else 0)
        out[device] = Engine(model, params,
                             ServeConfig(max_new_tokens=8)).generate(prompts)
    np.testing.assert_array_equal(out["cuda"], out["cpu"])
    want = logits["cpu"]
    err = float((logits["cuda"].cpu() - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["rwkv6_7b", "musicgen_medium",
                                  "internvl2_76b"])
def test_lm_families_on_card_match_cpu(cuda, arch):
    """RWKV6's and the frontend models' SMOKE widths in f32, weights drawn
    once on the CPU: prefill logits (from ``embeds`` for the frontend
    models) within 1e-4 * max|logit| of the CPU's, a decode step's too,
    and the greedy tokens of ``Engine.generate`` equal."""
    from repro_torch.models.transformer import FRONTEND_DIMS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.smoke_config(arch).with_overrides(
        compute_dtype=torch.float32)
    rng = np.random.default_rng(4)
    prompts = rng.integers(2, cfg.vocab_size, (2, 49)).astype(np.int32)
    batch = {"tokens": prompts}
    if cfg.frontend is not None:
        batch = {"embeds": rng.standard_normal(
            (2, 49, FRONTEND_DIMS[cfg.frontend])).astype(np.float32)}
    out = {}
    for device in ("cuda", "cpu"):
        model = Model(cfg, device=device)
        params = model.init(torch.Generator().manual_seed(0))
        inputs = {k: torch.as_tensor(v, device=device)
                  for k, v in batch.items()}
        logits, cache = model.prefill(
            params, {k: v[:, :48] for k, v in inputs.items()}, cache_len=56)
        step, _ = model.decode_step(
            params, cache, {k: v[:, 48:] for k, v in inputs.items()}, 48)
        gen = Engine(model, params, ServeConfig(max_new_tokens=8)).generate(
            prompts)
        out[device] = (logits.cpu(), step.cpu(), gen)
    (lc, sc, gc), (lp, sp, gp) = out["cuda"], out["cpu"]
    for got, want in ((lc, lp), (sc, sp)):
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
    np.testing.assert_array_equal(gc, gp)


def test_lowering_a_cell_allocates_no_card_memory(cuda):
    """``launch.lowering`` runs the step on ``meta``: Qwen3-4B at full
    width on a (64, 1) mesh's ``train_4k`` cell leaves the card's
    allocation as it was."""
    from repro_torch.launch import lowering
    from repro_torch.launch.mesh import make_mesh_with_devices
    from repro_torch.models.config import shape_cell
    mesh = make_mesh_with_devices(["cuda:0"] * 64, (64, 1),
                                  ("data", "model"))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cell = lowering.lower_train_cell(configs.get_config("qwen3_4b"),
                                     shape_cell("train_4k"), mesh)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert cell.num_devices == 64 and len(cell.collectives) > 0
    assert all(op.groups == [list(range(64))] for op in cell.collectives)


def _world_on_the_card_matches_cpu(size, backend):
    """``size`` ranks of ``backend`` on cuda:0 run Qwen3's SMOKE
    data-parallel step (f32, weights from a CPU generator) with one CPU
    device's first-step gradients and per-step losses, every rank's
    collectives the lowered cell's."""
    import _torch_dp_world as dpw
    from repro_torch.launch import lowering
    from repro_torch.launch.mesh import make_mesh_with_devices
    from repro_torch.launch.world import run_world
    from repro_torch.models.param import tree_flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = run_world(dpw.dp_rank, size, device_type="cuda",
                      backend=backend, args=("cuda",), timeout_s=600)
    loss, grads, losses = dpw.one_device("cpu")
    mesh = make_mesh_with_devices(["cuda:0"] * size, (size, 1), dpw.AXES)
    lowered = lowering.lower_train_cell(dpw.config(), dpw.CELL, mesh)
    for rank in ranks:
        assert rank["backend"] == backend
        assert rank["loss"] == pytest.approx(loss, rel=1e-4)
        np.testing.assert_allclose(rank["losses"], losses, rtol=1e-4)
        for g, want in zip(tree_flatten(rank["grads"])[0], grads):
            assert float(np.abs(g - want).max()) <= \
                1e-4 * float(np.abs(want).max())
        assert all(trace == lowered.collectives for trace in rank["traces"])


def test_data_parallel_world_on_the_card_matches_cpu(cuda):
    """4 gloo ranks on cuda:0 (reduce-scatter as all-reduce and slice)."""
    _world_on_the_card_matches_cpu(4, "gloo")


def test_data_parallel_step_on_an_nccl_rank_matches_cpu(cuda):
    """One NCCL rank on cuda:0: the NCCL branch of
    ``collectives.reduce_scatter`` (``reduce_scatter_tensor``).  Its shard
    order on a placed mesh is held on the CPU, where gloo's own
    ``reduce_scatter_tensor`` runs the same branch
    (``tests/test_torch_placement_job.py``, ``placed_native``)."""
    _world_on_the_card_matches_cpu(1, "nccl")


def test_placed_nccl_world_on_four_cards_matches_one_card(cuda):
    """``launch.train.train`` on a (4, 1) mesh of four cards with
    ``placement="psa"``: one NCCL rank a card (the launcher's choice) on
    the placed mesh, so every reduce-scatter goes through NCCL's
    ``reduce_scatter_tensor`` in the positions' order; gain 1/3, the
    losses one card's on the same batches, every rank's collectives the
    lowered cell's.  Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    import _torch_dp_world as dpw
    from repro_torch.launch import lowering, train as launch_train
    from repro_torch.launch.mesh import make_mesh_with_devices
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dpw.config()
    kw = dict(steps=dpw.STEPS, global_batch=dpw.CELL.global_batch,
              seq_len=dpw.CELL.seq_len, lr=dpw.LR, warmup=dpw.WARMUP,
              log_every=1, seed=dpw.SEED)
    one = launch_train.train(cfg, device="cuda:0", **kw)
    mesh = make_mesh_with_devices([f"cuda:{i}" for i in range(dpw.WORLD)],
                                  dpw.MESH_SHAPE, dpw.AXES)
    world = launch_train.train(cfg, mesh=mesh, placement="psa", **kw)
    assert world["placement"]["perm"] != list(range(dpw.WORLD))
    assert world["placement"]["gain"] == pytest.approx(1 / 3, abs=1e-6)
    np.testing.assert_allclose([h["loss"] for h in world["history"]],
                               [h["loss"] for h in one["history"]],
                               rtol=1e-4)
    lowered = lowering.lower_train_cell(cfg, dpw.CELL, mesh)
    assert all(rank["trace"] == lowered.collectives
               for rank in world["ranks"])


def test_lowering_the_production_mesh_allocates_no_card_memory(cuda):
    """Qwen3-4B at full width (2 layers) on the (16, 16) mesh's
    ``train_4k`` cell: the tensor-parallel step runs on ``meta``."""
    from repro_torch.launch import lowering
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import shape_cell
    cfg = configs.get_config("qwen3_4b").with_overrides(
        num_layers=2, layer_pattern="TT")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cell = lowering.lower_train_cell(cfg, shape_cell("train_4k"),
                                     make_production_mesh())
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    ids = np.arange(256).reshape(16, 16)
    assert {op.kind for op in cell.collectives
            if op.groups == ids.tolist()} == \
        {"all-gather", "all-reduce", "reduce-scatter"}
    assert all(op.groups in (ids.tolist(), ids.T.tolist())
               for op in cell.collectives)


@pytest.mark.parametrize("arch", ["qwen3_4b", "jamba_v0_1_52b"])
def test_tensor_parallel_world_on_the_card_matches_cpu(cuda, arch):
    """4 gloo ranks on cuda:0 as a (2, 2) mesh: the first step's loss and
    gradients, on the mesh and on a placed order of its ranks, and three
    steps' losses are one CPU device's; every step issues one trace (the
    lowered cell's for Qwen3); Jamba's ranks launch K8 on their channel
    slices (the backward's collectives run on the autograd engine's
    device thread, and are recorded all the same)."""
    import _torch_tp_world as tpw
    from repro_torch.launch import lowering
    from repro_torch.launch.mesh import make_mesh_with_devices
    from repro_torch.launch.world import run_world
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = run_world(tpw.tp_rank, 4, device_type="cuda", backend="gloo",
                      args=(arch, (2, 2), (3, 1, 0, 2), "cuda"),
                      timeout_s=600)
    loss, grads, losses = tpw.one_device(arch, "cpu")
    for rank in ranks:
        for got_loss, got, _ in (rank["first"], rank["placed"]):
            assert got_loss == pytest.approx(loss, rel=1e-4)
            for g, want in zip(got, grads):
                assert float(np.abs(g - want).max()) <= \
                    1e-4 * float(np.abs(want).max())
        np.testing.assert_allclose(rank["losses"], losses, rtol=1e-4)
        assert all(t == rank["traces"][0] for t in rank["traces"])
        if arch == "jamba_v0_1_52b":
            assert rank["launches"]["selective_scan"] > 0
    if arch == "qwen3_4b":
        mesh = make_mesh_with_devices(["cuda:0"] * 4, (2, 2), tpw.AXES)
        lowered = lowering.lower_train_cell(tpw.config(arch), tpw.CELL, mesh)
        assert all(rank["traces"][0] == lowered.collectives
                   for rank in ranks)


def test_selective_scan_on_meta_launches_nothing(cuda):
    """On ``meta`` tensors (a step lowered without devices) the scan gives
    the outputs' shapes and launches nothing; on the card's tensors it
    still launches K8."""
    shape = (2, 49, 200, 4)
    args = _scan_args(shape, cuda)
    before = ops.launch_counts()["selective_scan"]
    y, h = ops.selective_scan(*[x.to("meta") for x in args])
    assert y.device.type == h.device.type == "meta"
    assert y.shape == (2, 49, 200) and h.shape == (2, 200, 4)
    assert ops.launch_counts()["selective_scan"] == before
    ops.selective_scan(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["selective_scan"] == before + 1


def test_moe_histogram_on_the_card_is_bincount(cuda):
    from repro_torch.models import moe
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 128, 4096),
                          device=cuda)
    assert torch.equal(moe._histogram(ids, 128),
                       torch.bincount(ids, minlength=128))


@pytest.mark.parametrize("name", ["jamba-2x2", "rwkv-2x2"])
def test_expert_parallel_world_on_the_card_matches_cpu(cuda, name):
    """Jamba SMOKE with 16 experts over ep and RWKV6 SMOKE on a (2, 2)
    mesh of 4 gloo ranks on cuda:0: the first step's loss and gradients
    within 1e-4 of one CPU device's (of each leaf's largest magnitude),
    and K8 launched on every rank of the Jamba world."""
    import _torch_ep_world as epw
    from repro_torch.launch.world import run_world
    torch.backends.cuda.matmul.allow_tf32 = False
    case = {"jamba-2x2": ("jamba_v0_1_52b", dict(num_experts=16), (2, 2),
                          False),
            "rwkv-2x2": ("rwkv6_7b", {}, (2, 2), False)}[name]
    ranks = run_world(epw.ep_rank, 4, device_type="cuda", backend="gloo",
                      args=([case], "cuda"), timeout_s=600)
    loss, grads = epw.one_device(*case[:2])
    for (rank,) in ranks:
        assert rank["loss"] == pytest.approx(loss, rel=1e-4)
        for g, want in zip(rank["grads"], grads):
            assert float(np.abs(g - want).max()) <= \
                1e-4 * float(np.abs(want).max())
        assert (rank["k8"] > 0) == (case[0] == "jamba_v0_1_52b")


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_serving_world_on_the_card_matches_cpu(cuda, shape):
    """Qwen3, Granite, Gemma3, Jamba (16 experts over ep, dropless and at
    a capped capacity) and RWKV6 SMOKE in f32 served on a ``shape`` mesh
    of 4 gloo ranks on cuda:0 (``data_parallel.make_serve_steps``: KV
    caches over ``seq``, the flash-decoding combine, decode's MoE routed
    over the global batch): every step's logits within 1e-4 of one CPU
    device's largest magnitude, the same greedy tokens, and K8 launched
    on every rank of Jamba's prefill."""
    import _torch_serve_world as sw
    from repro_torch.launch.world import run_world
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [("qwen3_4b", {}, shape), ("granite_34b", {}, shape),
             ("gemma3_4b", {}, shape),
             ("jamba_v0_1_52b", dict(num_experts=16), shape),
             ("jamba_v0_1_52b", dict(num_experts=16,
                                     moe_capacity_factor=1.25), shape),
             ("rwkv6_7b", {}, shape)]
    ranks = run_world(sw.serve_rank, 4, device_type="cuda", backend="gloo",
                      args=(cases, "cuda"), timeout_s=600)
    for i, (arch, overrides, _) in enumerate(cases):
        want = sw.one_device(arch, overrides, groups=shape[0])
        for rank in ranks:
            got = rank[i]
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            for g, w in zip(got["logits"], want["logits"]):
                assert float(np.abs(g - w).max()) <= \
                    1e-4 * float(np.abs(w).max())
            assert (got["k8"] > 0) == (arch == "jamba_v0_1_52b")
    for rank in ranks:
        tokens, whole = rank[len(cases)]
        np.testing.assert_array_equal(tokens, np.argmax(whole, axis=-1))


def test_autotune_event_width_on_the_card(cuda):
    """The measured width on the card is one of the candidates, cached
    per (device type, n), and resolved within ``max_neighbors``."""
    saved = dict(annealing._EVENT_WIDTH_CACHE)
    annealing._EVENT_WIDTH_CACHE.clear()
    try:
        build.build_all()
        w = annealing.autotune_event_width(64, repeats=2, device=cuda)
        assert w in annealing._AUTO_WIDTHS
        assert annealing._EVENT_WIDTH_CACHE == {("cuda", 64): w}
        for k in (4, 25, 50):
            cfg = annealing.SAConfig(max_neighbors=k, event_width="auto")
            assert annealing.resolved_event_width(cfg, 64, cuda) == min(w, k)
        assert annealing.resolved_event_width(
            annealing.SAConfig(max_neighbors=25), 64, cuda) == 25
    finally:
        annealing._EVENT_WIDTH_CACHE.clear()
        annealing._EVENT_WIDTH_CACHE.update(saved)


@pytest.mark.parametrize("n,nv,shared", [(64, 60, True), (256, 250, False)])
def test_event_loop_widths_through_k1_match(cuda, n, nv, shared):
    """The event loop at widths 1, 6 and K through K1 on the card: the
    same states, one K1 launch a round."""
    from repro_torch.kernels.qap_sa_step import event_loop
    C, M, p, pairs, f, temp, _, _ = _inputs(n, nv, shared, 31, cuda)
    B = p.shape[0]
    us = torch.as_tensor(np.random.default_rng(5).random((B, K)),
                         dtype=torch.float32, device=cuda)
    outs = {}
    for w in (1, 6, K):
        before = ops.launch_counts()["qap_delta"]
        outs[w] = event_loop(lambda pp, pr: ops.qap_delta(C, M, pp, pr),
                             p, f, p, f, temp, pairs, us, 4, w)
        launched = ops.launch_counts()["qap_delta"] - before
        assert 1 <= launched <= min(4, K) + -(-K // w)
    for w in (1, 6):
        for a, b in zip(outs[K], outs[w]):
            assert torch.equal(a, b), w
