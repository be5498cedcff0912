"""Kernels K1 (qap_delta), K2 (qap_objective), K4 (qap_sa_step) and K5
(qap_ga_step): the plain PyTorch versions against the reference's oracles
and its Pallas kernels in interpret mode, bit for bit on integer-valued
instances.  The CUDA kernels against the plain versions on the card:
``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref
from repro.kernels.qap_delta import qap_delta_pallas_batch
from repro.kernels.qap_ga_step import qap_ga_step_pallas_batch
from repro.kernels.qap_objective import qap_objective_pallas_batch
from repro.kernels.qap_sa_step import qap_sa_step_pallas_batch
from repro_torch.core import sparse
from repro_torch.kernels import build, ops
from repro_torch.kernels.qap_delta import qap_delta_cuda, qap_delta_plain
from repro_torch.kernels.qap_ga_step import qap_ga_step_cuda, qap_ga_step_plain
from repro_torch.kernels.qap_objective import (qap_objective_cuda,
                                               qap_objective_plain)
from repro_torch.kernels.qap_sa_step import (Cooling, qap_sa_step_cuda,
                                             qap_sa_step_plain)
from repro_torch.kernels.qap_sparse import (qap_delta_sparse_cuda,
                                            qap_delta_sparse_plain,
                                            qap_objective_sparse_plain)
from repro_torch.kernels.selective_scan import (selective_scan_cuda,
                                                selective_scan_plain)

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
# Orders past the card's shared-memory threshold (169), where K1 and K2
# take their L2 branches and these plain versions are the card checks'
# oracles: the engine's exact-size range, a ragged edge and a full order.
L2_CASES = [(176, 170, False), (200, 200, True)]


@pytest.mark.parametrize("n,nv,shared", CASES + L2_CASES)
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


def _islands(n, nv, shared, seed, pop=8):
    """B0 * RPT islands of ``pop`` members (permutations with the padded
    tail on itself) over integer instances, their exact F with many ties,
    key words and valid orders."""
    Cs, Ms, _, _ = _wave(n, nv, shared, seed)
    rng = np.random.default_rng(seed + 2)
    B = B0 * RPT
    pops = np.tile(np.arange(n, dtype=np.int32), (B, pop, 1))
    for r in range(B):
        for j in range(pop):
            pops[r, j, :nv] = rng.permutation(nv)
    pops[:, 1] = pops[:, 0]                              # equal members
    Cb = np.broadcast_to(Cs, (B0, n, n)) if shared else Cs
    Mb = np.broadcast_to(Ms, (B0, n, n)) if shared else Ms
    fits = np.array([[(Cb[r // RPT] * Mb[r // RPT][np.ix_(p, p)]).sum()
                      for p in pops[r]] for r in range(B)], np.float32)
    keys = rng.integers(0, 2 ** 32, (B, 2), dtype=np.uint64).astype(np.uint32)
    return Cs, Ms, pops, fits, keys, np.full(B, nv, np.int32)


@pytest.mark.parametrize("n,nv,shared", CASES + L2_CASES)
def test_qap_objective_plain_matches_ref_and_pallas(n, nv, shared):
    Cs, Ms, pops, *_ = _islands(n, nv, shared, seed=3 * n + nv)
    got = qap_objective_plain(_t(Cs), _t(Ms), _t(pops)).numpy()
    if shared:
        pallas = qap_objective_pallas_batch(jnp.asarray(Cs), jnp.asarray(Ms),
                                            jnp.asarray(pops), interpret=True)
    else:       # the Pallas kernel wants one instance per leading row
        pallas = qap_objective_pallas_batch(
            jnp.asarray(np.repeat(Cs, RPT, 0)), jnp.asarray(np.repeat(Ms, RPT, 0)),
            jnp.asarray(pops), interpret=True)
    assert got.tobytes() == np.asarray(pallas).tobytes()
    for r in range(B0 * RPT):
        C, M = (Cs, Ms) if shared else (Cs[r // RPT], Ms[r // RPT])
        want = ref.qap_objective_ref(jnp.asarray(C), jnp.asarray(M),
                                     jnp.asarray(pops[r]))
        assert got[r].tobytes() == np.asarray(want).tobytes()


def test_qap_objective_plain_tolerance_on_real_values():
    """Off the integers the sums may round in another order: relative
    1e-6 against the reference."""
    rng = np.random.default_rng(9)
    C = rng.random((B0, 24, 24)).astype(np.float32) * 7.3
    M = rng.random((B0, 24, 24)).astype(np.float32) * 3.1
    pops = np.stack([np.stack([rng.permutation(24) for _ in range(5)])
                     for _ in range(B0 * RPT)]).astype(np.int32)
    got = qap_objective_plain(_t(C), _t(M), _t(pops)).numpy()
    want = np.stack([np.asarray(ref.qap_objective_ref(
        jnp.asarray(C[r // RPT]), jnp.asarray(M[r // RPT]), jnp.asarray(pops[r])))
        for r in range(B0 * RPT)])
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("crossover", ["ox", "oxs"])
@pytest.mark.parametrize("n,nv,shared", [(16, 16, True), (16, 13, False)])
def test_qap_ga_step_plain_matches_ref_and_pallas(n, nv, shared, crossover):
    Cs, Ms, pops, fits, keys, nvs = _islands(n, nv, shared, seed=n + nv)
    kw = dict(n_off=4, tournament=3, p_crossover=0.9, p_mutation=0.3,
              crossover=crossover)
    got = qap_ga_step_plain(_t(Cs), _t(Ms), _t(pops), _t(fits),
                            _t(keys.astype(np.int64)), _t(nvs), **kw)
    pallas = qap_ga_step_pallas_batch(
        jnp.asarray(Cs), jnp.asarray(Ms), jnp.asarray(pops), jnp.asarray(fits),
        jnp.asarray(keys), jnp.asarray(nvs), interpret=True, **kw)
    for g, w in zip(got, pallas):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    for r in range(B0 * RPT):
        C, M = (Cs, Ms) if shared else (Cs[r // RPT], Ms[r // RPT])
        want = ref.qap_ga_step_ref(
            jnp.asarray(C), jnp.asarray(M), jnp.asarray(pops[r]),
            jnp.asarray(fits[r]), jnp.asarray(keys[r]), jnp.int32(nv), **kw)
        for g, w in zip(got, want):
            assert g[r].numpy().tobytes() == np.asarray(w).tobytes()
    np.testing.assert_array_equal(got[0][..., nv:].numpy(), pops[..., nv:])


@pytest.mark.parametrize("n,per_inst,insts", [
    (170, 32, 1), (200, 64, 1), (255, 16, 8), (343, 256, 1), (729, 256, 1),
    (729, 3, 5), (2230, 8, 1), (4096, 8, 1), (11614, 2, 1), (12288, 1, 1)])
def test_qap_objective_l2_tiling_covers_every_row_once(n, per_inst, insts):
    """K2's L2 tiling: its row tiles cover 0..n-1 exactly once, its
    groups every permutation of an instance once, its block fits shared
    memory, and it takes no property of the card."""
    import inspect
    from repro_torch.kernels.qap_objective import (L2_MAX_GROUP, L2_MAX_WARPS,
                                                   l2_block_bytes, l2_tiling)
    assert list(inspect.signature(l2_tiling).parameters) == [
        "n", "perms_per_inst", "instances"]
    t = l2_tiling(n, per_inst, insts)
    rows = [k for tile in range(t.tiles)
            for k in range(tile * t.tile_rows,
                           min(n, (tile + 1) * t.tile_rows))]
    assert rows == list(range(n))
    groups = -(-per_inst // t.group)
    perms = [q for g in range(groups)
             for q in range(g * t.group, min(per_inst, (g + 1) * t.group))]
    assert perms == list(range(per_inst))
    assert t.blocks == insts * groups * t.tiles
    assert 1 <= t.group <= min(L2_MAX_GROUP, per_inst)
    assert 1 <= t.warps <= L2_MAX_WARPS and t.sets in (1, 2)
    assert l2_block_bytes(n, t.group, t.warps, t.sets) \
        <= build.SMEM_BLOCK_LIMIT
    # the warps and tiles, and so a permutation's bits, depend on the
    # order alone, not on the batch
    assert t[1:5] == l2_tiling(n, 1, 1)[1:5] == l2_tiling(n, 64, 3)[1:5]


def test_qap_objective_l2_tiling_fills_the_card_at_the_dense_baseline():
    """sparse_scale's dense baseline, 8 permutations of one order-4096
    instance, runs hundreds of blocks (132 SMs); Table 1's 4 x 64 on
    tai729 more; two row sets a warp where 4 warps fit them."""
    from repro_torch.kernels.qap_objective import l2_tiling
    wide = l2_tiling(4096, 8, 1)
    assert wide.blocks >= 2 * 132
    assert l2_tiling(729, 256, 1).blocks >= wide.blocks
    assert l2_tiling(729, 256, 1).sets == 2
    assert l2_tiling(12288, 1, 1).sets == 1


@pytest.mark.parametrize("n", [170, 200, 256, 343, 445, 446, 729, 891,
                               4096, 11617, 11618, 30000])
def test_qap_delta_l2_plan_fits_shared_memory(n):
    """K1's L2 plan: 16 warps with two row sets where they fit with the
    permutation row within the block's shared memory; else one set and as
    many warps as fit; the unstaged kernel only where one warp's one set
    does not fit."""
    from repro_torch.kernels.qap_delta import (L2_MAX_WARPS, l2_block_bytes,
                                               l2_plan)
    warps, sets = l2_plan(n)
    if sets == 0:
        assert l2_block_bytes(n, 1, 1) > build.SMEM_BLOCK_LIMIT
        return
    assert 1 <= warps <= L2_MAX_WARPS
    assert l2_block_bytes(n, warps, sets) <= build.SMEM_BLOCK_LIMIT
    if warps < L2_MAX_WARPS:
        assert l2_block_bytes(n, warps + 1, sets) > build.SMEM_BLOCK_LIMIT
    assert (sets == 2) == (l2_block_bytes(n, L2_MAX_WARPS, 2)
                           <= build.SMEM_BLOCK_LIMIT)
    assert l2_plan(729) == (16, 1) and l2_plan(200) == (16, 2)


@pytest.mark.parametrize("n", [170, 171, 200, 256, 343, 445, 729, 768, 3072,
                               3073, 5632, 5633, 30000])
def test_qap_sa_step_l2_plan_fits_shared_memory(n):
    """K4's L2 plan: a block a chain with two row sets, which fits the
    block's shared memory, up to the fused cap; an order past it (where a
    chain's permutation no longer fits its lanes' registers) is refused."""
    from repro_torch.kernels.qap_sa_step import (L2_MAX_N, l2_block_bytes,
                                                 l2_plan)
    assert L2_MAX_N == ops.MAX_FUSED_N
    if n > L2_MAX_N:
        with pytest.raises(ValueError, match=f"order {n}"):
            l2_plan(n)
        return
    assert l2_plan(n) == l2_block_bytes(n) <= build.SMEM_BLOCK_LIMIT
    assert l2_block_bytes(n) >= 4 * (2 * 8 + 2) * n


@pytest.mark.parametrize("P,n_off", [(32, 16), (128, 64), (0, 0)])
def test_fused_l2_plans_fit_every_fused_order(P, n_off):
    """Every order the fused steps take past the shared-memory threshold
    (170-768): K4's chains and K5's breed, rank, finish and tile blocks
    fit the block's shared memory, at the engine's GA, Table 1's fused
    PGA and the GA's default pop = n with every member replaced (P = 0
    below).  Both plans read the order and shapes alone, no property of
    the card, so the bits cannot change with the machine."""
    import inspect
    from repro_torch.kernels import qap_ga_step as ga, qap_sa_step as sa
    from repro_torch.kernels.qap_objective import l2_block_bytes, l2_tiling
    assert list(inspect.signature(sa.l2_plan).parameters) == ["n"]
    assert list(inspect.signature(ga.l2_plan).parameters) == [
        "P", "n", "n_off", "tournament", "islands", "instances"]
    for n in range(170, ops.MAX_FUSED_N + 1):
        assert sa.l2_plan(n) <= build.SMEM_BLOCK_LIMIT
        pop, kids = (P, n_off) if P else (n, n)
        plan = ga.l2_plan(pop, n, kids, 3, 4, 2)
        assert 1 <= plan.breed_warps <= min(ga.L2_BREED_WARPS, kids)
        assert ga.l2_breed_bytes(n, 3, plan.breed_warps) \
            <= build.SMEM_BLOCK_LIMIT
        assert 4 * (pop + 3) <= build.SMEM_BLOCK_LIMIT
        t = plan.tiling
        assert t == l2_tiling(n, 2 * kids, 2)
        assert l2_block_bytes(n, t.group, t.warps, t.sets) \
            <= build.SMEM_BLOCK_LIMIT
        assert plan.work_words == 4 * kids * (1 + n + t.tiles)


def test_qap_ga_step_l2_plan_scores_children_with_k2s_tiling():
    """K5's L2 plan tiles its children as K2 tiles the same permutations
    (so their F is K2's, bit for bit), breeds at most L2_BREED_WARPS
    children a block and refuses what does not fit."""
    from repro_torch.kernels import qap_ga_step as ga
    from repro_torch.kernels.qap_objective import l2_tiling
    plan = ga.l2_plan(32, 256, 16, 2, 16, 8)
    assert plan.tiling == l2_tiling(256, 2 * 16, 8)
    assert plan.breed_warps == ga.L2_BREED_WARPS
    assert ga.l2_plan(32, 200, 3, 2, 2, 1).breed_warps == 3
    assert ga.l2_plan(128, 729, 64, 2, 4).tiling[1:5] == l2_tiling(
        729, 1)[1:5]
    with pytest.raises(ValueError, match="order 30000"):
        ga.l2_plan(32, 30000, 16, 2, 2, 1)
    with pytest.raises(ValueError, match="pop 58110"):
        ga.l2_plan(58110, 256, 16, 2, 2, 1)
    assert ga.l2_plan(58109, 256, 16, 2, 2, 1).breed_warps == 4


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
    Cs, Ms, pops, fits, keys, nvs = _islands(16, 12, False, seed=7)
    assert torch.equal(ops.qap_objective(_t(Cs), _t(Ms), _t(pops)),
                       qap_objective_plain(_t(Cs), _t(Ms), _t(pops)))
    args = (_t(Cs), _t(Ms), _t(pops), _t(fits), _t(keys.astype(np.int64)),
            _t(nvs))
    kw = dict(n_off=3, tournament=2, p_crossover=1.0, p_mutation=0.2)
    got = ops.qap_ga_step(*args, **kw)
    want = qap_ga_step_plain(*args, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    S = sparse.from_dense(Cs)
    assert torch.equal(ops.qap_objective(S, _t(Ms), _t(pops)),
                       qap_objective_sparse_plain(S, _t(Ms), _t(pops)))
    Cs, Ms, ps, pairs = _wave(16, 12, False, seed=8)
    S = sparse.from_dense(Cs)
    assert torch.equal(ops.qap_delta(S, _t(Ms), _t(ps), _t(pairs)),
                       qap_delta_sparse_plain(S, _t(Ms), _t(ps), _t(pairs)))
    rng = np.random.default_rng(9)
    scan = [_t(rng.standard_normal(shape).astype(np.float32))
            for shape in ((2, 5, 8), (2, 5, 8), (8, 4), (2, 5, 4), (2, 5, 4))]
    got = ops.selective_scan(*scan)
    want = selective_scan_plain(*scan)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launch_counts() == {
        "qap_delta": 0, "qap_objective": 0, "qap_sa_step": 0,
        "qap_ga_step": 0, "qap_objective_sparse": 0, "qap_delta_sparse": 0,
        "selective_scan": 0}


def test_fused_step_fits_keeps_the_reference_cap():
    from repro.kernels import ops as jops
    for n in (8, 127, 128, 129, 640, 768, 769, 1024, 4096):
        assert ops.fused_step_fits(n) == jops.fused_step_fits(n)


def _malformed_calls():
    """One call per way a kernel's wrapper must refuse its input, each
    with the words of the refusal.  The checks run before any library is
    built or pointer leaves Python, so they run on CPU tensors here."""
    Cs, Ms, ps, pairs = (_t(x) for x in _wave(16, 12, False, seed=5))
    _, _, sps, fs, temps, keys, nvs = (_t(x) for x in
                                       _sa_inputs(16, 12, False, seed=6))
    keys = keys.long()
    sa = (Cs, Ms, sps, fs, sps, fs, temps, keys, nvs)
    sa_kw = dict(max_neighbors=K, max_success=4)
    cool = Cooling("cauchy", 0.95, 1e-3, torch.ones_like(temps))
    rnd = dict(sa_kw, steps=3, cooling=cool, temp_out=torch.empty_like(temps))
    iC, iM, pops, fits, ikeys, invs = (_t(x) for x in
                                       _islands(16, 12, False, seed=7))
    ga = (iC, iM, pops, fits, ikeys.long(), invs)
    ga_kw = dict(n_off=3, tournament=2, p_crossover=1.0, p_mutation=0.2)
    rng = np.random.default_rng(10)
    scan = [_t(rng.standard_normal(shape).astype(np.float32))
            for shape in ((2, 5, 8), (2, 5, 8), (8, 4), (2, 5, 4), (2, 5, 4))]
    S = sparse.from_dense(Cs)
    odd = torch.zeros(pairs.numel() + 1, dtype=torch.int32)[1:].view(
        pairs.shape)                          # 4 bytes past an 8-byte line
    return {
        "sparse-delta-pairs-misaligned": (lambda: qap_delta_sparse_cuda(
            S, Ms, ps, odd), "8-byte"),
        "sparse-delta-p-rank": (lambda: qap_delta_sparse_cuda(S, Ms, ps[0],
                                                              pairs), "p must be"),
        "sparse-delta-M-strided": (lambda: qap_delta_sparse_cuda(
            S, Ms.transpose(1, 2), ps, pairs), "contiguous float32"),
        "sparse-delta-vals-f64": (lambda: qap_delta_sparse_cuda(
            S._replace(vals=S.vals.double()), Ms, ps, pairs), "vals must be"),
        "sparse-delta-cols_t-f32": (lambda: qap_delta_sparse_cuda(
            S._replace(cols_t=S.cols_t.float()), Ms, ps, pairs),
            "cols_t must be"),
        "scan-d-state": (lambda: selective_scan_cuda(
            *scan[:2], scan[2].repeat(1, 2), *scan[3:]), "d_state"),
        "scan-u-f64": (lambda: selective_scan_cuda(scan[0].double(), *scan[1:]),
                       "u must be"),
        "scan-c-strided": (lambda: selective_scan_cuda(
            *scan[:4], scan[4].transpose(0, 1).contiguous().transpose(0, 1)),
            "c must be"),
        "scan-b-shape": (lambda: selective_scan_cuda(*scan[:3], scan[3][:, :4],
                                                     scan[4]), "b must be"),
        "scan-u-rank": (lambda: selective_scan_cuda(scan[0][0], *scan[1:]),
                        "u must be"),
        "delta-p-int64": (lambda: qap_delta_cuda(Cs, Ms, ps.long(), pairs),
                          "int32"),
        "delta-b0-divides": (lambda: qap_delta_cuda(
            torch.cat([Cs, Cs[:1]]), torch.cat([Ms, Ms[:1]]), ps, pairs),
            "divide"),
        "delta-pairs-shape": (lambda: qap_delta_cuda(Cs, Ms, ps, pairs[:, :, :1]),
                              "pairs"),
        "sa-keys-int32": (lambda: qap_sa_step_cuda(*sa[:7], keys.int(), nvs,
                                                   **sa_kw), "keys"),
        "sa-round-steps-0": (lambda: qap_sa_step_cuda(
            *sa, **dict(rnd, steps=0)), "steps >= 1"),
        "sa-round-schedule": (lambda: qap_sa_step_cuda(
            *sa, **dict(rnd, cooling=cool._replace(schedule="geometric"))),
            "schedule"),
        "sa-round-temp_out-shape": (lambda: qap_sa_step_cuda(
            *sa, **dict(rnd, temp_out=temps[:1].clone())), "temp_out"),
        "objective-perms-int64": (lambda: qap_objective_cuda(iC, iM, pops.long()),
                                  "int32"),
        "objective-C-strided": (lambda: qap_objective_cuda(
            iC.transpose(1, 2), iM, pops), "contiguous float32"),
        "objective-order": (lambda: qap_objective_cuda(iC[..., :8, :8],
                                                       iM[..., :8, :8], pops),
                            "C must be"),
        "ga-fit-f64": (lambda: qap_ga_step_cuda(iC, iM, pops, fits.double(),
                                                *ga[4:], **ga_kw), "fit"),
        "ga-n_off": (lambda: qap_ga_step_cuda(*ga, **dict(ga_kw, n_off=99)),
                     "n_off"),
    }


@pytest.mark.parametrize("case", sorted(_malformed_calls()))
def test_kernel_wrappers_refuse_malformed_input_before_launch(case):
    call, words = _malformed_calls()[case]
    with pytest.raises(ValueError, match=words):
        call()


def test_key_words_are_the_int32_bit_pattern():
    words = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    got = build.key_words(torch.as_tensor(words.astype(np.int64)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), words.view(np.int32))
