"""Sparse flows in the port against ``repro.core.sparse`` and the sparse
kernels of the JAX package, bit for bit on integer-valued instances: the
ELL storage, the plain versions of K6 (``qap_objective_sparse``) and K7
(``qap_delta_sparse``) against ``repro.kernels.ref`` and the Pallas
kernels in interpret mode, and the solvers on sparse flows (PSA event and
scan loops, masked and warm-started batches, PGA, polish).  The CUDA
kernels against the plain versions on the card:
``tests/test_torch_cuda.py``."""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import annealing as jann
from repro.core import exact as jexact
from repro.core import genetic as jgen
from repro.core import instances as jinst
from repro.core import mapping as jmapping
from repro.core import qap as jqap
from repro.core import sparse as jsparse
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch import convert
from repro_torch.core import (annealing, exact, genetic, mapping, multilevel,
                              qap, sparse)
from repro_torch.kernels import ops
from repro_torch.kernels.qap_sparse import (K6_MAX_CLUSTER,
                                            objective_sparse_launch,
                                            qap_delta_sparse_plain,
                                            qap_objective_sparse_plain)

from _fixtures import GA_SMALL, SA_SMALL

SA_SPARSE = dataclasses.replace(SA_SMALL, flows="sparse")
GA_SPARSE = dataclasses.replace(GA_SMALL, flows="sparse")
RPT, K = 3, 11


def _family(name, seed):
    """Integer-valued (C, M) of the repo's families: sparse tori and rings
    (known optimum) and the dense-ish Taillard-style instances."""
    if name == "torus":
        inst = jexact.make_torus((4, 4), version=seed)
    elif name == "ring":
        inst = jexact.make_ring(12, version=seed)
    elif name == "torus3":
        inst = jexact.make_torus((2, 2, 4), version=seed)
    else:
        inst = jinst.make_taie(12, version=seed)
    return np.asarray(inst.C, np.float32), np.asarray(inst.M, np.float32)


def _padded(names, n):
    """One instance per family name, zero-padded to order ``n``; the
    valid orders."""
    mats = [_family(f, i + 1) for i, f in enumerate(names)]
    Cs = np.zeros((len(mats), n, n), np.float32)
    Ms = np.zeros((len(mats), n, n), np.float32)
    nvs = []
    for i, (C, M) in enumerate(mats):
        m = C.shape[0]
        Cs[i, :m, :m], Ms[i, :m, :m] = C, M
        nvs.append(m)
    return Cs, Ms, np.asarray(nvs, np.int32)


def _port_sparse(S_ref):
    return convert.sparse_flows_from_reference([np.asarray(x) for x in S_ref])


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _kd(k):
    return convert.keys_from_reference(np.asarray(k))


def _cfg(cfg, **changes):
    fields = dataclasses.asdict(dataclasses.replace(cfg, **changes))
    if isinstance(cfg, jann.SAConfig):
        return convert.sa_config_from_reference(fields)
    return convert.ga_config_from_reference(fields)


# ------------------------------------------------------------- storage
@pytest.mark.parametrize("family", ["torus", "ring", "taie", "torus3"])
@pytest.mark.parametrize("width", [None, 9])
def test_from_dense_leaves_match_reference(family, width):
    C, _ = _family(family, 2)
    if width is not None:
        width = max(width, jsparse.max_degree(C))
    want = jsparse.from_dense(C, width)
    got = sparse.from_dense(C, width)
    for name, w, g in zip(sparse.SparseFlows._fields, want, got):
        assert g.dtype == (torch.float32 if name.startswith("vals")
                           else torch.int32), name
        assert np.asarray(w).tobytes() == g.numpy().tobytes(), name
    assert got.shape == tuple(want.shape) and got.n == want.n
    assert got.max_degree == want.max_degree == (width or sparse.max_degree(C))
    assert int(got.nnz()) == int(want.nnz())
    assert sparse.to_dense(got).numpy().tobytes() == \
        np.asarray(jsparse.to_dense(want)).tobytes() == C.tobytes()


def test_from_dense_batched_leaves_and_width_validation():
    Cs, _, _ = _padded(["torus", "ring", "taie"], 16)
    want = jsparse.from_dense(Cs)
    got = sparse.from_dense(Cs)
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()
    assert got.shape == (3, 16, 16) and got.dim() == 3
    np.testing.assert_array_equal(got.nnz().numpy(), np.asarray(want.nnz()))
    np.testing.assert_array_equal(sparse.to_dense(got).numpy(), Cs)
    assert sparse.to_dense(got.unsqueeze0()).shape == (1, 3, 16, 16)
    with pytest.raises(ValueError, match="width"):
        sparse.from_dense(Cs[0], width=sparse.max_degree(Cs[0]) - 1)
    with pytest.raises(ValueError, match="flows"):
        sparse.prepare_flows(Cs[0], "bogus")
    S = sparse.prepare_flows(Cs[0], "sparse")
    assert sparse.prepare_flows(S, "sparse") is S
    C0 = Cs[0]
    assert sparse.prepare_flows(C0, "dense") is C0


@pytest.mark.parametrize("batched", [False, True])
def test_mask_flows_sparse_matches_reference(batched):
    Cs, _, nvs = _padded(["torus", "ring", "taie"], 16)
    if batched:
        want = jax.vmap(jsparse.mask_flows_sparse)(jsparse.from_dense(Cs),
                                                   jnp.asarray(nvs))
        got = qap.mask_flows(sparse.from_dense(Cs), _t(nvs))
    else:
        want = jqap.mask_flows(jsparse.from_dense(Cs[1]), jnp.int32(12))
        got = qap.mask_flows(sparse.from_dense(Cs[1]), 12)
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()


# ------------------------------------------------------- plain kernels
KERNEL_CASES = [(16, ("torus",), True), (16, ("torus", "ring", "taie"), False),
                (24, ("ring",), True), (24, ("torus3", "taie"), False)]


def _wave(n, names, shared, seed):
    """Masked sparse flows (shared or one per instance), ``len(names) *
    RPT`` permutations that keep each padded tail on itself, and K
    candidate pairs per permutation inside the valid prefix."""
    rng = np.random.default_rng(seed)
    Cs, Ms, nvs = _padded(names, n)
    S_ref = jax.vmap(jsparse.mask_flows_sparse)(jsparse.from_dense(Cs),
                                                jnp.asarray(nvs))
    B = len(names) * RPT
    ps = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    pairs = np.zeros((B, K, 2), np.int32)
    for r in range(B):
        nv = nvs[r // RPT]
        ps[r, :nv] = rng.permutation(nv)
        for k in range(K):
            pairs[r, k] = np.sort(rng.choice(nv, 2, replace=False))
    if shared:
        S_ref = jax.tree.map(lambda x: x[0], S_ref)
        Ms = Ms[0]
    return S_ref, Ms, ps, pairs


@pytest.mark.parametrize("n,names,shared", KERNEL_CASES)
def test_qap_objective_sparse_plain_matches_ref_and_pallas(n, names, shared):
    S_ref, Ms, ps, _ = _wave(n, names, shared, seed=n + len(names))
    b0 = 1 if shared else len(names)
    perms = ps.reshape(b0, -1, n)
    got = qap_objective_sparse_plain(_port_sparse(S_ref), _t(Ms), _t(perms))
    pallas = lambda s, m, p: jops.qap_objective_sparse(
        s, m, p, force_pallas=True, interpret=True)
    oracle = ref.qap_objective_sparse_ref
    if not shared:
        pallas, oracle = jax.vmap(pallas), jax.vmap(oracle)
    args = (S_ref, jnp.asarray(Ms), jnp.asarray(perms))
    assert got.numpy().tobytes() == np.asarray(pallas(*args)).tobytes()
    assert got.numpy().tobytes() == np.asarray(oracle(*args)).tobytes()
    # the generic dispatch routes sparse flows to the sparse path
    S = _port_sparse(S_ref)
    assert torch.equal(ops.qap_objective(S, _t(Ms), _t(perms)), got)
    dense = sparse.to_dense(S)
    assert torch.equal(ops.qap_objective(dense, _t(Ms), _t(perms)), got)
    assert torch.equal(qap.objective(S, _t(Ms), _t(perms)), got)


# (N, D) of every level of the multilevel route's 4096 torus, finest first
# (its coarsening at the default MultilevelConfig).
TORUS_LEVELS = [(4096, 6), (2048, 12), (1024, 22), (512, 30), (256, 38),
                (128, 46)]


@functools.lru_cache(maxsize=None)
def _torus_levels():
    """The (16, 16, 16) torus's level stack, as the multilevel route and
    ``chip_smoke.torus_levels`` build it: ``[(C, M, ...), ...]``."""
    inst = exact.make_torus((16, 16, 16))
    stack, _ = multilevel.coarsen_levels(inst.C, inst.M,
                                         multilevel.MultilevelConfig())
    return stack


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("per", [1, 4])
@pytest.mark.parametrize("level", [-2, -1])
def test_qap_objective_sparse_plain_at_the_route_shapes(level, per, shared):
    """K6's plain version on the 4096 torus's two coarsest levels (orders
    256 and 128, ELL widths 38 and 46) at the route's shapes, 1 x 1 and
    1 x 4, shared leaves and the engine's one-instance batch: equal to
    ``ref.qap_objective_sparse_ref`` and the Pallas kernel in interpret
    mode bit for bit (integer flows)."""
    stack = _torus_levels()
    assert [(c.shape[0], sparse.max_degree(c)) for c, *_ in stack] == \
        TORUS_LEVELS
    C, M = stack[level][0], stack[level][1]
    n = C.shape[0]
    rng = np.random.default_rng(n + per)
    perms = np.stack([rng.permutation(n) for _ in range(per)]
                     ).astype(np.int32).reshape(1, per, n)
    S_ref = jsparse.from_dense(C if shared else C[None])
    Ms = M if shared else M[None]
    got = qap_objective_sparse_plain(_port_sparse(S_ref), _t(Ms), _t(perms))
    pallas = lambda s, m, p: jops.qap_objective_sparse(
        s, m, p, force_pallas=True, interpret=True)
    oracle = ref.qap_objective_sparse_ref
    args = (S_ref, jnp.asarray(Ms), jnp.asarray(perms))
    if not shared:
        pallas, oracle = jax.vmap(pallas), jax.vmap(oracle)
        args = (S_ref, jnp.asarray(Ms), jnp.asarray(perms)[None])
    assert got.shape == (1, per)
    want_p = np.asarray(pallas(*args)).reshape(got.shape)
    want_r = np.asarray(oracle(*args)).reshape(got.shape)
    assert got.numpy().tobytes() == want_p.tobytes() == want_r.tobytes()


@pytest.mark.parametrize("perms", [1, 4, 256])
@pytest.mark.parametrize("n,d", TORUS_LEVELS + [(130, 8), (5, 3), (1, 1)])
def test_k6_launch_covers_every_row_once(n, d, perms):
    """K6's grid is a whole number of clusters, one per permutation, of
    1 to 16 blocks and at most N; the blocks of a cluster take every row
    exactly once by the kernel's split (block g the rows [g N / G, (g +
    1) N / G)), each block at least one, so D or more of the N x D
    entries.  On an H100 (132 SMs) the route's 1 x 1 and 1 x 4 get the
    same, largest cluster, and a 256-wide batch one block a
    permutation."""
    grid, cluster = objective_sparse_launch(n, perms, 132)
    assert 1 <= cluster <= min(16, K6_MAX_CLUSTER, n)
    assert grid % cluster == 0 and grid == perms * cluster
    assert cluster == (1 if perms == 256 else min(16, n))
    ranges = [(g * n // cluster, (g + 1) * n // cluster)
              for g in range(cluster)]
    assert all(r1 > r0 for r0, r1 in ranges)
    rows = np.concatenate([np.arange(r0, r1) for r0, r1 in ranges])
    np.testing.assert_array_equal(rows, np.arange(n))
    assert sum((r1 - r0) * d for r0, r1 in ranges) == n * d
    # a card with fewer SMs than the batch still gets one block each
    assert objective_sparse_launch(n, perms, 1) == (perms, 1)


@pytest.mark.parametrize("n,names,shared", KERNEL_CASES)
def test_qap_delta_sparse_plain_matches_ref_and_pallas(n, names, shared):
    S_ref, Ms, ps, pairs = _wave(n, names, shared, seed=2 * n + len(names))
    S = _port_sparse(S_ref)
    got = qap_delta_sparse_plain(S, _t(Ms), _t(ps), _t(pairs))
    pallas = lambda s, m, p, pr: jops.qap_delta_sparse(
        s, m, p, pr, force_pallas=True, interpret=True)
    oracle = ref.qap_delta_sparse_ref
    if shared:
        args = (S_ref, jnp.asarray(Ms), jnp.asarray(ps), jnp.asarray(pairs))
    else:                           # one vmapped call per instance of RPT rows
        b0 = len(names)
        args = (S_ref, jnp.asarray(Ms), jnp.asarray(ps.reshape(b0, RPT, n)),
                jnp.asarray(pairs.reshape(b0, RPT, K, 2)))
        pallas, oracle = jax.vmap(pallas), jax.vmap(oracle)
    want_p = np.asarray(pallas(*args)).reshape(got.shape)
    want_r = np.asarray(oracle(*args)).reshape(got.shape)
    assert got.numpy().tobytes() == want_p.tobytes() == want_r.tobytes()
    dense = sparse.to_dense(S)
    assert torch.equal(ops.qap_delta(S, _t(Ms), _t(ps), _t(pairs)), got)
    assert torch.equal(ops.qap_delta(dense, _t(Ms), _t(ps), _t(pairs)), got)
    # the single-swap entry point, and the delta against a recomputed F
    r, (a, b) = 1, pairs[1, 0]
    i = 0 if shared else r // RPT
    Si = S if shared else sparse.SparseFlows(*(x[i] for x in S))
    Mi = _t(Ms if shared else Ms[i])
    p = _t(ps[r])
    d = qap.swap_delta(Si, Mi, p, int(a), int(b))
    assert float(d) == float(got[r, 0])
    f0 = float(qap.objective(Si, Mi, p))
    f1 = float(qap.objective(Si, Mi, qap.swap_positions(p, int(a), int(b))))
    assert float(d) == f1 - f0


def test_transposes_of_sparse_flows():
    S_ref, Ms, _, _ = _wave(16, ("torus",), True, 0)
    assert ops.transposes(_port_sparse(S_ref), _t(Ms)) == (None, None)


# ------------------------------------------------------------- solvers
@pytest.mark.parametrize("loop", ["event", "scan"])
@pytest.mark.parametrize("warm", [False, True])
def test_run_psa_sparse_matches_reference(loop, warm):
    C, M = _family("torus", 3)
    key = jax.random.PRNGKey(4)
    n = C.shape[0]
    init = np.random.default_rng(5).permutation(n).astype(np.int32) \
        if warm else None
    cfg = dataclasses.replace(SA_SPARSE, loop=loop)
    want = jann.run_psa(jsparse.from_dense(C), jnp.asarray(M), key, cfg, 2,
                        init_perm=None if init is None else jnp.asarray(init))
    got = annealing.run_psa(sparse.from_dense(C), M, _kd(key), _cfg(cfg), 2,
                            init_perm=init, device="cpu")
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()


def test_run_psa_batch_sparse_masked_warm_matches_reference():
    Cs, Ms, nvs = _padded(["torus", "ring", "taie"], 16)
    keys = jnp.stack([jax.random.PRNGKey(30 + i) for i in range(3)])
    warm = np.tile(np.arange(16, dtype=np.int32), (3, 1))
    warm[1] = -1                                  # instance 1 stays cold
    warm[2, :12] = np.random.default_rng(0).permutation(12)
    want = jann.run_psa_batch(jsparse.from_dense(Cs), jnp.asarray(Ms), keys,
                              SA_SPARSE, 2, n_valid=jnp.asarray(nvs),
                              init_perm=jnp.asarray(warm))
    got = annealing.run_psa_batch(sparse.from_dense(Cs), Ms, _kd(keys),
                                  _cfg(SA_SPARSE), 2, n_valid=nvs,
                                  init_perm=warm, device="cpu")
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()
    dense = annealing.run_psa_batch(Cs, Ms, _kd(keys), _cfg(SA_SMALL), 2,
                                    n_valid=nvs, init_perm=warm, device="cpu")
    for d, g in zip(dense, got):
        assert torch.equal(d, g)


@pytest.mark.parametrize("ga_eval", ["wide", "fused"])
def test_run_pga_sparse_matches_reference(ga_eval):
    C, M = _family("ring", 4)
    key = jax.random.PRNGKey(6)
    cfg = dataclasses.replace(GA_SPARSE, eval=ga_eval)
    want = jgen.run_pga(jsparse.from_dense(C), jnp.asarray(M), key, cfg, 2)
    got = genetic.run_pga(sparse.from_dense(C), M, _kd(key), _cfg(cfg), 2,
                          device="cpu")
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()
    assert genetic.resolved_eval(_cfg(cfg), C.shape[0]) == "wide"


def test_polish_sparse_matches_reference():
    C, M = _family("taie", 5)
    n = C.shape[0]
    p0 = np.random.default_rng(7).permutation(n).astype(np.int32)
    key = jax.random.PRNGKey(8)
    want = jmapping.polish(jsparse.from_dense(C), jnp.asarray(M),
                           jnp.asarray(p0), key, rounds=12)
    got = mapping.polish(sparse.from_dense(C), M, p0, _kd(key), rounds=12,
                         device="cpu")
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()


def test_polish_batch_sparse_masked_matches_reference():
    Cs, Ms, nvs = _padded(["torus", "ring", "taie"], 16)
    rng = np.random.default_rng(9)
    ps = np.tile(np.arange(16, dtype=np.int32), (3, 1))
    for i, nv in enumerate(nvs):
        ps[i, :nv] = rng.permutation(nv)
    keys = jnp.stack([jax.random.PRNGKey(40 + i) for i in range(3)])
    want = jmapping.polish_batch(jsparse.from_dense(Cs), jnp.asarray(Ms),
                                 jnp.asarray(ps), keys, rounds=10,
                                 n_valid=jnp.asarray(nvs))
    got = mapping.polish_batch(sparse.from_dense(Cs), Ms, ps, _kd(keys),
                               rounds=10, n_valid=nvs, device="cpu")
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()


def test_sparse_configs_require_sparse_flows_and_degrade_fused():
    C, M = _family("torus", 1)
    with pytest.raises(TypeError, match="SparseFlows"):
        annealing.run_psa(C, M, _kd(jax.random.PRNGKey(0)), _cfg(SA_SPARSE),
                          2, device="cpu")
    with pytest.raises(TypeError, match="SparseFlows"):
        genetic.run_pga(C, M, _kd(jax.random.PRNGKey(0)), _cfg(GA_SPARSE), 2,
                        device="cpu")
    with pytest.raises(ValueError, match="flows"):
        annealing.run_psa(C, M, _kd(jax.random.PRNGKey(0)),
                          _cfg(SA_SMALL, flows="bogus"), 2, device="cpu")
    fused = _cfg(SA_SPARSE, loop="fused")
    assert annealing.resolved_loop(fused, 16) == "event"
    assert jann.resolved_loop(dataclasses.replace(SA_SPARSE, loop="fused"),
                              16) == "event"
    assert annealing.resolved_loop(_cfg(SA_SMALL, loop="fused"), 16) == "fused"
