"""The port's ClusterState against ``repro.serve.cluster.ClusterState``:
the same seeded sequences of allocations, reservations, promotions,
cancellations and releases -- misuse included -- leave the same free
sets, carve the same candidate subsets under every policy, and raise the
same exception types."""
import numpy as np
import pytest

from repro.core import instances as ref_instances
from repro.serve import cluster as ref_cluster
from repro_torch.core import exact
from repro_torch.serve import cluster

OPS = ("allocate", "allocate_nodes", "reserve", "promote", "cancel",
       "release")


def _systems():
    rng = np.random.default_rng(7)
    real = rng.random((20, 20)).astype(np.float32) * 9.0
    ties = rng.integers(1, 4, (18, 18)).astype(np.float32)   # many ties
    return {
        "grid": ref_instances.grid_distance_matrix((2, 3, 4)),
        "torus": exact.torus_distance_matrix((4, 4, 2)),
        "real": (real + real.T) * (1 - np.eye(20, dtype=np.float32)),
        "ties": (ties + ties.T) * (1 - np.eye(18, dtype=np.float32)),
    }


SYSTEMS = _systems()


def _call(cl, op, *args):
    """``("ok", value)`` or ``("raised", exception type name)``."""
    try:
        return "ok", getattr(cl, op)(*args)
    except (ValueError, KeyError) as e:
        return "raised", type(e).__name__


def _same_value(want, got):
    if isinstance(want, (ref_cluster.Allocation, cluster.Allocation)):
        assert got.job_id == want.job_id
        np.testing.assert_array_equal(got.nodes, want.nodes)
        assert got.M_sub.tobytes() == want.M_sub.tobytes()
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _same_candidates(ref, port, size):
    for policy in cluster.CANDIDATE_POLICIES:
        want = ref.candidate_subsets(size, k=1, policies=(policy,))
        got = port.candidate_subsets(size, k=1, policies=(policy,))
        assert len(got) == len(want)
        for w, g in zip(want, got):
            assert g.policy == w.policy
            assert g.nodes.dtype == w.nodes.dtype
            np.testing.assert_array_equal(g.nodes, w.nodes)
            assert g.M_sub.tobytes() == w.M_sub.tobytes()
    want = ref.candidate_subsets(size)
    got = port.candidate_subsets(size)
    assert [c.policy for c in got] == [c.policy for c in want]


def _random_step(rng, ref, state):
    """One operation and its arguments, drawn from the reference's
    state: mostly valid, sometimes misuse (busy nodes, unknown tags and
    jobs, a duplicate job id, nodes outside a reservation)."""
    n = ref.num_nodes
    op = OPS[int(rng.integers(len(OPS)))]
    free = ref.free_nodes()
    jobs, tags = state["jobs"], state["tags"]
    misuse = rng.random() < 0.2
    if op == "allocate":
        job = (jobs[0] if misuse and jobs else f"j{state['seq']}")
        size = int(rng.integers(1, n + 1)) if misuse else \
            int(rng.integers(1, max(2, free.size // 2 + 1)))
        return op, (job, size)
    if op in ("allocate_nodes", "reserve"):
        pool = np.arange(n) if misuse or free.size == 0 else free
        k = int(rng.integers(1, max(2, min(pool.size, 6))))
        nodes = rng.choice(pool, size=min(k, pool.size), replace=False)
        name = f"j{state['seq']}" if op == "allocate_nodes" \
            else f"t{state['seq']}"
        return op, (name, nodes)
    if op == "promote":
        tag = tags[int(rng.integers(len(tags)))] if tags and not misuse \
            else "nope"
        held = ref.reserved_nodes(tag)
        if held is None or misuse:
            nodes = rng.choice(n, size=2, replace=False)
        else:
            nodes = rng.choice(held, size=int(rng.integers(1, held.size + 1)),
                               replace=False)
        return op, (tag, f"j{state['seq']}", nodes)
    if op == "cancel":
        return op, (tags[int(rng.integers(len(tags)))]
                    if tags and not misuse else "nope",)
    return op, (jobs[int(rng.integers(len(jobs)))]
                if jobs and not misuse else "ghost",)


def _track(state, op, args, outcome):
    state["seq"] += 1
    if outcome[0] != "ok":
        return
    if op in ("allocate", "allocate_nodes") and outcome[1] is not None:
        state["jobs"].append(args[0])
    elif op == "reserve":
        state["tags"].append(args[0])
    elif op == "promote":
        state["tags"].remove(args[0])
        state["jobs"].append(args[1])
    elif op == "cancel":
        state["tags"].remove(args[0])
    elif op == "release":
        state["jobs"].remove(args[0])


@pytest.mark.parametrize("policy", cluster.POLICIES)
@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sequences_match_reference(seed, system, policy):
    M = SYSTEMS[system]
    ref = ref_cluster.ClusterState(M, policy=policy)
    port = cluster.ClusterState(M, policy=policy)
    rng = np.random.default_rng(1000 * seed + len(system))
    state = {"jobs": [], "tags": [], "seq": 0}
    raised = 0
    for _ in range(40):
        op, args = _random_step(rng, ref, state)
        want = _call(ref, op, *args)
        got = _call(port, op, *args)
        assert got[0] == want[0], (op, args, want, got)
        if want[0] == "ok":
            _same_value(want[1], got[1])
        else:
            assert got[1] == want[1], (op, args)
            raised += 1
        _track(state, op, args, want)
        np.testing.assert_array_equal(port.free_nodes(), ref.free_nodes())
        assert port.num_free == ref.num_free
        assert port.utilization == ref.utilization
        for tag in state["tags"]:
            np.testing.assert_array_equal(port.reserved_nodes(tag),
                                          ref.reserved_nodes(tag))
        for size in {1, 3, max(1, ref.num_free // 2), ref.num_free}:
            if size >= 1:
                _same_candidates(ref, port, size)
    assert raised > 0          # the sequence exercised misuse too


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_policy_constants_and_argument_errors_match(system):
    assert cluster.POLICIES == ref_cluster.POLICIES
    assert cluster.CANDIDATE_POLICIES == ref_cluster.CANDIDATE_POLICIES
    M = SYSTEMS[system]
    ref = ref_cluster.ClusterState(M)
    port = cluster.ClusterState(M)
    for args, kw in (((0,), {}), ((M.shape[0] + 1,), {}),
                     ((2,), dict(policies=("bogus",)))):
        with pytest.raises(ValueError):
            ref.candidate_subsets(*args, **kw)
        with pytest.raises(ValueError):
            port.candidate_subsets(*args, **kw)
    for bad in (np.zeros((3, 4)), np.zeros(3)):
        for cls in (ref_cluster.ClusterState, cluster.ClusterState):
            with pytest.raises(ValueError, match="square"):
                cls(bad)
    for cls in (ref_cluster.ClusterState, cluster.ClusterState):
        with pytest.raises(ValueError, match="policy"):
            cls(M, policy="slab")
    np.testing.assert_array_equal(port.induced([3, 1, 2]),
                                  ref.induced([3, 1, 2]))


def test_reservation_lifecycle_restores_occupancy():
    M = SYSTEMS["grid"]
    cl = cluster.ClusterState(M)
    cl.allocate("blocker", 5)
    before = cl.free_nodes().copy()
    cands = cl.candidate_subsets(6)
    assert len(cands) >= 2 and all(c.size == 6 for c in cands)
    union = np.unique(np.concatenate([c.nodes for c in cands]))
    cl.reserve("w", union)
    assert cl.num_free == before.size - union.size
    alloc = cl.promote("w", "job", cands[1].nodes)
    np.testing.assert_array_equal(alloc.nodes, cands[1].nodes)
    assert cl.reserved_nodes("w") is None
    cl.release("job")
    np.testing.assert_array_equal(cl.free_nodes(), before)
