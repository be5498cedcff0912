"""The yardstick's own pieces: the frozen generators against the
program's, the reference's exact F, the control, the traffic draws, the
K4 byte count and the reduction of a device trace."""
from __future__ import annotations

import itertools

import numpy as np
import pytest

from perfbench import devtrace, instances, reference, roofline, traffic


@pytest.mark.parametrize("n,version", [(6, 1), (27, 5), (125, 1),
                                       (125, 2 ** 31 - 1)])
def test_frozen_taie_matches_the_program(n, version):
    from repro_torch.core.instances import make_taie
    want = make_taie(n, version)
    got = instances.taie(n, version)
    assert np.array_equal(got.C, want.C) and got.C.dtype == want.C.dtype
    assert np.array_equal(got.M, want.M)
    assert got.optimum == want.optimum
    assert reference.objective(got.C, got.M, want.opt_perm) == want.optimum


@pytest.mark.parametrize("dims,version", [((4, 4, 8), 1), ((4, 4, 8), 99),
                                          ((2, 3), 7), ((5,), 3)])
def test_frozen_torus_matches_the_program(dims, version):
    from repro_torch.core.exact import make_torus
    want = make_torus(dims, version)
    got = instances.torus(dims, version)
    assert np.array_equal(got.C, want.C) and got.C.dtype == want.C.dtype
    assert np.array_equal(got.M, want.M)
    assert got.optimum == want.optimum == float(got.C.sum())
    assert reference.objective(got.C, got.M, want.opt_perm) == want.optimum


def test_reference_objective_is_exact_on_small_instances():
    inst = instances.taie(6, 3)
    C, M = inst.C.astype(np.float64), inst.M.astype(np.float64)
    fs = []
    for perm in itertools.permutations(range(6)):
        p = np.asarray(perm)
        f = reference.objective(inst.C, inst.M, p)
        assert f == (C * M[np.ix_(p, p)]).sum()
        fs.append(f)
    assert min(fs) == inst.optimum


def test_check_counts_bad_answers():
    inst = instances.taie(27, 4)
    good = np.arange(27)
    f = reference.objective(inst.C, inst.M, good)
    answers = [dict(C=inst.C, M=inst.M, optimum=inst.optimum, perm=good,
                    objective=float(f)),
               dict(C=inst.C, M=inst.M, optimum=inst.optimum, perm=good,
                    objective=float(f) + 2.0),
               dict(C=inst.C, M=inst.M, optimum=inst.optimum,
                    perm=np.zeros(27, np.int64), objective=0.0)]
    read, each = reference.check(answers, missing=1)
    assert read == {"missing": 1.0, "invalid_perm": 1.0,
                    "objective_gap": 2.0, "worse_than_identity": 0.0,
                    "mean_f_over_f0": f / inst.optimum,
                    "worst_f_over_f0": f / inst.optimum}
    assert each == [(f, True), (f, False), (None, False)]
    assert not reference.judge(read, reference.limits(
        {"mean_f_over_f0": 10.0, "worst_f_over_f0": 10.0}))


def test_check_holds_each_answer_to_the_identity_and_the_worst():
    inst = instances.taie(27, 4)
    identity = np.arange(27)
    base = reference.objective(inst.C, inst.M, identity)
    worse = next(p for p in (np.random.default_rng(s).permutation(27)
                             for s in range(100))
                 if reference.objective(inst.C, inst.M, p) > base)
    f_worse = reference.objective(inst.C, inst.M, worse)
    answers = [dict(C=inst.C, M=inst.M, optimum=inst.optimum, perm=p,
                    objective=float(reference.objective(inst.C, inst.M, p)))
               for p in (identity, worse)]
    read, each = reference.check(answers, missing=0)
    assert read["worse_than_identity"] == 1.0
    assert read["objective_gap"] == 0.0
    assert read["worst_f_over_f0"] == f_worse / inst.optimum
    assert read["mean_f_over_f0"] == pytest.approx(
        (base + f_worse) / 2 / inst.optimum)
    assert each == [(base, True), (f_worse, False)]
    lim = reference.limits({"mean_f_over_f0": 10.0, "worst_f_over_f0": 10.0})
    assert lim["worse_than_identity"] == 0.0
    assert not reference.judge(read, lim)
    read["worse_than_identity"] = 0.0
    assert reference.judge(read, lim)
    assert not reference.judge(read, dict(lim, worst_f_over_f0=(
        read["worst_f_over_f0"] + read["mean_f_over_f0"]) / 2))


def test_worse_than_identity_fault_places_above_the_identity():
    from perfbench import faults
    for n, v in ((27, 1), (125, 3)):
        inst = instances.taie(n, v)
        p = faults._worse_than_identity(inst.C, inst.M)
        assert reference.is_permutation(p, n)
        assert reference.objective(inst.C, inst.M, p) > \
            reference.objective(inst.C, inst.M, np.arange(n))


@pytest.mark.parametrize("family", ["taie", "torus"])
def test_bf16_control_misses_the_exact_objective(family):
    inst = (instances.taie(125, 9) if family == "taie"
            else instances.torus((4, 4, 8), 9))
    rng = np.random.default_rng(0)
    gaps = []
    for _ in range(8):
        p = rng.permutation(inst.C.shape[0])
        gaps.append(abs(reference.bf16_objective(inst.C, inst.M, p)
                        - reference.objective(inst.C, inst.M, p)))
    assert max(gaps) > 0


def _passes(mix, seed, count):
    stream = traffic.Stream({"family": "taie"}, mix, seed)
    return [stream.specs() for _ in range(count)]


def test_traffic_draws_from_the_seed():
    mix = {"loop": "closed", "orders": {"27": 1, "45": 3}, "pass_size": 8}
    a, b = _passes(mix, 2 ** 31 + 12345, 50), _passes(mix, 2 ** 31 + 12345, 50)
    c = _passes(mix, 7, 50)
    assert a == b and a != c
    flat = [x for p in a for x in p]
    assert len({v for _, v, _ in flat}) == 400
    assert all(0 <= s < 2 ** 31 and v >= 1 for _, v, s in flat)
    for p, q in zip(a, c):                # the same orders in every pass
        assert sorted(n for n, _, _ in p) == sorted(n for n, _, _ in q) \
            == [27, 27, 45, 45, 45, 45, 45, 45]
    assert len({tuple(n for n, _, _ in p) for p in a}) > 1


def test_traffic_makes_requests_of_the_configured_family():
    mix = {"loop": "closed", "orders": {"27": 1, "45": 1}, "pass_size": 2}
    stream = traffic.Stream({"family": "taie"}, mix, 5)
    first, second = stream.next_pass(), stream.next_pass()
    assert [r.job_id for r in first + second] == [f"r{i}" for i in range(4)]
    specs = traffic.Stream({"family": "taie"}, mix, 5).specs()
    for req, (order, version, seed) in zip(first, specs):
        want = instances.taie(order, version)
        assert req.seed == seed and req.optimum == want.optimum
        assert np.array_equal(req.C, want.C) and req.C.shape == (order, order)


def test_sa_step_bytes_counts_each_input_and_output_once():
    b0, n, chains = 128, 128, 128 * 250
    matrices = 2 * b0 * n * n * 4
    p_in_out = 4 * chains * n * 4            # p, best_p read and written
    scalars = chains * (4 * 4 + 2 * 8 + 2 * 4)
    assert roofline.sa_step_bytes(b0, n, chains) == \
        matrices + p_in_out + scalars
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)


def test_trace_reduction():
    ms = 1_000_000
    events = [("cudaLaunchKernel", "DeviceType.CPU", 0, 100 * ms),
              (devtrace.MARKER, "DeviceType.CPU", 10 * ms, 100 * ms),
              ("void (anonymous namespace)::qap_sa_step_smem_kernel<4>(int)",
               "DeviceType.CUDA", 5 * ms, 20 * ms),
              ("void at::native::copy(int)", "DeviceType.CUDA", 20 * ms,
               10 * ms),
              ("void (anonymous namespace)::qap_sa_step_smem_kernel<4>(int)",
               "DeviceType.CUDA", 60 * ms, 30 * ms),
              ("late", "DeviceType.CUDA", 120 * ms, 5 * ms)]
    t = devtrace.reduce_events(events)
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.05)         # 10-30 and 60-90 ms
    assert t.kernel("qap_sa_step") == (2, pytest.approx(0.05))
    assert t.device_ops()[0] == ["qap_sa_step_smem_kernel<4>",
                                 pytest.approx(0.045)]
    assert dict(map(tuple, t.idle_gaps())) == {
        "before qap_sa_step_smem_kernel<4>": pytest.approx(0.03),
        "window end": pytest.approx(0.02)}
    assert devtrace.reduce_events(events[:1]) is None
