"""The harness's ``common`` against the reference's (budgets, instances,
A1, the JSON merge, the device rule), and the pieces the other harness
parity tests share: both harnesses importable from the repo root, their
budgets set for a test, ``common.get`` redirected to small orders in
both, the reference's ``main`` run with a given command line, and the
check that holds a row to its own permutation.  Nothing here writes into
the repo tree: callers point every output path into ``tmp_path``."""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common as ref_common            # noqa: E402
from benchmarks_torch import common as port_common     # noqa: E402
from repro_torch.core import instances                 # noqa: E402

# Figure instances at test size: 343 -> 27, 729 -> 45.
REDIRECT = {343: 27, 729: 45}


def set_budget(monkeypatch, scale, runs=1):
    for common in (ref_common, port_common):
        monkeypatch.setattr(common, "SCALE", scale)
        monkeypatch.setattr(common, "RUNS", runs)


def redirect_get(monkeypatch):
    """``common.get`` of both harnesses serves order REDIRECT[n] for n."""
    ref_get, port_get = ref_common.get, port_common.get
    monkeypatch.setattr(ref_common, "get", lambda n: ref_get(REDIRECT[n]))
    monkeypatch.setattr(port_common, "get",
                        lambda n, device=None: port_get(REDIRECT[n], device))


def run_ref_main(module, argv, monkeypatch):
    """The reference script's ``main()`` with ``argv`` as its command
    line."""
    monkeypatch.setattr(sys, "argv", [module.__name__] + list(argv))
    module.main()


def name_and_derived(rows):
    """CSV rows without their timing column."""
    out = []
    for row in rows:
        name, _, derived = row.split(",", 2)
        out.append((name, derived))
    return out


def exact_objective(order, perm):
    """F(perm) of the order's paper instance in float64."""
    inst = instances.get_instance(order)
    return float((inst.C.astype(np.float64)
                  * inst.M.astype(np.float64)[np.ix_(perm, perm)]).sum())


def check_own_perm(row):
    """A port row's permutation is feasible and scores its reported F
    (exact below 2^24, as at every test order)."""
    n = row.order
    assert sorted(row.perm.tolist()) == list(range(n)), row.name
    assert exact_objective(n, row.perm) == row.f, row.name
    assert instances.get_instance(n).optimum <= row.f, row.name


@pytest.mark.parametrize("scale", [1e-4, 0.02, 0.25, 1.0])
def test_budgets_match_reference(scale, monkeypatch):
    set_budget(monkeypatch, scale)
    for kw in (dict(), dict(solvers=8, num_exchanges=30, ipe=30),
               dict(neighbors=200, solvers=8), dict(solvers=4, num_exchanges=15,
                                                   ipe=15)):
        ref = dataclasses.asdict(ref_common.sa_budget(**kw))
        port = dataclasses.asdict(port_common.sa_budget(**kw))
        assert {k: port[k] for k in ref} == ref
    for kw in (dict(), dict(generations=150, pop=128)):
        ref = dataclasses.asdict(ref_common.ga_budget(**kw))
        port = dataclasses.asdict(port_common.ga_budget(**kw))
        assert {k: port[k] for k in ref} == ref
    assert port_common.scaled(150, 5) == ref_common.scaled(150, 5)


def test_common_helpers(tmp_path):
    for seed in (0, 7):
        for a, b in zip(port_common.random_instance(12, seed),
                        ref_common.random_instance(12, seed)):
            np.testing.assert_array_equal(a, b)
    C, M, inst = port_common.get(27, "cpu")
    assert C.device.type == "cpu" and inst.optimum == ref_common.get(27)[2].optimum
    np.testing.assert_array_equal(C.numpy(), inst.C)
    assert port_common.accuracy(110.0, 100.0) == ref_common.accuracy(110.0,
                                                                     100.0)
    t, out = port_common.time_fn(lambda x: x + 1, torch.ones(3))
    assert t >= 0 and out.tolist() == [2.0, 2.0, 2.0]

    path = tmp_path / "b.json"
    path.write_text("{torn")
    port_common.write_bench_json(str(path), "a", {"x": 1})
    port_common.write_bench_json(str(path), "b", {"y": 2})
    assert json.loads(path.read_text()) == {"a": {"x": 1}, "b": {"y": 2}}
    assert port_common.BENCH_JSON == "BENCH_torch.json"
    assert port_common.device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_common.device("cuda")
