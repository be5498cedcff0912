"""Table 1 of the port's harness against the reference harness on the
CPU: the same algorithms, budgets and keys give the same permutation, F
and A1 bit for bit at orders 27 and 45, and ``run()`` the same rows and
markdown table (timings aside)."""
import jax
import numpy as np
import pytest

from _torch_serve import one_torch_thread  # noqa: F401
from test_torch_bench_common import (check_own_perm, name_and_derived,
                                     port_common, ref_common, set_budget)
from benchmarks import table1_accuracy as ref_t1
from benchmarks_torch import table1_accuracy as port_t1
from repro_torch.core import keys

SCALE = 0.02          # the harness's default; chip_smoke's card == CPU scale


@pytest.mark.parametrize("algorithm", ["psa", "pga", "pca"])
@pytest.mark.parametrize("n", [27, 45])
def test_algorithms_match_reference(n, algorithm, monkeypatch):
    set_budget(monkeypatch, SCALE)
    C, M, inst = ref_common.get(n)
    Ct, Mt, inst_t = port_common.get(n, "cpu")
    assert inst_t.optimum == inst.optimum
    ref_p, ref_f, _ = ref_t1._algorithms(n)[algorithm](
        C, M, jax.random.PRNGKey(1))
    p, f, _ = port_t1._algorithms(n, "cpu")[algorithm](Ct, Mt,
                                                       keys.prng_key(1))
    np.testing.assert_array_equal(p.numpy(), np.asarray(ref_p))
    assert float(f) == float(ref_f)
    assert (port_common.accuracy(float(f), inst.optimum)
            == ref_common.accuracy(float(ref_f), inst.optimum))


def test_run_matches_reference(tmp_path, monkeypatch):
    """``run()`` at orders 27 and 45 with two runs a cell: the same row
    names, F, F0 and A1, and the same markdown table but for T; each port
    row's permutation scores its F."""
    set_budget(monkeypatch, SCALE, runs=2)
    for module, art in ((ref_t1, tmp_path / "ref"), (port_t1,
                                                     tmp_path / "port")):
        monkeypatch.setattr(module, "ORDERS", (27, 45))
        monkeypatch.setattr(module, "ART", str(art))
    monkeypatch.setattr(port_common, "DEVICE", "cpu")
    ref_rows = ref_t1.run()
    port_rows = []
    rows = port_t1.rows
    monkeypatch.setattr(port_t1, "rows",
                        lambda device=None: port_rows.extend(rows(device))
                        or port_rows)
    port_csv = port_t1.run()
    assert port_csv == [r.csv() for r in port_rows]
    assert port_csv[0].startswith("table1.tai27.psa,")
    assert name_and_derived(port_csv) == name_and_derived(ref_rows)
    for row in port_rows:
        check_own_perm(row)

    def without_times(path):
        lines = (path / "table1.md").read_text().splitlines()
        cells = [line.split(" | ") for line in lines]
        return [[c for i, c in enumerate(row) if i not in (2, 5, 8)]
                for row in cells]

    assert without_times(tmp_path / "port") == without_times(tmp_path / "ref")
