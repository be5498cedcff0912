"""Figs 1-4 of the port's harness against the reference harness on the
CPU: with ``common.get`` serving order 27 for tai343 in both harnesses,
each module's ``run()`` gives the reference's row names and derived
fields (F and A1) exactly, and each row's permutation scores its F."""
import importlib

import pytest

from _torch_serve import one_torch_thread  # noqa: F401
from test_torch_bench_common import (check_own_perm, name_and_derived,
                                     redirect_get, set_budget)

SCALE = 1e-4       # every budget at its floor


@pytest.mark.parametrize("module", ["fig1_2_maxneighbors", "fig3_temperature",
                                    "fig4_exchange_period"])
def test_figure_matches_reference(module, monkeypatch):
    set_budget(monkeypatch, SCALE)
    redirect_get(monkeypatch)
    ref = importlib.import_module(f"benchmarks.{module}")
    port = importlib.import_module(f"benchmarks_torch.{module}")
    ref_rows = ref.run()
    rows = port.rows("cpu")
    assert name_and_derived([r.csv() for r in rows]) == \
        name_and_derived(ref_rows)
    for row in rows:
        check_own_perm(row)
