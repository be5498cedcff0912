"""``correct`` at a size a test run holds: sound runs of the tiny cell
pass; the control and every fault the cells can have fail.  The same
faults and control are read on the card at the cells' own sizes by
``perfbench/control.py``."""
from __future__ import annotations

import pytest

from perfbench import faults, harness


def _correct(run) -> bool:
    return harness.result(run, "cpu", False)["correct"]


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_sound_run_is_correct(tiny_cell, seed):
    run = harness.run_cell(tiny_cell, seed, 0.3, False, "cpu")
    assert _correct(run), run.readings
    assert run.readings["objective_gap"] == 0


def test_control_is_not_correct(tiny_cell):
    run = harness.run_cell(tiny_cell, 4, 0.3, False, "cpu")
    assert _correct(run)
    faults.control(run)
    assert not _correct(run)
    assert run.readings["objective_gap"] > 0


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(tiny_cell, fault):
    with faults.planted(fault):
        run = harness.run_cell(tiny_cell, 5, 0.3, False, "cpu")
    assert not _correct(run), (fault, run.readings)
    if fault == "worse_than_identity":
        assert run.readings["worse_than_identity"] > 0
    if fault == "one_slot_unannealed":
        assert run.readings["worst_f_over_f0"] > run.limits[
            "worst_f_over_f0"]


def test_faults_are_taken_out_after_the_block(tiny_cell):
    from repro_torch.core import annealing, mapping
    from repro_torch.kernels import ops
    from repro_torch.serve.mapper import MappingEngine

    def now():
        return (ops.qap_sa_step, annealing.run_psa_batch,
                mapping.polish_batch, MappingEngine._respond)
    before = now()
    for fault in faults.FAULTS:
        with faults.planted(fault):
            assert now() != before
    assert now() == before
