"""The harness: cells found by name, a cell added as files alone, the
result line's keys, and what the command refuses."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, TINY, run_command

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_benchmark_json_has_the_contract_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert {"mappings_per_s", "map_latency_p95_ms", "f_over_f0",
            "setup_s"} <= e2e
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_finds_its_files_by_name(workload):
    from perfbench import byname, harness
    cell = harness.load_cell(ROOT, workload)
    assert callable(byname.load("families", cell.config["family"]).make)
    assert callable(byname.load("loops", cell.mix["loop"]).Loop)
    assert cell.mix["pass_size"] == cell.config["engine"]["max_batch"]
    assert 1.0 < cell.limits["mean_f_over_f0"] < \
        cell.limits["worst_f_over_f0"]
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))


def test_pieces_not_there_are_named():
    from perfbench import byname
    with pytest.raises(KeyError, match="no families/nope.py"):
        byname.load("families", "nope")


def test_engine_takes_both_solvers_settings():
    from perfbench import harness
    from conftest import tiny_config
    config = dict(tiny_config(), ga={"generations": 7, "eval": "fused"})
    engine = harness.make_engine(config, "cpu")
    assert (engine.ga_cfg.generations, engine.ga_cfg.eval) == (7, "fused")
    assert engine.sa_cfg.max_neighbors == config["sa"]["max_neighbors"]
    assert engine.max_batch == config["engine"]["max_batch"]


@pytest.mark.parametrize("trace", [0, 1])
def test_added_cell_runs_from_new_files_alone(checkout, trace):
    got = run_command(checkout, "--workload", TINY, "--seed", "3000000017",
                      "--seconds", "0.5", "--trace", str(trace))
    assert got.returncode == 0, got.stderr[-3000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    keys = RESULT_KEYS + (["breakdown"] if "breakdown" in line else []) \
        + ["compared"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    if trace:
        assert "tiny.passes" in line["metrics"]
        assert "device.idle_share" not in line["metrics"]   # no CPU trace
    else:
        assert set(line["metrics"]) == {"mappings_per_s",
                                        "map_latency_p95_ms", "f_over_f0",
                                        "setup_s"}
    tail = got.stderr.strip().splitlines()[-len(line["compared"]):]
    assert all(t.startswith("compared ") for t in tail)


def test_command_refuses_without_the_program(tmp_path):
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json")
                                         .read_text())
    shutil.copytree(ROOT / "perfbench", bare / "perfbench")
    got = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         cwd=bare, capture_output=True, text=True,
                         timeout=120)
    assert got.returncode != 0 and got.stdout == ""


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    got = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert got.returncode != 0 and got.stdout == ""


def test_forbidden_modules_compare_whole_top_level_names():
    from perfbench import harness
    assert harness.forbidden_modules(
        ["repro_torch.serve.mapper", "jaxtyping", "reprolib"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jax.numpy", "jaxlib", "flax.linen", "numpy"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_command_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
            "import perfbench.run, perfbench.harness, perfbench.faults\n"
            "import perfbench.control, repro_torch.serve.mapper\n"
            "from perfbench import harness\n"
            "spec = __import__('json').load(open(sys.argv[1] + "
            "'/BENCHMARK.json'))\n"
            "for m in spec['end_to_end'] + spec['per_layer']:\n"
            "    harness.reader(m['name'])\n"
            "print(harness.forbidden_modules(sys.modules))\n")
    got = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip() == "[]"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          workload, "--seed", "3000000023", "--seconds", "5"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
