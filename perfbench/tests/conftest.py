"""Fixtures of the benchmark's CPU tests: a tiny cell that runs the
program's plain PyTorch path in about a second, in process or from a
copy of the benchmark beside the program.

Run from the root of the repository:
``PYTHONPATH=src python -m pytest perfbench/tests``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = "tiny.o27"
# Limits between the tiny cell's sound runs and its runs with a broken
# solver, seeds 0-5: mean F/F0 1.56-1.59 sound, 1.85-1.89 with half the
# batch left out, 2.09-2.10 with the annealing switched off; the worst
# answer's F/F0 1.67-1.72 sound, 2.20-2.32 with one slot of each wave
# left unannealed.
TINY_LIMITS = {"mean_f_over_f0": 1.72, "worst_f_over_f0": 1.95}


def tiny_config() -> dict:
    cfg = json.loads((ROOT / "perfbench/configs/psa_taie.json").read_text())
    cfg["name"] = "tiny"
    cfg["engine"].update(buckets=[32], num_processes=1, max_batch=4,
                         polish_rounds=2)
    cfg["sa"].update(max_neighbors=8, max_success=4, iters_per_exchange=8,
                     num_exchanges=3, solvers=4)
    return cfg


TINY_MIX = {"loop": "closed", "orders": {"27": 1}, "pass_size": 4}


@pytest.fixture
def tiny_cell():
    from perfbench import harness
    return harness.Cell(name=TINY, chips=1, config=tiny_config(),
                        mix=dict(TINY_MIX),
                        limits=dict(TINY_LIMITS),
                        end_to_end=[], per_layer=[])


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark beside the program, with the tiny cell
    added as new files and new ``BENCHMARK.json`` entries alone: its
    configuration, its instance family, its mix, its loop kind, its
    limits and a metric of its own."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    (root / "src").symlink_to(ROOT / "src")
    bench = root / "perfbench"
    (bench / "configs/tiny.json").write_text(
        json.dumps(dict(tiny_config(), family="tiny_taie")))
    (bench / "families/tiny_taie.py").write_text(
        "from perfbench import instances\n\n\n"
        "def make(config, order, version):\n"
        "    return instances.taie(order, version)\n")
    (bench / "traffic/o27.json").write_text(
        json.dumps(dict(TINY_MIX, loop="tiny_closed")))
    (bench / "loops/tiny_closed.py").write_text(
        "from perfbench import byname\n\n"
        "Loop = byname.load('loops', 'closed').Loop\n")
    (bench / f"cells/{TINY}.json").write_text(
        json.dumps({"limits": TINY_LIMITS}))
    (bench / "metrics/tiny.passes.py").write_text(
        "def read(run):\n"
        "    return float(len({a.pass_no for a in run.window}))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "a test",
                            "file": "perfbench/configs/tiny.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": TINY, "config": "tiny",
                              "traffic": "o27", "chips": 1, "why": "a test"})
    for m in spec["per_layer"]:
        m["workloads"].append(TINY)
    spec["per_layer"].append({"name": "tiny.passes", "unit": "passes",
                              "better": "higher", "source": "host_clock",
                              "layer": "engine", "moves": "mappings_per_s",
                              "workloads": [TINY]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run_command(root: Path, *args: str, device: str = "cpu"):
    """``perfbench/run.py`` of ``root`` in a fresh interpreter; with
    ``device="cpu"`` past the look for a card."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import run; "
            f"sys.exit(run.main(sys.argv[2:], device={device!r}))")
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "-c", code, str(root / "perfbench"), *args],
        capture_output=True, text=True, env=env, timeout=300)
