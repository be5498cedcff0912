"""Framework experiment: predicted comm-cost gain from QAP device placement.

Reads artifacts produced by ``repro_torch.launch.placement_bench`` (which
lowers real cells on the 512-device mesh and solves their placements);
runs it in-process on first run, its solves on the harness's device
(``common.device``).  The port needs no subprocess: lowering on
``meta`` needs no placeholder platform.
"""
from __future__ import annotations

import glob
import json
import os

from . import common

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts_torch",
                   "placement")


def _ensure_artifacts() -> None:
    if glob.glob(os.path.join(ART, "*.json")):
        return
    from repro_torch.launch import placement_bench
    placement_bench._run(placement_bench.DEFAULT_CELLS, "multi",
                         common.device(), ART)


def run() -> list:
    _ensure_artifacts()
    rows = []
    for path in sorted(glob.glob(os.path.join(ART, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        for scen, label in (("algorithms", "pristine"), ("fragmented", "frag")):
            for algo, a in rec.get(scen, {}).items():
                rows.append(common.csv_row(
                    f"placement.{rec['arch']}.{rec['shape']}.{label}.{algo}",
                    a["seconds"] * 1e6,
                    f"F0={a['cost_before']:.3g};F={a['cost_after']:.3g};"
                    f"gain={a['gain']*100:.1f}%"))
    if not rows:
        rows.append(common.csv_row("placement.unavailable", 0.0,
                                   "run repro_torch.launch.placement_bench"))
    return rows
