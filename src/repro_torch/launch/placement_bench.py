"""Placement-gain benchmark (framework-level experiment).

Lowers a real (arch x shape) cell on the production mesh, reads the
program graph C off the step's collectives, and runs the paper's three
algorithms to find a device permutation minimising the QAP functional
(1) over the torus's distance matrix, on a pristine slice and on the
fragmented allocation a resource manager hands out.  Reports predicted
communication cost before/after -- the deployment-level payoff of the
paper's technique.  The reference's ``repro/launch/placement_bench.py``:
the cell is lowered on ``meta`` (``launch.lowering``) instead of
compiled, and the solves run on the card unless the caller asks for the
CPU (``device``).

    PYTHONPATH=src python -m repro_torch.launch.placement_bench \\
        --cells gemma3_4b:train_4k --mesh multi
"""
from __future__ import annotations

import argparse
import json
import os
import time
import numpy as np

from .. import configs
from ..models.config import shape_cell
from ..topology import tpu
from . import lowering, placement as pl
from .mesh import make_production_mesh

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "artifacts_torch", "placement")

DEFAULT_CELLS = ("gemma3_4b:train_4k,qwen3_moe_235b_a22b:decode_32k,"
                 "granite_34b:decode_32k")

# the reference's jax.random.PRNGKey(0): key words (0, 0), engine seed 0
_KEY = np.zeros(2, np.uint32)


def compile_cell(arch: str, shape_name: str, multi_pod: bool):
    """Lower one cell, its work counted (``costs=True``), and return
    ``(LoweredCell, mesh)``."""
    cfg = configs.get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    return lowering.lower_cell(cfg, shape_cell(shape_name), mesh,
                               costs=True), mesh


def _fragmented_system_graph(ndev: int, seed: int = 0) -> np.ndarray:
    """The paper's deployment case: the scheduler hands the job an
    *arbitrary subset* of free nodes of a larger machine.  We model a
    4-pod machine at ~60% occupancy and draw the job's ndev nodes at
    random -- distances between allocated nodes are those of the full
    machine, so the as-allocated (identity) order is far from optimal."""
    spec = tpu.PodSpec(num_pods=max(4, (ndev * 2 + 255) // 256))
    m_full = tpu.distance_matrix(spec)
    rng = np.random.default_rng(seed)
    alloc = np.sort(rng.choice(spec.num_chips, size=ndev, replace=False))
    return m_full[np.ix_(alloc, alloc)]


def bench(arch: str, shape_name: str, multi_pod: bool = True,
          device=None) -> dict:
    """PSA, PGA and PCA on the cell's C against the pristine torus and the
    fragmented allocation, on one default-budget ``PlacementService`` on
    ``device`` (the card by default), as the reference's solves share its
    default service."""
    t0 = time.time()
    lowered, mesh = compile_cell(arch, shape_name, multi_pod)
    ndev = mesh.size
    c = pl.traffic_from_compiled(lowered, ndev)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "multi" if multi_pod else "single",
           "num_devices": ndev, "lower_s": round(time.time() - t0, 1),
           "traffic_nonzero": int((c > 0).sum()),
           "traffic_total_bytes": float(c.sum()), "algorithms": {},
           "fragmented": {}}
    # Scenario 1: pristine slice (the mesh's own order is a strong baseline).
    m = pl.system_graph_for_mesh(mesh)
    # Scenario 2: fragmented allocation (the paper's resource-manager case).
    m_frag = _fragmented_system_graph(ndev)
    service = pl.PlacementService(device=device)
    try:
        for algo in ("psa", "pga", "pca"):
            for label, mm in (("algorithms", m), ("fragmented", m_frag)):
                res = service.solve(c, mm, algo, key=_KEY)
                rec[label][algo] = {
                    "cost_before": res.cost_before,
                    "cost_after": res.cost_after,
                    "gain": res.gain, "seconds": round(res.seconds, 2)}
                print(f"[{arch}.{shape_name}] {label}/{algo}: "
                      f"F0={res.cost_before:.3g} -> F={res.cost_after:.3g}"
                      f"  gain={res.gain:.1%} ({res.seconds:.1f}s)",
                      flush=True)
    finally:
        service.close()
    return rec


def _run(cells: str, mesh: str, device=None, out_dir: str = ART) -> None:
    """:func:`bench` of each ``arch:shape`` of ``cells`` not yet in
    ``out_dir``, written there as JSON."""
    os.makedirs(out_dir, exist_ok=True)
    for cell in cells.split(","):
        arch, shape = cell.split(":")
        path = os.path.join(out_dir, f"{arch}.{shape}.{mesh}.json")
        if os.path.exists(path):
            print(f"cached: {path}")
            continue
        rec = bench(arch, shape, mesh == "multi", device)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=DEFAULT_CELLS)
    ap.add_argument("--mesh", default="multi", choices=["single", "multi"])
    ap.add_argument("--device", default=None,
                    help="where the solves run (default: the card)")
    ap.add_argument("--out", default=ART)
    args = ap.parse_args()
    _run(args.cells, args.mesh, args.device, args.out)


if __name__ == "__main__":
    main()
