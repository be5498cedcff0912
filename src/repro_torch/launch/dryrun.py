"""Dry run of the production cells: what one device of an (arch x shape x
mesh) cell computes, holds and communicates, without devices.

The reference's ``repro/launch/dryrun.py`` lowers and compiles each cell
on a 512-device placeholder platform and reads XLA's cost analysis and
its own trip-count-aware HLO count off the compiled module.  The port
compiles nothing: a cell is one run of logical coordinate 0's step on
``meta`` tensors (``launch.lowering``, no placeholder platform needed)
under ``topology.opcost.count_costs``, which counts that same run.  So
the record has no ``compile_s``, ``cost_raw`` or ``memory_analysis``;
``flops`` and ``flops_hlo`` are both the counter's matrix-product FLOPs
(per device), ``flops_by_dtype`` splits them by the product's dtype,
``hbm_bytes`` is every op's inputs and outputs (the port runs unfused),
``collective_bytes`` the collectives' wire bytes summed over
participants (``traffic.total_collective_bytes``) and ``collectives``
their count and result bytes by kind, as ``HloCost.by_collective``.
The weight, optimizer and cache bytes a device holds are exact.

``long_500k`` runs only on sub-quadratic architectures; a cell whose
global batch does not split over the data axes replicates its batch
(``rules["batch"] = None``).  ``--rule logical=physical`` overrides
reach the lowered step and the byte counts through
``sharding.use_rules``; one the port's layouts cannot take raises
``ValueError`` naming it (``sharding.check_rules``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_4b \\
        --shape train_4k --mesh single

Artifacts go to ``artifacts_torch/dryrun/<arch>.<shape>.<mesh>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

from .. import configs
from ..models.api import Model
from ..models.config import LM_SHAPES, is_subquadratic, shape_cell
from ..parallel import sharding as sh
from ..train import optimizer as opt_lib
from . import lowering
from .mesh import make_production_mesh

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts_torch", "dryrun")


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        try:
            out[k] = int(v)
        except ValueError:
            out[k] = {"true": True, "false": False}.get(v.lower(), v)
    return out


def _sharded_bytes_per_device(tree, spec_tree, mesh) -> int:
    """Analytic per-device bytes of a tree sharded by ``spec_tree``
    (resolved to ``mesh``'s axes; exact for weights)."""
    return lowering.sharded_bytes(tree, spec_tree, dict(mesh.shape))


def _parse_rules(pairs) -> Dict[str, Any]:
    rules = {}
    for r in pairs or []:
        k, v = r.split("=", 1)
        rules[k] = tuple(v.split("+")) if v else None
    return rules


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: Optional[Dict[str, Any]] = None,
               rule_overrides: Optional[Dict[str, Any]] = None,
               microbatch: int = 1) -> Dict[str, Any]:
    """Lower and count one (arch x shape x mesh) cell; return the record."""
    cfg = configs.get_config(arch)
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    cell = shape_cell(shape_name)

    if cell.name == "long_500k" and not is_subquadratic(cfg):
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped",
                "reason": "pure full-attention arch; long_500k requires "
                          "sub-quadratic attention (DESIGN.md S5)"}

    mesh = make_production_mesh(multi_pod=multi_pod)
    ndev = mesh.size
    sh.check_rules(mesh, rule_overrides or {})
    rules = sh.rules_for_mesh(mesh, rule_overrides)
    dp_size = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    if cell.global_batch % dp_size != 0:
        # long_500k has global_batch=1: batch cannot shard over the data
        # axes; activations/caches replicate on batch and shard on seq/tp.
        rules = dict(rules)
        rules["batch"] = None
    model = Model(cfg, device="meta")
    with sh.use_rules(rules):
        lowered = lowering.lower_cell(cfg, cell, mesh, costs=True,
                                      microbatch=microbatch)
        aparams = model.abstract()
        pspecs = sh.resolve_tree(model.specs(), rules)
        record: Dict[str, Any] = {
            "arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single",
            "status": "ok", "num_devices": ndev,
            "lower_s": round(lowered.seconds, 1),
            "overrides": overrides or {},
            "rule_overrides": rule_overrides or {},
            "microbatch": microbatch,
            "num_params": model.num_params(),
        }
        record["weight_bytes_per_device"] = _sharded_bytes_per_device(
            aparams, pspecs, mesh)
        if cell.kind == "train":
            ocfg = opt_lib.OptConfig(moment_dtype=cfg.opt_dtype)
            aopt = opt_lib.abstract_state(ocfg, aparams)
            ospecs = opt_lib.state_specs(ocfg, pspecs)
            record["opt_bytes_per_device"] = _sharded_bytes_per_device(
                aopt.mu, ospecs.mu, mesh) + _sharded_bytes_per_device(
                aopt.nu, ospecs.nu, mesh)
        if cell.kind == "decode":
            record["cache_bytes_per_device"] = lowered.cache_bytes_per_device

    cost = lowered.cost
    by_kind: Dict[str, Dict[str, float]] = {}
    for op in cost.collectives:
        d = by_kind.setdefault(op.kind, {"count": 0.0, "bytes": 0.0})
        d["count"] += 1
        d["bytes"] += op.bytes
    record["flops"] = cost.flops
    record["flops_hlo"] = cost.flops
    record["flops_by_dtype"] = dict(cost.flops_by_dtype)
    record["hbm_bytes"] = cost.hbm_bytes
    record["collective_bytes"] = cost.collective_bytes
    record["collectives"] = by_kind
    return record


def cell_tag(rec: Dict[str, Any]) -> str:
    return f"{rec['arch']}.{rec['shape']}.{rec['mesh']}"


def run(arch_list, shape_list, meshes, overrides=None, rule_overrides=None,
        microbatch=1, out_dir=ARTIFACT_DIR, tag="") -> None:
    os.makedirs(out_dir, exist_ok=True)
    for arch in arch_list:
        for shape in shape_list:
            for multi in meshes:
                name = f"{arch}.{shape}.{'multi' if multi else 'single'}"
                if tag:
                    name += f".{tag}"
                path = os.path.join(out_dir, name + ".json")
                if os.path.exists(path):
                    print(f"== {name}: cached")
                    continue
                print(f"== {name}: lowering...", flush=True)
                t = time.perf_counter()
                try:
                    rec = lower_cell(arch, shape, multi, overrides,
                                     rule_overrides, microbatch)
                except Exception:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if multi else "single",
                           "status": "error",
                           "traceback": traceback.format_exc()}
                rec["tag"] = tag
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec.get("status")
                print(f"   -> {status} ({time.perf_counter() - t:.1f} s, "
                      f"flops {rec.get('flops', 0):.3g}, "
                      f"coll {rec.get('collective_bytes', 0):.3g}B)",
                      flush=True)
                if status == "error":
                    print(rec["traceback"].splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description="production-mesh dry run")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--rule", action="append", default=[],
                    help="logical=physical sharding rule override, e.g. fsdp=")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args()

    archs = configs.ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = [c.name for c in LM_SHAPES] if args.shape == "all" \
        else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    run(archs, shapes, meshes, _parse_overrides(args.override),
        _parse_rules(args.rule) or None, args.microbatch, args.out, args.tag)


if __name__ == "__main__":
    main()
