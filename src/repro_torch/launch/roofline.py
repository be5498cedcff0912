"""Roofline derivation from dry-run artifacts at the H100's rates.

Reads ``artifacts_torch/dryrun/*.json`` (written by ``launch.dryrun``)
and derives, per (arch x shape x mesh), from one device's counts:

    compute term    = sum over dtypes of FLOPs / peak FLOP/s of the dtype [s]
    memory term     = HBM bytes / HBM bandwidth                         [s]
    collective term = collective wire bytes / (chips x NVLink bandwidth) [s]

The rates are one H100 SXM5's datasheet figures (``topology.h100``): a
bf16 product at the tensor cores' peak, an f32 one at the f32 peak
outside them.  These terms are counts divided by rates, not times
measured on a card.  FLOPs and bytes are the ``topology.opcost`` counts
of the cell's step run once on ``meta`` (per device: logical coordinate
0's step); collective bytes are summed over participants, divided by
chips x link bandwidth as the reference's brief divides them.  A record
without ``flops_by_dtype`` is read as bf16.

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for train; 2*N*D for
prefill; 2*N*B for decode.  The ratio MODEL_FLOPS / (counted FLOPs x
chips) flags recompute and redundancy: above 1 means the count missed
work.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from .. import configs
from ..models.config import shape_cell
from ..topology.h100 import HBM_BW, NVLINK_BW, PEAK_FLOPS

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "artifacts_torch", "dryrun")

_HINTS = {
    "compute": "raise arithmetic efficiency: run attention's products in "
               "bf16 on the tensor cores, skip fully masked chunks, remat "
               "less",
    "memory": "cut HBM traffic: fuse the attention chunk loop and the "
              "elementwise chains into kernels, raise attn chunk sizes",
    "collective": "cut wire bytes: gather weights in bf16, scope fsdp to "
                  "fewer axes, QAP placement to shorten hop distance",
}


def active_params(arch: str) -> int:
    cfg = configs.get_config(arch)
    from ..models.api import Model
    total = Model(cfg, device="meta").num_params()
    if cfg.num_experts > 0:
        moe_layers = sum(ch in "EWMA" for ch in cfg.layer_pattern)
        expert = 3 * cfg.num_experts * cfg.d_model * cfg.moe_d_ff
        inactive = expert * (1.0 - cfg.num_experts_per_tok / cfg.num_experts)
        total -= int(moe_layers * inactive)
    return total


def model_flops(arch: str, shape: str) -> float:
    cell = shape_cell(shape)
    n = active_params(arch)
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch          # decode: one token


def derive(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    ndev = rec["num_devices"]
    by_dtype = rec.get("flops_by_dtype") or {"bf16": rec.get("flops_hlo",
                                                             0.0)}
    compute_s = sum(f / PEAK_FLOPS[dt] for dt, f in by_dtype.items())
    memory_s = rec.get("hbm_bytes", 0.0) / HBM_BW
    collective_s = rec.get("collective_bytes", 0.0) / (ndev * NVLINK_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"])
    counted = rec.get("flops_hlo", 0.0) * ndev
    useful = mf / counted if counted else 0.0
    # roofline fraction: ideal time / achievable time.  Train/prefill are
    # compute-ideal (model flops at the bf16 peak); decode is bandwidth-
    # ideal (every step must at minimum stream weights + KV cache once).
    cell = shape_cell(rec["shape"])
    if cell.kind == "decode":
        min_bytes = rec.get("weight_bytes_per_device", 0) + \
            rec.get("cache_bytes_per_device", 0)
        ideal_s = min_bytes / HBM_BW
    else:
        ideal_s = mf / (ndev * PEAK_FLOPS["bf16"])
    bound_s = max(terms.values())
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "tag": rec.get("tag", ""),
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "model_flops": mf, "useful_ratio": useful,
        "roofline_fraction": (ideal_s / bound_s) if bound_s else 0.0,
        "hint": _HINTS[dominant],
    }


def load_all(mesh: Optional[str] = None, tag: str = "") -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(ART, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if mesh and rec.get("mesh") != mesh:
            continue
        if (rec.get("tag") or "") != tag:
            continue
        d = derive(rec)
        if d:
            rows.append(d)
    return rows


def markdown_table(rows: List[Dict]) -> str:
    out = ["| arch | shape | mesh | compute (s) | memory (s) | collective (s) "
           "| dominant | MODEL/counted flops | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.3f} | {r['memory_s']:.3f} "
            f"| {r['collective_s']:.3f} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.1%} |")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    rows = load_all(args.mesh, args.tag)
    print(markdown_table(rows))
    for r in rows:
        print(f"# {r['arch']}.{r['shape']}: dominant={r['dominant']} -> "
              f"{r['hint']}")


if __name__ == "__main__":
    main()
