"""Profiling aid for the perf loop: lower one cell with costs and print
its top HBM-traffic ops and its top collectives -- the dry-run
equivalent of reading a profile.  The reference reads trip-multiplied
HLO instructions; the port reads ``topology.opcost``'s per-op table of
the step run once on ``meta`` (ops by name and input shapes, their
calls and bytes) and the collectives that run issued.

    PYTHONPATH=src python -m repro_torch.launch.inspect_cell \\
        --arch granite_34b --shape decode_32k --top 12
"""
from __future__ import annotations

import argparse
from typing import List

from ..topology.opcost import OpCost
from ..topology.traffic import CollectiveOp


def top_contributors(cost: OpCost, collectives: List[CollectiveOp],
                     k: int = 12) -> None:
    """Prints the ``k`` ops of ``cost.by_op`` moving the most HBM bytes
    (bytes over all calls, calls, op, input shapes) and the ``k``
    collectives of the most result bytes (bytes x count, count, kind,
    largest group's size)."""
    hbm_rows = sorted(((row[1], row[0], name, shapes)
                       for (name, shapes), row in cost.by_op.items()),
                      reverse=True)
    coll = {}
    for op in collectives:
        key = (op.kind, op.bytes, max(len(g) for g in op.groups))
        coll[key] = coll.get(key, 0) + 1
    coll_rows = sorted(((n * key[1], n) + key for key, n in coll.items()),
                       reverse=True)
    print("== top HBM traffic (bytes x calls) ==")
    for r in hbm_rows[:k]:
        print(f"  {r[0]:.3g}  x{r[1]:.0f} {r[2]:<22} {r[3][:70]}")
    print("== top collectives (result bytes x count) ==")
    for r in coll_rows[:k]:
        print(f"  {r[0]:.3g}  x{r[1]} {r[2]:<14} {r[3]:.3g} B "
              f"groups of {r[4]}")


def main() -> None:
    from .dryrun import _parse_overrides, _parse_rules
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--rule", action="append", default=[])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    from .. import configs
    from ..parallel import sharding as sh
    from . import placement_bench
    from .mesh import make_production_mesh
    overrides = _parse_overrides(args.override)
    rules = _parse_rules(args.rule)
    mesh = make_production_mesh(multi_pod=args.multi)
    sh.check_rules(mesh, rules)
    # route through compile_cell with patched config
    orig = configs.get_config
    configs.get_config = lambda a: orig(a).with_overrides(**overrides) \
        if overrides else orig(a)
    try:
        with sh.use_rules(sh.rules_for_mesh(mesh, rules)):
            lowered, mesh = placement_bench.compile_cell(
                args.arch, args.shape, args.multi)
    finally:
        configs.get_config = orig
    top_contributors(lowered.cost, lowered.collectives, args.top)


if __name__ == "__main__":
    main()
