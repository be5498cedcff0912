"""Reads the compared numbers of sound runs, of the control and of each
planted fault at a cell's own size, on the card, several seeds in one
process: the readings the limits in ``cells/<workload>.json`` are set
from.  The benchmark's own runs do not run it.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13 --seconds 10

Prints one JSON line a run (``kind``: ``sound``, ``control`` or a fault)
and the lowest and highest reading of each number by kind.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None, device: str = "cuda") -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--kinds", nargs="+",
                   help="sound, control or a fault (default: every one)")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import faults, harness
    kinds = args.kinds or ["sound", "control", *faults.FAULTS]
    cell = harness.load_cell(ROOT, args.workload)
    table = {}
    for kind in kinds:
        for seed in args.seeds:
            if kind in faults.FAULTS:
                with faults.planted(kind):
                    run = harness.run_cell(cell, seed, args.seconds, False,
                                           device)
            else:
                run = harness.run_cell(cell, seed, args.seconds, False,
                                       device)
                if kind == "control":
                    faults.control(run)
            out = harness.result(run, device, False)
            line = {"kind": kind, "seed": seed, "correct": out["correct"],
                    "failed": run.failed, "answers": len(run.answers),
                    "readings": run.readings}
            print(json.dumps(line), flush=True)
            for k, v in run.readings.items():
                table.setdefault(kind, {}).setdefault(k, []).append(v)
    for kind, numbers in table.items():
        print(json.dumps({"kind": kind, "range": {
            k: [min(v), max(v)] for k, v in numbers.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
