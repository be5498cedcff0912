"""The benchmark's command, run from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card and prints its result as
the last line of standard output, one JSON object; the numbers compared
for ``correct`` go, each beside its limit, to the last lines of standard
error.  Exits with another code than 0, printing no result, without a
card, without the program beside the benchmark, or when JAX, its
libraries or the JAX package were loaded.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda") -> int:
    """Run a cell; ``device="cpu"`` (tests only) skips the look for a card
    and runs the program's plain PyTorch path."""
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch under {ROOT}: the benchmark runs beside "
              f"the program", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import harness
    cell = harness.load_cell(ROOT, args.workload)
    if device == "cuda" and (not torch.cuda.is_available() or
                             torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    trace = bool(args.trace)
    run = harness.run_cell(cell, args.seed, args.seconds, trace, device,
                           T_START)
    out = harness.result(run, device, trace)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in out["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
