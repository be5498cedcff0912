"""The port's benchmark harness: one module per paper table/figure.

Prints ``name,us_per_call,derived`` CSV rows, as ``benchmarks/run.py``
does for the JAX package, from the same sweeps.  Budgets scale via
REPRO_BENCH_SCALE and runs per Table 1 cell via REPRO_BENCH_RUNS
(common.py); the device is REPRO_BENCH_DEVICE (default ``cuda``; ``cpu``
only when asked for).

Usage (from the repo root):
    PYTHONPATH=src python -m benchmarks_torch.run [MODULE-SUBSTRING]
    REPRO_BENCH_DEVICE=cpu REPRO_BENCH_SCALE=0.0001 REPRO_BENCH_RUNS=1 \\
        PYTHONPATH=src python -m benchmarks_torch.run fig5

The reference's ``placement`` module waits for the port's HLO placement.
Exits non-zero when any module failed.
"""
from __future__ import annotations

import sys
import time
import traceback


def main() -> int:
    from . import (fig1_2_maxneighbors, fig3_temperature, fig4_exchange_period,
                   fig5_solvers, fig6_7_processes, kernel_micro,
                   table1_accuracy)
    modules = [
        ("fig1_2", fig1_2_maxneighbors),
        ("fig3", fig3_temperature),
        ("fig4", fig4_exchange_period),
        ("fig5", fig5_solvers),
        ("fig6_7", fig6_7_processes),
        ("table1+fig8", table1_accuracy),
        ("kernel", kernel_micro),
    ]
    only = sys.argv[1] if len(sys.argv) > 1 else None
    failed = []
    print("name,us_per_call,derived")
    for name, mod in modules:
        if only and only not in name:
            continue
        t0 = time.time()
        try:
            for row in mod.run():
                print(row, flush=True)
        except Exception:
            traceback.print_exc()
            print(f"{name}.ERROR,0,failed")
            failed.append(name)
        print(f"# {name} done in {time.time()-t0:.1f}s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
