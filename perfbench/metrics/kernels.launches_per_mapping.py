"""Kernel launches over the window per mapping answered in it, all
kernels together; the split by kernel goes to standard error."""
import sys


def read(run):
    split = {k: v for k, v in run.launches.items() if v}
    if not run.window or not split:
        return None
    print(f"kernels.launches_per_mapping split over {len(run.window)} "
          f"mappings: {split}", file=sys.stderr)
    return sum(split.values()) / len(run.window)
