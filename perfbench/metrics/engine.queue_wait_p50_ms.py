"""The median over the window's answers of the wait in the engine's
queue: submit -> the start of its group's solve
(``MapFuture.dispatched_at``, the program's stamp on the same monotonic
clock as the benchmark's submit stamp), in ms.  Nothing to read from a
program without the stamp."""
import numpy as np


def read(run):
    waits = [(a.future.dispatched_at - a.t_submit) * 1e3 for a in run.window
             if getattr(a.future, "dispatched_at", None) is not None]
    return float(np.percentile(waits, 50)) if waits else None
