"""K4 (``qap_sa_step``)'s byte bound over its device time in the traced
dispatch, in %.  The bound counts each launch's inputs read once and its
outputs written once (``roofline.sa_step_bytes``); the candidates a
chain scores are known only inside the kernel (the acceptance cap stops
a chain early), so operations are not counted.  Every wave of the
dispatch makes one launch a temperature step, the same number each, at
its own bucket and padded batch.  Nothing to read without K4 launches
in the trace."""
from perfbench import roofline


def read(run):
    if run.trace is None or not run.traced:
        return None
    launches, seconds = run.trace.kernel("qap_sa_step")
    waves = {(a.bucket, a.batch_size) for a in run.traced}
    engine, sa = run.cell.config["engine"], run.cell.config["sa"]
    if launches == 0 or launches % len(waves) or any(
            b > engine["max_batch"] for _, b in waves):
        return None
    bound = 0.0
    for n, batch in waves:
        b0 = 1 << (batch - 1).bit_length()
        chains = b0 * engine["num_processes"] * sa["solvers"]
        bound += roofline.bound_s(roofline.sa_step_bytes(b0, n, chains))
    return 100.0 * (launches // len(waves)) * bound / seconds
