"""From the start of the command to the window's opening: imports, the
CUDA context, the first pass's requests, the kernels' build (first run
of a checkout) and the first two passes (the first warms every kernel
the cell uses, the second fills the backlog)."""


def read(run):
    return run.setup_s
