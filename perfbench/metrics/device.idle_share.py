"""The share of the traced dispatch in which no operation ran on the
device (``torch.profiler``, CUPTI), in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
