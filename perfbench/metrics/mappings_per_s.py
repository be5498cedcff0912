"""Mappings answered correctly in the window over the window's length:
whole dispatches, from one pass's completion to another's (host clock).
An answer is correct where the reference finds it right on its own."""


def read(run):
    return sum(a.ok for a in run.window) / (run.t_close - run.t_open)
