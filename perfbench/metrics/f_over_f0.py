"""The mean of F(perm) / F0 over the window's answers: F recomputed by
the reference, F0 the generator's known optimum."""
import numpy as np


def read(run):
    return float(np.mean([a.f / a.req.optimum for a in run.window
                          if a.f is not None]))
