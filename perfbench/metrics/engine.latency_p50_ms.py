"""The median of submit -> ``result()`` over the window's answers (host
clock), in ms."""
import numpy as np


def read(run):
    return float(np.percentile([(a.t_done - a.t_submit) * 1e3
                                for a in run.window], 50))
