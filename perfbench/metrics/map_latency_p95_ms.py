"""The 95th percentile of submit -> ``result()`` over every request
answered in the window (host clock), in ms."""
import numpy as np


def read(run):
    return float(np.percentile([(a.t_done - a.t_submit) * 1e3
                                for a in run.window], 95))
