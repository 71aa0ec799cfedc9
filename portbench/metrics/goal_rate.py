"""goal_rate: the scenario plans of the window whose last state lies in
their goal box (the configuration's goal_buffer, the angle dims wrapped),
over every scenario plan of the window."""
import math

import numpy as np


def read(run):
    if run.system != "fleet" or not run.replans:
        return None
    buf = np.asarray(run.cfg["goal_buffer"], np.float64)
    wrap = list(run.cfg["wrap_dims"])
    hit = total = 0
    for r in run.replans:
        for p in r["plans"]:
            total += 1
            if p["x"] is None or len(p["x"]) == 0:
                continue
            e = np.asarray(p["goal"], np.float64) - p["x"][-1]
            e[wrap] = np.remainder(e[wrap] + math.pi, 2 * math.pi) - math.pi
            hit += bool((np.abs(e) <= buf).all())
    return hit / total
