"""The 95th percentile of every call's wall in the window, enqueue to the
answers on the host, in ms (numpy's linear interpolation)."""
import numpy as np


def read(rec):
    if not rec.window.walls:
        return None
    return 1e3 * float(np.percentile(rec.window.walls, 95))
