"""The mean of the reported matvecs over the window's lanes."""
import numpy as np


def read(rec):
    if not rec.window.matvecs:
        return None
    return float(np.concatenate(rec.window.matvecs).mean())
