"""The 95th percentile of all the window's step times, in milliseconds
(each from the step's start to the synchronize after it; numpy's linear
interpolation between order statistics)."""
import numpy as np


def read(window):
    if not window.units:
        return None
    return float(np.percentile(window.unit_seconds(), 95)) * 1e3
