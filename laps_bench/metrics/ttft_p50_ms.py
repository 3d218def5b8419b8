"""Median time to first token (ms) over every turn due in the window,
from the time it was due."""
import numpy as np


def read(rec):
    x = [t.first - t.due for t in rec.in_window() if t.first is not None]
    return float(np.percentile(x, 50)) * 1e3 if x else None
