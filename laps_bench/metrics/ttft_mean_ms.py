"""Mean time to first token (ms) over every turn due in the window, from
the time it was due; turns with no first token are counted as failed,
not here."""
import numpy as np


def read(rec):
    x = [t.first - t.due for t in rec.in_window() if t.first is not None]
    return float(np.mean(x)) * 1e3 if x else None
