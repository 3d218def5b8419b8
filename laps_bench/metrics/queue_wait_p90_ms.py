"""Loop: 90th percentile (ms) of the wait from a turn's due time to its
first dispatch (``Request.dispatch_time``), over the turns due in the
window that dispatched."""
import numpy as np


def read(rec):
    x = [t.dispatch - t.due for t in rec.in_window()
         if t.dispatch is not None]
    return float(np.percentile(x, 90)) * 1e3 if x else None
