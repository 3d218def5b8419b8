"""90th percentile (ms) of every gap between consecutive output tokens of
the turns due in the window, each gap ending inside the window."""
import numpy as np


def read(rec):
    gaps = []
    for t in rec.in_window():
        s = t.times
        gaps.extend(b - a for a, b in zip(s, s[1:]) if b <= rec.t_end)
    return float(np.percentile(gaps, 90)) * 1e3 if gaps else None
