"""Scheduler: the mean (ms) of ``Request.awd_hold_s`` over the short
turns due in the window that dispatched, as ``awd_hold_p90_ms`` reads
them.  Steadier than the 90th percentile, which sits near the edge of
the share of turns held at all (7-14% on qwen3-4b) and so reads 0 or
some milliseconds by seed."""
import numpy as np


def read(rec):
    x = [t.req.awd_hold_s for t in rec.in_window()
         if t.dispatch is not None
         and getattr(t.req, "awd_hold_s", None) is not None]
    return float(np.mean(x)) * 1e3 if x else None
