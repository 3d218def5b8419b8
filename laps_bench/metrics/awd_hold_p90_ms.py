"""Scheduler: 90th percentile (ms) of ``Request.awd_hold_s``, the part of
a short turn's queue wait during which the policy held the short queue
open for the AWD window, over the short turns due in the window that
dispatched; nothing where the program keeps no such count."""
import numpy as np


def read(rec):
    x = [t.req.awd_hold_s for t in rec.in_window()
         if t.dispatch is not None
         and getattr(t.req, "awd_hold_s", None) is not None]
    return float(np.percentile(x, 90)) * 1e3 if x else None
