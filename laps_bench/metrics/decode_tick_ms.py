"""Engine: mean host-clock ms of the window's untraced decode-only
ticks."""
import numpy as np


def read(rec):
    x = [k.t1 - k.t0 for k in rec.ticks if k.kind == "decode"
         and not k.traced and rec.t_start <= k.t0 < rec.t_end]
    return float(np.mean(x)) * 1e3 if x else None
