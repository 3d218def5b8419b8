"""Engine: mean host-clock ms of the window's untraced ticks that ran a packed
step (a prefill or a chunk, with any fused decode rows), each ending in
the sampled tokens' copy to the host."""
import numpy as np


def read(rec):
    x = [k.t1 - k.t0 for k in rec.ticks if k.kind == "prefill"
         and not k.traced and rec.t_start <= k.t0 < rec.t_end]
    return float(np.mean(x)) * 1e3 if x else None
