"""Model step, decode only: ``step_mfu`` over the window's untraced
decode-only ticks, the whole step's share of the peak beside
``decode_attn_paged_roofline``."""
from laps_bench import arith


def read(rec):
    return arith.ticks_mfu(rec, ("decode",))
