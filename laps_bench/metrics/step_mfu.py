"""Model step: model FLOPs of the tokens the window's untraced ticks ran
(the benchmark's own count: 2 per weight per token, causal attention
over each segment's keys, the output head once per segment) over those
ticks' wall seconds times the card's bf16 peak, in %."""
from laps_bench import arith


def read(rec):
    return arith.ticks_mfu(rec, ("prefill", "decode"))
