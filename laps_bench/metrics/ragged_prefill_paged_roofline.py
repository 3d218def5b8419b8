"""Kernels: the least time of the traced ``ragged_prefill_paged``
launches (the larger of operations over the bf16 peak and bytes over the
memory bandwidth, from each segment's new tokens and history) over their
device time, in %."""
from laps_bench import arith


def _ours(name):
    return "ragged_prefill_kernel" in name and "Paged" in name


def read(rec):
    if rec.trace is None or not rec.peak:
        return None
    dev = rec.trace.kernel_seconds(_ours)
    if not dev:
        return None
    least = 0.0
    for k in rec.ticks:
        if k.traced:
            for segs in k.prefill:
                least += arith.least_seconds(
                    *arith.prefill_call(rec.shape, segs), rec.peak)
    least *= rec.shape.attn_layers        # one launch a layer with attention
    return 100.0 * least / dev if least else None
