"""Kernels: the least time of the traced ``decode_attn_paged`` launches
(bytes of the keys and values each live row reads, over the memory
bandwidth, or its operations over the bf16 peak) over the device time of
its split and combine kernels, in %."""
from laps_bench import arith


def _ours(name):
    return ("decode_split_kernel" in name and "Paged" in name) or \
        "decode_combine_kernel" in name


def read(rec):
    if rec.trace is None or not rec.peak:
        return None
    dev = rec.trace.kernel_seconds(_ours)
    if not dev:
        return None
    least = 0.0
    for k in rec.ticks:
        if k.traced:
            for lens in k.decode:
                least += arith.least_seconds(
                    *arith.decode_call(rec.shape, lens), rec.peak)
    least *= rec.shape.attn_layers        # one launch a layer with attention
    return 100.0 * least / dev if least else None
