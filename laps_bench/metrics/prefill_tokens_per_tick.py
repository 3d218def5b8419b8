"""Scheduler: useful tokens per dispatch of the packed executor over the
window (its own counters: prefill, chunk and fused decode rows)."""


def read(rec):
    k = "packed_dispatches"
    n = rec.stats1.get(k, 0) - rec.stats0.get(k, 0)
    u = (rec.stats1.get("packed_useful_tokens", 0)
         - rec.stats0.get("packed_useful_tokens", 0))
    return u / n if n else None
