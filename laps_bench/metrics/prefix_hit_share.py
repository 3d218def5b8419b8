"""KV arena: prompt tokens served from the radix index (prefix hits at
submit and at chunk boundaries, over the window and its drain) over the
prompt tokens of the turns due in the window, in %."""


def read(rec):
    hit = sum(rec.stats1[k] - rec.stats0[k]
              for k in ("prefix_hit_tokens", "chunk_hit_tokens"))
    total = sum(len(t.prompt) for t in rec.in_window())
    return 100.0 * hit / total if total else None
