"""Prompt tokens (cached or computed) of every turn whose first token came
in the window, over the window's seconds."""


def read(rec):
    n = sum(len(t.prompt) for t in rec.turns
            if t.first is not None and rec.t_start <= t.first <= rec.t_end)
    return n / rec.seconds if n else None
