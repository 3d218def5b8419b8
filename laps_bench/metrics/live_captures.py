"""Executors: step graphs captured after set-up, in the window and its
drain (the engine's graph count before and after)."""


def read(rec):
    return rec.graphs1 - rec.graphs0
