"""Seconds from the process's start to the window's: imports, weights,
the engine and its page pool, the warm-up trace that captures every step
graph, and in a checkout's first run the kernels' build."""


def read(rec):
    return rec.setup_s
