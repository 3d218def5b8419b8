"""Device: share of the traced ticks' wall time in which no device
operation ran, in %; the time the loop waits for arrivals between ticks
is not counted."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.tick_s or not tr.busy_s:
        return None
    return 100.0 * tr.tick_idle_s / tr.tick_s
