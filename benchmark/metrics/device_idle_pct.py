"""Percent of the traced window in which no kernel, copy or fill ran on
the card (the union of the profiler's device intervals)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
