"""Percent of a pod's traced window in which no kernel, copy or fill ran
on rank 0's card (the union of the profiler's device intervals): the
pod's part of ``device_idle_pct``, moving its own rate."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
