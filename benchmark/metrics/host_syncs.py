"""Copies the host blocked on a pass (``engine.counters()``:
``host_syncs`` over the window's passes; ``engine.host_sync`` counts
each where it happens).  None where the run has no device trace (no
card to wait for) or the program counts none."""


def read(ctx):
    if ctx.trace is None or "host_syncs" not in ctx.engine1 \
            or ctx.passes <= 0:
        return None
    return ctx.engine("host_syncs") / ctx.passes
