"""Mean host microseconds of one engine dispatch without its waits for
the card (``engine.counters()``: ``dispatch_seconds`` less
``dispatch_sync_seconds``, the counted synchronisations inside
dispatches, over ``dispatches``).  None where the run has no device
trace or the program counts no such waits."""


def read(ctx):
    n = ctx.engine("dispatches")
    if ctx.trace is None or "dispatch_sync_seconds" not in ctx.engine1 \
            or n <= 0:
        return None
    return 1e6 * (ctx.engine("dispatch_seconds")
                  - ctx.engine("dispatch_sync_seconds")) / n
