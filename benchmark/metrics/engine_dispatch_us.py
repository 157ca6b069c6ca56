"""Mean host microseconds of one engine dispatch in the window
(``engine.counters()``: ``dispatch_seconds`` over ``dispatches``; a
dispatch that synchronises includes its wait for the card)."""


def read(ctx):
    n = ctx.engine("dispatches")
    if n <= 0:
        return None
    return 1e6 * ctx.engine("dispatch_seconds") / n
