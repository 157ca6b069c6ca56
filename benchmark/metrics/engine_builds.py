"""Programs the engine built inside the window (``misses`` of
``engine.counters()``): every one should have been built in set-up."""


def read(ctx):
    return float(ctx.engine("misses"))
