"""Percent of one card's roofline in the ``filter_sum`` range's calls on a
pod's rank 0: its share of the declared least time (the rank's share of the
bytes and operations, over 3.35 TB/s or the f32 peak, the larger) over
the device time of the operations launched inside them, from the traced
window.  The pod's part of ``filter_sum_roofline``, moving its own rate."""


def read(ctx):
    return ctx.roofline("filter_sum")
