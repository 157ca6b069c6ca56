"""Percent of the H100's roofline in the ``group`` range's calls: their
declared least time (bytes read once and written once over 3.35 TB/s, or
operations over the f32 peak, the larger) over the device time of the
operations launched inside them, from the traced window."""


def read(ctx):
    return ctx.roofline("group")
