"""Device operations a pass: the kernels, copies and fills of the traced
window (torch's own launches counted, where the LAUNCHES check covers
only the port's six kernels) over the window's passes."""

from benchmark import spans


def read(ctx):
    s = spans.of(ctx)
    if s is None or ctx.passes <= 0:
        return None
    return s.device_ops / ctx.passes
