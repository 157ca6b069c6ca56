"""Device milliseconds a pass of rank 0's NCCL kernels in the traced
window (``ncclDevKernel_*``; not the ``nccl:<op>`` range torch opens on
the card around each): the pod's exchanges, with every wait on a slower
rank (an NCCL kernel runs until its peers have joined it).  None where
the run is not a pod or its trace holds no NCCL kernel."""

from benchmark import tracing


def read(ctx):
    events = getattr(ctx, "events", None)
    if events is None or ctx.passes <= 0:
        return None
    window, spans = None, []
    for e in events:
        name = e.name()
        if tracing._is_device(e):
            if name.startswith("nccl") and tracing.is_operation(name):
                spans.append((e.start_ns(), e.end_ns()))
        elif name == tracing.WINDOW:
            window = (e.start_ns(), e.end_ns())
    if window is None:
        return None
    w0, w1 = window
    ns = sum(min(e, w1) - max(s, w0) for s, e in spans if e > w0 and s < w1)
    return ns * 1e-6 / ctx.passes if ns > 0 else None
