"""Megabytes a pass that rank 0 sent and received through the pod's
collectives (``multihost.counters()["collective_bytes"]`` over the
window's passes).  None where the run is not a pod."""


def read(ctx):
    moved = getattr(ctx, "collective", None)
    if moved is None or ctx.passes <= 0:
        return None
    return moved("collective_bytes") / ctx.passes / 1e6
