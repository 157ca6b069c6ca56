"""``map``: ``add`` (``v + value``) or ``center`` (``v`` less its mean
over the record), per record."""


def _center(blk):
    return blk - blk.mean(dim=tuple(range(1, blk.ndim)), keepdim=True)


def apply(x, params, ctx):
    if params["fn"] == "add":
        value = params["value"]
        return x.then(lambda blk: blk + value)
    if params["fn"] == "center":
        return x.then(_center)
    raise ValueError("no reference for map fn %r" % params["fn"])
