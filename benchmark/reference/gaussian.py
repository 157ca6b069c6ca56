"""``gaussian``: correlation with normalised gaussian taps (radius
``int(4 sigma + 0.5)``, scipy.ndimage's construction) along each value
axis, zeros beyond the edges.  Number: the sampled records' largest
error over their largest magnitude."""

import math

import torch

from benchmark.reference.plain import rel_gap


def taps(sigma, truncate=4.0):
    radius = int(truncate * sigma + 0.5)
    t = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-radius, radius + 1)]
    total = sum(t)
    return [v / total for v in t]


def correlate(blk, w, dim):
    r = (len(w) - 1) // 2
    n = blk.shape[dim]
    pad = list(blk.shape)
    pad[dim] = r
    z = torch.zeros(pad, dtype=blk.dtype, device=blk.device)
    xp = torch.cat([z, blk, z], dim)
    out = torch.zeros_like(blk)
    for j, t in enumerate(w):
        out += t * xp.narrow(dim, j, n)
    return out


def apply(x, params, ctx):
    w = taps(params["sigma"])
    dims = [1 + a for a in params["axis"]]

    def f(blk):
        for d in dims:
            blk = correlate(blk, w, d)
        return blk
    return x.then(f)


def output(res, x, params, ctx):
    idx = ctx.sample(res.nrec, math.prod(res.vshape))
    return {"values": res.records(idx)}


def judge(got, ref):
    return {"values": rel_gap(got["values"], ref["values"])}
