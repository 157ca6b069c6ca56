"""``zscore(epsilon)``: each record less its mean over value axis 0,
over its population standard deviation plus ``epsilon``.  Number: the
sampled records' largest error over their largest magnitude."""

import math

from benchmark.reference.plain import rel_gap


def apply(x, params, ctx):
    eps = params.get("epsilon", 0.0)

    def f(blk):
        mu = blk.mean(dim=1, keepdim=True)
        sd = ((blk - mu) ** 2).mean(dim=1, keepdim=True).sqrt()
        return (blk - mu) / (sd + eps)
    return x.then(f)


def output(res, x, params, ctx):
    idx = ctx.sample(res.nrec, math.prod(res.vshape))
    return {"values": res.records(idx)}


def judge(got, ref):
    return {"values": rel_gap(got["values"], ref["values"])}
