"""``swap``: the same permutation of axes (``benchmark/common.py``'s
copy of Bolt's algebra).  Number: the sampled records' largest error
over their largest magnitude (0 where the input is the dataset)."""

import math

from benchmark import common
from benchmark.reference.plain import rel_gap


def apply(x, params, ctx):
    perm, split = common.swap_perm(x.split, len(x.base.shape),
                                   params["kaxes"], params["vaxes"])
    return x.permute(perm, split)


def output(res, x, params, ctx):
    idx = ctx.sample(res.nrec, math.prod(res.vshape))
    return {"values": res.records(idx)}


def judge(got, ref):
    return {"values": rel_gap(got["values"], ref["values"])}
