"""``stats()``: mean, population variance, min and max over the key
axes, in two passes.  Numbers: the mean's largest error over the mean
magnitude of its terms; the variance's largest relative error; and the
min's and max's largest error over their magnitude (0 where the input
is the dataset itself: each is one of its own values)."""

import numpy as np
import torch


def apply(x, params, ctx):
    return x


def moments(x):
    n = x.nrec
    s = a = mn = mx = None
    for _, _, blk in x.blocks():
        bs, ba = blk.sum(0), blk.abs().sum(0)
        bmn, bmx = blk.amin(0), blk.amax(0)
        s = bs if s is None else s + bs
        a = ba if a is None else a + ba
        mn = bmn if mn is None else torch.minimum(mn, bmn)
        mx = bmx if mx is None else torch.maximum(mx, bmx)
    mean = s / n
    m2 = None
    for _, _, blk in x.blocks():
        d = ((blk - mean) ** 2).sum(0)
        m2 = d if m2 is None else m2 + d
    return {"sum": s, "abs": a, "absmean": a / n, "mean": mean,
            "var": m2 / n, "min": mn, "max": mx, "n": n}


def output(res, x, params, ctx):
    m = moments(x)
    return {k: m[k] for k in ("mean", "var", "min", "max", "absmean")}


def as64(v, like):
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return torch.as_tensor(v).to(like.device, torch.float64).reshape(
        like.shape)


def minmax_gap(got_min, got_max, ref):
    lo, hi = ref["min"].double(), ref["max"].double()
    scale = torch.maximum(lo.abs(), hi.abs()).clamp_min(1e-300)
    return float(torch.maximum((as64(got_min, lo) - lo).abs(),
                               (as64(got_max, hi) - hi).abs()).div(scale)
                 .max())


def judge(got, ref):
    mean = ref["mean"].double()
    var = ref["var"].double()
    return {
        "mean": float(((as64(got["mean"], mean) - mean).abs()
                       / ref["absmean"].double().clamp_min(1e-300)).max()),
        "var": float(((as64(got["var"], var) - var).abs()
                      / var.abs().clamp_min(1e-300)).max()),
        "minmax": minmax_gap(got["min"], got["max"], ref)}
