"""``stats()``: count, mean, variance, min and max over the key axes in
one pass (``gpu/stats.py``'s ``fused_welford``), as a StatCounter on the
host."""

from benchmark.common import Spec


def run(x, state, params):
    return x.stats()


def spec(s, params):
    return Spec(s.vshape, 0, s.dtype)


def written(s, params):
    # mean, second moment, min and max, each record-shaped
    return 4 * s.record_bytes


def ops(s, params):
    return 8 * s.numel


def keep(out, sample):
    return {"mean": out.mean(), "var": out.variance(), "min": out.min(),
            "max": out.max()}
