"""``sum()`` over the key axes, resolved at once."""

from benchmark.common import Spec


def run(x, state, params):
    return x.sum().cache()


def spec(s, params):
    return Spec(s.vshape, 0, s.dtype)


def written(s, params):
    return s.record_bytes


def ops(s, params):
    return s.numel


def keep(out, sample):
    return {"sum": out.totorch().clone()}
