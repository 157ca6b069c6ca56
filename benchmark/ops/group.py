"""The fluent stat group ``stats("sum", "mean", ...)``: every member
over the key axes, resolved together (``gpu/multistat.py``)."""

from benchmark.common import Spec


def run(x, state, params):
    return x.stats(*params["names"])


def spec(s, params):
    return Spec(s.vshape, 0, s.dtype)


def written(s, params):
    return len(params["names"]) * s.record_bytes


def ops(s, params):
    return len(params["names"]) * s.numel


def keep(out, sample):
    return {name: arr.totorch().clone() for name, arr in out.items()}
