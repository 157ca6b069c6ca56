"""``swap(kaxes, vaxes)``: key axes into the values and value axes into
the keys, materialised (``gpu/array.py``)."""

from benchmark.common import Spec, swap_perm
from benchmark.ops._records import sampled


def run(x, state, params):
    return x.swap(tuple(params["kaxes"]), tuple(params["vaxes"]))


def spec(s, params):
    perm, split = swap_perm(s.split, len(s.shape), params["kaxes"],
                            params["vaxes"])
    return Spec([s.shape[p] for p in perm], split, s.dtype)


def written(s, params):
    return s.nbytes


def ops(s, params):
    return 0


def keep(out, sample):
    return {"values": sampled(out, sample(out.split, out.shape))}
