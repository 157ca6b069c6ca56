"""``ops.gaussian``: a separable gaussian over value axes of every record
(``ops/overlap.py``; the window kernels)."""

from benchmark.ops._records import sampled


def _taps(sigma, truncate=4.0):
    return 2 * int(truncate * sigma + 0.5) + 1


def run(x, state, params):
    from bolt_tpu_torch import ops
    return ops.gaussian(x, sigma=params["sigma"], axis=tuple(params["axis"]),
                        size=params.get("size", "150"))


def spec(s, params):
    return s


def written(s, params):
    return s.nbytes


def ops(s, params):
    # a product and a sum a tap, per filtered axis
    return 2 * _taps(params["sigma"]) * len(params["axis"]) * s.numel


def keep(out, sample):
    return {"values": sampled(out, sample(out.split, out.shape))}
