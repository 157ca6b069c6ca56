"""``ops.detrend``: a least-squares polynomial trend removed from every
record along value axis 0, deferred into the chain (``ops/series.py``)."""


def run(x, state, params):
    from bolt_tpu_torch import ops
    return ops.detrend(x, order=params.get("order", 1))


def spec(s, params):
    return s


def written(s, params):
    return s.nbytes


def ops(s, params):
    # the fit's two thin products and the subtraction
    return (4 * (params.get("order", 1) + 1) + 1) * s.numel
