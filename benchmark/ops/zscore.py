"""``ops.zscore``: every record standardised along value axis 0,
deferred into the chain (``ops/series.py``)."""

from benchmark.ops._records import sampled


def run(x, state, params):
    from bolt_tpu_torch import ops
    return ops.zscore(x, epsilon=params.get("epsilon", 0.0))


def spec(s, params):
    return s


def written(s, params):
    return s.nbytes


def ops(s, params):
    return 6 * s.numel


def keep(out, sample):
    if out.deferred:
        # a terminal that streams the chain in blocks (pca) leaves it
        # unmaterialised: its own comparison covers it
        return None
    return {"values": sampled(out, sample(out.split, out.shape))}
