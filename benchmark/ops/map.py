"""``map(f)``: a per-record function joins the array's deferred chain.
``fn`` names it: ``add`` (``v + value``, which the expression compiler
takes into ``fused_map_reduce``) or ``center`` (``v - v.mean()``, a
reduction inside the map, which it does not take)."""


def _add(value):
    def add(v):
        return v + value
    return add


def _center(value):
    def center(v):
        return v - v.mean()
    return center


FNS = {"add": (_add, 1), "center": (_center, 2)}


def prepare(params):
    """The callable, made once, so every pass reuses its programs."""
    return FNS[params["fn"]][0](params.get("value"))


def run(x, fn, params):
    return x.map(fn)


def spec(s, params):
    return s


def written(s, params):
    return s.nbytes


def ops(s, params):
    return FNS[params["fn"]][1] * s.numel
