"""``filter(pred)``: keep the records whose predicate holds.  ``fn``:
``mean_gt`` (``v.mean() > value``, BASELINE config 4's predicate)."""


def _mean_gt(value):
    def pred(v):
        return v.mean() > value
    return pred


FNS = {"mean_gt": _mean_gt}


def prepare(params):
    return FNS[params["fn"]](params["value"])


def run(x, pred, params):
    return x.filter(pred)


def spec(s, params):
    # the survivors' count depends on the data; every record is read
    return s


def written(s, params):
    return s.nbytes


def ops(s, params):
    return s.numel
