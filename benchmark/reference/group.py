"""The stat group ``stats("sum", "mean", "var", "std", "min", "max")``:
each member as ``reference/stats.py`` and ``reference/sum.py`` measure
it (population variance, as the standalone terminals take it)."""

import torch

from benchmark import common


def apply(x, params, ctx):
    return x


def output(res, x, params, ctx):
    m = common.piece("reference", "stats").moments(x)
    out = {"abs": m["abs"], "absmean": m["absmean"]}
    for name in params["names"]:
        out[name] = m["var"].sqrt() if name == "std" else m[name]
    return out


def judge(got, ref):
    stats = common.piece("reference", "stats")
    out = {}
    for name in ("sum", "mean", "var", "std"):
        if name not in got:
            continue
        want = ref[name].double()
        scale = {"sum": ref["abs"], "mean": ref["absmean"]}.get(name, want)
        out[name] = float(((stats.as64(got[name], want) - want).abs()
                           / scale.double().abs().clamp_min(1e-300)).max())
    if "min" in got or "max" in got:
        out["minmax"] = stats.minmax_gap(got["min"], got["max"], ref)
    return out
