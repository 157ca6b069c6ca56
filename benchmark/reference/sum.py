"""``sum()`` over the key axes.  The number compared is the largest
error of an element over the sum of its terms' magnitudes (rounding
grows with that sum).  Behind a filter, each record the reference finds
within rounding of the bound may be in the program's sum or not: the
error's least-squares fit on those records says which, and anything but
a clean 0 or 1 for each reads as infinite."""

import torch


def apply(x, params, ctx):
    return x


def output(res, x, params, ctx):
    total = absum = None
    amb = []
    for _, _, blk in x.blocks():
        if x.pred is not None:
            certain, ambiguous = x.pred(blk)
            if bool(ambiguous.any()):
                amb.append(blk[ambiguous])
            blk = blk[certain]
        part, mag = blk.sum(0), blk.abs().sum(0)
        total = part if total is None else total + part
        absum = mag if absum is None else absum + mag
    return {"sum": total, "abs": absum,
            "ambiguous": torch.cat(amb) if amb else None}


def judge(got, ref):
    r = ref["sum"].double().reshape(-1)
    scale = ref["abs"].double().reshape(-1)
    g = torch.as_tensor(got["sum"]).to(r.device, torch.float64).reshape(-1)
    amb = ref.get("ambiguous")
    if amb is not None and len(amb):
        a = amb.double().reshape(len(amb), -1)
        c = torch.linalg.solve(a @ a.T, a @ (g - r))
        ci = c.round()
        if bool(((c - ci).abs() > 0.25).any()) or bool(
                ((ci != 0) & (ci != 1)).any()):
            return {"sum": float("inf")}
        r = r + ci @ a
        scale = scale + ci @ a.abs()
    return {"sum": float(((g - r).abs() / scale.clamp_min(1e-300)).max())}
