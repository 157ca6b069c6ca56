"""``detrend(order)``: each record less its least-squares polynomial of
degree ``order`` along value axis 0, by an orthonormal basis of the
polynomials (QR of the Vandermonde matrix of the sample index)."""

import torch


def apply(x, params, ctx):
    order = params.get("order", 1)
    length = x.vshape[0]
    t = torch.arange(length, dtype=torch.float64, device=x.base.device)
    t = t / max(1, length - 1)
    q, _ = torch.linalg.qr(torch.stack([t ** p for p in range(order + 1)],
                                       1))

    def f(blk):
        qq = q.to(blk.dtype)
        v = blk.movedim(1, -1)
        v = v - (v @ qq) @ qq.T
        return v.movedim(-1, 1)
    return x.then(f)
