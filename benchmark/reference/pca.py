"""``pca(k, center)`` of the records as samples and their values as
features: the centred Gram, its eigendecomposition, the top ``k``.

Numbers, each over the reference's own scale:
- ``whitened``: the sampled rows of the program's scores over its
  singular values against the reference's, each component's sign taken
  as the program's, over their largest magnitude: every component
  weighs alike, and a wrong singular value shows here (the values
  alone do not separate from the control: a TF32 Gram over millions of
  rows errs no more than an f32 one);
- ``scores``: the sampled rows of the program's scores against the
  reference's scores (the reference's rows on the reference's
  components, each component's sign taken as the program's), over their
  largest magnitude: a wrong component shows here;
- ``projection``: the same rows of the program's scores against the
  reference's rows projected on the program's own components: components
  returned that are not the ones the scores were made with show here;
- ``subspace``: the sine of the largest principal angle between the
  program's components (orthonormalised in f64) and the reference's."""

import math

import torch


def apply(x, params, ctx):
    return x


def output(res, x, params, ctx):
    k = params["k"]
    d = math.prod(x.vshape)
    n = x.nrec
    g = torch.zeros((d, d), dtype=x.dtype, device=x.base.device)
    s1 = torch.zeros(d, dtype=x.dtype, device=x.base.device)
    for _, _, blk in x.blocks():
        m = blk.reshape(-1, d)
        g += m.T @ m
        s1 += m.sum(0)
    mu = s1 / n if params.get("center", False) else torch.zeros_like(s1)
    c = g - n * torch.outer(mu, mu)
    evals, vecs = torch.linalg.eigh(c)
    evals, vecs = evals.flip(0), vecs.flip(1)
    vec = vecs[:, :k]
    rows = x.records(ctx.sample(n, k)).reshape(-1, d)
    return {"vec": vec, "sv": evals[:k].clamp_min(0).sqrt(),
            "scores": (rows - mu) @ vec, "rows": rows, "mu": mu}


def judge(got, ref):
    dev = ref["sv"].device
    vec = torch.as_tensor(got["vec"]).to(dev, torch.float64)
    sv = torch.as_tensor(got["sv"]).to(dev, torch.float64)
    want_sv = ref["sv"].double()
    rows = ref["rows"].double() - ref["mu"].double()
    want = ref["scores"].double()
    scores = torch.as_tensor(got["scores"]).to(dev, torch.float64).reshape(
        want.shape)
    sign = torch.where((scores * want).sum(0) < 0, -1.0, 1.0).to(want)
    own = rows @ vec
    q = torch.linalg.qr(vec)[0]
    v = ref["vec"].double()
    out_of = q - v @ (v.T @ q)
    white = want * sign / want_sv
    return {
        "whitened": float((scores / sv - white).abs().max()
                          / white.abs().max().clamp_min(1e-300)),
        "scores": float((scores - want * sign).abs().max()
                        / want.abs().max().clamp_min(1e-300)),
        "projection": float((scores - own).abs().max()
                            / own.abs().max().clamp_min(1e-300)),
        "subspace": float(torch.linalg.matrix_norm(out_of, 2))}
