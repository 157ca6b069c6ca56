"""``ops.pca(k, center)``: the pixel series' Gram route, its ``(d, d)``
eigenproblem and the projection (``ops/linalg.py``), results kept on the
card (``fetch=False``)."""

from benchmark.common import Spec
from benchmark.ops._records import sampled


def run(x, state, params):
    from bolt_tpu_torch import ops
    return ops.pca(x, k=params["k"], center=params.get("center", False),
                   fetch=False)


def spec(s, params):
    return Spec(s.kshape + (params["k"],), s.split, s.dtype)


def written(s, params):
    k = params["k"]
    d = s.record_bytes // 4
    return 4 * (s.nrec * k + d * k + k)


def ops(s, params):
    k = params["k"]
    d = s.numel // s.nrec
    # the Gram X^T X and the projection X V
    return 2 * s.nrec * d * d + 2 * s.nrec * d * k


def keep(out, sample):
    scores, vec, sv = out
    return {"vec": vec.clone(), "sv": sv.clone(),
            "scores": sampled(scores, sample(scores.split, scores.shape))}
