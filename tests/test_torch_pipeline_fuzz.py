"""The checker's prediction against execution on seeded random pipelines
(the port's counterpart of ``tests/test_pipeline_fuzz.py``'s
``_assert_checker_parity``).

Each case draws a chain of one to four operations (affine maps, scalar
operators, casts, a value-axis reduction, a ufunc, a swap, a trailing
filter) from its seed and builds it in ``bolt_tpu`` (the 8-device CPU
mesh) and in the port (``context=torch.device("cpu")``).  Before anything
runs, ``analysis.check`` of the port's pipeline must build and dispatch
nothing, find no error, and predict exactly (no tolerance) the shape —
the value axes behind a pending filter — and the dtype of the executed
result, and agree with the reference's check on ``shape``, ``dtype``,
``dynamic`` and ``ok``.  The executed values equal the reference's
(``rtol=1e-12`` in f64, ``1e-6`` after a cast to f32).
"""

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu import analysis as ref_analysis
from bolt_tpu_torch import analysis, engine

CPU = torch.device("cpu")


def _affine(rs):
    a = float(rs.choice([-2.0, 0.5, 3.0]))
    c = float(rs.choice([-1.0, 0.0, 2.5]))
    return (lambda v: v * a + c), (lambda v: v * a + c)


def _operator(rs):
    c = float(rs.choice([1.5, -0.5]))
    return (lambda b: b + c), (lambda b: b + c)


def _cast(rs):
    return (lambda b: b.astype(np.float32)), (lambda b: b.astype(np.float32))


def _vsum(rs):
    return (lambda b: b.map(lambda v: v.sum(axis=0)),
            lambda b: b.map(lambda v: v.sum(dim=0)))


def _exp(rs):
    return (lambda b: np.exp(b * 0.1)), (lambda b: np.exp(b * 0.1))


def _swap(rs):
    return (lambda b: b.swap((0,), (0,))), (lambda b: b.swap((0,), (0,)))


OPS = {"affine": _affine, "operator": _operator, "cast": _cast,
       "vsum": _vsum, "exp": _exp, "swap": _swap}


def _draw(seed):
    rs = np.random.RandomState(seed)
    names = list(rs.choice(sorted(OPS), size=rs.randint(1, 5)))
    steps = []
    for n in names:
        r_op, p_op = OPS[n](rs)
        if n in ("affine",):
            steps.append((n, lambda b, f=r_op: b.map(f),
                          lambda b, f=p_op: b.map(f)))
        else:
            steps.append((n, r_op, p_op))
    if rs.rand() < 0.4:
        steps.append(("filter", lambda b: b.filter(lambda v: v.mean() > 0),
                      lambda b: b.filter(lambda v: v.mean() > 0)))
    return steps


@pytest.mark.parametrize("seed", range(30))
def test_checker_predicts_the_executed_pipeline(mesh, seed):
    x = np.random.RandomState(100 + seed).randn(16, 6, 4)
    r, p = ref.array(x, mesh), bolt.array(x, CPU)
    applied = []
    for name, r_op, p_op in _draw(seed):
        if name == "vsum" and len(p.shape) - p.split < 2:
            continue
        r, p = r_op(r), p_op(p)
        applied.append(name)
    c0 = engine.counters()
    rep = analysis.check(p)
    c1 = engine.counters()
    for k in ("misses", "aot_compiles", "dispatches"):
        assert c1[k] == c0[k], (k, applied)
    assert rep.ok, (applied, rep.diagnostics)
    want = ref_analysis.check(r)
    assert (rep.shape, rep.dynamic, rep.ok) == (
        tuple(want.shape), want.dynamic, want.ok), applied
    assert np.dtype(rep.dtype) == np.dtype(want.dtype), applied
    got = p.toarray()
    if rep.dynamic:
        assert rep.shape[0] is None and rep.shape[1:] == got.shape[1:]
    else:
        assert rep.shape == got.shape, (applied, rep.shape, got.shape)
    assert np.dtype(rep.dtype) == got.dtype, applied
    rtol = 1e-6 if got.dtype == np.float32 else 1e-12
    assert np.allclose(got, np.asarray(r.toarray()), rtol=rtol,
                       atol=rtol), applied
