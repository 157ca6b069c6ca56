"""The port's per-record series transforms (``detrend``, ``zscore``,
``center``, ``crosscorr``, ``fourier``, ``normalize``) and the imaging
workflow's preprocessing against the reference's, on the same seeded numpy
inputs: the reference on the conftest CPU mesh, the port on the CPU device.
Tolerances: f64 ``rtol=atol=1e-12`` where both compute the same
expression, ``rtol=1e-10`` across the fit's matmuls and the FFT (their
summation orders differ); dtypes equal.  Follows ``test_ops_series.py``
and ``test_workflow_e2e.py`` (up to its ``filter`` step, ROADMAP A5)."""

import numpy as np
import pytest
import scipy.signal
import torch

import bolt_tpu as ref
import bolt_tpu.ops as rops
import bolt_tpu_torch as bolt
from bolt_tpu_torch import ops

CPU = torch.device("cpu")


def _x(shape=(3, 20, 6), seed=31):
    return np.random.RandomState(seed).randn(*shape)


def _same(g, t, rtol=1e-10, atol=1e-12):
    gv, tv = np.asarray(g.toarray()), np.asarray(t.toarray())
    assert gv.shape == tv.shape and gv.dtype == tv.dtype, \
        (gv.shape, tv.shape, gv.dtype, tv.dtype)
    np.testing.assert_allclose(gv, tv, rtol=rtol, atol=atol)


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_detrend_matches_reference(mesh, order, axis):
    x = _x()
    t = rops.detrend(ref.array(x, mesh), order=order, axis=axis)
    g = ops.detrend(bolt.array(x, CPU), order=order, axis=axis)
    assert g.deferred
    _same(g, t)
    ax = axis % 2 + 1
    if order <= 1:
        want = scipy.signal.detrend(
            x, axis=ax, type="linear" if order else "constant")
        np.testing.assert_allclose(g.toarray(), want, rtol=1e-8, atol=1e-10)


def test_detrend_removes_a_quadratic_and_fuses(mesh):
    x = _x()
    t = np.linspace(-1, 1, 20)
    y = x + (3.0 * t ** 2 + 2.0 * t - 1.0)[None, :, None]
    g = ops.detrend(bolt.array(y, CPU), order=2).toarray()
    np.testing.assert_allclose(
        g, ops.detrend(bolt.array(x, CPU), order=2).toarray(), atol=1e-12)
    # a deferred map chain joins the transform and the next action
    tr = rops.detrend(ref.array(x, mesh).map(lambda v: v * 2.0)).sum(
        axis=(0,))
    gr = ops.detrend(bolt.array(x, CPU).map(lambda v: v * 2.0)).sum(
        axis=(0,))
    _same(gr, tr)


def test_detrend_errors_match_reference(mesh):
    x = _x()
    for kw in (dict(order=-1), dict(order=25), dict(axis=7)):
        with pytest.raises(ValueError):
            rops.detrend(ref.array(x, mesh), **kw)
        with pytest.raises(ValueError):
            ops.detrend(bolt.array(x, CPU), **kw)


@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("axis", [0, 1])
def test_zscore_center_match_reference(mesh, ddof, axis):
    x = _x()
    _same(ops.zscore(bolt.array(x, CPU), axis=axis, ddof=ddof),
          rops.zscore(ref.array(x, mesh), axis=axis, ddof=ddof))
    _same(ops.center(bolt.array(x, CPU), axis=axis),
          rops.center(ref.array(x, mesh), axis=axis))


def test_zscore_epsilon_guards_constant_records(mesh):
    const = np.ones((2, 5))
    g = ops.zscore(bolt.array(const, CPU), epsilon=1e-6)
    _same(g, rops.zscore(ref.array(const, mesh), epsilon=1e-6))
    np.testing.assert_array_equal(g.toarray(), 0.0)


def test_crosscorr_matches_reference(mesh):
    rs = np.random.RandomState(5)
    x = rs.randn(6, 30)
    sig = rs.randn(30)
    for lag in (0, 3):
        g = ops.crosscorr(bolt.array(x, CPU), sig, lag=lag)
        assert g.shape == (6, 2 * lag + 1)
        _same(g, rops.crosscorr(ref.array(x, mesh), sig, lag=lag))
    for i, k in ((0, -3), (2, 0), (5, 2)):
        a, s = (x[i, k:], sig[:30 - k]) if k >= 0 else (x[i, :30 + k],
                                                        sig[-k:])
        assert np.isclose(g.toarray()[i, k + 3], np.corrcoef(a, s)[0, 1],
                          rtol=1e-10)
    x3 = rs.randn(4, 20, 3)
    s3 = rs.randn(20)
    _same(ops.crosscorr(bolt.array(x3, CPU), s3, lag=2, axis=0),
          rops.crosscorr(ref.array(x3, mesh), s3, lag=2, axis=0))
    z = ops.crosscorr(bolt.array(np.ones((2, 10)), CPU), sig[:10],
                      epsilon=1e-9)
    assert np.isfinite(z.toarray()).all()


def test_crosscorr_errors_match_reference(mesh):
    x = np.random.RandomState(3).randn(3, 10)
    for args in ((np.zeros(7),), (np.zeros(10), -1), (np.zeros(10), 10),
                 (np.zeros(10), 9)):
        with pytest.raises(ValueError):
            rops.crosscorr(ref.array(x, mesh), *args)
        with pytest.raises(ValueError):
            ops.crosscorr(bolt.array(x, CPU), *args)


def test_fourier_matches_reference(mesh):
    T = 64
    t = np.arange(T)
    rs = np.random.RandomState(17)
    x = np.stack([np.sin(2 * np.pi * 4 * t / T + 0.7),
                  np.sin(2 * np.pi * 4 * t / T) + rs.randn(T) * 0.1,
                  rs.randn(T)])
    gc, gp = ops.fourier(bolt.array(x, CPU), freq=4)
    tc, tp = rops.fourier(ref.array(x, mesh), freq=4)
    assert gc.deferred and gp.deferred
    _same(gc, tc)
    _same(gp, tp)
    assert np.isclose(gc.toarray()[0], 1.0, atol=1e-9)
    assert np.isclose(gp.toarray()[0], 0.7 - np.pi / 2, atol=1e-9)
    for freq in (0, T):
        with pytest.raises(ValueError):
            ops.fourier(bolt.array(x, CPU), freq=freq)
    c, _ = ops.fourier(bolt.array(np.ones((2, 16)), CPU), freq=2,
                       epsilon=1e-9)
    assert np.isfinite(c.toarray()).all()


@pytest.mark.parametrize("baseline", ["percentile", "mean"])
def test_normalize_matches_reference(mesh, baseline):
    x = np.random.RandomState(23).rand(5, 40) + 0.5
    _same(ops.normalize(bolt.array(x, CPU), baseline=baseline, perc=20),
          rops.normalize(ref.array(x, mesh), baseline=baseline, perc=20))
    xn = np.array([[-1e-6, -1e-6, -1e-6, 1.0]])
    zn = ops.normalize(bolt.array(xn, CPU), baseline=baseline, perc=20,
                       epsilon=1e-6)
    _same(zn, rops.normalize(ref.array(xn, mesh), baseline=baseline,
                             perc=20, epsilon=1e-6))
    assert np.isfinite(zn.toarray()).all()
    for kw in (dict(baseline="windowed"), dict(perc=150)):
        with pytest.raises(ValueError):
            ops.normalize(bolt.array(x, CPU), **kw)


@pytest.mark.parametrize("name,call", [
    ("detrend", lambda m, b: m.detrend(b, order=1)),
    ("zscore", lambda m, b: m.zscore(b, epsilon=1e-9)),
    ("center", lambda m, b: m.center(b)),
    ("crosscorr", lambda m, b: m.crosscorr(b, np.arange(20.0) % 7, lag=2)),
    ("fourier", lambda m, b: m.fourier(b, freq=3)[0]),
    ("normalize", lambda m, b: m.normalize(b, epsilon=1e-9))],
    ids=["detrend", "zscore", "center", "crosscorr", "fourier",
         "normalize"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_result_dtypes_match_reference(mesh, name, call, dtype):
    # an int32 record widens to f32 under the reference's jnp rule (the
    # local mode keeps numpy's f64)
    x = (_x((3, 20)) * 10).astype(dtype)
    t = call(rops, ref.array(x, mesh))
    g = call(ops, bolt.array(x, CPU))
    _same(g, t, rtol=2e-5, atol=2e-5)
    lo = call(ops, bolt.array(x))
    _same(lo, call(rops, ref.array(x)))


@pytest.mark.parametrize("name,call", [
    ("detrend", lambda m, b: m.detrend(b, order=2)),
    ("zscore", lambda m, b: m.zscore(b, ddof=1)),
    ("crosscorr", lambda m, b: m.crosscorr(b, np.arange(20.0), lag=1)),
    ("normalize", lambda m, b: m.normalize(b, perc=35))],
    ids=["detrend", "zscore", "crosscorr", "normalize"])
def test_local_mode_matches_reference_local(name, call):
    x = _x()
    _same(call(ops, bolt.array(x)), call(rops, ref.array(x)), rtol=1e-12)


def test_calcium_imaging_preprocessing_matches_reference(mesh):
    # test_workflow_e2e.py's pipeline: zscore(detrend) -> smooth -> stats
    rs = np.random.RandomState(42)
    npix, T = 64, 48
    sig = np.sin(np.linspace(0, 4 * np.pi, T))
    x = (rs.randn(npix, T) * 0.3 + np.linspace(0, 2, T)[None, :]
         + np.outer(rs.randn(npix), sig))

    def pipeline(m, b):
        return m.smooth(m.zscore(m.detrend(b, order=1), epsilon=1e-9), 3,
                        axis=(0,), size=(12,))

    t = pipeline(rops, ref.array(x, mesh, axis=(0,)))
    g = pipeline(ops, bolt.array(x, CPU))
    _same(g, t)
    np.testing.assert_allclose(g.stats().mean(), t.stats().mean(),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(g.stats().variance(), t.stats().variance(),
                               rtol=1e-10)


def test_image_stack_denoise_matches_reference(mesh2d):
    # test_workflow_e2e.py's denoise step: median_filter -> gaussian over
    # both spatial axes of a (time, H, W) stack
    x = np.random.RandomState(7).rand(8, 12, 10) ** 2

    def denoise(m, b):
        return m.gaussian(m.median_filter(b, 3, axis=(0, 1), size=(6, 5)),
                          1.0, axis=(0, 1), size=(6, 5))

    t = denoise(rops, ref.array(x, mesh2d, axis=(0,)))
    g = denoise(ops, bolt.array(x, CPU))
    _same(g, t)
    _same(denoise(ops, bolt.array(x)), t)
    # the per-frame peak pixel agrees
    peak = np.asarray([np.argmax(f) for f in t.toarray()])
    np.testing.assert_array_equal(
        g.map(lambda v: v.reshape(-1).argmax()).toarray(), peak)


def test_series_bodies_are_differentiable():
    # the per-record bodies are plain torch pipelines: gradients flow
    from bolt_tpu_torch.ops.series import _detrend_fn, _zscore_fn
    x = torch.tensor(np.random.RandomState(2).randn(20),
                     requires_grad=True)
    det = _detrend_fn(20, 1, 0)
    (g,) = torch.autograd.grad((det(x) ** 2).sum(), x)
    t = np.linspace(-1, 1, 20)
    a = np.vander(t, 2, increasing=True)
    r = np.eye(20) - a @ np.linalg.pinv(a)
    np.testing.assert_allclose(g.numpy(), 2 * r @ x.detach().numpy(),
                               atol=1e-10)
    (gz,) = torch.autograd.grad((_zscore_fn(0, 0, 1e-9)(x) ** 2).sum(), x)
    assert torch.isfinite(gz).all()
