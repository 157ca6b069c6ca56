"""``__array_function__`` on the port: the non-ufunc numpy API on
``BoltArrayGPU`` against the reference's.

The assertions of the ``tests/test_array_function.py`` tests of the
families this package's table serves (``bolt_tpu_torch/gpu/npdispatch.py``:
the core table, ``np.histogram``/``histogram2d``/``histogramdd``,
``np.bincount``, ``np.unique``, ``np.cov``/``np.corrcoef`` and the set
operations) on ``bolt_tpu_torch`` (``context=torch.device("cpu")``), with
the same seeded inputs fed to ``bolt_tpu`` (8-device CPU mesh, x64).
Expected values are numpy's on the host array (``allclose``, NaN equal;
integer results exactly); each device case also equals the reference's
result to the same tolerance.  The stacking, einsum, nan-family,
``np.linalg``, ``np.fft`` and tail families are held in
``tests/test_torch_npdispatch_tail.py``.
"""

import warnings

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch import profile
from bolt_tpu_torch.gpu import array as garray
from tests.test_array_function import DEVICE_CASES

CPU = torch.device("cpu")


def _x():
    return np.random.RandomState(31).randn(16, 6, 4)


def _norm(v):
    if isinstance(v, (tuple, list)):
        return tuple(np.asarray(i) for i in v)
    return np.asarray(v.toarray() if hasattr(v, "toarray") else v)


def _same(got, want, name):
    g, e = _norm(got), _norm(want)
    if isinstance(e, tuple):
        assert len(g) == len(e), name
        assert all(np.array_equal(a, b) for a, b in zip(g, e)), name
    else:
        assert g.shape == e.shape, (name, g.shape, e.shape)
        assert np.allclose(g, e, equal_nan=True), name


@pytest.mark.parametrize("name,call", DEVICE_CASES,
                         ids=[c[0] for c in DEVICE_CASES])
def test_numpy_semantics_parity(mesh, name, call):
    x = _x()
    if name == "searchsorted":
        x = np.sort(x.ravel())
    b = bolt.array(x, CPU)
    got = call(b)
    # served on the device: a bolt array comes back (the port's nonzero
    # and searchsorted methods return host index arrays, as they do
    # called directly)
    if name not in ("nonzero", "searchsorted"):
        assert getattr(got, "mode", None) == "gpu", name
    _same(got, call(x), name)
    _same(got, call(ref.array(x, mesh)), name)


def test_device_served_no_gather(monkeypatch):
    # np.sum(b) and the other table entries run on the device: no toarray,
    # no __array__ anywhere in their path, and the engine runs programs
    x = _x()
    b = bolt.array(x, CPU)
    xs = np.floor(x[:, 0, :] * 2)
    s = bolt.array(xs, CPU)

    def gathered(*args, **kwargs):
        raise AssertionError("gathered!")

    monkeypatch.setattr(type(b), "toarray", gathered)
    monkeypatch.setattr(type(b), "__array__", gathered)
    with profile.instrument() as stats:
        out = np.sum(b).cache()
        mean = np.mean(b, axis=0).cache()
        srt = np.sort(b, axis=1)
        cat = np.concatenate([b, b], axis=2)
        counts, edges = np.histogram(b, bins=8)
        c = np.cov(s)
        u = np.unique(s)
        bc = np.bincount(np.abs(s).astype(np.int64).ravel())
    assert out.mode == "gpu" and out.split == 0
    assert sum(v["calls"] for v in stats.values()) >= 5
    for arr, want in ((out, x.sum()), (mean, x.mean(axis=0)),
                      (srt, np.sort(x, axis=1)),
                      (cat, np.concatenate([x, x], axis=2))):
        assert np.allclose(arr.totorch().numpy(), want)
    cn, en = np.histogram(x, bins=8)
    assert np.array_equal(counts, cn) and np.allclose(edges, en)
    assert np.allclose(c, np.cov(xs))
    assert np.array_equal(u, np.unique(xs))
    assert np.array_equal(bc, np.bincount(np.abs(xs).astype(np.int64)
                                          .ravel()))


def test_np_sort_functional_does_not_mutate():
    x = _x()
    b = bolt.array(x, CPU)
    s = np.sort(b, axis=0)
    assert np.allclose(b.toarray(), x)
    assert np.allclose(s.toarray(), np.sort(x, axis=0))
    m = bolt.array(x, CPU).map(lambda v: v * 2)
    s2 = np.sort(m, axis=0)
    assert np.allclose(s2.toarray(), np.sort(x * 2, axis=0))
    assert np.allclose(m.toarray(), x * 2)


def test_concatenate_mixed_operands():
    x = _x()
    b = bolt.array(x, CPU)
    out = np.concatenate([b, bolt.array(x), x], axis=0)
    assert getattr(out, "mode", None) == "gpu"
    assert np.allclose(out.toarray(), np.concatenate([x, x, x], axis=0))
    out2 = np.concatenate([x, b], axis=0)        # host first: host result
    assert isinstance(out2, np.ndarray)
    assert np.allclose(out2, np.concatenate([x, x], axis=0))


def test_concatenate_axis_none():
    x = _x()
    b = bolt.array(x, CPU, axis=(0, 1))
    out = np.concatenate([b, b], axis=None)
    assert np.allclose(out.toarray(), np.concatenate([x, x], axis=None))
    assert out.split == 1
    mixed = np.concatenate([b, bolt.array(x[0, 0], CPU)], axis=None)
    assert np.allclose(mixed.toarray(),
                       np.concatenate([x, x[0, 0]], axis=None))
    out = np.concatenate([b, b, b, b], axis=1)
    assert np.allclose(out.toarray(), np.concatenate([x] * 4, axis=1))
    with pytest.raises(ValueError):
        np.concatenate([b, bolt.array(x[0], CPU)], axis=0)


class _Duck:
    """A foreign duck array implementing __array_function__."""

    def __array_function__(self, func, types, args, kwargs):
        return "duck-served"


def test_nep18_defers_to_unknown_duck_types():
    b = bolt.array(_x(), CPU)
    assert np.concatenate([b, _Duck()]) == "duck-served"


def test_unsupported_kwargs_fall_back_correctly():
    x = _x()
    b = bolt.array(x, CPU)
    out = np.zeros(())
    np.sum(b, out=out)
    assert np.allclose(out, x.sum())
    assert np.allclose(np.sum(b, dtype=np.float32), x.sum(dtype=np.float32))
    v = bolt.array(np.array([0.0, 0.0, 1.0, 2.0, 0.0]), CPU)
    st = np.trim_zeros(v)
    assert isinstance(st, np.ndarray)
    assert np.allclose(st, [1.0, 2.0])


def test_implicit_gather_warns_once_above_threshold(monkeypatch):
    b = bolt.array(_x(), CPU)
    monkeypatch.setattr(garray, "IMPLICIT_GATHER_WARN_BYTES", 64)
    monkeypatch.setattr(garray, "_gather_warned", [])
    # a function outside the table copies its operands to the host
    with pytest.warns(UserWarning, match="implicitly copied"):
        np.trim_zeros(b.ravel())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.asarray(b)                       # once a process
    monkeypatch.setattr(garray, "_gather_warned", [])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b.toarray()                         # explicit: never warns
        np.sum(b)                           # the table: no copy, no warning


def test_small_gather_is_silent(monkeypatch):
    monkeypatch.setattr(garray, "_gather_warned", [])
    b = bolt.array(_x(), CPU)              # ~3 KB << threshold
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.asarray(b)
        np.trim_zeros(b.ravel())


def test_shape_ndim_size():
    b = bolt.array(_x(), CPU)
    assert np.shape(b) == (16, 6, 4)
    assert np.ndim(b) == 3
    assert np.size(b) == 384
    assert np.size(b, 1) == 6


def test_np_diff_flip_moveaxis_validation():
    b = bolt.array(_x(), CPU)
    with pytest.raises(ValueError, match="non-negative"):
        np.diff(b, n=-1)
    with pytest.raises(ValueError):
        np.diff(b, axis=7)
    got = np.diff(b, axis=0, prepend=0.0)             # host fallback
    assert np.allclose(got, np.diff(_x(), axis=0, prepend=0.0))
    xb = _x() > 0
    gb = np.diff(bolt.array(xb, CPU), axis=0)
    assert gb.dtype == np.bool_
    assert np.array_equal(gb.toarray(), np.diff(xb, axis=0))
    with pytest.raises(ValueError):
        np.flip(b, 5)
    with pytest.raises(ValueError):
        np.flip(b, (1, -2))
    for src, dst in ((0, -4), ((0, 1), (0, 0)), (5, 0), ((0, 1), (0,))):
        with pytest.raises(ValueError):
            np.moveaxis(b, src, dst)


def test_np_split():
    x = _x()
    b = bolt.array(x, CPU)
    for args in [(4,), (2, 1), (np.array([3, 9]),), ([2, -4],), ([3, 1],)]:
        got = np.split(b, *args) if len(args) == 1 \
            else np.split(b, args[0], axis=args[1])
        want = np.split(x, *args) if len(args) == 1 \
            else np.split(x, args[0], axis=args[1])
        assert len(got) == len(want), args
        for g, w in zip(got, want):
            assert g.mode == "gpu" and np.allclose(g.toarray(), w), args
    with pytest.raises(ValueError, match="equal division"):
        np.split(b, 5)
    got = np.array_split(b, 5)
    assert [g.shape for g in got] == [w.shape for w in np.array_split(x, 5)]
    with pytest.raises(ValueError):
        np.split(b, 0)
    assert len(np.split(b, np.array(4))) == 4
    with pytest.raises(TypeError):
        np.split(b, [2.5])


def test_np_where():
    x = _x()
    b = bolt.array(x, CPU)
    out = np.where(b > 0, b, 0.0)
    assert out.mode == "gpu" and out.split == 1
    assert np.allclose(out.toarray(), np.where(x > 0, x, 0.0))
    out2 = np.where(x > 1, b, b * -1.0)
    assert np.allclose(out2.toarray(), np.where(x > 1, x, -x))
    out3 = np.where(b[0] > 0, 1.0, np.arange(4.0))
    assert np.allclose(out3.toarray(),
                       np.where(x[0] > 0, 1.0, np.arange(4.0)))
    got = np.where(bolt.array((x > 1).astype(int), CPU))
    want = np.where((x > 1).astype(int))
    assert all(np.array_equal(a, w) for a, w in zip(got, want))
    with pytest.raises(ValueError, match="both or neither"):
        np.where(b, 1.0)
    out4 = np.where(np.ones((16, 16, 6, 4), bool), b, 0.0)
    assert out4.shape == (16, 16, 6, 4) and out4.split == 0


def test_np_histogram_and_bincount(mesh):
    x = _x()
    b = bolt.array(x, CPU)
    c, e = np.histogram(b, bins=8)
    cn, en = np.histogram(x, bins=8)
    assert np.array_equal(c, cn) and np.allclose(e, en)
    ct, _ = np.histogram(ref.array(x, mesh), bins=8)
    assert np.array_equal(c, ct)
    c2, e2 = np.histogram(b, bins=6, range=(-1, 1), density=True)
    cn2, en2 = np.histogram(x, bins=6, range=(-1, 1), density=True)
    assert np.allclose(c2, cn2) and np.allclose(e2, en2)
    edges = np.linspace(-2, 2, 5)
    c3, _ = np.histogram(b, bins=edges)              # host fallback
    assert np.array_equal(c3, np.histogram(x, bins=edges)[0])
    ivn = (np.abs(x[0]) * 4).astype(np.int64).ravel()
    iv = bolt.array(ivn, CPU)
    assert np.array_equal(np.bincount(iv), np.bincount(ivn))
    assert np.array_equal(np.bincount(iv, minlength=20),
                          np.bincount(ivn, minlength=20))
    with pytest.raises(ValueError):
        np.bincount(bolt.array((np.abs(x) * 4).astype(np.int64), CPU))
    with pytest.raises(ValueError, match="negative"):
        np.bincount(iv, minlength=-1)
    with pytest.raises(ValueError, match="finite"):
        np.histogram(b, bins=4, range=(np.nan, np.nan))
    with pytest.raises(ValueError, match="finite"):
        np.histogram(b, bins=4, range=(0.0, np.inf))


def test_np_unique_and_dot(mesh):
    x = np.floor(_x() * 2)
    b = bolt.array(x, CPU)
    u, c = np.unique(b, return_counts=True)
    un, cn = np.unique(x, return_counts=True)
    assert np.array_equal(u, un) and np.array_equal(c, cn)
    tu, tc = np.unique(ref.array(x, mesh), return_counts=True)
    assert np.array_equal(u, tu) and np.array_equal(c, tc)
    u2, inv = np.unique(b, return_inverse=True)      # host fallback
    un2, invn = np.unique(x, return_inverse=True)
    assert np.array_equal(u2, un2) and np.array_equal(inv, invn)
    w = np.random.RandomState(3).randn(4, 2)
    d = np.dot(b, w)
    assert d.mode == "gpu"
    assert np.allclose(d.toarray(), x @ w)


@pytest.mark.parametrize("layout", ["keys1d", "keys2d"])
def test_cov_corrcoef_parity(request, layout):
    m = request.getfixturevalue("mesh" if layout == "keys1d" else "mesh2d")
    axis = (0,) if layout == "keys1d" else (0, 1)
    x = np.random.RandomState(42).randn(8, 6)
    b = bolt.array(x, CPU, axis=axis)
    assert np.allclose(np.cov(b), np.cov(x))
    assert np.allclose(np.cov(b, rowvar=False), np.cov(x, rowvar=False))
    assert np.allclose(np.cov(b, bias=True), np.cov(x, bias=True))
    assert np.allclose(np.cov(b, ddof=0), np.cov(x, ddof=0))
    assert np.allclose(np.corrcoef(b), np.corrcoef(x))
    assert np.allclose(np.corrcoef(b, rowvar=False),
                       np.corrcoef(x, rowvar=False))
    assert np.allclose(np.cov(b), np.cov(ref.array(x, m, axis=axis)),
                       rtol=1e-12)
    v = x[:, 0]
    bv = bolt.array(v, CPU)
    assert np.shape(np.cov(bv)) == np.shape(np.cov(v)) == ()
    assert np.allclose(np.cov(bv), np.cov(v))
    assert np.allclose(np.corrcoef(bv), np.corrcoef(v))


def test_histogram2d_dd_parity(mesh):
    rs = np.random.RandomState(56)
    x, y = rs.randn(512), rs.randn(512)
    bx, by = bolt.array(x, CPU), bolt.array(y, CPU)
    h, ex, ey = np.histogram2d(bx, by, bins=8)
    hn, exn, eyn = np.histogram2d(x, y, bins=8)
    assert np.allclose(h, hn) and h.dtype == hn.dtype
    assert np.allclose(ex, exn) and np.allclose(ey, eyn)
    ht = np.histogram2d(ref.array(x, mesh), ref.array(y, mesh), bins=8)[0]
    assert np.array_equal(h, ht)
    h2 = np.histogram2d(bx, by, bins=[4, 6], range=[[-2, 2], [-3, 3]],
                        density=True)[0]
    h2n = np.histogram2d(x, y, bins=[4, 6], range=[[-2, 2], [-3, 3]],
                         density=True)[0]
    assert np.allclose(h2, h2n) and h2.dtype == h2n.dtype
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hnr = np.histogram2d(bx, by, bins=6, range=[[0, 1], None])[0]
    assert np.allclose(hnr, np.histogram2d(x, y, bins=6,
                                           range=[[0, 1], None])[0])
    s = rs.randn(256, 3)
    bs = bolt.array(s, CPU)
    hd, edges = np.histogramdd(bs, bins=4)
    hdn, edgesn = np.histogramdd(s, bins=4)
    assert np.allclose(hd, hdn) and hd.dtype == hdn.dtype
    assert all(np.allclose(a, b) for a, b in zip(edges, edgesn))
    hd2 = np.histogramdd(bs, bins=(3, 4, 5), density=True)[0]
    assert np.allclose(hd2, np.histogramdd(s, bins=(3, 4, 5),
                                           density=True)[0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hfb = np.histogram2d(bx, by, bins=[np.linspace(-2, 2, 5),
                                           np.linspace(-2, 2, 4)])[0]
    assert np.allclose(hfb, np.histogram2d(
        x, y, bins=[np.linspace(-2, 2, 5), np.linspace(-2, 2, 4)])[0])


def test_set_operations_parity():
    rs = np.random.RandomState(55)
    a = rs.randint(0, 20, 64).astype(float)
    c = rs.randint(10, 30, 48).astype(float)
    ba, bc = bolt.array(a, CPU), bolt.array(c, CPU)
    assert np.array_equal(np.intersect1d(ba, bc), np.intersect1d(a, c))
    assert np.array_equal(np.intersect1d(ba, c), np.intersect1d(a, c))
    assert np.array_equal(np.union1d(ba, bc), np.union1d(a, c))
    assert np.array_equal(np.setdiff1d(ba, bc), np.setdiff1d(a, c))
    assert np.array_equal(np.setxor1d(ba, bc), np.setxor1d(a, c))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = np.intersect1d(ba, bc, return_indices=True)
    e = np.intersect1d(a, c, return_indices=True)
    assert all(np.array_equal(np.asarray(i), j) for i, j in zip(r, e))
