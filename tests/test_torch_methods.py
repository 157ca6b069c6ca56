"""The port's ndarray methods, quantiles and lazy chains against the
reference's.

The assertions of ``tests/test_ndarray_methods.py``,
``tests/test_stats_extras.py`` (all but ``cov``/``corrcoef``/``histogram``,
which come with the ops library), ``tests/test_tpu_lazy.py`` and
``tests/test_toarray_out.py`` on the port, on the CPU, with ``bolt_tpu`` on
the same seeded inputs: the method table gives the same value, shape and
dtype (``allclose``, NaN equal) or raises the same error class on both.
Left out, as they test what the port does not have: the reference's
jit-cache counts (``test_quantile_vector_q``'s program reuse), its
``profile.instrument`` program names (``test_with_keys_map_defers_and_
fuses`` keeps its values and laziness here), the 8-way shard layout of
``iter_shards`` (one card holds one shard) and the foreign-mesh operands of
``test_cross_mesh_operands_rejected``.
"""

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from tests.test_ndarray_methods import CASES

CPU = torch.device("cpu")


def _run(fn, b):
    try:
        return ("ok", fn(b))
    except Exception as exc:                      # noqa: BLE001
        return ("err", type(exc))


def _host(v):
    return v.toarray() if hasattr(v, "toarray") else v


def _assert_same(name, want, got):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(want) == len(got), name
        for a, b in zip(want, got):
            _assert_same(name, a, b)
        return
    want, got = _host(want), _host(got)
    if isinstance(want, list) or want is None or np.isscalar(want):
        assert np.array_equal(np.asarray(want), np.asarray(got)), name
        return
    an, bn = np.asarray(want), np.asarray(got)
    assert an.shape == bn.shape, (name, an.shape, bn.shape)
    assert an.dtype == bn.dtype, (name, an.dtype, bn.dtype)
    assert np.allclose(an, bn, equal_nan=True), name


@pytest.mark.parametrize("layout", ["keys1d", "keys2d"])
@pytest.mark.parametrize("name,make,fn", CASES, ids=[c[0] for c in CASES])
def test_method_parity(request, layout, name, make, fn):
    # the reference's method table, run on both packages: the same value,
    # shape and dtype, or the same error class
    if layout == "keys1d":
        m, axis = request.getfixturevalue("mesh"), (0,)
    else:
        m, axis = request.getfixturevalue("mesh2d"), (0, 1)
    x = make()
    if x.ndim < 2 and layout == "keys2d":
        axis = (0,)
    t_status, t = _run(fn, ref.array(x.copy(), m, axis=axis))
    g_status, g = _run(fn, bolt.array(x.copy(), CPU, axis=axis))
    assert t_status == g_status, (name, t, g)
    if t_status == "err":
        assert t is g or issubclass(g, t) or issubclass(t, g), (name, t, g)
    else:
        _assert_same(name, t, g)
        if hasattr(t, "split"):
            assert g.split == t.split, name


def _f():
    return np.random.RandomState(7).randn(8, 4, 5)


def test_sort_matches_numpy():
    x = _f()
    b = bolt.array(x, CPU)
    assert b.sort(axis=0) is None
    assert np.array_equal(b.toarray(), np.sort(x, axis=0))
    m = bolt.array(x, CPU).map(lambda v: v * -1)
    m.sort()
    assert np.allclose(m.toarray(), np.sort(-x, axis=-1))


def test_set_does_not_mutate():
    x = _f()
    b = bolt.array(x, CPU)
    out = b.set(0, 0.0)
    assert np.allclose(b.toarray(), x)
    assert np.allclose(out.toarray()[0], 0.0)
    assert out.shape == x.shape and out.split == 1


def test_setitem_raises_pointing_to_set():
    b = bolt.array(_f(), CPU)
    with pytest.raises(TypeError, match="set"):
        b[0] = 1.0


def test_set_getitem_roundtrip():
    x = _f()
    for idx in [np.s_[1:3], (2,), ([0, 1], 2), (2, [1, 3]),
                ([0, 2], slice(None), [1, 3]), (slice(None), 1, [0, 4]),
                np.s_[..., 2], ([4, 0], 1, 2), np.s_[::-1, 1],
                ([0, 2], slice(None, None, -2))]:
        b = bolt.array(x, CPU)
        region = b[idx].toarray()
        out = b.set(idx, region * 0 - 1.0)
        assert (out.toarray() != x).sum() == region.size, idx
        assert np.allclose(out.set(idx, region).toarray(), x), idx


def test_item_reads_one_element(monkeypatch):
    x = _f()
    b = bolt.array(x, CPU)
    monkeypatch.setattr(type(b), "toarray", lambda self, out=None: 1 / 0)
    assert b.item(3) == x.reshape(-1)[3]
    assert b.item(1, 2, 3) == x[1, 2, 3]
    assert bolt.array(np.full((1, 1), 42.0), CPU).item() == 42.0


def test_nonzero_values(mesh):
    x = np.zeros((5, 4))
    x[1, 2] = 3.0
    x[4, 0] = -1.0
    got = bolt.array(x, CPU).nonzero()
    for a, b in zip(got, x.nonzero()):
        assert a.dtype == np.int64 and np.array_equal(a, b)
    m = bolt.array(x, CPU).map(lambda v: v * 0 + (v > 2))
    for a, b in zip(m.nonzero(), (x > 2).nonzero()):
        assert np.array_equal(a, b)


def test_searchsorted_sorter(mesh):
    x = np.random.RandomState(12).randn(16)
    order = np.argsort(x)
    v = np.linspace(-1, 1, 5)
    got = bolt.array(x, CPU).searchsorted(v, sorter=order)
    assert np.array_equal(got, ref.array(x, mesh).searchsorted(
        v, sorter=order))
    assert np.array_equal(got, np.searchsorted(x, v, sorter=order))
    with pytest.raises(ValueError):
        bolt.array(x, CPU).searchsorted(0.0, sorter=np.arange(3))
    s = bolt.array(np.sort(x), CPU)
    assert np.array_equal(s.searchsorted(bolt.array(v, CPU)),
                          np.searchsorted(np.sort(x), v))


def test_repeat_split_and_chain():
    x = _f()
    t = bolt.array(x, CPU).repeat(2)
    assert t.split == 1 and t.shape == (x.size * 2,)
    t = bolt.array(x, CPU).repeat(3, axis=0)
    assert t.split == 1 and t.shape == (24, 4, 5)
    m = bolt.array(x, CPU).map(lambda v: v + 1).repeat(2, axis=2)
    assert np.allclose(m.toarray(), (x + 1).repeat(2, axis=2))


def test_ravel_and_diagonal_splits():
    x = _f()
    b = bolt.array(x, CPU, axis=(0, 1))
    r = b.ravel()
    assert r.split == 1 and np.allclose(r.toarray(), x.ravel())
    d = b.diagonal(0, 0, 2)
    assert d.split == 1 and np.allclose(d.toarray(), x.diagonal(0, 0, 2))
    tr = b.trace(0, 0, 1)
    assert tr.split == 0 and np.allclose(tr.toarray(), x.trace(0, 0, 1))


# ---------------------------------------------------------------------------
# test_stats_extras.py
# ---------------------------------------------------------------------------

def _e(shape=(16, 5, 4)):
    return np.random.RandomState(21).randn(*shape)


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 1.0])
def test_quantile_parity(mesh, q):
    x = _e()
    got = bolt.array(x, CPU).quantile(q)
    want = ref.array(x, mesh).quantile(q)
    assert got.split == want.split
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-12)
    assert bolt.allclose(got.toarray(), np.quantile(x, q, axis=0))


def test_quantile_axes_and_median(mesh):
    x = _e()
    b = bolt.array(x, CPU, axis=(0, 1))
    assert bolt.allclose(b.quantile(0.5).toarray(), np.median(x, (0, 1)))
    assert bolt.allclose(b.median().toarray(), np.median(x, axis=(0, 1)))
    assert bolt.allclose(b.quantile(0.75, axis=(2,)).toarray(),
                         np.quantile(x, 0.75, axis=2))
    assert bolt.allclose(b.median(axis=(0,), keepdims=True).toarray(),
                         np.median(x, axis=0, keepdims=True))
    for q in np.linspace(0.1, 0.9, 5):
        assert bolt.allclose(bolt.array(x, CPU).quantile(float(q))
                             .toarray(), np.quantile(x, q, axis=0))
    assert bolt.allclose(bolt.array(x, CPU).map(lambda v: v * 2).median()
                         .toarray(), np.median(x * 2, axis=0))
    for method in ("lower", "higher", "midpoint", "nearest"):
        got = bolt.array(x, CPU).quantile([0.3, 0.8], method=method)
        want = ref.array(x, mesh).quantile([0.3, 0.8], method=method)
        np.testing.assert_allclose(got.toarray(), want.toarray(),
                                   rtol=1e-12)


def test_quantile_vector_q(mesh):
    x = _e()
    qs = [0.1, 0.5, 0.9]
    t = bolt.array(x, CPU).quantile(qs)
    assert t.shape == (3, 5, 4) and t.split == 1
    assert bolt.allclose(t.toarray(), np.quantile(x, qs, axis=0))
    b2 = bolt.array(x, CPU, axis=(0, 1))
    t2 = b2.quantile(qs, keepdims=True)
    e2 = np.quantile(x, qs, axis=(0, 1), keepdims=True)
    assert t2.shape == e2.shape and t2.split == 3
    assert bolt.allclose(t2.toarray(), e2)
    t3 = bolt.array(x, CPU).quantile(qs, axis=(2,))
    assert t3.split == 2 and bolt.allclose(t3.toarray(),
                                           np.quantile(x, qs, axis=2))
    t1 = bolt.array(x, CPU).quantile([0.5])
    assert t1.shape == (1,) + x.shape[1:]


def test_quantile_nan_and_dtypes(mesh):
    x = _e()
    x[3, 1, 2] = np.nan
    for dt in (np.float64, np.float32, np.int32, np.int64, np.float16):
        xd = (x * 10).astype(dt) if np.dtype(dt).kind == "i" else \
            x.astype(dt)
        got = bolt.array(xd, CPU).quantile(0.4)
        want = ref.array(xd, mesh).quantile(0.4)
        assert got.dtype == want.dtype, dt
        np.testing.assert_allclose(got.toarray(), want.toarray(),
                                   rtol=1e-6)


def test_quantile_above_2_24_elements():
    # torch.quantile refuses more than 2**24 elements; the port's sort
    # plan takes them (4 records of 2**22 + 8 values)
    n = (1 << 22) + 8
    x = np.random.RandomState(3).rand(4, n).astype(np.float32)
    b = bolt.array(x, CPU)
    assert b.size > 1 << 24
    got = b.median().toarray()
    np.testing.assert_allclose(got, np.median(x, axis=0), rtol=1e-6)
    got = b.quantile([0.1, 0.9]).toarray()
    np.testing.assert_allclose(got, np.quantile(x, [0.1, 0.9], axis=0),
                               rtol=1e-6, atol=1e-7)


def test_quantile_validation():
    b = bolt.array(_e(), CPU)
    for q in (1.5, [0.2, 1.8], [[0.2], [0.8]], "half", float("nan"),
              [0.5, float("nan")]):
        with pytest.raises(ValueError):
            b.quantile(q)
    with pytest.raises(ValueError):
        b.quantile(0.5, method="weibull")


def test_argmax_argmin_parity(mesh):
    x = _e((12, 5, 4))
    b = bolt.array(x, CPU)
    t = ref.array(x, mesh)
    for axis in (None, 0, 1, 2, -1, -2):
        for name in ("argmax", "argmin"):
            got, want = getattr(b, name)(axis=axis), getattr(t, name)(
                axis=axis)
            assert got.dtype == want.dtype and got.split == want.split
            assert np.array_equal(got.toarray(), want.toarray())
    assert np.array_equal(b.argmax(axis=0, keepdims=True).toarray(),
                          np.argmax(x, axis=0, keepdims=True))
    assert b.argmax(axis=0).split == 0 and b.argmax(axis=1).split == 1
    tie = np.zeros((4, 3))
    tie[1] = tie[3] = 7.0
    assert np.array_equal(bolt.array(tie, CPU).argmax(axis=0).toarray(),
                          np.argmax(tie, axis=0))
    nan = x.copy()
    nan[2, 1, 1] = nan[5, 1, 1] = np.nan
    for name in ("argmax", "argmin"):
        assert np.array_equal(getattr(bolt.array(nan, CPU), name)(
            axis=0).toarray(), getattr(np, name)(nan, axis=0))
    with pytest.raises(ValueError):
        b.argmax(axis=9)
    with pytest.raises(TypeError):
        b.argmax(axis=1.9)


def test_ndarray_method_parity(mesh):
    x = np.abs(_e((8, 4, 3))) + 0.5
    b = bolt.array(x, CPU)
    t = ref.array(x, mesh)
    pairs = [
        lambda a: a.prod(), lambda a: a.prod(axis=(1,), keepdims=True),
        lambda a: (a > 1.0).all(), lambda a: (a > 1.0).any(axis=(0, 2)),
        lambda a: a.clip(0.7, 1.2), lambda a: a.clip(max=1.0),
        lambda a: a.clip(a_max=1.0), lambda a: a.round(1),
        lambda a: a.clip(min=np.full(x.shape[2], 0.8)),
        lambda a: a.clip(min=np.full(x.shape, 0.9)),
        lambda a: a.clip(min=np.linspace(0.6, 1.1, 8).reshape(-1, 1, 1)),
        lambda a: a.clip(1.0, 0.8)]
    for f in pairs:
        got, want = f(b), f(t)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got.toarray(), want.toarray(),
                                   rtol=1e-12)
    xi = (x * 10).astype(np.int64)
    bi = bolt.array(xi, CPU)
    ci = bi.clip(0, 9)
    assert ci.dtype == xi.dtype and np.array_equal(ci.toarray(),
                                                   xi.clip(0, 9))
    with pytest.raises(ValueError):
        b.clip()
    with pytest.raises(ValueError):
        b.clip(0.1, a_min=0.2)
    with pytest.raises(TypeError):
        b.round(1.7)
    assert (bi * 2).toarray().dtype == xi.dtype
    assert np.issubdtype((bi * 2.0).toarray().dtype, np.floating)
    # halves to even, as jnp.round; numpy's values bit for bit (XLA's
    # division by the constant 10 may land an ulp off them)
    h = np.array([[0.5, 1.5, 2.5, -0.5, 1.25, 1.35]])
    got = bolt.array(h, CPU).round(1).toarray()
    assert np.array_equal(got, h.round(1))
    np.testing.assert_allclose(got, ref.array(h, mesh).round(1).toarray(),
                               rtol=1e-15)


def test_cumsum_cumprod_parity(mesh):
    x = _e((6, 4, 3))
    b = bolt.array(x, CPU)
    for axis in (0, 1, 2, -1):
        assert bolt.allclose(b.cumsum(axis=axis).toarray(), x.cumsum(axis))
        assert bolt.allclose(b.cumprod(axis=axis).toarray(),
                             x.cumprod(axis))
    c = b.cumsum()
    assert c.split == 1 and bolt.allclose(c.toarray(), x.cumsum())
    assert bolt.allclose(bolt.array(x, CPU).map(lambda v: v + 1).cumsum(
        axis=0).toarray(), (x + 1).cumsum(axis=0))
    with pytest.raises(TypeError):
        b.cumsum(axis=1.5)
    for dt in (np.int8, np.int32, np.bool_, np.uint8):
        xd = (x > 0) if dt == np.bool_ else (x * 3).astype(dt)
        for name in ("cumsum", "cumprod"):
            got = getattr(bolt.array(xd, CPU), name)(axis=1)
            want = getattr(ref.array(xd, mesh), name)(axis=1)
            assert got.dtype == want.dtype, (dt, name)
            assert np.array_equal(got.toarray(), want.toarray())


def test_argsort_parity(mesh):
    x = np.random.RandomState(60).permutation(160).reshape(8, 5, 4) \
        .astype(np.float64)
    b = bolt.array(x, CPU)
    assert np.array_equal(b.argsort().toarray(), x.argsort())
    assert np.array_equal(b.argsort(axis=0).toarray(), x.argsort(axis=0))
    assert np.array_equal(b.argsort(axis=-2).toarray(), x.argsort(axis=-2))
    out = b.argsort(axis=None)
    assert out.split == 1 and np.array_equal(out.toarray(),
                                             x.argsort(axis=None))
    tie = np.zeros((6, 3))
    tie[::2] = 1.0
    assert np.array_equal(bolt.array(tie, CPU).argsort(
        axis=0, kind="stable").toarray(), tie.argsort(axis=0, kind="stable"))
    with pytest.raises(TypeError):
        b.argsort(axis=1.5)
    with pytest.raises(ValueError):
        b.argsort(kind="bogus")
    assert np.array_equal(bolt.array(x, CPU).map(lambda v: -v).argsort(
        axis=0).toarray(), (-x).argsort(axis=0))
    assert b.argsort().dtype == ref.array(x, mesh).argsort().dtype


def test_dot_parity(mesh):
    rs = np.random.RandomState(61)
    a, w = rs.randn(8, 5), rs.randn(5, 3)
    out = bolt.array(a, CPU).dot(w)
    assert out.split == 1 and bolt.allclose(out.toarray(), a.dot(w))
    v, u = rs.randn(5), rs.randn(5)
    assert bolt.allclose(float(bolt.array(u, CPU).dot(v).toarray()),
                         u.dot(v))
    a3, c3 = rs.randn(8, 4, 5), rs.randn(2, 5, 3)
    b3 = bolt.array(a3, CPU)
    for other in (w, c3):
        got, want = b3.dot(other), ref.array(a3, mesh).dot(other)
        assert got.split == want.split
        np.testing.assert_allclose(got.toarray(), want.toarray(),
                                   rtol=1e-10)
    with pytest.raises(ValueError):
        bolt.array(a, CPU).dot(np.ones((7, 2)))


def test_full_constructor():
    t = bolt.full((8, 4), 2.5, CPU)
    assert t.mode == "gpu" and t.dtype == np.float64
    assert np.issubdtype(bolt.full((8, 4), 2, CPU).dtype, np.integer)
    assert bolt.full((8, 4), 2, CPU, dtype=np.float32).dtype == np.float32


# ---------------------------------------------------------------------------
# test_tpu_lazy.py
# ---------------------------------------------------------------------------

def _l():
    return np.random.RandomState(11).randn(8, 4, 5)


def test_map_is_deferred():
    x = _l()
    m = bolt.array(x, CPU).map(lambda v: v + 1)
    assert m.deferred and m.shape == x.shape and m.dtype == x.dtype
    assert "deferred" in repr(m)
    assert bolt.allclose(m.toarray(), x + 1)
    assert not m.deferred


def test_chain_fuses():
    x = _l()
    m = bolt.array(x, CPU).map(lambda v: v + 1).map(lambda v: v * 2).map(
        lambda v: v - 3)
    assert m.deferred and len(m._chain[1]) == 3
    assert bolt.allclose(m.toarray(), (x + 1) * 2 - 3)


def test_reduce_and_stats_consume_chain():
    from operator import add
    x = _l()
    m = bolt.array(x, CPU).map(lambda v: v + 1)
    assert bolt.allclose(m.reduce(add).toarray(), (x + 1).sum(axis=0))
    assert m.deferred
    m = bolt.array(x, CPU).map(lambda v: v * 2)
    assert bolt.allclose(m.sum().toarray(), (x * 2).sum(axis=0))
    assert bolt.allclose(m.mean(axis=(0, 1)).toarray(),
                         (x * 2).mean(axis=(0, 1)))
    assert m.deferred


def test_cache_astype_swap():
    x = _l()
    m = bolt.array(x, CPU).map(lambda v: v + 1)
    m.cache()
    assert not m.deferred and bolt.allclose(m.toarray(), x + 1)
    m = bolt.array(x, CPU).map(lambda v: v + 1).astype(np.float32)
    assert m.deferred and m.dtype == np.float32
    s = bolt.array(x, CPU).map(lambda v: v + 1).swap((0,), (0,))
    assert not s.deferred
    assert bolt.allclose(s.toarray(), np.transpose(x + 1, (1, 0, 2)))


def test_with_keys_map_defers_and_fuses():
    x = _l()
    f = lambda kv: kv[1] + kv[0][0]                      # noqa: E731
    m = bolt.array(x, CPU).map(f, with_keys=True)
    assert m.deferred
    keys = np.arange(x.shape[0]).reshape((-1, 1, 1))
    assert bolt.allclose(m.sum().toarray(), (x + keys).sum(axis=0))
    assert m.deferred
    m3 = (bolt.array(x, CPU).map(lambda v: v * 2).map(f, with_keys=True)
          .map(lambda v: v - 1))
    assert bolt.allclose(m3.first(), x[0] * 2 - 1)
    assert m3.deferred
    assert bolt.allclose(m3.toarray(), x * 2 + keys - 1)


# ---------------------------------------------------------------------------
# test_toarray_out.py, the numpy protocol and the parity no-ops
# ---------------------------------------------------------------------------

def _o():
    return np.random.RandomState(50).randn(16, 6, 4)


def test_toarray_out(tmp_path):
    x = _o()
    b = bolt.array(x, CPU)
    out = np.empty_like(x)
    assert b.toarray(out=out) is out and np.array_equal(out, x)
    mm = np.lib.format.open_memmap(str(tmp_path / "out.npy"), mode="w+",
                                   dtype=x.dtype, shape=x.shape)
    assert b.toarray(out=mm) is mm
    mm.flush()
    assert np.array_equal(np.load(str(tmp_path / "out.npy")), x)
    with pytest.raises(ValueError, match="shape"):
        b.toarray(out=np.empty((3, 3)))
    with pytest.raises(ValueError, match="cast"):
        b.toarray(out=np.empty(x.shape, np.float32))


def test_toarray_out_materialises_chain_and_pending():
    x = _o()
    out = np.empty_like(x)
    bolt.array(x, CPU).map(lambda v: v * 2).toarray(out=out)
    assert np.allclose(out, x * 2)
    keep = x[x.mean(axis=(1, 2)) > 0]
    out2 = np.empty_like(keep)
    bolt.array(x, CPU).filter(lambda v: v.mean() > 0).toarray(out=out2)
    assert np.allclose(out2, keep)


def test_iter_shards_copies_and_covers():
    x = _o()
    b = bolt.array(x, CPU).map(lambda v: v + 1)
    seen = np.full(x.shape, np.nan)
    for index, block in b.iter_shards():
        seen[index] = block
        block *= 0.0
    assert np.allclose(seen, x + 1) and np.allclose(b.toarray(), x + 1)


def test_parity_noops_and_concatenate(mesh):
    x, y = _o(), _o() + 1
    b = bolt.array(x, CPU)
    assert b.unpersist() is b and b.repartition(4) is b
    got = b.concatenate(bolt.array(y, CPU), axis=1)
    want = ref.array(x, mesh).concatenate(ref.array(y, mesh), axis=1)
    assert got.split == want.split
    assert np.array_equal(got.toarray(), want.toarray())
    assert np.array_equal(b.concatenate(y).toarray(),
                          np.concatenate((x, y)))


def test_pending_filter_serves_the_methods():
    # tests/test_interactions.py::test_new_stats_on_pending_filter
    x = _o()
    keep = x[x.mean(axis=(1, 2)) > 0]

    def f():
        return bolt.array(x, CPU).filter(lambda v: v.mean() > 0)

    assert bolt.allclose(f().quantile(0.5).toarray(),
                         np.quantile(keep, 0.5, axis=0))
    assert np.array_equal(f().argmax(axis=0).toarray(), keep.argmax(axis=0))
    assert bolt.allclose(f().cumsum(axis=0).toarray(), keep.cumsum(axis=0))
    assert bolt.allclose(f().clip(-0.5, 0.5).toarray(),
                         keep.clip(-0.5, 0.5))
