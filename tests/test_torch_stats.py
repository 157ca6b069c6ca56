"""The port's statistics against the reference's: ``stats()`` and the
stat terminals, on the same seeded numpy inputs (the reference on the
conftest CPU mesh, the port on the CPU device).  Tolerances: f64
``rtol=1e-10`` (summation order differs), f32 ``rtol=1e-5`` for means
and ``rtol=1e-4, atol=1e-4`` for second moments; min/max and integral
sums exact.  Follows ``test_tpu_stats.py``."""

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch.ops import kernels as K

CPU = torch.device("cpu")


def _x(shape=(8, 4, 5), dtype=np.float64, seed=4):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _close(got, want, rtol=1e-10, atol=0.0, dtype=None):
    """Shape, dtype (``want``'s, or ``dtype`` where the port follows
    numpy's rule and the reference jnp's) and values."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == (want.dtype if dtype is None else dtype), \
        (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("axes", [(0,), (0, 1)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stats_matches_reference(mesh, axes, dtype):
    # shard-friendly shape so the reference's Pallas kernel engages
    # (test_ops_kernels.py::test_stats_kernel_path_parity)
    x = _x((32, 4, 128), dtype, seed=2)
    t = ref.array(x, mesh).stats(axis=axes)
    g = bolt.array(x, CPU).stats(axis=axes)
    f32 = dtype == np.float32
    _close(g.mean(), t.mean(), *((1e-5, 1e-6) if f32 else (1e-10,)))
    for name in ("variance", "stdev"):
        _close(getattr(g, name)(), getattr(t, name)(),
               *((1e-4, 1e-4) if f32 else (1e-10,)))
    np.testing.assert_array_equal(g.min(), t.min())
    np.testing.assert_array_equal(g.max(), t.max())
    assert g.count() == t.count()


@pytest.mark.parametrize("axes", [(1,), (2,), (0, 2), (1, 2)])
def test_stats_other_axes_match_reference(mesh, axes):
    # value axes and mixed key/value axes take the two-pass body
    x = _x()
    t = ref.array(x, mesh).stats(axis=axes)
    g = bolt.array(x, CPU).stats(axis=axes)
    for name in ("mean", "variance", "stdev", "min", "max", "count"):
        _close(getattr(g, name)(), getattr(t, name)())


def test_stats_routes_through_fused_welford(monkeypatch):
    # the default geometry (leading key axes, floating) makes ONE kernel
    # call over the leading axes flattened; other geometries do not
    calls = []
    real = K.fused_welford

    def spy(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(K, "fused_welford", spy)
    x = _x((6, 4, 5))
    b = bolt.array(x, CPU, axis=(0, 1))
    b.stats()
    assert calls == [(24, 5)]
    b.stats(axis=(2,))
    bolt.array(x.astype(np.int32), CPU).stats()
    assert calls == [(24, 5)]


_INT_KINDS = [np.int32, np.int8, np.int16, np.uint8, np.bool_]


def _ints(dtype, scale):
    x = _x() * scale
    return x > 0 if dtype == np.bool_ else x.astype(dtype)


@pytest.mark.parametrize("dtype", _INT_KINDS)
def test_stats_integers_and_one_row(mesh, dtype):
    # integer moments take the reference's (jnp's) mean dtype: f32 for
    # int32 and narrower; the local mode keeps numpy's f64
    x = _ints(dtype, 10)
    for data, axes in ((x, (0,)), (x[:1], (0,))):
        t = ref.array(data, mesh).stats(axis=axes)
        g = bolt.array(data, CPU).stats(axis=axes)
        lo = bolt.array(data).stats(axis=axes)
        for name in ("mean", "variance"):
            _close(getattr(g, name)(), getattr(t, name)(), rtol=1e-6,
                   atol=1e-6)
            np.testing.assert_allclose(getattr(g, name)(),
                                       getattr(lo, name)(), rtol=1e-6,
                                       atol=1e-6)
        for name in ("min", "max", "count"):
            _close(getattr(g, name)(), getattr(t, name)())


def test_stats_errors_and_legacy_form(mesh):
    x = _x()
    b = bolt.array(x, CPU)
    with pytest.raises(ValueError):
        b.stats(axis=(9,))
    with pytest.raises(NotImplementedError):
        b.stats("sum", "var")          # fluent multi-stat: ROADMAP A3
    t = ref.array(x, mesh).stats(("mean",), (0,))
    g = b.stats(("mean",), (0,))
    assert g.requested == t.requested == ("mean",)
    _close(g.mean(), t.mean())


_NAMES = ["sum", "mean", "var", "std", "min", "max", "prod", "ptp"]


@pytest.mark.parametrize("name", _NAMES)
@pytest.mark.parametrize("axis", [(0,), (0, 1), (1, 2), (2,), None])
def test_terminals_match_reference(mesh, name, axis):
    x = _x()
    t = getattr(ref.array(x, mesh, axis=(0, 1)), name)(axis=axis)
    g = getattr(bolt.array(x, CPU, axis=(0, 1)), name)(axis=axis)
    assert g.split == t.split
    _close(g.toarray(), t.toarray())


@pytest.mark.parametrize("name", _NAMES)
def test_terminals_keepdims_match_reference(mesh, name):
    x = _x()
    t = getattr(ref.array(x, mesh), name)(axis=(0, 2), keepdims=True)
    g = getattr(bolt.array(x, CPU), name)(axis=(0, 2), keepdims=True)
    assert g.split == t.split == 1
    _close(g.toarray(), t.toarray())


@pytest.mark.parametrize("name", ["var", "std"])
@pytest.mark.parametrize("ddof", [1, 1.5])
def test_ddof_matches_reference(mesh, name, ddof):
    x = _x()
    t = getattr(ref.array(x, mesh), name)(axis=(0,), ddof=ddof)
    g = getattr(bolt.array(x, CPU), name)(axis=(0,), ddof=ddof)
    _close(g.toarray(), t.toarray())
    _close(g.toarray(), getattr(x, name)(axis=0, ddof=ddof))


@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for dtype in _INT_KINDS
    for name in ("sum", "mean", "var", "min", "prod", "ptp")
    if not (dtype == np.bool_ and name == "ptp")])   # numpy/jnp refuse
def test_integer_dtype_rule_matches_reference(mesh, name, dtype):
    # output dtypes follow the reference's jnp rule: sum of int32 is
    # int64, mean and var of int32 (and narrower) are f32
    x = _ints(dtype, 3)
    t = getattr(ref.array(x, mesh), name)()
    g = getattr(bolt.array(x, CPU), name)()
    assert g.dtype == t.dtype
    if name in ("mean", "var"):
        _close(g.toarray(), t.toarray(), rtol=1e-6, atol=1e-6)
    else:
        _close(g.toarray(), t.toarray())


@pytest.mark.parametrize("name", ["all", "any"])
def test_truth_terminals_match_reference(mesh, name):
    x = _x() > 0.5
    t = getattr(ref.array(x, mesh, axis=(0, 1)), name)()
    g = getattr(bolt.array(x, CPU, axis=(0, 1)), name)()
    assert g.dtype == t.dtype == np.bool_
    np.testing.assert_array_equal(g.toarray(), t.toarray())


def test_sum_bit_exact_integral(mesh):
    # integral floats: sum is bit-exact whatever the order (BASELINE
    # config 1's parity condition)
    x = np.arange(8.0 * 6).reshape(8, 6)
    b = bolt.array(x, CPU)
    assert np.array_equal(b.sum().toarray(), x.sum(axis=0))
    assert float(b.sum(axis=(0, 1)).toarray()) == float(x.sum())


def test_stat_of_deferred_chain_matches_reference(mesh):
    x = _x()
    t = ref.array(x, mesh).map(lambda v: v * 2 + 1).var(axis=(0, 1))
    g = bolt.array(x, CPU).map(lambda v: v * 2 + 1).var(axis=(0, 1))
    _close(g.toarray(), t.toarray())
