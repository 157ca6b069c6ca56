"""Complex statistics and orderings on the port against the reference
(ROADMAP C6).

``var``/``std`` of a complex array are real (float32 for complex64,
float64 for complex128), whole, by blocks of a chain and in a group, as
the reference's and numpy's; values within ``1e-6`` (relative) for
complex64 and ``1e-12`` for complex128.  The orderings take numpy's
order of complex numbers, by the real part and ties by the imaginary
part: ``>``/``<``, ``np.sort``/``np.argsort``, ``reduce(np.maximum)``
and ``clip`` equal the reference's exactly; ``max``/``min``/``argmax``,
which the reference refuses, raise ``TypeError``.
"""

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch.gpu import array as garray

CPU = torch.device("cpu")
COMPLEX = [np.complex64, np.complex128]
RTOL = {np.complex64: 1e-6, np.complex128: 1e-12}


def _z(dtype, shape=(16, 3, 4), seed=0):
    rs = np.random.RandomState(seed)
    z = rs.randn(*shape) + 1j * rs.randn(*shape)
    # ties in the real part, so the imaginary part decides
    z.reshape(-1)[::5] = np.round(z.reshape(-1)[::5].real) + 1j * rs.randn(
        z.reshape(-1)[::5].size)
    return z.astype(dtype)


def _a(r):
    return np.asarray(r.toarray() if hasattr(r, "toarray") else r)


@pytest.mark.parametrize("dtype", COMPLEX)
@pytest.mark.parametrize("name", ["var", "std"])
@pytest.mark.parametrize("axis", [None, 1, (0, 2)])
def test_complex_var_std_are_real(mesh, dtype, name, axis):
    z = _z(dtype)
    want = _a(getattr(ref.array(z, mesh), name)(axis=axis))
    got = _a(getattr(bolt.array(z, CPU), name)(axis=axis))
    assert got.dtype == want.dtype == np.dtype(dtype).type(0).real.dtype
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)
    np.testing.assert_allclose(got, getattr(np, name)(
        z, axis=(0,) if axis is None else axis), rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", COMPLEX)
def test_complex_var_of_chain_blocks_and_group(mesh, dtype, monkeypatch):
    # a chain longer than one block folds (count, mean, M2) partials: M2
    # of complex values is real
    z = _z(dtype, shape=(32, 3, 4))
    want = _a(ref.array(z, mesh).map(lambda v: v * 2).var())
    monkeypatch.setattr(garray, "_BLOCK_BYTES", 3 * 4 * 16 * 5)
    b = bolt.array(z, CPU).map(lambda v: v * 2)
    got = _a(b.var())
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)
    c = bolt.array(z, CPU).map(lambda v: v * 2)
    gv, gs = bolt.compute(c.var(), c.std())
    assert np.array_equal(_a(gv), got)
    assert _a(gs).dtype == want.dtype


def test_complex_sort_takes_numpys_order(mesh):
    z = np.array([[1 + 5j], [1 - 5j], [2 + 0j], [9j]], dtype=np.complex64)
    got = _a(np.sort(bolt.array(z, CPU), axis=0)).ravel()
    assert got.tolist() == [9j, 1 - 5j, 1 + 5j, 2]
    assert np.array_equal(got, _a(np.sort(ref.array(z, mesh), axis=0))
                          .ravel())


ORDERINGS = {
    "gt": lambda b: b > 0.5,
    "lt": lambda b: b < (0.25 + 0.5j),
    "le": lambda b: b <= b.map(lambda v: v * 1),
    "sort": lambda b: np.sort(b, axis=0),
    "sort_last": lambda b: np.sort(b),
    "argsort": lambda b: np.argsort(b, axis=0),
    "reduce_max": lambda b: b.reduce(np.maximum),
    "reduce_min": lambda b: b.reduce(np.minimum),
    "clip": lambda b: b.clip(0, 1),
    "maximum": lambda b: np.maximum(b, 0.5j),
}


@pytest.mark.parametrize("dtype", COMPLEX)
@pytest.mark.parametrize("name", sorted(ORDERINGS))
def test_complex_orderings_match_reference(mesh, dtype, name):
    z = _z(dtype)
    want = _a(ORDERINGS[name](ref.array(z, mesh)))
    got = _a(ORDERINGS[name](bolt.array(z, CPU)))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_complex_sort_method_in_place():
    z = _z(np.complex128)
    b = bolt.array(z, CPU)
    assert b.sort(axis=0) is None
    assert np.array_equal(_a(b), np.sort(z, axis=0))


@pytest.mark.parametrize("call", [lambda b: b.max(), lambda b: b.min(),
                                  lambda b: b.ptp(), lambda b: b.argmax(),
                                  lambda b: b.argmin(axis=0)])
def test_complex_extrema_refused_pointedly(call):
    b = bolt.array(_z(np.complex64), CPU)
    with pytest.raises(TypeError, match="complex"):
        _a(call(b))
