"""The reference's indexing tests (``tests/test_tpu_getting.py``) on the
port: ``bolt_tpu`` swapped for ``bolt_tpu_torch`` and the
mesh for the CPU device (the ``dev`` fixture), the same inputs and
assertions.  Integer, slice, list, boolean-mask and
mixed indexing against numpy.  No case is left out.
"""

import numpy as np
import pytest
import torch

import bolt_tpu_torch as bolt
from bolt_tpu_torch.utils import allclose

CPU = torch.device("cpu")


@pytest.fixture
def dev():
    """The port's context in place of the reference's mesh."""
    return CPU


def _x():
    rs = np.random.RandomState(6)
    return rs.randn(8, 4, 5)


def test_slices(dev):
    x = _x()
    b = bolt.array(x, dev)
    assert allclose(b[:].toarray(), x)
    assert allclose(b[2:6].toarray(), x[2:6])
    assert allclose(b[:, 1:3].toarray(), x[:, 1:3])
    assert allclose(b[::2, :, ::2].toarray(), x[::2, :, ::2])
    assert allclose(b[1:7:2, ::-1].toarray(), x[1:7:2, ::-1])


def test_ints_squeeze(dev):
    x = _x()
    b = bolt.array(x, dev)
    out = b[3]
    assert out.shape == x[3].shape
    assert out.split == 0
    assert allclose(out.toarray(), x[3])
    out = b[:, 2]
    assert out.split == 1
    assert allclose(out.toarray(), x[:, 2])
    assert allclose(b[-1, -2, -3].toarray(), np.asarray(x[-1, -2, -3]))


def test_lists_orthogonal(dev):
    x = _x()
    b = bolt.array(x, dev)
    assert allclose(b[[0, 3, 5]].toarray(), x[[0, 3, 5]])
    # per-axis advanced indices apply orthogonally (np.ix_ semantics)
    out = b[[0, 1], :, [0, 2, 4]]
    expected = x[np.ix_([0, 1], range(4), [0, 2, 4])]
    assert allclose(out.toarray(), expected)
    assert allclose(b[:, [3, 1]].toarray(), x[:, [3, 1]])
    assert allclose(b[[-1, 0]].toarray(), x[[-1, 0]])


def test_bool_arrays(dev):
    x = _x()
    b = bolt.array(x, dev)
    kmask = x[:, 0, 0] > 0
    assert allclose(b[kmask].toarray(), x[kmask])
    vmask = np.array([True, False, True, False, True])
    assert allclose(b[:, :, vmask].toarray(), x[:, :, vmask])


def test_mixed(dev):
    x = _x()
    b = bolt.array(x, dev)
    out = b[2:7, [0, 3], ::2]
    expected = x[2:7][:, [0, 3]][:, :, ::2]
    assert allclose(out.toarray(), expected)
    out = b[1, :, [0, 4]]
    expected = x[1][:, [0, 4]]
    assert allclose(out.toarray(), expected)


def test_split_bookkeeping(dev):
    x = _x()
    b = bolt.array(x, dev, axis=(0, 1))
    assert b[0].split == 1
    assert b[0, 0].split == 0
    assert b[:, 0].split == 1
    assert b[:, :, 0].split == 2


def test_errors(dev):
    b = bolt.array(_x(), dev)
    with pytest.raises(ValueError):
        b[0, 0, 0, 0]
    with pytest.raises(IndexError):
        b[99]


def test_negative_and_mixed_index_forms(dev):
    # negatives, reversed slices, empty slices, ndarray indices, and
    # int+list+slice mixes — full numpy-oracle parity
    rs = np.random.RandomState(50)
    x = rs.randn(16, 6, 4)
    b = bolt.array(x, dev)
    assert allclose(b[-1].toarray(), x[-1])
    assert allclose(b[-3:].toarray(), x[-3:])
    assert allclose(b[..., -2:].toarray(), x[..., -2:])
    assert allclose(b[[-1, 0, 2]].toarray(), x[[-1, 0, 2]])
    assert allclose(b[::-1].toarray(), x[::-1])
    assert allclose(b[np.array([1, 3])].toarray(), x[np.array([1, 3])])
    assert allclose(np.asarray(b[2, -1, ::2].toarray()), x[2, -1, ::2])
    assert b[5:2].toarray().shape == x[5:2].shape
    assert allclose(b[1, [0, 2], :].toarray(), x[1][[0, 2], :])


def test_take_parity(dev):
    # ndarray.take: inherited locally, compiled program on TPU
    x = _x()
    b, lo = bolt.array(x, dev), bolt.array(x)
    for kwargs in [dict(indices=[2, 0, 5]), dict(indices=[1, -1], axis=0),
                   dict(indices=[3, 1], axis=1),
                   dict(indices=[0, 2, 4], axis=2),
                   dict(indices=[[0, 1], [2, 3]], axis=0),
                   dict(indices=7)]:
        ref = x.take(**kwargs)
        t = b.take(**kwargs)
        l = lo.take(**kwargs)
        assert np.asarray(t.toarray()).shape == ref.shape, kwargs
        assert allclose(t.toarray(), ref), kwargs
        assert allclose(np.asarray(l), ref), kwargs
    # split bookkeeping
    assert b.take([1, 0], axis=0).split == 1
    assert b.take(0, axis=0).split == 0
    assert b.take([1, 0], axis=2).split == 1
    assert b.take([[0, 1], [2, 3]], axis=0).split == 2
    # errors match numpy's classes
    with pytest.raises(IndexError):
        b.take([9999])               # OOB for the flattened 160 elements
    with pytest.raises(IndexError):
        b.take([8], axis=0)
    # deferred chains fuse in
    assert allclose(bolt.array(x, dev).map(lambda v: v * 2)
                    .take([1, 3], axis=0).toarray(), (x * 2).take([1, 3], 0))


def test_take_numpy_dtype_and_mode_semantics(dev):
    # numpy's exact quirks: float NDARRAYS rejected, float sequences and
    # scalars truncate, bools are 0/1 indices, mode= clips/wraps
    x = _x()
    b, lo = bolt.array(x, dev), bolt.array(x)
    for args in [([True, False],), ([2.7],), (1.5,), ([-1.5],)]:
        ref = x.take(*args)
        assert allclose(np.asarray(b.take(*args).toarray()), ref), args
        assert allclose(np.asarray(lo.take(*args)), ref), args
    with pytest.raises(TypeError):
        b.take(np.array([1.5]))
    with pytest.raises(TypeError):
        b.take(np.array([], dtype=float))
    assert allclose(np.asarray(b.take([9999], mode="clip").toarray()),
                    x.take([9999], mode="clip"))
    assert allclose(np.asarray(b.take([-3, 175], axis=None, mode="wrap").toarray()),
                    x.take([-3, 175], mode="wrap"))
    with pytest.raises(ValueError):
        b.take([0], mode="nope")
