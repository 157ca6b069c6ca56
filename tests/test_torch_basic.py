"""The reference's backend basics (``tests/test_tpu_basic.py``) on the
port: ``bolt_tpu`` swapped for ``bolt_tpu_torch`` and the
mesh for the CPU device (the ``dev`` fixture), the same inputs and
assertions.  Adapted: the repr names the ``gpu`` mode where the
reference's names ``tpu``.  No case is left out.
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
    rs = np.random.RandomState(2)
    return rs.randn(8, 4, 5)


def test_dtype_preserved(dev):
    x = _x()
    b = bolt.array(x, dev)
    assert b.dtype == np.float64
    assert b.toarray().dtype == np.float64
    b32 = bolt.array(x.astype(np.float32), dev)
    assert b32.dtype == np.float32


def test_astype(dev):
    x = np.arange(16.0).reshape(8, 2)
    b = bolt.array(x, dev)
    c = b.astype(np.int32)
    assert c.dtype == np.int32
    assert allclose(c.toarray(), x.astype(np.int32))


def test_ufunc_via_map(dev):
    x = np.abs(_x()) + 0.5
    b = bolt.array(x, dev)
    for f in (np.sqrt, np.log, np.exp, np.sin):
        assert allclose(b.map(f).toarray(), f(x))


def test_cache_unpersist_repartition(dev):
    b = bolt.ones((8, 3), dev)
    assert b.cache() is b
    assert b.unpersist() is b
    assert b.repartition(4) is b


def test_first(dev):
    x = _x()
    b = bolt.array(x, dev)
    assert allclose(b.first(), x[0])
    b2 = bolt.array(x, dev, axis=(0, 1))
    assert allclose(b2.first(), x[0, 0])


def test_repr(dev):
    b = bolt.ones((8, 3), dev)
    r = repr(b)
    assert "gpu" in r and "split: 1" in r and "shape" in r


def test_size_ndim(dev):
    b = bolt.ones((8, 3, 2), dev)
    assert b.size == 48
    assert b.ndim == 3
    assert np.asarray(b).shape == (8, 3, 2)
