"""The reference's construction tests (``tests/test_tpu_construct.py``)
on the port: ``bolt_tpu`` swapped for ``bolt_tpu_torch`` and the mesh
for the CPU device, the same inputs and assertions.

Adapted: ``mode == "tpu"``/``BoltArrayTPU``/``totpu`` read
``"gpu"``/``BoltArrayGPU``/``togpu``; a ``jax.Array`` input is a
``torch.Tensor``; ``mode="gpu"`` with no context runs on ``cuda:0``, so
without a card it raises (the port never falls back to the CPU).
Left out (jax only): ``test_array_sharded`` and ``test_ones_zeros``'s
last line (``._data.sharding.device_set``), and
``test_lazy_submodules``'s ``parallel.exchange_halo`` (halos come with
ROADMAP A12).
"""

import numpy as np
import pytest
import torch

import bolt_tpu_torch as bolt
from bolt_tpu_torch.gpu.array import BoltArrayGPU
from bolt_tpu_torch.utils import allclose

CPU = torch.device("cpu")


@pytest.fixture
def dev():
    """The port's context in place of the reference's mesh."""
    return CPU


def _x():
    rs = np.random.RandomState(1)
    return rs.randn(8, 4, 5)


def test_array_dispatch(dev):
    x = _x()
    b = bolt.array(x, dev)
    assert isinstance(b, BoltArrayGPU)
    assert b.mode == "gpu"
    assert b.shape == x.shape
    assert b.split == 1
    assert allclose(b.toarray(), x)
    # keyword context
    assert bolt.array(x, context=dev).mode == "gpu"
    # explicit mode with the default device, cuda:0
    if torch.cuda.is_available():
        assert bolt.array(x, mode="gpu").mode == "gpu"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            bolt.array(x, mode="gpu")


def test_array_from_sequence(dev):
    # plain Python sequences are valid array-likes (regression: the
    # device-array fast path must not reach .shape before coercion)
    rows = [[1.0, 2.0, 3.0, 4.0]] * 8
    b = bolt.array(rows, dev)
    assert b.shape == (8, 4)
    assert allclose(b.toarray(), np.asarray(rows))
    t = bolt.array(tuple(map(tuple, rows)), dev, dtype=np.float32)
    assert t.dtype == np.float32
    assert allclose(t.toarray(), np.asarray(rows, dtype=np.float32))


def test_array_axis(dev):
    x = _x()
    b = bolt.array(x, dev, axis=(0, 1))
    assert b.split == 2
    assert allclose(b.toarray(), x)
    # non-leading key axis: moved to the front of the logical shape
    b = bolt.array(x, dev, axis=(1,))
    assert b.shape == (4, 8, 5)
    assert allclose(b.toarray(), np.transpose(x, (1, 0, 2)))


def test_ones_zeros(dev):
    b = bolt.ones((8, 3, 2), dev)
    assert allclose(b.toarray(), np.ones((8, 3, 2)))
    assert b.dtype == np.float64
    b = bolt.zeros((8, 3), dev, dtype=np.float32)
    assert allclose(b.toarray(), np.zeros((8, 3)))
    assert b.dtype == np.float32


def test_full_scalar_and_array_fill(dev):
    # scalar fill: engine-keyed constant program, numpy full semantics
    b = bolt.full((8, 3), 2.5, dev)
    assert allclose(b.toarray(), np.full((8, 3), 2.5))
    # array-like fill broadcasts like np.full — unhashable, so it rides
    # as a program ARGUMENT, not an engine cache key (regression: the
    # engine-routed path must not TypeError on hashing an ndarray)
    fill = np.array([1.0, 2.0, 3.0])
    a = bolt.full((8, 3), fill, dev)
    assert allclose(a.toarray(), np.full((8, 3), fill))
    # and a repeat of each geometry HITS the executable cache
    from bolt_tpu_torch import engine
    c0 = engine.counters()["misses"]
    bolt.full((8, 3), 2.5, dev)
    bolt.full((8, 3), np.array([9.0, 8.0, 7.0]), dev)
    assert engine.counters()["misses"] == c0
    # NaN fills must cache too (NaN != NaN would never match a raw
    # value key): first call may miss, repeats must hit
    n = bolt.full((8, 3), np.nan, dev)
    assert np.isnan(np.asarray(n.toarray())).all()
    c1 = engine.counters()["misses"]
    bolt.full((8, 3), np.nan, dev)
    bolt.full((8, 3), np.nan, dev)
    assert engine.counters()["misses"] == c1


def test_ones_axis(dev):
    b = bolt.ones((3, 8), dev, axis=(1,))
    assert b.shape == (8, 3)
    assert b.split == 1


def test_indivisible_key_axis(dev):
    # 7 does not divide 8: replicated but still correct
    x = np.arange(7.0 * 3).reshape(7, 3)
    b = bolt.array(x, dev)
    assert allclose(b.toarray(), x)
    assert allclose(b.map(lambda v: v * 2).toarray(), x * 2)


def test_concatenate(dev):
    x = _x()
    b = bolt.array(x, dev)
    out = bolt.concatenate((b, b), axis=1)
    assert isinstance(out, BoltArrayGPU)
    assert allclose(out.toarray(), np.concatenate([x, x], axis=1))


def test_context_validation():
    with pytest.raises(ValueError):
        bolt.array(np.ones(3), context="not a device", mode="gpu")


def test_construct_from_device_array(dev):
    # torch.Tensor / BoltArrayGPU inputs stay on device (no host round-trip)
    x = _x()
    d = torch.from_numpy(x)
    b = bolt.array(d, dev)
    assert isinstance(b, BoltArrayGPU)
    assert allclose(b.toarray(), x)
    # re-keying an existing distributed array
    b2 = bolt.array(b, dev, axis=(1,))
    assert b2.shape == (4, 8, 5)
    assert allclose(b2.toarray(), np.transpose(x, (1, 0, 2)))


def test_lazy_submodules():
    assert hasattr(bolt.profile, "timeit")
    assert hasattr(bolt.checkpoint, "save")
    with pytest.raises(AttributeError):
        bolt.no_such_submodule


def test_conversions(dev):
    x = _x()
    b = bolt.array(x, dev)
    loc = b.tolocal()
    assert loc.mode == "local"
    assert allclose(loc.toarray(), x)
    back = loc.togpu(dev)
    assert back.mode == "gpu"
    assert allclose(back.toarray(), x)
    assert b.togpu() is b
