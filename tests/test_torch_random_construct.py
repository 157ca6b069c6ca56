"""The reference's random-constructor tests
(``tests/test_random_construct.py``) on the port: ``bolt_tpu`` swapped
for ``bolt_tpu_torch`` and the mesh for the CPU device, the same inputs
and assertions.  ``rand``/``randn`` draw on the device from a
``torch.Generator``, so values differ from ``jax.random``'s; the tests
check moments, ranges and seeds, not values.

Adapted: ``mode == "tpu"`` reads ``"gpu"``; the jit cache of
``test_random_program_cache_reused_across_seeds`` is the engine's
program cache (``engine._CACHE``).  Left out (jax only):
``test_randn_sharded_and_deterministic``'s sharding line
(``tojax().sharding``) and ``test_random_sharding_keyed_by_split`` (a
2-d mesh's shardings).
"""

import numpy as np
import pytest
import torch

import bolt_tpu_torch as bolt

CPU = torch.device("cpu")


@pytest.fixture
def dev():
    """The port's context in place of the reference's mesh."""
    return CPU


def test_randn_sharded_and_deterministic(dev):
    b = bolt.randn((16, 4, 3), dev, axis=(0,), dtype=np.float32, seed=7)
    assert b.mode == "gpu" and b.split == 1
    assert b.shape == (16, 4, 3) and b.dtype == np.float32
    # same seed reproduces, different seed differs
    again = bolt.randn((16, 4, 3), dev, axis=(0,), dtype=np.float32, seed=7)
    other = bolt.randn((16, 4, 3), dev, axis=(0,), dtype=np.float32, seed=8)
    assert np.array_equal(b.toarray(), again.toarray())
    assert not np.array_equal(b.toarray(), other.toarray())


def test_randn_moments(dev):
    b = bolt.randn((64, 32, 16), dev, dtype=np.float32, seed=0)
    x = b.toarray()
    assert abs(x.mean()) < 0.02 and abs(x.std() - 1.0) < 0.02


def test_rand_range_and_mode_dispatch(dev):
    b = bolt.rand((32, 8), dev, dtype=np.float32)
    x = b.toarray()
    assert x.min() >= 0.0 and x.max() < 1.0
    # local dispatch without a dev
    lo = bolt.rand((32, 8))
    assert lo.mode == "local" and lo.shape == (32, 8)
    lo2 = bolt.randn((32, 8), seed=3)
    assert lo2.mode == "local"
    assert np.array_equal(np.asarray(lo2),
                          np.asarray(bolt.randn((32, 8), seed=3)))


def test_random_local_rejects_non_float():
    # local must match the TPU contract, not silently truncate to zeros
    with pytest.raises(ValueError):
        bolt.rand((8, 4), dtype=np.int32)
    with pytest.raises(ValueError):
        bolt.randn((8, 4), dtype=np.int64)


def test_random_pipeline_end_to_end(dev):
    # generated arrays are ordinary bolt arrays: map/stats/swap all work
    b = bolt.randn((8, 6, 4), dev, axis=(0, 1), dtype=np.float32, seed=1)
    assert b.split == 2
    m = b.map(lambda v: v * 2.0, axis=(0, 1))
    assert np.allclose(m.toarray(), b.toarray() * 2.0)
    assert np.allclose(np.asarray(b.stats().mean()),
                       b.toarray().mean(axis=(0, 1)), atol=1e-6)


def test_random_rejects_non_float(dev):
    with pytest.raises(ValueError):
        bolt.randn((8, 4), dev, dtype=np.int32)


def test_random_key_axis_moves_front(dev):
    # axis=(1,) distributes that axis; it moves to the front like array()
    b = bolt.randn((6, 16, 3), dev, axis=(1,), dtype=np.float32)
    assert b.shape == (16, 6, 3) and b.split == 1


def test_random_program_cache_reused_across_seeds(dev):
    # seed is an argument: new seeds must NOT grow the program cache
    from bolt_tpu_torch.engine import _CACHE as _JIT_CACHE
    bolt.randn((8, 4), dev, dtype=np.float32, seed=0)
    size = len(_JIT_CACHE)
    for seed in (1, 2, 3):
        bolt.randn((8, 4), dev, dtype=np.float32, seed=seed)
    assert len(_JIT_CACHE) == size


def test_random_negative_and_huge_seeds(dev):
    # any Python int seed works, matching the local backend
    a = bolt.randn((8, 4), dev, dtype=np.float32, seed=-1)
    b = bolt.randn((8, 4), dev, dtype=np.float32, seed=2 ** 40 + 5)
    assert np.all(np.isfinite(a.toarray()))
    assert not np.array_equal(a.toarray(), b.toarray())
    lo = bolt.randn((8, 4), seed=-1)
    assert lo.mode == "local"
