"""The reference's shaping tests (``tests/test_tpu_shaping.py``) on the
port: ``bolt_tpu`` swapped for ``bolt_tpu_torch`` and the
mesh for the CPU device (the ``dev`` fixture), the same inputs and
assertions.  ``transpose``/``reshape``/``squeeze``/``swap``
over axis permutations against numpy, with the key/value boundary
guards.  No case is left out.
"""

from itertools import permutations

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


def _x(shape=(4, 2, 3, 2)):
    rs = np.random.RandomState(5)
    return rs.randn(*shape)


def test_transpose_within_groups(dev):
    x = _x()
    b = bolt.array(x, dev, axis=(0, 1))
    # all group-respecting permutations of a (2 key, 2 value) array
    for kperm in permutations(range(2)):
        for vperm in permutations(range(2)):
            perm = tuple(kperm) + tuple(v + 2 for v in vperm)
            out = b.transpose(*perm)
            assert out.split == 2
            assert allclose(out.toarray(), np.transpose(x, perm))


def test_transpose_guard(dev):
    b = bolt.array(_x(), dev, axis=(0, 1))
    with pytest.raises(ValueError):
        b.transpose(0, 2, 1, 3)  # crosses the key/value boundary
    with pytest.raises(ValueError):
        b.transpose(0, 0, 1, 2)  # not a permutation


def test_T(dev):
    x = _x()
    b = bolt.array(x, dev, axis=(0, 1))
    assert allclose(b.T.toarray(), np.transpose(x, (1, 0, 3, 2)))


def test_swapaxes(dev):
    x = _x()
    b = bolt.array(x, dev, axis=(0, 1))
    assert allclose(b.swapaxes(2, 3).toarray(), x.swapaxes(2, 3))
    assert allclose(b.swapaxes(0, 1).toarray(), x.swapaxes(0, 1))


def test_reshape_within_groups(dev):
    x = _x()
    b = bolt.array(x, dev, axis=(0, 1))  # keys (4,2), values (3,2)
    out = b.reshape(8, 3, 2)
    assert out.split == 1
    assert allclose(out.toarray(), x.reshape(8, 3, 2))
    out = b.reshape(4, 2, 6)
    assert out.split == 2
    assert allclose(out.toarray(), x.reshape(4, 2, 6))
    out = b.reshape((2, 2, 2, 6))
    assert out.split == 3
    assert allclose(out.toarray(), x.reshape(2, 2, 2, 6))


def test_reshape_guards(dev):
    b = bolt.array(_x(), dev, axis=(0, 1))
    with pytest.raises(ValueError):
        b.reshape(4, 2, 3, 3)  # wrong size
    with pytest.raises(ValueError):
        b.reshape(3, 16)  # crosses the key/value boundary (8 keys)


def test_squeeze(dev):
    x = _x((4, 1, 3, 1))
    b = bolt.array(x, dev, axis=(0, 1))
    out = b.squeeze()
    assert out.shape == (4, 3)
    assert out.split == 1
    assert allclose(out.toarray(), x.squeeze())
    out = b.squeeze(axis=(3,))
    assert out.shape == (4, 1, 3)
    assert out.split == 2
    with pytest.raises(ValueError):
        b.squeeze(axis=(0,))  # size 4, not squeezable


def test_swap_roundtrip(dev):
    x = _x()
    b = bolt.array(x, dev, axis=(0, 1))
    s = b.swap((0,), (0,))
    # new keys = (key1,) + (value0,); new values = (key0,) + (value1,)
    assert s.split == 2
    assert s.shape == (2, 3, 4, 2)
    assert allclose(s.toarray(), np.transpose(x, (1, 2, 0, 3)))


def test_swap_all_keys_out_guard(dev):
    b = bolt.array(_x(), dev, axis=(0,))
    with pytest.raises(ValueError):
        b.swap((0,), ())


def test_swap_all_values_in(dev):
    x = _x()
    b = bolt.array(x, dev, axis=(0,))
    # nothing leaves the keys, every value axis joins them: layout unchanged
    s = b.swap((), (0, 1, 2))
    assert s.split == 4
    assert allclose(s.toarray(), x)
    # move key 0 out and every value in: values lead, old key trails
    s = b.swap((0,), (0, 1, 2))
    assert s.split == 3
    assert allclose(s.toarray(), np.transpose(x, (1, 2, 3, 0)))


def test_swap_validation(dev):
    b = bolt.array(_x(), dev, axis=(0, 1))
    with pytest.raises(ValueError):
        b.swap((5,), ())
    with pytest.raises(ValueError):
        b.swap((), (7,))
    with pytest.raises(ValueError):
        b.swap((0, 0), ())


def test_swap_enumerated_4d(dev):
    """Brute-force: every single-key/single-value swap of a 4D array
    (the reference's enumeration-style shaping tests)."""
    x = _x()
    b = bolt.array(x, dev, axis=(0, 1))
    for ka in range(2):
        for va in range(2):
            s = b.swap((ka,), (va,))
            keys_rest = [k for k in range(2) if k != ka]
            perm = keys_rest + [2 + va] + [ka] + [2 + v for v in range(2) if v != va]
            assert allclose(s.toarray(), np.transpose(x, perm))
            assert s.split == 2
            # roundtrip restores values via the inverse swap
            back = s.swap((s.split - 1,), (0,))
            assert back.shape[0] in (2, 4)


def test_keys_values_views(dev):
    x = _x()
    b = bolt.array(x, dev, axis=(0, 1))
    assert b.keys.shape == (4, 2)
    assert b.values.shape == (3, 2)
    out = b.keys.reshape(8)
    assert out.shape == (8, 3, 2)
    assert out.split == 1
    assert allclose(out.toarray(), x.reshape(8, 3, 2))
    out = b.values.reshape(6)
    assert out.shape == (4, 2, 6)
    assert allclose(out.toarray(), x.reshape(4, 2, 6))
    out = b.keys.transpose(1, 0)
    assert allclose(out.toarray(), np.transpose(x, (1, 0, 2, 3)))
    out = b.values.transpose(1, 0)
    assert allclose(out.toarray(), np.transpose(x, (0, 1, 3, 2)))
    with pytest.raises(ValueError):
        b.keys.reshape(7)
    with pytest.raises(ValueError):
        b.values.transpose(0, 2)
    assert "keys" in repr(b.keys) and "values" in repr(b.values)
