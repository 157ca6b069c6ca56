"""The reference's cross-backend parity locks (``tests/test_parity_locks.py``)
on the port: ``bolt_tpu`` swapped for ``bolt_tpu_torch`` and the
mesh for the CPU device (the ``dev`` fixture), the same inputs and
assertions.  The local oracle and the gpu backend give the
same result for the same expression: advanced indexing applies
orthogonally on both, and ``reduce`` folds one fixed pairwise tree, so
f32 accumulation is bit-exact across backends.  No case is left out.
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


def _x(seed=11, shape=(8, 4, 5)):
    return np.random.RandomState(seed).randn(*shape)


def _both(x, dev, axis=(0,)):
    return (bolt.array(x, axis=axis),
            bolt.array(x, dev, axis=axis))


# ----------------------------------------------------------------------
# advanced indexing: multiple advanced indices apply orthogonally
# (np.ix_ semantics) on BOTH backends
# ----------------------------------------------------------------------

INDEXES = [
    (np.s_[[0, 1], :, [0, 2]], "two lists"),
    (np.s_[[0, 1], :, [0, 2, 4]], "two lists, different lengths"),
    (np.s_[[2, 0], [1, 3], [4, 0]], "three lists"),
    (np.s_[..., [1, 0], [0, 2]], "ellipsis + two lists"),
    (np.s_[np.array([1, 5]), 1:3, np.array([0, 3])], "ndarrays + slice"),
    (np.s_[[-1, 0], :, [-2, -1]], "negative entries"),
]


@pytest.mark.parametrize("index,label", INDEXES,
                         ids=[label for _, label in INDEXES])
def test_multi_advanced_orthogonal_both_backends(dev, index, label):
    x = _x()
    lo, tp = _both(x, dev)
    a = lo[index].toarray()
    b = tp[index].toarray()
    assert a.shape == b.shape, (label, a.shape, b.shape)
    assert allclose(a, b)


def test_multi_advanced_matches_ix(dev):
    # both backends implement the documented np.ix_ semantics
    x = _x()
    lo, tp = _both(x, dev)
    expected = x[np.ix_([0, 1], range(x.shape[1]), [0, 2])]
    assert allclose(lo[[0, 1], :, [0, 2]].toarray(), expected)
    assert allclose(tp[[0, 1], :, [0, 2]].toarray(), expected)


def test_bool_plus_list_orthogonal(dev):
    x = _x()
    lo, tp = _both(x, dev)
    kmask = x[:, 0, 0] > 0
    a = lo[kmask, :, [0, 3]].toarray()
    b = tp[kmask, :, [0, 3]].toarray()
    expected = x[np.ix_(np.nonzero(kmask)[0], range(x.shape[1]), [0, 3])]
    assert allclose(a, expected)
    assert allclose(b, expected)


def test_int_with_two_lists(dev):
    x = _x()
    lo, tp = _both(x, dev)
    a = lo[2, [0, 1], [0, 2, 4]].toarray()
    b = tp[2, [0, 1], [0, 2, 4]].toarray()
    expected = x[2][np.ix_([0, 1], [0, 2, 4])]
    assert allclose(a, expected)
    assert allclose(b, expected)


def test_single_advanced_still_numpy(dev):
    # a single advanced index is identical under zipped and orthogonal
    # conventions; the local backend must keep ndarray behavior exactly
    x = _x()
    lo = bolt.array(x)
    assert allclose(lo[[0, 3, 5]].toarray(), x[[0, 3, 5]])
    assert allclose(lo[:, [3, 1]].toarray(), x[:, [3, 1]])
    assert allclose(lo[2:7, [0, 3], ::2].toarray(), x[2:7][:, [0, 3]][:, :, ::2])
    mask = x[:, 0, 0] > 0
    assert allclose(lo[mask].toarray(), x[mask])


def test_local_basic_indexing_untouched():
    # the override must not disturb basic (view) indexing or types
    x = _x()
    lo = bolt.array(x)
    assert isinstance(lo[1:3], bolt.BoltArrayLocal)
    assert allclose(lo[1:3].toarray(), x[1:3])
    assert allclose(np.asarray(lo[3, 1]), x[3, 1])
    assert float(lo[0, 0, 0]) == float(x[0, 0, 0])


# ----------------------------------------------------------------------
# reduce: one fixed pairwise tree on both backends
# ----------------------------------------------------------------------

def test_reduce_f32_bitexact_cross_backend(dev):
    x = np.random.RandomState(7).randn(13, 5).astype(np.float32)
    lo, tp = _both(x, dev)
    a = lo.reduce(np.add).toarray()
    b = tp.reduce(np.add).toarray()
    assert a.dtype == b.dtype == np.float32
    # BIT-exact, not allclose: identical combine tree + IEEE f32 adds
    assert np.array_equal(a, b)


def test_reduce_nonassociative_parity(dev):
    # a non-associative reducer gives the same (tree-order) answer on both
    x = np.random.RandomState(8).randn(11, 3)
    lo, tp = _both(x, dev)
    f = lambda a, b: a - 0.5 * b
    assert np.array_equal(lo.reduce(f).toarray(), tp.reduce(f).toarray())


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 16])
def test_reduce_tree_every_count(dev, n):
    x = np.random.RandomState(n).randn(n, 4).astype(np.float32)
    lo, tp = _both(x, dev)
    assert np.array_equal(lo.reduce(np.add).toarray(),
                          tp.reduce(np.add).toarray())


def test_reduce_empty_raises():
    lo = bolt.array(np.zeros((0, 3)))
    with pytest.raises(TypeError):
        lo.reduce(np.add)


def test_zero_d_array_index_is_scalar(dev):
    # np.argmax results are 0-d arrays; they must squeeze like scalars,
    # never shift later axes through a degenerate take
    x = _x(shape=(4, 5, 6))
    lo, tp = _both(x, dev)
    i, j = np.array(0), np.array(1)
    expected = x[0, 1, :]
    for b in (lo, tp):
        out = b[i, j]
        assert out.shape == (6,), out.shape
        assert allclose(out.toarray(), expected)
    # mixed with a real advanced index
    expected = x[0][:, [0, 2]]
    for b in (lo, tp):
        assert allclose(b[np.array(0), :, [0, 2]].toarray(), expected)


def test_reduce_empty_raises_both_backends(dev):
    lo = bolt.array(np.zeros((0, 3)))
    tp = bolt.array(np.zeros((4, 3)), dev).filter(lambda v: False)
    with pytest.raises(TypeError):
        lo.reduce(np.add)
    with pytest.raises(TypeError):
        tp.reduce(np.add)


def test_scalar_plus_list_separated_by_slice(dev):
    # numpy would move the advanced result axis to the front here; both
    # backends must keep the documented orthogonal (in-place) semantics
    x = _x()
    lo, tp = _both(x, dev)
    expected = x[1][:, [0, 4]]           # shape (4, 2), not numpy's (2, 4)
    a = lo[1, :, [0, 4]].toarray()
    b = tp[1, :, [0, 4]].toarray()
    assert a.shape == expected.shape
    assert allclose(a, expected)
    assert allclose(b, expected)


def test_multi_d_advanced_index_rejected(dev):
    # the per-axis orthogonal contract is 1-d index lists; a 2-d array
    # would silently shift later axes through the take loop
    x = _x()
    lo, tp = _both(x, dev)
    bad = np.array([[0, 1], [2, 3]])
    with pytest.raises(IndexError):
        tp[bad, :, [0, 2]]
    with pytest.raises(IndexError):
        lo[bad, :, [0, 2]]
    with pytest.raises(IndexError):
        tp[bad]
