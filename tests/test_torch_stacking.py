"""``BoltArrayGPU.stacked`` (``bolt_tpu_torch/gpu/stack.py``) against the
reference's (``bolt_tpu/tpu/stack.py``).

The assertions of ``tests/test_tpu_stacking.py`` on the port, on the CPU
(``context=torch.device("cpu")``), from the same seeded numpy inputs; each
result equals ``bolt_tpu``'s (``rtol=1e-10`` in f64).  Then what the port
adds: the blocks run in groups of about ``_BLOCK_BYTES`` of records (the
group boundaries fall between whole blocks, so a small block size gives
the same values as one group), the hints are checked before any work, and
a streamed source refuses with a pointed error until its stacked stage is
ported.
"""

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch.gpu import array as garray
from bolt_tpu_torch.utils import allclose

CPU = torch.device("cpu")


def _x():
    rs = np.random.RandomState(10)
    return rs.randn(8, 4, 5)


def _arr(x):
    return bolt.array(x, context=CPU)


def _same(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-10, atol=1e-12)


def test_stack_view():
    x = _x()
    b = _arr(x)
    s = b.stacked(size=3)
    assert s.shape == x.shape
    assert s.split == 1
    assert s.size == 3
    assert s.nblocks == 3  # 8 records in blocks of 3 -> 3, 3, 2
    assert s.unstack() is b
    assert s.mode == "gpu"
    with pytest.raises(ValueError):
        b.stacked(size=0)


def test_stack_map_elementwise(mesh):
    x = _x()
    out = _arr(x).stacked(size=3).map(lambda blk: blk * 2)
    assert allclose(out.unstack().toarray(), x * 2)
    _same(out.unstack().toarray(), ref.array(x, mesh).stacked(size=3).map(
        lambda blk: blk * 2).unstack().toarray())


def test_stack_map_blockwise(mesh):
    # a genuinely block-level func: normalise within each stack block
    x = _x()
    s = _arr(x).stacked(size=4)
    out = s.map(lambda blk: blk - blk.mean(axis=0)).unstack().toarray()
    expected = np.concatenate(
        [x[i:i + 4] - x[i:i + 4].mean(axis=0) for i in (0, 4)])
    assert allclose(out, expected)
    _same(out, ref.array(x, mesh).stacked(size=4).map(
        lambda blk: blk - blk.mean(axis=0)).unstack().toarray())


def test_stack_map_value_shape_change(mesh):
    x = _x()
    out = (_arr(x).stacked(size=5)
           .map(lambda blk: blk.sum(axis=2)).unstack())
    assert out.shape == (8, 4)
    assert allclose(out.toarray(), x.sum(axis=2))
    _same(out.toarray(), ref.array(x, mesh).stacked(size=5).map(
        lambda blk: blk.sum(axis=2)).unstack().toarray())


def test_stack_map_count_guard():
    s = _arr(_x()).stacked(size=4)
    with pytest.raises(ValueError):
        s.map(lambda blk: blk[:2])


def test_repr():
    r = repr(_arr(_x()).stacked(size=3))
    assert "nblocks: 3" in r and "size: 3" in r


def test_stacked_map_trace_cost_is_grid_independent():
    # func runs at most twice (vmapped full blocks + ragged tail), not
    # once per block — size=2 over 16 records would otherwise cost 8
    rs = np.random.RandomState(70)
    x = rs.randn(16, 3)
    traces = []

    def f(blk):
        traces.append(tuple(blk.shape))
        return blk * 2.0

    out = _arr(x).stacked(size=3).map(f).unstack()
    assert np.allclose(out.toarray(), x * 2.0)
    assert len(traces) <= 2, traces          # 5 full blocks + tail of 1
    # uniform split: single vmapped call
    traces.clear()
    out = _arr(x).stacked(size=4).map(f).unstack()
    assert np.allclose(out.toarray(), x * 2.0)
    assert len(traces) == 1, traces


def test_stack_map_count_guard_both_branches():
    rs = np.random.RandomState(71)
    x = rs.randn(8, 3)
    # vmap branch: full blocks violate the contract
    with pytest.raises(ValueError):
        _arr(x).stacked(size=4).map(lambda blk: blk[:2]).unstack()
    # ragged-tail branch: a fixed 3-row output satisfies the full blocks
    # but violates the 2-record tail
    with pytest.raises(ValueError):
        _arr(x).stacked(size=3).map(
            lambda blk: torch.zeros((3,) + tuple(blk.shape[1:]),
                                    dtype=blk.dtype)).unstack()
    # record axis dropped entirely
    with pytest.raises(ValueError):
        _arr(x).stacked(size=4).map(lambda blk: blk.sum()).unstack()


def test_stacked_map_zero_records():
    # a filter with no survivors yields (0, *vshape); stacked.map returns
    # the empty result with the shape/dtype a non-empty run would give,
    # and func never runs on data
    x = np.random.RandomState(72).randn(8, 3)
    f = _arr(x).filter(lambda v: v.sum() > 1e9)
    out = f.stacked(size=4).map(lambda blk: blk * 2).unstack()
    assert out.shape == (0, 3)
    assert out.toarray().shape == (0, 3)
    out2 = f.stacked(size=4).map(lambda blk: blk[:, :1]).unstack()
    assert out2.shape == (0, 1)
    out3 = f.stacked(size=4).map(
        lambda blk: blk.to(torch.float32)).unstack()
    assert out3.dtype == np.float32
    out4 = f.stacked(size=4).map(lambda blk: blk * 2, dtype=np.float32
                                 ).unstack()
    assert out4.dtype == np.float32 and out4.shape == (0, 3)
    seen = []
    f.stacked(size=4).map(lambda blk: seen.append(blk.device) or blk)
    assert seen == [torch.device("meta")]


def test_stacked_map_value_shape_and_dtype_hints():
    rs = np.random.RandomState(81)
    x = rs.randn(8, 3)
    s = _arr(x).stacked(size=4)
    out = s.map(lambda blk: blk + 1, dtype=np.float32).unstack()
    assert out.dtype == np.float32
    assert np.allclose(out.toarray(), (x + 1).astype(np.float32), atol=1e-6)
    with pytest.raises(ValueError):
        s.map(lambda blk: blk + 1, value_shape=(7,))


def test_hints_are_checked_before_any_work():
    x = np.random.RandomState(82).randn(8, 3)
    seen = []

    def f(blk):
        seen.append(blk.device)
        return blk + 1

    s = _arr(x).map(lambda v: v * 2).stacked(size=4)
    with pytest.raises(ValueError):
        s.map(f, value_shape=(7,))
    assert seen == [torch.device("meta")]
    with pytest.raises(TypeError):
        s.map(f, dtype="not-a-dtype")
    assert seen == [torch.device("meta")]
    assert s.unstack().deferred            # the chain never ran


@pytest.mark.parametrize("records", [1, 4, 6])
def test_grouped_blocks_equal_one_group(monkeypatch, records, mesh):
    # groups of whole blocks: at most `records` records of bytes a group
    x = np.random.RandomState(83).randn(13, 5)
    f = lambda blk: blk - blk.mean(0, keepdim=True)
    want = _arr(x).map(lambda v: v + 1).stacked(3).map(f).unstack().toarray()
    monkeypatch.setattr(garray, "_BLOCK_BYTES", records * 5 * 8)
    got = _arr(x).map(lambda v: v + 1).stacked(3).map(f).unstack()
    assert np.array_equal(got.toarray(), want)
    _same(got.toarray(), ref.array(x, mesh).map(lambda v: v + 1).stacked(
        3).map(lambda blk: blk - blk.mean(0, keepdims=True)).unstack()
        .toarray())


def test_streamed_source_refuses_until_ported():
    x = np.arange(24.0).reshape(6, 4)
    s = bolt.fromcallback(lambda i: x[i], x.shape, CPU, dtype=np.float64,
                          chunks=2)
    with pytest.raises(NotImplementedError, match="A9"):
        s.stacked(2).map(lambda blk: blk * 2)
    assert s.streaming                        # nothing materialised
