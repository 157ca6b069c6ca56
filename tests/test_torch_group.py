"""The port's grouped reductions, ``bincount``, ``unique``, ``topk`` and
``histogram`` against the reference's.

The assertions of ``tests/test_ops_group.py`` and of the ``histogram``
cases of ``tests/test_stats_extras.py`` on ``bolt_tpu_torch``
(``context=torch.device("cpu")``), with the same seeded inputs fed to
``bolt_tpu`` (8-device CPU mesh, x64).  Values match the numpy mirror
(``allclose``: rtol 1e-5, atol 1e-8, or the tolerance stated) and the
reference's own results; integer results (counts, indices, uniques) are
equal exactly.  ``_unique_sharded``'s cases have no single-device
counterpart (``ROADMAP.md`` A12); the port's chunked ``unique`` and
slabbed ``topk`` are driven by ``ops/group.py :: _CHUNK_MAX_BYTES`` made
small.
"""

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu.ops import (bincount as ref_bincount, histogram as
                          ref_histogram, segment_reduce as ref_segment,
                          topk as ref_topk, unique as ref_unique)
from bolt_tpu_torch import engine
from bolt_tpu_torch.ops import (bincount, group, histogram, segment_reduce,
                                topk, unique)
from bolt_tpu_torch.utils import allclose

CPU = torch.device("cpu")


def _x(shape=(12, 4, 3), seed=80):
    return np.random.RandomState(seed).randn(*shape)


def _mirror(x, labels, nseg, op):
    out = []
    for g in range(nseg):
        rows = x[labels == g]
        if len(rows) == 0:
            if op in ("sum", "mean"):
                out.append(np.zeros(x.shape[1:]))
            else:
                out.append(np.full(x.shape[1:],
                                   -np.inf if op == "max" else np.inf))
        else:
            out.append(getattr(rows, op)(axis=0))
    return np.stack(out)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_segment_reduce_parity(mesh, op):
    x = _x()
    labels = np.array([0, 2, 1, 0, 2, 2, 1, 0, 3, 3, 0, 2])
    expected = _mirror(x, labels, 4, op)
    for b in (bolt.array(x), bolt.array(x, CPU)):
        out = segment_reduce(b, labels, op=op)
        assert out.shape == (4,) + x.shape[1:]
        assert allclose(out.toarray(), expected), (b.mode, op)
    t = segment_reduce(bolt.array(x, CPU), labels, op=op)
    assert t.split == 1
    theirs = ref_segment(ref.array(x, mesh), labels, op=op).toarray()
    assert np.allclose(t.toarray(), theirs, rtol=1e-12, atol=1e-12)


def test_segment_reduce_empty_group_and_num_segments():
    x = _x((6, 2))
    labels = np.array([0, 0, 3, 3, 3, 0])       # groups 1, 2 empty
    for b in (bolt.array(x), bolt.array(x, CPU)):
        out = segment_reduce(b, labels, num_segments=5).toarray()
        assert out.shape == (5, 2)
        assert np.allclose(out[1], 0) and np.allclose(out[2], 0)
        assert np.allclose(out[4], 0)
        assert np.allclose(out[0], x[labels == 0].sum(axis=0))


@pytest.mark.parametrize("block", [None, 5 * 12 * 8])
def test_segment_reduce_deferred_chain(monkeypatch, block):
    # the chain is applied block by block: one block, and blocks of 5
    # records with a ragged tail
    if block is not None:
        from bolt_tpu_torch.gpu import array as garray
        monkeypatch.setattr(garray, "_BLOCK_BYTES", block)
    x = _x()
    labels = np.arange(12) % 3
    b = bolt.array(x, CPU).map(lambda v: v * 2)
    for method in ("scatter", "matmul"):
        out = segment_reduce(b, labels, op="sum", method=method)
        assert allclose(out.toarray(), _mirror(x * 2, labels, 3, "sum"))
    out = segment_reduce(b, labels, op="max")
    assert allclose(out.toarray(), _mirror(x * 2, labels, 3, "max"))


def test_segment_reduce_int_mean(mesh):
    x = np.arange(24, dtype=np.int64).reshape(8, 3)
    labels = np.array([0, 1, 0, 1, 0, 1, 0, 1])
    for b in (bolt.array(x), bolt.array(x, CPU)):
        out = segment_reduce(b, labels, op="mean").toarray()
        assert np.issubdtype(out.dtype, np.floating)
        assert np.allclose(out, _mirror(x.astype(float), labels, 2, "mean"))
    theirs = ref_segment(ref.array(x, mesh), labels, op="mean").toarray()
    got = segment_reduce(bolt.array(x, CPU), labels, op="mean").toarray()
    assert got.dtype == theirs.dtype and np.array_equal(got, theirs)


def test_segment_reduce_errors():
    b = bolt.array(_x(), CPU)
    with pytest.raises(ValueError):
        segment_reduce(b, np.arange(5))           # wrong length
    with pytest.raises(ValueError):
        segment_reduce(b, np.arange(12), op="prod")
    with pytest.raises(ValueError):
        segment_reduce(b, np.arange(12) - 1)      # negative label
    with pytest.raises(ValueError):
        segment_reduce(b, np.arange(12), num_segments=5)  # label 11 > 4
    with pytest.raises(ValueError):
        segment_reduce(b, np.arange(12.0))        # non-integer labels


def test_bincount_parity(mesh):
    x = np.random.RandomState(81).randint(0, 9, size=(16, 5))
    for b in (bolt.array(x), bolt.array(x, CPU)):
        got = bincount(b)
        assert got.dtype == np.int64
        assert np.array_equal(got, np.bincount(x.reshape(-1)))
        got = bincount(b, minlength=20)
        assert np.array_equal(got, np.bincount(x.reshape(-1), minlength=20))
    assert np.array_equal(bincount(bolt.array(x, CPU)),
                          ref_bincount(ref.array(x, mesh)))
    # a deferred chain is applied once
    got = bincount(bolt.array(x, CPU).map(lambda v: v * 2))
    assert np.array_equal(got, np.bincount(x.reshape(-1) * 2))
    with pytest.raises(TypeError):
        bincount(bolt.array(_x(), CPU))          # floats rejected
    with pytest.raises(ValueError):
        bincount(bolt.array(x - 5, CPU))         # negatives rejected


def test_segment_reduce_multi_key_axes(mesh):
    x = _x((4, 2, 3, 2))
    labels = np.array([0, 1, 0, 1])
    lo = segment_reduce(bolt.array(x), labels, op="sum")
    gp = segment_reduce(bolt.array(x, CPU, axis=(0, 1)), labels, op="sum")
    ch = segment_reduce(bolt.array(x, CPU, axis=(0, 1)).map(
        lambda v: v + 1), labels, op="sum")
    expected = np.stack([x[labels == g].sum(axis=0) for g in range(2)])
    assert allclose(lo.toarray(), expected)
    assert allclose(gp.toarray(), expected)
    assert allclose(ch.toarray(), np.stack(
        [(x + 1)[labels == g].sum(axis=0) for g in range(2)]))
    theirs = ref_segment(ref.array(x, mesh, axis=(0, 1)), labels, op="sum")
    assert np.allclose(gp.toarray(), theirs.toarray(), rtol=1e-12)


def test_segment_reduce_device_labels_no_host_bounce(monkeypatch):
    # a tensor (or a gpu bolt array) of labels stays on its device: its
    # data never passes through np.asarray; only the two-scalar range
    # check syncs
    x = _x()
    labels_host = np.array([0, 2, 1, 0, 2, 2, 1, 0, 3, 3, 0, 2])
    expected = _mirror(x, labels_host, 4, "sum")
    dev_labels = torch.from_numpy(labels_host)
    bounced = []
    real_asarray = np.asarray

    def spy(a, *args, **kwargs):
        if a is dev_labels:
            bounced.append(a)
        return real_asarray(a, *args, **kwargs)

    monkeypatch.setattr(group.np, "asarray", spy)
    b = bolt.array(x, CPU)
    for nseg in (None, 4):
        out = segment_reduce(b, dev_labels, num_segments=nseg, op="sum")
        assert allclose(out.toarray(), expected)
    assert not bounced
    out = segment_reduce(b, bolt.array(labels_host, CPU), op="sum")
    assert allclose(out.toarray(), expected)
    with pytest.raises(ValueError):
        segment_reduce(b, torch.from_numpy(labels_host - 1))
    with pytest.raises(ValueError):
        segment_reduce(b, dev_labels, num_segments=2)
    # labels on another device are refused, like a binary operand's
    with pytest.raises(ValueError, match="different devices"):
        segment_reduce(b, dev_labels.to("meta"))


def test_bincount_chunked_accumulation(monkeypatch):
    x = np.random.RandomState(84).randint(0, 9, size=(16, 5))
    expected = np.bincount(x.reshape(-1), minlength=11)
    monkeypatch.setattr(group, "_BINCOUNT_CHUNK", 17)   # 80 elems -> 5 chunks
    got = bincount(bolt.array(x, CPU), minlength=11)
    assert got.dtype == np.int64
    assert np.array_equal(got, expected)
    monkeypatch.setattr(group, "_BINCOUNT_CHUNK", 80)   # exact fit
    assert np.array_equal(bincount(bolt.array(x, CPU), minlength=11),
                          expected)


def test_segment_reduce_one_program_many_labels():
    # labels are an argument of the program: distinct label vectors reuse
    # one engine program
    b = bolt.array(_x(), CPU)
    segment_reduce(b, np.arange(12) % 4, num_segments=4, op="sum")
    n_before = sum(1 for k in engine._CACHE if k[0] == "segreduce")
    segment_reduce(b, np.arange(12) % 2 * 3, num_segments=4, op="sum")
    segment_reduce(b, np.zeros(12, dtype=int), num_segments=4, op="sum")
    assert sum(1 for k in engine._CACHE if k[0] == "segreduce") == n_before


def test_bincount_empty():
    e = bolt.array(np.zeros((0, 3), np.int64), CPU)
    assert np.array_equal(bincount(e, minlength=4), np.zeros(4, np.int64))
    assert np.array_equal(bincount(bolt.array(np.zeros((0,), np.int64)),
                                   minlength=2), np.zeros(2, np.int64))


def test_unique_parity(mesh):
    x = np.random.RandomState(82).randint(0, 7, size=(9, 4)).astype(
        np.float64)
    for b in (bolt.array(x), bolt.array(x, CPU)):
        assert np.array_equal(unique(b), np.unique(x)), b.mode
        u, c = unique(b, return_counts=True)
        un, cn = np.unique(x, return_counts=True)
        assert np.array_equal(u, un) and np.array_equal(c, cn), b.mode
    tu, tc = ref_unique(ref.array(x, mesh), return_counts=True)
    u, c = unique(bolt.array(x, CPU), return_counts=True)
    assert np.array_equal(u, tu) and np.array_equal(c, tc)
    i = bolt.array(np.full((4, 3), 5), CPU)
    u, c = unique(i, return_counts=True)
    assert np.array_equal(u, [5]) and np.array_equal(c, [12])
    m = bolt.array(x, CPU).map(lambda v: v * 0 + 2.0)
    assert np.array_equal(unique(m), [2.0])
    e = bolt.array(np.zeros((0, 3)), CPU)
    u, c = unique(e, return_counts=True)
    assert u.size == 0 and c.size == 0


def test_unique_nan_semantics(mesh):
    x = np.array([[1.0, np.nan], [np.nan, 1.0]])
    un, cn = np.unique(x, return_counts=True)
    for b in (bolt.array(x), bolt.array(x, CPU)):
        u, c = unique(b, return_counts=True)
        # modern numpy collapses NaNs to one entry; counts aggregate
        assert u.shape == un.shape, b.mode
        assert np.isnan(u[-1]) and u[0] == 1.0
        assert np.array_equal(c, cn), b.mode
    tu, tc = ref_unique(ref.array(x, mesh), return_counts=True)
    u, c = unique(bolt.array(x, CPU), return_counts=True)
    assert np.array_equal(u, tu, equal_nan=True) and np.array_equal(c, tc)


def test_unique_chunked_merges_exactly(monkeypatch):
    # above _CHUNK_MAX_BYTES the flattened array is sorted a chunk at a
    # time (here 13 elements, a ragged tail) and merged on the host
    x = np.random.RandomState(85).randint(0, 9, size=(10, 6)).astype(
        np.float32)
    x[3, 2] = x[7, 5] = np.nan
    monkeypatch.setattr(group, "_CHUNK_MAX_BYTES", 13 * 4)
    b = bolt.array(x, CPU).map(lambda v: v - 1)
    u, c = unique(b, return_counts=True)
    un, cn = np.unique(x - 1, return_counts=True)
    assert np.array_equal(u, un, equal_nan=True) and np.array_equal(c, cn)
    assert np.array_equal(unique(b), np.unique(x - 1), equal_nan=True)


def test_topk_parity(mesh):
    x = np.random.RandomState(83).randn(8, 6, 5)
    for b in (bolt.array(x), bolt.array(x, CPU)):
        for axis in (-1, 0, 1):
            v, i = topk(b, 3, axis=axis)
            moved = np.moveaxis(x, axis, -1)
            ref_i = np.argsort(-moved, axis=-1, kind="stable")[..., :3]
            ref_v = np.take_along_axis(moved, ref_i, axis=-1)
            assert allclose(v.toarray(), np.moveaxis(ref_v, -1, axis))
            assert np.array_equal(np.asarray(i.toarray()),
                                  np.moveaxis(ref_i, -1, axis))
    t, _ = topk(bolt.array(x, CPU), 3, axis=2)
    assert t.split == 1 and t.shape == (8, 6, 3)
    t, ti = topk(bolt.array(x, CPU), 2, axis=0)
    assert t.split == 1 and t.shape == (2, 6, 5)
    _, ri = ref_topk(ref.array(x, mesh), 2, axis=0)
    assert np.array_equal(ti.toarray(), ri.toarray())
    z = np.zeros((4, 4))
    for b in (bolt.array(z), bolt.array(z, CPU)):
        _, i = topk(b, 2)
        assert np.array_equal(np.asarray(i.toarray()), np.tile([0, 1], (4, 1)))


def test_topk_slabbed_matches_whole(monkeypatch):
    # a non-last axis above _CHUNK_MAX_BYTES is slabbed along the largest
    # other axis: same values and indices
    x = np.random.RandomState(86).randn(6, 9, 4)
    x[2, 3, 1] = x[4, 3, 1]                      # a tie across the axis
    b = bolt.array(x, CPU).map(lambda v: v * 3)
    whole = topk(b, 2, axis=0)
    monkeypatch.setattr(group, "_CHUNK_MAX_BYTES", 100)
    assert group.slab_plan(b.shape, 0, 6 * 9 * 4 * 8)[0] == 1
    slabbed = topk(b, 2, axis=0)
    for w, s in zip(whole, slabbed):
        assert np.array_equal(w.toarray(), s.toarray())


def test_topk_errors():
    b = bolt.array(_x(), CPU)
    with pytest.raises(ValueError):
        topk(b, 0)
    with pytest.raises(ValueError):
        topk(b, 99, axis=0)
    with pytest.raises(ValueError):
        topk(b, 1, axis=9)
    with pytest.raises(TypeError):
        topk(b, 1, axis=1.5)
    v, _ = topk(bolt.array(_x(), CPU).map(lambda r: -r), 2, axis=0)
    moved = np.moveaxis(-_x(), 0, -1)
    want = np.moveaxis(np.take_along_axis(
        moved, np.argsort(-moved, axis=-1, kind="stable")[..., :2], -1),
        -1, 0)
    assert allclose(v.toarray(), want)


def test_topk_dtype_and_nan_parity(mesh):
    cases = [
        np.array([[5, 0, 3]], dtype=np.uint32),
        np.array([[np.iinfo(np.int32).min, 4, -2]], dtype=np.int32),
        np.array([[True, False, True]]),
        np.array([[1.0, np.nan, 3.0, 2.0]]),
    ]
    for x in cases:
        lo_v, lo_i = topk(bolt.array(x), 2)
        gp_v, gp_i = topk(bolt.array(x, CPU), 2)
        tp_v, tp_i = ref_topk(ref.array(x, mesh), 2)
        for v in (gp_v, tp_v):
            assert np.array_equal(np.asarray(lo_v.toarray()),
                                  np.asarray(v.toarray()), equal_nan=True)
        for i in (gp_i, tp_i):
            assert np.array_equal(np.asarray(lo_i.toarray()),
                                  np.asarray(i.toarray())), x.dtype
    with pytest.raises(TypeError):
        topk(bolt.array(cases[0], CPU), 2.7)


def test_segment_reduce_matmul_path(mesh):
    rs = np.random.RandomState(33)
    x = rs.randn(32, 6, 4)
    lab = rs.randint(0, 5, 32)
    b, lo = bolt.array(x, CPU), bolt.array(x)
    for op in ("sum", "mean"):
        gm = segment_reduce(b, lab, num_segments=5, op=op,
                            method="matmul").toarray()
        gs = segment_reduce(b, lab, num_segments=5, op=op,
                            method="scatter").toarray()
        e = segment_reduce(lo, lab, num_segments=5, op=op).toarray()
        assert np.allclose(gm, gs, rtol=1e-6, atol=1e-9)
        assert np.allclose(gm, e, rtol=1e-6, atol=1e-9)
        theirs = ref_segment(ref.array(x, mesh), lab, num_segments=5, op=op,
                             method="matmul").toarray()
        assert np.allclose(gm, theirs, rtol=1e-6, atol=1e-9)
    gm = segment_reduce(b, lab, num_segments=5, method="matmul",
                        precision="high")
    with bolt.precision("default"):
        gd = segment_reduce(b, lab, num_segments=5, method="matmul")
    assert np.allclose(gm.toarray(), gd.toarray(), rtol=1e-5, atol=1e-8)


def test_segment_reduce_matmul_nonfinite_fallback():
    rs = np.random.RandomState(34)
    x = rs.randn(16, 5)
    x[3, 2] = np.nan
    x[7, 1] = np.inf
    x[9, 1] = -np.inf
    lab = rs.randint(0, 4, 16)
    g = segment_reduce(bolt.array(x, CPU), lab, num_segments=4,
                       method="matmul").toarray()
    e = segment_reduce(bolt.array(x), lab, num_segments=4).toarray()
    assert np.array_equal(np.isnan(g), np.isnan(e))
    assert np.array_equal(np.isposinf(g), np.isposinf(e))
    assert np.array_equal(np.isneginf(g), np.isneginf(e))
    fin = np.isfinite(e)
    assert np.allclose(g[fin], e[fin])


def test_segment_reduce_method_validation():
    b = bolt.array(np.ones((8, 3), np.int32), CPU)
    with pytest.raises(ValueError, match="method"):
        segment_reduce(b, [0] * 8, num_segments=1, method="magic")
    with pytest.raises(ValueError, match="matmul"):
        segment_reduce(b, [0] * 8, num_segments=1, method="matmul")
    out = segment_reduce(b, [0] * 8, num_segments=1, op="mean",
                         method="matmul")
    assert np.allclose(out.toarray(), 1.0)
    with pytest.raises(ValueError, match="matmul"):
        segment_reduce(bolt.array(np.ones((4, 2)), CPU), [0] * 4,
                       num_segments=1, op="max", method="matmul")
    with pytest.raises(ValueError, match="matmul"):
        segment_reduce(bolt.array(np.ones((4, 2))), [0] * 4,
                       num_segments=1, op="max", method="matmul")
    z = bolt.array(np.zeros((0, 3)), CPU)
    out = segment_reduce(z, np.array([], dtype=np.int64), num_segments=4,
                         method="matmul")
    assert out.shape == (4, 3) and not out.toarray().any()


def _edges_close(got, want):
    """Edges equal up to two roundings of the range's magnitude: the same
    linspace formula, with or without XLA's fused multiply-add."""
    atol = 2 * np.finfo(want.dtype).eps * np.abs(want).max()
    assert got.dtype == want.dtype
    assert np.allclose(got, want, rtol=0, atol=atol)


def test_histogram_parity(mesh):
    x = np.random.RandomState(70).randn(16, 6, 4)
    gp, lo, tp = bolt.array(x, CPU), bolt.array(x), ref.array(x, mesh)
    for kwargs in [dict(), dict(bins=7), dict(bins=5, range=(-1.0, 1.0)),
                   dict(bins=4, density=True)]:
        cg, eg = histogram(gp, **kwargs)
        cl, el = histogram(lo, **kwargs)
        cn, en = np.histogram(x, **kwargs)
        assert np.allclose(cg, cn) and np.allclose(cl, cn), kwargs
        assert np.allclose(eg, en) and np.allclose(el, en), kwargs
        # the reference's (jnp.histogram's) edges to a rounding of the
        # range (ROADMAP C: XLA contracts linspace's product and sum into
        # an FMA) and its counts exactly
        ct, et = ref_histogram(tp, **kwargs)
        _edges_close(eg, et)
        assert np.array_equal(cg, ct), kwargs
    cg, eg = histogram(gp.map(lambda v: v * 2), bins=6)
    cn, en = np.histogram(x * 2, bins=6)
    assert np.allclose(cg, cn) and np.allclose(eg, en)
    with pytest.raises(ValueError):
        histogram(gp, bins=0)
    with pytest.raises(ValueError):
        histogram(gp, range=(1.0, -1.0))


@pytest.mark.parametrize("block", [None, 7 * 24 * 4])
def test_histogram_blocked_chain_f32(mesh, monkeypatch, block):
    # f32 data through a chain, in one block and in blocks of 7 records:
    # the reference's f32 edges (to a rounding) and its counts exactly, over
    # the data's own range and a range whose bounds round in f32
    if block is not None:
        from bolt_tpu_torch.gpu import array as garray
        monkeypatch.setattr(garray, "_BLOCK_BYTES", block)
    x = np.random.RandomState(72).randn(30, 6, 4).astype(np.float32)
    gp = bolt.array(x, CPU).map(lambda v: v * 3 - 1)
    tp = ref.array(x, mesh).map(lambda v: v * 3 - 1)
    for kwargs in [dict(bins=64), dict(bins=9, range=(-0.1, 0.7))]:
        cg, eg = histogram(gp, **kwargs)
        ct, et = ref_histogram(tp, **kwargs)
        assert eg.dtype == et.dtype == np.float32
        _edges_close(eg, et)
        assert np.array_equal(cg, ct), kwargs


def test_histogram_numpy_edge_semantics(mesh):
    x = np.random.RandomState(71).randn(8, 4)
    gp, lo = bolt.array(x, CPU), bolt.array(x)
    assert histogram(gp)[0].dtype == np.int64
    assert histogram(lo)[0].dtype == np.int64
    cg, eg = histogram(gp, bins=3, range=(1.0, 1.0))
    cn, en = np.histogram(x, bins=3, range=(1.0, 1.0))
    assert np.array_equal(cg, cn) and np.allclose(eg, en)
    # constant data: the data's own range widens by 0.5 each way
    c = bolt.array(np.full((4, 3), 2.0), CPU)
    cc, ec = histogram(c, bins=4)
    cn, en = np.histogram(np.full((4, 3), 2.0), bins=4)
    assert np.array_equal(cc, cn) and np.allclose(ec, en)
    with pytest.raises(ValueError):
        histogram(gp, range=(2.0, -1.0))
    with pytest.raises(ValueError, match="finite"):
        histogram(gp, range=(0.0, np.inf))
