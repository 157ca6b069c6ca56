"""The port's streamed stages (``filter``, ``chunk().map()``,
``stacked().map()``) and multi-stat stream groups against the
reference's (``bolt_tpu/stream.py``, ``bolt_tpu/tpu/multistat.py``).

The same seeded numpy sources stream through ``bolt_tpu`` (the 8-device
CPU mesh) and through the port with ``context=torch.device("cpu")``.
Tolerances, as ``test_stream.py`` and ``test_multistat.py`` hold the
reference:

* integer-valued f64 sources keep ``sum``, ``min``, ``max`` and the
  chunked and stacked maps exact under any fold order: bit for bit;
* a streamed mean over uneven slabs or a filter's survivors (Chan
  denominators that are not powers of two): ``rtol=atol=1e-12``;
* a fused group member against its standalone streamed terminal, and
  a group over a power-of-two slab count against the reference's: bit
  for bit; the port's materialised ``var``/``std`` (``torch.var``)
  against a streamed one: ``rtol=atol=1e-12``.
"""

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch import engine
from bolt_tpu_torch.ops import kernels as K

CPU = torch.device("cpu")
N, V0, V1 = 16, 6, 4
SHAPE = (N, V0, V1)

DOUBLE = lambda blk: blk * 2.0           # noqa: E731
POSSUM = lambda v: v.sum() > 0           # noqa: E731


def _intdata(shape=SHAPE):
    """Integer-valued float64: sums are exact under any fold order."""
    return ((np.arange(np.prod(shape)) % 13) - 6).astype(
        np.float64).reshape(shape)


def _keep(x):
    return x[x.reshape(len(x), -1).sum(axis=1) > 0]


def _mine(x, chunks, **kw):
    return bolt.fromcallback(lambda idx: x[idx], x.shape, CPU,
                             dtype=x.dtype, chunks=chunks, **kw)


def _theirs(x, mesh, chunks, **kw):
    return ref.fromcallback(lambda idx: x[idx], x.shape, mesh,
                            dtype=x.dtype, chunks=chunks, **kw)


def _a(b):
    return np.asarray(b.toarray())


def _bits(a, b):
    """Bit-compare two results (NaNs equal)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a, b, equal_nan=np.issubdtype(a.dtype, np.floating))


# ---------------------------------------------------------------------------
# the filter stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunks", [1, 4, 7])
def test_stream_filter_sum_parity(mesh, chunks):
    data = _intdata()
    f = _mine(data, chunks).filter(POSSUM)
    assert f.streaming and f.dtype == np.float64
    got = _a(f.sum())
    assert f.streaming                      # the sum streamed the mask
    assert np.array_equal(got, _keep(data).sum(axis=0))
    assert _bits(got, _a(_theirs(data, mesh, chunks).filter(POSSUM).sum()))
    # the materialised twin: the fused filter->sum terminal
    assert _bits(got, _a(bolt.array(data, CPU).filter(POSSUM).sum()))


def test_stream_filter_all_false_and_empty_mean(mesh):
    data = _intdata()
    never = lambda v: v.sum() > 1e9         # noqa: E731
    got = _a(_mine(data, 4).filter(never).sum())
    assert np.array_equal(got, np.zeros((V0, V1)))     # identity fold
    m = _a(_mine(data, 4).filter(never).mean())
    assert np.all(np.isnan(m))                          # 0/0, like the
    assert _bits(m, _a(_theirs(data, mesh, 4).filter(never).mean()))
    assert np.all(np.isnan(_a(bolt.array(data, CPU).filter(never).mean())))


def test_stream_filter_mean_parity(mesh):
    data = _intdata()
    got = _a(_mine(data, 4).filter(POSSUM).mean())
    keep = _keep(data)
    assert np.allclose(got, keep.mean(axis=0), rtol=1e-12, atol=1e-12)
    assert np.allclose(got, _a(_theirs(data, mesh, 4).filter(POSSUM)
                               .mean()), rtol=1e-12, atol=1e-12)
    for name in ("var", "std"):
        got = _a(getattr(_mine(data, 4).filter(POSSUM), name)(ddof=1))
        assert np.allclose(got, getattr(keep, name)(axis=0, ddof=1),
                           rtol=1e-12, atol=1e-12), name


def test_stream_filter_nan_record_is_inert():
    data = _intdata()
    data[3] = np.nan                        # dropped by the predicate
    pred = lambda v: v.sum() > 0            # noqa: E731  (NaN > 0: False)
    keep = _keep(np.nan_to_num(data, nan=-1.0))
    got_sum = _a(_mine(data, 4).filter(pred).sum())
    got_mean = _a(_mine(data, 4).filter(pred).mean())
    assert np.array_equal(got_sum, keep.sum(axis=0))
    assert np.allclose(got_mean, keep.mean(axis=0), rtol=1e-12, atol=1e-12)


def test_stream_filtered_shape_materialises(mesh):
    data = _intdata()
    f = _mine(data, 4).filter(POSSUM)
    assert f.streaming and f.dtype == np.float64
    assert "?" in repr(f) and f.streaming   # repr does not materialise
    want = _keep(data)
    assert f.shape == want.shape            # materialises + count sync
    assert not f.streaming
    assert np.array_equal(f.toarray(), want)
    assert np.array_equal(_theirs(data, mesh, 4).filter(POSSUM).toarray(),
                          want)


def test_stream_filter_refuses_min_max_and_reduce_streaming():
    # min/max under a filter and reduce() materialise (the zero-survivor
    # error contract): the answers still agree
    data = _intdata()
    keep = _keep(data)
    assert np.array_equal(_a(_mine(data, 4).filter(POSSUM).max()),
                          keep.max(axis=0))
    got = _a(_mine(data, 4).filter(POSSUM).reduce(np.minimum))
    assert np.array_equal(got, keep.min(axis=0))
    with pytest.raises(ValueError, match="zero-size"):
        _mine(data, 4).filter(lambda v: v.sum() > 1e9).min().toarray()


def test_armed_int8_kernel_gated_off_under_stages(monkeypatch):
    # the armed int8 sum with no stage reads fused_decode_sum once a slab
    # (its plain version on the CPU); a filter, or a group's fold, keeps
    # the decode route, as the reference's gate does
    x = (np.random.RandomState(9).rand(32, 256) * 10).astype(np.float32)
    calls = []
    real = K.fused_decode_sum

    def counted(q, scale, zp):
        calls.append(tuple(q.shape))
        return real(q, scale, zp)

    monkeypatch.setattr(K, "fused_decode_sum", counted)
    monkeypatch.setenv("BOLT_CODEC_KERNEL", "1")
    plain = _a(_mine(x, 8, codec="int8").sum())
    assert calls == [(8, 256)] * 4
    got = _a(_mine(x, 8, codec="int8").filter(lambda v: v.sum() > 0).sum())
    assert len(calls) == 4 and got.shape == plain.shape
    s = _mine(x, 8, codec="int8")
    su, _ = bolt.compute(s.sum(), s.mean())
    assert len(calls) == 4                  # the group's fold
    np.testing.assert_allclose(_a(su), plain, rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# the chunked and stacked stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,axis", [((3,), (0,)), ((4, 3), (0, 1)),
                                       ((5,), (0,))])
def test_stream_chunked_map_parity(mesh, size, axis):
    # (5,) over a 6-long axis is a RAGGED plan: the general body per slab
    data = _intdata()
    view = _mine(data, 4).chunk(size=size, axis=axis).map(DOUBLE)
    assert view.unchunk().streaming
    got = _a(view.sum())
    mat = bolt.array(data, CPU).chunk(size=size, axis=axis).map(DOUBLE)
    assert _bits(got, _a(mat.sum()))
    assert np.array_equal(got, (data * 2).sum(axis=0))
    assert _bits(got, _a(_theirs(data, mesh, 4).chunk(size=size, axis=axis)
                         .map(DOUBLE).sum()))


def test_stream_chunked_map_padding_parity(mesh):
    # halo padding: a shape-preserving func, halos trimmed per slab
    data = _intdata()
    smooth = lambda blk: blk * 0.5          # noqa: E731
    got = _a(_mine(data, 4).chunk(size=(3,), axis=(0,), padding=(1,))
             .map(smooth).mean())
    mat = bolt.array(data, CPU).chunk(size=(3,), axis=(0,),
                                      padding=(1,)).map(smooth)
    assert _bits(got, _a(mat.mean()))
    assert _bits(got, _a(_theirs(data, mesh, 4).chunk(
        size=(3,), axis=(0,), padding=(1,)).map(smooth).mean()))


def test_stream_chunked_shape_changing_map(mesh):
    # a uniform plan allows per-block shape changes; the streamed view's
    # plan matches the materialised one
    data = _intdata()
    colsum = lambda blk: blk.sum(axis=0, keepdims=True)   # noqa: E731
    tcolsum = lambda blk: blk.sum(0, keepdim=True)         # noqa: E731
    sv = _mine(data, 4).chunk(size=(3, V1), axis=(0, 1)).map(tcolsum)
    mv = bolt.array(data, CPU).chunk(size=(3, V1), axis=(0, 1)).map(tcolsum)
    rv = _theirs(data, mesh, 4).chunk(size=(3, V1), axis=(0, 1)).map(colsum)
    assert sv.plan == mv.plan == rv.plan
    assert sv.unchunk().shape == (N, 2, V1)
    assert _bits(_a(sv.sum()), _a(mv.sum()))
    assert _bits(_a(sv.sum()), _a(rv.sum()))


def test_stream_chunked_map_then_filter_and_toarray():
    data = _intdata()
    view = _mine(data, 4).chunk(size=(3,), axis=(0,)).map(DOUBLE)
    f = view.filter(POSSUM)
    assert f.streaming
    assert np.array_equal(_a(f.sum()), _keep(data * 2).sum(axis=0))
    again = _mine(data, 4).chunk(size=(3,), axis=(0,)).map(DOUBLE)
    assert np.array_equal(again.unchunk().toarray(), data * 2)


def test_stream_stacked_map_parity(mesh):
    data = _intdata()
    zblock = lambda blk: blk - blk.mean(0)          # noqa: E731
    rblock = lambda blk: blk - blk.mean(axis=0)     # noqa: E731
    # aligned: slab (8) is a multiple of the stack size (4) -> streams
    sv = _mine(data, 8).stacked(4).map(zblock)
    assert sv.unstack().streaming
    mat = bolt.array(data, CPU).stacked(4).map(zblock)
    got = _a(sv.unstack().sum())
    assert _bits(got, _a(mat.unstack().sum()))
    assert _bits(got, _a(_theirs(data, mesh, 8).stacked(4).map(rblock)
                         .unstack().sum()))
    # misaligned (slab 6, size 4): block grouping would differ, so the
    # stage is refused and the map materialises — results still agree
    sv2 = _mine(data, 6).stacked(4).map(zblock)
    assert not sv2.unstack().streaming
    assert _bits(_a(sv2.unstack().sum()), _a(mat.unstack().sum()))


def test_stream_stacked_iterator_source_materialises():
    data = _intdata()
    zblock = lambda blk: blk - blk.mean(0)          # noqa: E731
    it = bolt.fromiter([data[:8], data[8:]], SHAPE, CPU, dtype=np.float64)
    out = it.stacked(4).map(zblock).unstack()
    assert not out.streaming
    want = bolt.array(data, CPU).stacked(4).map(zblock).unstack()
    assert np.array_equal(out.toarray(), want.toarray())


def test_chunked_terminals_materialised(mesh):
    data = _intdata()
    cv = bolt.array(data, CPU).chunk(size=(3,), axis=(0,))
    b = bolt.array(data, CPU)
    assert _bits(_a(cv.sum()), _a(b.sum()))
    assert _bits(_a(cv.mean()), _a(b.mean()))
    assert _bits(_a(cv.std(ddof=1)), _a(b.std(ddof=1)))
    assert _bits(_a(cv.reduce(np.maximum)), _a(b.reduce(np.maximum)))
    f = cv.filter(POSSUM)
    assert f.shape == b.filter(POSSUM).shape
    rv = ref.array(data, mesh).chunk(size=(3,), axis=(0,))
    assert f.shape == rv.filter(POSSUM).shape
    assert np.allclose(_a(cv.std(ddof=1)), _a(rv.std(ddof=1)), rtol=1e-12,
                       atol=1e-12)


# ---------------------------------------------------------------------------
# multi-stat stream groups: one ingest pass, bit for bit
# ---------------------------------------------------------------------------

def test_streamed_multi_stat_single_ingest_pass(mesh):
    data = _intdata()
    s = _mine(data, 4)                      # 4 power-of-two slabs
    c0 = engine.counters()
    su, va, mn, mx = bolt.compute(s.sum(), s.var(), s.min(), s.max())
    c1 = engine.counters()
    d = {k: c1[k] - c0[k] for k in c1}
    assert d["stream_chunks"] == 4          # ONE pass over the source
    assert d["transfer_bytes"] == data.nbytes
    assert d["fused_stat_terminals"] == 4
    # against the materialised terminals: exact for sum/min/max, the
    # port's torch.var to 1e-12
    mat = bolt.array(data, CPU)
    assert _bits(_a(su), _a(mat.sum()))
    assert np.allclose(_a(va), _a(mat.var()), rtol=1e-12, atol=1e-12)
    assert _bits(_a(mn), _a(mat.min()))
    assert _bits(_a(mx), _a(mat.max()))
    # bit for bit against the reference's streamed group (power-of-two
    # slabs keep the Chan denominators exact)
    r = _theirs(data, mesh, 4)
    for got, want in zip((su, va, mn, mx), ref.compute(
            r.sum(), r.var(), r.min(), r.max())):
        assert _bits(_a(got), _a(want))


def test_streamed_group_members_equal_standalone_terminals():
    rs = np.random.RandomState(5)
    data = rs.randn(40, 6, 4)               # 5 uneven slabs of 8 records
    s = _mine(data, 8)
    names = ("sum", "mean", "var", "std", "min", "max", "ptp")
    group = bolt.compute(*[getattr(s, n)() for n in names])
    for name, got in zip(names, group):
        alone = getattr(_mine(data, 8), name)()
        assert _bits(_a(got), _a(alone)), name
    v1 = bolt.compute(s.var(ddof=1), s.sum())[0]
    assert _bits(_a(v1), _a(_mine(data, 8).var(ddof=1)))


def test_streamed_group_calls_the_producer_once_a_slab():
    data = _intdata()
    calls = []

    def fn(idx):
        calls.append(idx[0].start)
        return data[idx]

    s = bolt.fromcallback(fn, SHAPE, CPU, dtype=np.float64, chunks=4)
    members = [s.sum(), s.mean(), s.var(), s.min(), s.max()]
    assert calls == []                      # pending until read
    bolt.compute(*members)
    assert sorted(calls) == [0, 4, 8, 12]   # once a slab, not a member


@pytest.mark.parametrize("chunks", [3, 5, 1])
def test_streamed_multi_stat_uneven_tails(mesh, chunks):
    data = _intdata()
    s = _mine(data, chunks)
    su, me, mn = bolt.compute(s.sum(), s.mean(), s.min())
    assert np.array_equal(_a(su), data.sum(axis=0))
    assert np.allclose(_a(me), data.mean(axis=0), rtol=1e-12, atol=1e-12)
    assert np.array_equal(_a(mn), data.min(axis=0))
    r = _theirs(data, mesh, chunks)
    rme = ref.compute(r.sum(), r.mean(), r.min())[1]
    assert np.allclose(_a(me), _a(rme), rtol=1e-12, atol=1e-12)


def test_streamed_standalone_still_bit_exact_and_lazy(mesh):
    data = _intdata()
    s = _mine(data, 4).sum()
    assert s._spending is not None          # lazy, like the reference's
    assert _theirs(data, mesh, 4).sum()._spending is not None
    assert np.array_equal(_a(s), data.sum(axis=0))
    assert s._spending is None


def test_streamed_filtered_multi_stat(mesh):
    data = _intdata()
    s = _mine(data, 4).filter(POSSUM)
    su, me = bolt.compute(s.sum(), s.mean())
    keep = _keep(data)
    assert np.array_equal(_a(su), keep.sum(axis=0))
    assert np.allclose(_a(me), keep.mean(axis=0), rtol=1e-12, atol=1e-12)
    r = _theirs(data, mesh, 4).filter(POSSUM)
    rsu, rme = ref.compute(r.sum(), r.mean())
    assert _bits(_a(su), _a(rsu))
    assert np.allclose(_a(me), _a(rme), rtol=1e-12, atol=1e-12)


def test_streamed_ptp_is_one_pass(mesh):
    data = _intdata()
    c0 = engine.counters()
    got = _a(_mine(data, 4).ptp())
    c1 = engine.counters()
    assert c1["stream_chunks"] - c0["stream_chunks"] == 4
    assert np.array_equal(got, np.ptp(data, axis=0))
    assert _bits(got, _a(_theirs(data, mesh, 4).ptp()))


def test_materialised_source_does_not_rejoin_stream_group(mesh):
    data = _intdata()

    def gen():
        yield data[:8]
        yield data[8:]

    it = bolt.fromiter(gen(), SHAPE, CPU, dtype=np.float64)
    h = it.sum()                            # stream group forms
    assert np.array_equal(it.toarray(), data)   # burns the iterator
    h2 = it.mean()                          # computes from the CONCRETE data
    assert np.array_equal(_a(h2), data.mean(axis=0))
    # the earlier handle kept its one-shot source: the pointed re-stream
    # error surfaces at ITS read, not a silent wrong answer
    with pytest.raises(RuntimeError, match="already streamed"):
        h.toarray()


def test_one_shot_fromiter_serves_all_members_in_one_pass(mesh):
    data = _intdata()

    def gen():
        yield data[:8]
        yield data[8:]

    it = bolt.fromiter(gen(), SHAPE, CPU, dtype=np.float64)
    su, me, sd = bolt.compute(it.sum(), it.mean(), it.std())
    assert np.array_equal(_a(su), data.sum(axis=0))
    assert np.array_equal(_a(me), data.mean(axis=0))
    assert np.allclose(_a(sd), data.std(axis=0))


def test_fluent_stats_mixed_names_on_one_shot_stream(mesh):
    # a non-streamable name (prod) in the same fluent call must not
    # consume a one-shot iterator under the streamed siblings: the
    # source materialises once, first
    data = _intdata()

    def gen():
        yield data[:8]
        yield data[8:]

    for names in (("sum", "prod"), ("prod", "sum")):
        it = bolt.fromiter(gen(), SHAPE, CPU, dtype=np.float64)
        out = it.stats(*names)
        assert np.array_equal(_a(out["sum"]), data.sum(axis=0)), names
        assert np.allclose(_a(out["prod"]), data.prod(axis=0)), names
    # streamable names only: one streamed pass, the source stays a stream
    it = bolt.fromiter(gen(), SHAPE, CPU, dtype=np.float64)
    out = it.stats("sum", "max", "ptp")
    assert it.streaming
    assert np.array_equal(_a(out["ptp"]), np.ptp(data, axis=0))


def test_accumulate_rejects_streamed_groups_explicitly(mesh):
    data = _intdata()
    with pytest.raises(ValueError, match="in-memory"):
        bolt.compute(_mine(data, 4).sum(), accumulate="bf16")
    with pytest.raises(ValueError, match="in-memory"):
        ref.compute(_theirs(data, mesh, 4).sum(), accumulate="bf16")


def test_accumulate_int8_scope_and_stream_rejection(mesh):
    from bolt_tpu_torch import _precision
    xi = ((np.arange(16 * 6 * 4) % 101) - 50).astype(np.int32).reshape(
        16, 6, 4)
    with _precision.accumulate("int8"):
        got = bolt.compute(bolt.array(xi, CPU).map(lambda v: v).sum())
    assert _a(got).dtype == np.int32
    assert np.array_equal(_a(got), xi.sum(axis=0))
    with pytest.raises(ValueError, match="in-memory"):
        bolt.compute(_mine(_intdata(), 4).sum(), accumulate="int8")
    with _precision.accumulate("int8"):     # an ambient scope: exact
        assert np.array_equal(_a(_mine(_intdata(), 4).sum()),
                              _intdata().sum(axis=0))


def test_lossy_codec_refuses_group_with_extrema():
    x = np.random.RandomState(2).rand(16, 8).astype(np.float32)
    s = _mine(x, 4, codec="bf16")
    with pytest.raises(ValueError, match="order-statistic"):
        bolt.compute(s.mean(), s.max())
    s2 = _mine(x, 4, codec="bf16")
    got = _a(bolt.compute(s2.sum(), s2.mean())[1])
    assert np.allclose(got, x.mean(axis=0), rtol=1e-2)
