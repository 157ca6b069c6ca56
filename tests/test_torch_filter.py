"""The port's ``filter`` against the reference's (BASELINE config 4).

The assertions of ``tests/test_tpu_functional.py`` (``test_filter``,
``test_filter_on_value_axis`` and the pending-filter tests),
``tests/test_tpu_edges.py::test_filter_after_swap``,
``tests/test_interactions.py`` (the filter chains) and
``tests/generic.py::filter_suite``, run on the port on the CPU, with the
reference on the same seeded inputs where a value is compared: data
movement exactly, arithmetic in f64 at ``rtol=1e-10`` (the fused
terminals sum in another order).  The fused terminals (``sum``/``mean``/
``var``/... and ``reduce`` on a pending filter) fold the predicate's mask
into the reduction, as the reference's do; a dropped record's NaN never
reaches them.
"""

import warnings
from operator import add

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch.ops import kernels as K
from tests.generic import filter_suite

CPU = torch.device("cpu")


def _x(shape=(8, 4, 5), seed=3):
    return np.random.RandomState(seed).randn(*shape)


def _same(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12)


# ---------------------------------------------------------------------------
# test_tpu_functional.py: filter, filter_suite, value axes, pending
# ---------------------------------------------------------------------------

def test_filter_suite():
    x = _x()
    filter_suite(x, bolt.array(x, CPU))


def test_filter_matches_reference(mesh):
    x = _x()
    pred = lambda v: v.mean() > 0         # noqa: E731
    want = ref.array(x, mesh).filter(pred)
    got = bolt.array(x, CPU).filter(pred)
    assert np.array_equal(got.toarray(), want.toarray())
    assert got.split == want.split == 1 and got.shape == want.shape


def test_filter_on_value_axis(mesh):
    x = _x()
    out = bolt.array(x, CPU).filter(lambda v: v[0, 0] > 0, axis=(1,))
    expected = np.asarray([x[:, i, :] for i in range(x.shape[1])
                           if x[0, i, 0] > 0])
    assert np.array_equal(out.toarray(), expected)
    assert out.split == 1
    want = ref.array(x, mesh).filter(lambda v: v[0, 0] > 0, axis=(1,))
    assert np.array_equal(out.toarray(), want.toarray())


def test_filter_is_pending_until_shape_read():
    x = _x()
    out = bolt.array(x, CPU).filter(lambda v: v.sum() > 0)
    assert out.pending
    expected = np.asarray([v for v in x if v.sum() > 0])
    assert out.shape == expected.shape
    assert not out.pending
    assert np.array_equal(out.toarray(), expected)


def test_filter_toarray_without_prior_resolution():
    x = _x()
    out = bolt.array(x, CPU).filter(lambda v: v[0, 0] > 0)
    assert out.pending
    expected = np.asarray([v for v in x if v[0, 0] > 0])
    assert np.array_equal(out.toarray(), expected)
    assert not out.pending
    assert np.array_equal(out.toarray(), expected)
    assert out.split == 1


def test_filter_repr_does_not_sync():
    out = bolt.array(_x(), CPU).filter(lambda v: v.sum() > 0)
    r = repr(out)
    assert "pending" in r and "(?, 4, 5)" in r
    assert out.pending


def test_filter_dtype_known_while_pending():
    x = _x()
    out = bolt.array(x, CPU).filter(lambda v: v.sum() > 0)
    assert out.dtype == x.dtype
    assert out.pending


def test_filter_fuses_deferred_chain(mesh):
    x = _x()
    out = bolt.array(x, CPU).map(lambda v: v * 2).map(lambda v: v - 1) \
        .filter(lambda v: v.sum() > -20)
    y = x * 2 - 1
    expected = np.asarray([v for v in y if v.sum() > -20])
    assert expected.shape[0] not in (0, x.shape[0])
    _same(out.toarray(), expected)
    want = ref.array(x, mesh).map(lambda v: v * 2).map(lambda v: v - 1) \
        .filter(lambda v: v.sum() > -20)
    _same(out.toarray(), want.toarray())


def test_filter_empty_and_full():
    x = _x()
    b = bolt.array(x, CPU)
    none = b.filter(lambda v: v.sum() > 1e9)
    assert none.shape == (0,) + x.shape[1:]
    assert none.toarray().shape == (0,) + x.shape[1:]
    everything = b.filter(lambda v: v.sum() > -1e9)
    assert np.array_equal(everything.toarray(), x)


def test_filter_chains_into_map():
    x = _x()
    out = bolt.array(x, CPU).filter(lambda v: v.sum() > 0).map(
        lambda v: v + 1)
    expected = np.asarray([v + 1 for v in x if v.sum() > 0])
    assert np.array_equal(out.toarray(), expected)


def test_filter_predicate_must_give_one_truth_value():
    with pytest.raises(ValueError, match="scalar truth value"):
        bolt.array(_x(), CPU).filter(lambda v: v.sum(axis=0) > 0)


def test_filter_host_fallback(mesh):
    x = _x()

    def pred(v):
        return bool(v.sum() > 0)        # data-dependent: vmap refuses it

    with pytest.warns(bolt.HostFallbackWarning):
        got = bolt.array(x, CPU).filter(pred)
    assert np.array_equal(got.toarray(),
                          ref.array(x, mesh).filter(pred).toarray())
    assert got.split == 1


# ---------------------------------------------------------------------------
# test_tpu_edges.py and test_interactions.py
# ---------------------------------------------------------------------------

def test_filter_after_swap():
    x = _x((8, 6, 4), seed=50)
    s = bolt.array(x, CPU, axis=(0, 1)).swap((1,), ())
    out = s.filter(lambda v: v.sum() > 0)
    expected = np.asarray([v for v in x if v.sum() > 0])
    assert np.array_equal(out.toarray(), expected)


def test_filter_map_reduce_chain(mesh):
    x = _x((8, 4, 6), seed=11)
    out = (bolt.array(x, CPU).filter(lambda v: v.mean() > 0)
           .map(lambda v: v * 2).reduce(np.add))
    keep = x[x.mean(axis=(1, 2)) > 0]
    np.testing.assert_allclose(out.toarray(), (keep * 2).sum(axis=0),
                               rtol=1e-12)
    want = (ref.array(x, mesh).filter(lambda v: v.mean() > 0)
            .map(lambda v: v * 2).reduce(np.add))
    _same(out.toarray(), want.toarray())


def test_filter_of_filter_chains_pending():
    x = np.random.RandomState(31).randn(16, 6, 4)
    ff = bolt.array(x, CPU).filter(lambda v: v.mean() > -10).filter(
        lambda v: v.sum() > 0)
    keep = x[x.reshape(16, -1).sum(axis=1) > 0]
    assert ff.shape == keep.shape
    assert np.array_equal(ff.toarray(), keep)


def test_pending_filter_into_map_sum_without_shape_read():
    x = np.random.RandomState(32).randn(16, 6, 4)
    f = bolt.array(x, CPU).filter(lambda v: v.mean() > 0)
    r = f.map(lambda v: v * 0 + 1).sum(axis=(0,))
    expect = np.ones((6, 4)) * (x.mean(axis=(1, 2)) > 0).sum()
    assert np.array_equal(r.toarray(), expect)


def test_stats_on_pending_filter():
    # test_interactions.py::test_new_stats_on_pending_filter: the port has
    # prod() of that surface (quantile/argmax/cumsum/clip wait for the numpy
    # surface, ROADMAP A8)
    x = np.random.RandomState(3).randn(16, 5)
    f = bolt.array(x, CPU).filter(lambda v: v.mean() > 0)
    keep = x[x.mean(axis=1) > 0]
    np.testing.assert_allclose(f.prod().toarray(), keep.prod(axis=0),
                               rtol=1e-12)
    assert f.pending


# ---------------------------------------------------------------------------
# the fused terminals against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sum", "mean", "var", "std", "max", "min",
                                  "prod", "any", "all", "ptp"])
@pytest.mark.parametrize("axis,keepdims", [(None, False), ((0,), True),
                                           ((0, 1), False), ((0, 1, 2), True),
                                           ((1,), False)])
def test_fused_filter_stats_match_reference(mesh, name, axis, keepdims):
    x = _x((12, 4, 5), seed=21)
    pred = lambda v: v.mean() > -1       # noqa: E731
    f = lambda v: v * 2 - 1              # noqa: E731
    t = getattr(ref.array(x, mesh).map(f).filter(pred), name)(
        axis=axis, keepdims=keepdims)
    g = getattr(bolt.array(x, CPU).map(f).filter(pred), name)(
        axis=axis, keepdims=keepdims)
    assert g.shape == t.shape and g.split == t.split
    _same(g.toarray(), t.toarray())


def test_fused_var_ddof_matches_reference(mesh):
    x = _x((12, 4, 5), seed=22)
    pred = lambda v: v.sum() > 0         # noqa: E731
    for ddof in (0, 1, 1.5):
        t = ref.array(x, mesh).filter(pred).var(ddof=ddof)
        g = bolt.array(x, CPU).filter(pred).var(ddof=ddof)
        _same(g.toarray(), t.toarray())


def test_fused_integer_stats_match_reference(mesh):
    x = np.arange(8 * 3 * 4, dtype=np.int32).reshape(8, 3, 4) % 7 - 3
    pred = lambda v: v.sum() > 0         # noqa: E731
    for name in ("sum", "mean", "max", "min", "prod", "any", "all"):
        t = getattr(ref.array(x, mesh).filter(pred), name)()
        g = getattr(bolt.array(x, CPU).filter(pred), name)()
        _same(g.toarray(), t.toarray())


def test_dropped_nan_record_does_not_reach_the_sum(mesh):
    x = _x((10, 4, 5), seed=23)
    x[3] = np.nan                        # mean NaN: the predicate drops it
    pred = lambda v: v.mean() > -5       # noqa: E731
    for name in ("sum", "mean", "var", "max"):
        t = getattr(ref.array(x, mesh).map(lambda v: v + 1).filter(pred),
                    name)()
        g = getattr(bolt.array(x, CPU).map(lambda v: v + 1).filter(pred),
                    name)()
        assert np.isfinite(g.toarray()).all()
        _same(g.toarray(), t.toarray())


def test_all_false_filter_terminals(mesh):
    x = _x()
    never = lambda v: v.sum() > 1e9      # noqa: E731
    b, r = bolt.array(x, CPU), ref.array(x, mesh)
    assert np.array_equal(b.filter(never).sum().toarray(), np.zeros((4, 5)))
    # the reference's arithmetic: 0 / 0
    mean = b.filter(never).mean().toarray()
    assert np.isnan(mean).all()
    assert np.isnan(r.filter(never).mean().toarray()).all()
    with pytest.raises(ValueError):
        b.filter(never).max()
    with pytest.raises(ValueError):
        r.filter(never).max()
    with pytest.raises(TypeError):
        b.filter(never).reduce(add)


@pytest.mark.parametrize("keepdims", [False, True])
def test_fused_filter_reduce_matches_reference(mesh, keepdims):
    x = _x((11, 4, 5), seed=24)
    x[4] = np.nan                        # dropped before the tree
    pred = lambda v: v.mean() > -0.2     # noqa: E731
    t = ref.array(x, mesh).filter(pred).reduce(add, keepdims=keepdims)
    g = bolt.array(x, CPU).filter(pred).reduce(add, keepdims=keepdims)
    assert g.shape == t.shape and g.split == t.split
    assert np.isfinite(g.toarray()).all()
    _same(g.toarray(), t.toarray())


def test_filter_reduce_with_a_host_reducer_resolves():
    x = _x()

    def rmax(a, b):
        return np.maximum(np.asarray(a), np.asarray(b))

    f = bolt.array(x, CPU).filter(lambda v: v.sum() > 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", bolt.HostFallbackWarning)
        out = f.reduce(rmax)
    keep = x[x.reshape(8, -1).sum(axis=1) > 0]
    assert np.array_equal(out.toarray(), keep.max(axis=0))


# ---------------------------------------------------------------------------
# the route: sum and mean fold the mask into fused_map_reduce
# ---------------------------------------------------------------------------

@pytest.fixture
def calls(monkeypatch):
    seen = []

    def cols(x, program, mask=None):
        seen.append(mask is not None)
        return real(x, program, mask)

    real = K.fused_map_reduce_cols
    monkeypatch.setattr(K, "fused_map_reduce_cols", cols)
    return seen


def test_filter_sum_and_mean_launch_the_masked_kernel(calls):
    x = _x()
    b = bolt.array(x, CPU).map(lambda v: v + 1)
    # the terminals are lazy: each result is read, which resolves it
    b.filter(lambda v: v.mean() > 1).sum().toarray()
    b.filter(lambda v: v.mean() > 1).mean().toarray()
    assert calls == [True, True]
    b.filter(lambda v: v.mean() > 1).var().toarray()
    b.filter(lambda v: v.mean() > 1).sum(axis=(0, 1)).toarray()
    bolt.array(x, CPU).map(lambda v: v - v.mean()).filter(
        lambda v: v.mean() > 1).sum().toarray()
    assert calls == [True, True]


def test_filter_sum_traces_a_new_chain_after_the_mask_pass(monkeypatch):
    # a chain the compiler has not seen is traced after the mask pass is
    # queued (its host time overlaps the card's work); a known one is
    # looked up first
    from bolt_tpu_torch.gpu import array as garray
    from bolt_tpu_torch.ops import mapexpr
    order = []
    real_mask, real_compile = garray._pred_mask, mapexpr.compile

    def mask(*a):
        order.append("mask")
        return real_mask(*a)

    def compile_(*a):
        order.append("trace" if not mapexpr.compiled(*a) else "cached")
        return real_compile(*a)

    monkeypatch.setattr(garray, "_pred_mask", mask)
    monkeypatch.setattr(mapexpr, "compile", compile_)
    b = bolt.array(_x(), CPU).map(lambda v: v + 1)
    b.filter(lambda v: v.mean() > 1).sum().toarray()
    assert order == ["mask", "trace"]
    del order[:]
    b.filter(lambda v: v.mean() > 1).sum().toarray()
    assert order == ["cached", "mask"]


@pytest.mark.parametrize("name", ["sum", "mean"])
def test_filter_stat_of_a_chain_that_does_not_compile(mesh, monkeypatch,
                                                      name):
    # first sight (traced after the mask pass, then a second pass of
    # partials) and cached (partials in the first pass) give the same
    # bits, the reference's values, at one block and at blocks of 3
    from bolt_tpu_torch.gpu import array as garray
    x = _x((11, 4, 5), seed=35)
    pred = lambda v: v.max() > 1                    # noqa: E731
    want = getattr(ref.array(x, mesh).map(lambda v: v - v.mean()).filter(
        pred), name)()
    for records in (None, 3):
        if records is not None:
            monkeypatch.setattr(garray, "_BLOCK_BYTES", records * 4 * 5 * 8)
        # a new callable each round: the compiler has not seen it
        b = bolt.array(x, CPU).map(lambda v: v - v.mean())
        first = getattr(b.filter(pred), name)().toarray()
        again = getattr(b.filter(pred), name)().toarray()
        assert np.array_equal(first, again)
        _same(first, want.toarray())


def test_streamed_source_filter_materialises():
    # a streamed filter stays a lazy stage (this test's name is from
    # before it was ported): its sum folds the mask slab by slab, with a
    # dropped NaN record an inert zero; its shape or data materialise
    x = _x((12, 3, 4), seed=25).astype(np.float32)
    x[5] = np.nan                             # dropped: sum() is NaN-free
    pred = lambda v: v.sum() > 0              # noqa: E731
    keep = x[np.nan_to_num(x.reshape(12, -1).sum(1), nan=-1.0) > 0]
    src = bolt.fromcallback(lambda idx: x[idx], x.shape, CPU,
                            dtype=np.float32, chunks=4)
    out = src.filter(pred)
    assert out.streaming and out.pending is False
    got = out.sum().toarray()
    assert out.streaming                      # the sum streamed
    np.testing.assert_allclose(got, keep.sum(0), rtol=1e-5, atol=1e-5)
    assert not np.isnan(got).any()
    assert np.array_equal(out.toarray(), keep)
    assert not out.streaming                  # materialised by toarray


# ---------------------------------------------------------------------------
# the blocked mask (the port's open fault C3): the chain and predicate run
# over blocks of records, so no pass holds the whole mapped chain; the
# survivors and results do not depend on the block size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("records", [1, 3, None])
def test_blocked_filter_same_survivors_and_results(mesh, monkeypatch,
                                                   records):
    from bolt_tpu_torch.gpu import array as garray
    x = _x((11, 4, 5), seed=31)
    x[4] = np.nan                                   # a dropped NaN record
    if records is not None:
        monkeypatch.setattr(garray, "_BLOCK_BYTES",
                            records * 4 * 5 * 8)
    f = lambda v: v * 2 + 1                         # noqa: E731
    pred = lambda v: v.mean() > 1                   # noqa: E731

    def port():
        return bolt.array(x, CPU, axis=(0,)).map(f).filter(pred)

    def refd():
        return ref.array(x, mesh).map(f).filter(pred)

    assert np.array_equal(port().toarray(), refd().toarray())
    for name in ("sum", "mean", "var", "std", "prod", "max", "min", "any",
                 "all"):
        got = getattr(port(), name)()
        want = getattr(refd(), name)()
        assert got.dtype == want.dtype, name
        _same(got.toarray(), want.toarray())
    _same(port().var(axis=(0, 2), ddof=1).toarray(),
          refd().var(axis=(0, 2), ddof=1).toarray())
    s = port().sum(keepdims=True)
    assert s.split == 1
    _same(s.toarray(), refd().sum(keepdims=True).toarray())


@pytest.mark.parametrize("records", [1, 3, None])
def test_blocked_mask_and_kernel_sum_bit_exact(monkeypatch, records):
    from bolt_tpu_torch.gpu import array as garray
    x = _x((10, 3, 4), seed=32).astype(np.float32)
    want = bolt.array(x, CPU).map(lambda v: v + 1).filter(
        lambda v: v.mean() > 1).sum().toarray()
    if records is not None:
        monkeypatch.setattr(garray, "_BLOCK_BYTES",
                            records * 3 * 4 * 4)
    b = bolt.array(x, CPU).map(lambda v: v + 1).filter(
        lambda v: v.mean() > 1)
    blocks = list(garray._filter_blocks(b._fpending, torch.float32))
    assert len(blocks) == (1 if records is None else -(-10 // records))
    assert np.array_equal(b.sum().toarray(), want)


@pytest.mark.parametrize("records", [1, 3, None])
def test_blocked_filter_reduce_matches_reference(mesh, monkeypatch,
                                                 records):
    # reduce's validity-bit tree takes its records and mask from the same
    # blocks as the other terminals: the reference's answer, bit for bit
    from operator import add
    from bolt_tpu_torch.gpu import array as garray
    x = _x((11, 4, 5), seed=34)
    x[6] = np.nan                                   # a dropped NaN record
    if records is not None:
        monkeypatch.setattr(garray, "_BLOCK_BYTES", records * 4 * 5 * 8)
    pred = lambda v: v.mean() > 0                   # noqa: E731
    for f in (None, lambda v: v * 2 + 1):
        g, t = bolt.array(x, CPU), ref.array(x, mesh)
        if f is not None:
            g, t = g.map(f), t.map(f)
        got = g.filter(pred).reduce(add)
        assert np.array_equal(got.toarray(),
                              t.filter(pred).reduce(add).toarray())


def test_blocked_filter_with_keys_and_two_key_axes(mesh, monkeypatch):
    from bolt_tpu_torch.gpu import array as garray
    monkeypatch.setattr(garray, "_BLOCK_BYTES", 3 * 5 * 8)
    x = _x((4, 3, 5), seed=33)
    f = lambda kv: kv[1] + kv[0][0] - kv[0][1]      # noqa: E731
    pred = lambda v: v.sum() > 0                    # noqa: E731
    g = bolt.array(x, CPU, axis=(0, 1)).map(f, axis=(0, 1), with_keys=True)
    t = ref.array(x, mesh, axis=(0, 1)).map(f, axis=(0, 1), with_keys=True)
    assert np.array_equal(g.filter(pred, axis=(0, 1)).toarray(),
                          t.filter(pred, axis=(0, 1)).toarray())
    _same(g.filter(pred, axis=(0, 1)).mean().toarray(),
          t.filter(pred, axis=(0, 1)).mean().toarray())


def test_empty_filter_source(mesh):
    x = np.zeros((0, 4))
    g = bolt.array(x, CPU).filter(lambda v: v.sum() > 0)
    assert g.shape == (0, 4)
    _same(bolt.array(x, CPU).filter(lambda v: v.sum() > 0).sum().toarray(),
          ref.array(x, mesh).filter(lambda v: v.sum() > 0).sum().toarray())
    with pytest.raises(ValueError):
        bolt.array(x, CPU).filter(lambda v: v.sum() > 0).max()
