"""The port's fused stat groups (``bolt_tpu_torch.compute``, the fluent
``stats("sum", ...)``) and ``StatCounter`` against the reference's.

The assertions of ``tests/test_multistat.py``'s chain, filter, fluent,
``ptp``, accumulate and concurrency members, and of
``tests/test_statcounter.py``, on the port, on the CPU: every member of a
group equals its standalone terminal bit for bit, and the values equal
``bolt_tpu``'s on the same seeded inputs (``rtol=1e-10`` in f64).  The
reference counts compiled programs and dispatches; a group's one pass is
counted here by the applications of its chain and by
``engine.counters()``'s ``fused_stat_groups``/``fused_stat_terminals``.
A group donates once (``test_group_donates_once_and_guards_source``).
The stream and ``check``/strict members wait for the stream groups and
the analysis layer (ROADMAP A9, A11).
"""

import threading

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu.statcounter import StatCounter as RefStatCounter
from bolt_tpu_torch import engine
from bolt_tpu_torch.gpu import array as garray
from bolt_tpu_torch.statcounter import StatCounter

CPU = torch.device("cpu")
STATS = ("sum", "mean", "var", "std", "min", "max", "prod")


def _x(shape=(16, 6, 4), seed=0):
    return np.random.RandomState(seed).randn(*shape)


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a, b, equal_nan=np.issubdtype(a.dtype, np.floating))


def _delta(c0):
    c1 = engine.counters()
    return {k: c1[k] - c0[k] for k in ("fused_stat_groups",
                                       "fused_stat_terminals")}


@pytest.fixture
def applications(monkeypatch):
    """Count the applications of a non-empty map chain."""
    seen = []
    real = garray._chain_apply

    def counted(funcs, *a, **k):
        if funcs:
            seen.append(len(funcs))
        return real(funcs, *a, **k)

    monkeypatch.setattr(garray, "_chain_apply", counted)
    return seen


# ---------------------------------------------------------------------------
# laziness: validation at the call, resolution at the first read
# ---------------------------------------------------------------------------

def test_stat_terminal_is_lazy_then_transparent():
    x = _x()
    s = bolt.array(x, CPU).map(lambda v: v * 3).sum()
    assert s._spending is not None
    assert s.shape == (6, 4) and s.dtype == np.float64
    assert "lazy sum() terminal" in repr(s)
    assert np.allclose(s.toarray(), (x * 3).sum(axis=0))
    assert s._spending is None


def test_invalid_axis_still_raises_eagerly():
    with pytest.raises(ValueError):
        bolt.array(_x(), CPU).sum(axis=(9,))


def test_zero_size_extrema_raise_at_call(mesh):
    for b in (ref.array(np.zeros((0, 4)), mesh),
              bolt.array(np.zeros((0, 4)), CPU)):
        for name in ("min", "max", "ptp"):
            with pytest.raises(ValueError):
                getattr(b, name)()


# ---------------------------------------------------------------------------
# fused against standalone: bit for bit, and against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STATS)
def test_fused_bit_identical_to_standalone(mesh, name):
    x = np.abs(_x(seed=1)) * 0.25 + 0.5
    want = getattr(bolt.array(x, CPU).map(lambda v: torch.sqrt(v) + 1.0),
                   name)().toarray()
    m = bolt.array(x, CPU).map(lambda v: torch.sqrt(v) + 1.0)
    handles = {n: getattr(m, n)() for n in STATS}
    bolt.compute(*handles.values())
    assert _bits(handles[name].toarray(), want)
    import jax.numpy as jnp
    t = getattr(ref.array(x, mesh).map(lambda v: jnp.sqrt(v) + 1.0), name)()
    np.testing.assert_allclose(want, t.toarray(), rtol=1e-10)


def test_fused_group_applies_its_chain_once(applications):
    x = _x(shape=(12, 5, 3), seed=2)

    def add7(v):
        return v + 7.0

    m = bolt.array(x, CPU).map(add7)
    hs = [m.sum(), m.var(), m.min(), m.max()]
    c0 = engine.counters()
    bolt.compute(*hs)
    assert _delta(c0) == {"fused_stat_groups": 1, "fused_stat_terminals": 4}
    # sum reads the base through fused_map_reduce; var/min/max share ONE
    # application of the chain
    assert applications == [1]
    for h, name in zip(hs, ("sum", "var", "min", "max")):
        assert _bits(h.toarray(), getattr(
            bolt.array(x, CPU).map(add7), name)().toarray()), name
    del applications[:]
    for name in ("var", "min", "max"):           # standalone: one each
        getattr(bolt.array(x, CPU).map(add7), name)().toarray()
    assert applications == [1, 1, 1]


def test_group_sum_takes_the_kernel(monkeypatch):
    from bolt_tpu_torch.ops import kernels as K
    seen = []
    real = K.fused_map_reduce_cols
    monkeypatch.setattr(K, "fused_map_reduce_cols",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    x = _x(seed=20).astype(np.float32)
    c = np.exp(-(bolt.array(x, CPU) ** 2)) * 0.5
    s, v = bolt.compute(c.sum(), c.var())
    assert seen == [1]
    want = (np.exp(-(x.astype(np.float64) ** 2)) * 0.5).sum(axis=0)
    np.testing.assert_allclose(s.toarray(), want, rtol=1e-5)


def test_read_of_any_member_resolves_whole_group():
    x = _x(seed=3)
    m = bolt.array(x, CPU).map(lambda v: v - 2)
    s, v = m.sum(), m.var()
    c0 = engine.counters()
    assert np.allclose(s.toarray(), (x - 2).sum(axis=0))
    assert _delta(c0)["fused_stat_groups"] == 1
    assert v._spending.result is not None
    assert np.allclose(v.toarray(), (x - 2).var(axis=0))


def test_mixed_sources_fall_back_per_group():
    x, y = _x(seed=4), _x(seed=5)
    ma = bolt.array(x, CPU).map(lambda v: v + 1)
    mb = bolt.array(y, CPU).map(lambda v: v + 1)
    c0 = engine.counters()
    s1, s2, v1 = bolt.compute(ma.sum(), mb.sum(), ma.var())
    assert _delta(c0) == {"fused_stat_groups": 1, "fused_stat_terminals": 2}
    assert np.allclose(s1.toarray(), (x + 1).sum(axis=0))
    assert np.allclose(s2.toarray(), (y + 1).sum(axis=0))
    assert np.allclose(v1.toarray(), (x + 1).var(axis=0))


def test_compute_passes_through_concrete_and_local():
    x = _x()
    out = bolt.compute(bolt.array(x).sum(axis=0), 3.5)
    assert np.allclose(np.asarray(out[0]), x.sum(axis=0))
    assert out[1] == 3.5
    with pytest.raises(TypeError):
        bolt.compute()


def test_axes_keepdims_ddof_specs_fuse(mesh):
    x = _x(seed=6)

    def m():
        return bolt.array(x, CPU).map(lambda v: v * 2)

    g = m()
    a, b, c = bolt.compute(g.sum(axis=(0,), keepdims=True), g.var(ddof=1),
                           g.mean(axis=(0, 1)))
    assert _bits(a.toarray(), m().sum(axis=(0,), keepdims=True).toarray())
    assert _bits(b.toarray(), m().var(ddof=1).toarray())
    assert _bits(c.toarray(), m().mean(axis=(0, 1)).toarray())
    t = ref.array(x, mesh).map(lambda v: v * 2)
    for got, want in ((a, t.sum(axis=(0,), keepdims=True)),
                      (b, t.var(ddof=1)), (c, t.mean(axis=(0, 1)))):
        assert got.split == want.split
        np.testing.assert_allclose(got.toarray(), want.toarray(),
                                   rtol=1e-10)


# ---------------------------------------------------------------------------
# ptp rides the max/min pair
# ---------------------------------------------------------------------------

def test_ptp_routes_through_min_max_pair():
    x = _x(shape=(10, 7, 3), seed=7)
    b = bolt.array(x, CPU)
    assert np.allclose(b.ptp().toarray(), np.ptp(x, axis=0))
    b2 = bolt.array(x, CPU)
    p, mn, mx = bolt.compute(b2.ptp(), b2.min(), b2.max())
    assert _bits(p.toarray(), mx.toarray() - mn.toarray())
    assert _bits(p.toarray(), bolt.array(x, CPU).ptp().toarray())


def test_ptp_axis_variants_match_numpy():
    x = _x(seed=8)
    b = bolt.array(x, CPU)
    assert np.allclose(b.ptp(axis=(0, 1, 2)).toarray(), np.ptp(x))
    assert np.allclose(b.ptp(axis=(1,)).toarray(), np.ptp(x, axis=1))


# ---------------------------------------------------------------------------
# a pending filter's group: one mask pass folded into every member
# ---------------------------------------------------------------------------

def PRED(v):
    return v.sum() > 0


def _keep(x):
    return x[[v.sum() > 0 for v in x]]


@pytest.mark.parametrize("name", ["sum", "mean", "var", "std", "prod"])
def test_filtered_fused_bit_identical_to_standalone(mesh, name):
    x = _x(seed=9) * 0.5
    want = getattr(bolt.array(x, CPU).filter(PRED), name)().toarray()
    f = bolt.array(x, CPU).filter(PRED)
    hs = {n: getattr(f, n)() for n in ("sum", "mean", "var", "std",
                                       "prod")}
    c0 = engine.counters()
    bolt.compute(*hs.values())
    assert _delta(c0) == {"fused_stat_groups": 1, "fused_stat_terminals": 5}
    assert _bits(hs[name].toarray(), want)
    np.testing.assert_allclose(want, getattr(_keep(x), name)(axis=0),
                               atol=1e-10)
    t = getattr(ref.array(x, mesh).filter(lambda v: v.sum() > 0), name)()
    np.testing.assert_allclose(want, t.toarray(), rtol=1e-10, atol=1e-12)


def test_filtered_group_runs_the_predicate_once():
    x = _x(seed=9)
    calls = []

    def pred(v):
        calls.append(1)
        return v.sum() > 0

    f = bolt.array(x, CPU).map(lambda v: v * 2).filter(pred)
    calls.clear()                      # filter() traced it once
    bolt.compute(f.sum(), f.var(), f.any())
    assert len(calls) == 1             # one vmapped call, one block


def test_filtered_min_max_stay_eager_with_error_contract():
    x = _x(seed=10)
    b = bolt.array(x, CPU)
    with pytest.raises(ValueError, match="zero-size"):
        b.filter(lambda v: v.sum() > 1e9).max()
    got = b.filter(PRED).min()
    assert got._spending is None
    assert np.allclose(got.toarray(), _keep(x).min(axis=0))


def test_chunked_view_stats_fuse():
    x = _x(seed=11)
    cv = bolt.array(x, CPU).map(lambda v: v + 1).chunk(size=(3,), axis=(0,))
    s, v = bolt.compute(cv.sum(), cv.var())
    assert np.allclose(s.toarray(), (x + 1).sum(axis=0))
    assert np.allclose(v.toarray(), (x + 1).var(axis=0))


# ---------------------------------------------------------------------------
# the fluent form
# ---------------------------------------------------------------------------

def test_fluent_stats_matches_reference_and_local(mesh):
    x = _x(seed=12)
    g = bolt.array(x, CPU).stats("sum", "var", "min", "ptp")
    t = ref.array(x, mesh).stats("sum", "var", "min", "ptp")
    lo = bolt.array(x).stats("sum", "var", "min", "ptp")
    assert list(g) == list(t) == ["sum", "var", "min", "ptp"]
    for name in g:
        np.testing.assert_allclose(g[name].toarray(), t[name].toarray(),
                                   rtol=1e-10)
        assert np.allclose(g[name].toarray(), np.asarray(lo[name]),
                           atol=1e-10)


def test_fluent_stats_is_one_pass(applications):
    x = _x(seed=13)
    b = bolt.array(x, CPU).map(lambda v: v + 5)
    c0 = engine.counters()
    out = b.stats("sum", "mean", "max")
    assert _delta(c0) == {"fused_stat_groups": 1, "fused_stat_terminals": 3}
    assert applications == [1]
    assert np.allclose(out["max"].toarray(), (x + 5).max(axis=0))


def test_fluent_stats_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown statistic"):
        bolt.array(_x(), CPU).stats("sum", "median")


def test_stats_statcounter_contract_unchanged():
    x = _x(seed=14)
    b = bolt.array(x, CPU)
    assert np.allclose(b.stats().mean(), x.mean(axis=0))
    assert np.allclose(b.stats(("mean", "var")).variance(), x.var(axis=0))
    assert np.allclose(b.stats(axis=(1,)).mean(), x.mean(axis=1))
    assert np.allclose(b.stats(("mean",), (1,)).mean(), x.mean(axis=1))
    with pytest.raises(TypeError, match="axis twice"):
        b.stats(("mean",), (1,), axis=(0,))


def test_group_donates_once_and_guards_source(mesh):
    x = _x(seed=15)
    with engine.donation(0):
        d = bolt.array(x, context=CPU).map(lambda v: v + 1)
        n0 = engine.counters()["donations"]
        s = d.sum()                           # consumes the sole owner
        assert engine.counters()["donations"] == n0 + 1
        v = d.var()                           # joins the SAME group
        assert engine.counters()["donations"] == n0 + 1
        su, va = bolt.compute(s, v)
        np.testing.assert_allclose(su.toarray(), (x + 1).sum(axis=0),
                                   rtol=1e-10)
        np.testing.assert_allclose(va.toarray(), (x + 1).var(axis=0),
                                   rtol=1e-10)
        assert engine.counters()["donations"] == n0 + 1   # ONE donate
        with pytest.raises(RuntimeError, match="donated"):
            d.toarray()
        # after the group dispatched, further terminals hit the guard
        with pytest.raises(RuntimeError, match="donated"):
            d.mean()
        # the group dropped its base when it resolved
        assert s._spending is None and v._spending is None
    r = ref.array(x, mesh).map(lambda v: v + 1)
    rs, rv = ref.compute(r.sum(), r.var())
    np.testing.assert_allclose(su.toarray(), rs.toarray(), rtol=1e-10)
    np.testing.assert_allclose(va.toarray(), rv.toarray(), rtol=1e-10)


def test_donated_group_equals_undonated_bit_for_bit(monkeypatch):
    monkeypatch.setattr(garray, "_BLOCK_BYTES", 3 * 6 * 4 * 8)
    x = _x(seed=16)
    with engine.donation(None):
        m = bolt.array(x, context=CPU).map(lambda v: v * 1.5)
        want = [h.toarray() for h in bolt.compute(m.sum(), m.var(), m.min())]
    with engine.donation(0):
        m = bolt.array(x, context=CPU).map(lambda v: v * 1.5)
        got = [h.toarray() for h in bolt.compute(m.sum(), m.var(), m.min())]
    assert all(_bits(g, w) for g, w in zip(got, want))


def test_materialised_chain_source_starts_fresh_group():
    x = _x(seed=19)
    m = bolt.array(x, CPU).map(lambda v: v * 3)
    s = m.sum()
    m.cache()
    v = m.var()
    assert v._spending.group is not s._spending.group
    assert v._spending.group.funcs == ()
    assert np.allclose(v.toarray(), (x * 3).var(axis=0))
    assert np.allclose(s.toarray(), (x * 3).sum(axis=0))


def test_sorted_source_starts_fresh_group():
    x = _x(seed=22)
    b = bolt.array(x, CPU)
    s = b.sum()
    b.sort(axis=1)
    mx = b.max(axis=(0, 2))
    assert mx._spending.group is not s._spending.group
    assert np.allclose(mx.toarray(), np.sort(x, axis=1).max(axis=(0, 2)))


# ---------------------------------------------------------------------------
# reduced-precision accumulation (opt-in; exact by default)
# ---------------------------------------------------------------------------

def _acc():
    return (np.random.RandomState(16).rand(32, 8, 4).astype(np.float32)
            * 3 + 0.5)


def test_accumulate_default_is_bit_exact():
    x = _acc()
    s1 = bolt.compute(bolt.array(x, CPU).map(lambda v: v * 1.7).sum())
    m = bolt.array(x, CPU).map(lambda v: v * 1.7)
    s2, _ = bolt.compute(m.sum(), m.var())
    assert _bits(s1.toarray(), s2.toarray())


def test_accumulate_f32_exact_for_f32_pipeline():
    x = _acc()
    want = bolt.compute(bolt.array(x, CPU).sum()).toarray()
    got = bolt.compute(bolt.array(x, CPU).sum(), accumulate="f32")
    assert _bits(got.toarray(), want)


def test_accumulate_bf16_within_documented_envelope(mesh):
    x = _acc()
    exact = bolt.array(x, CPU).sum().toarray()
    b = bolt.array(x, CPU)
    s, v, mn = bolt.compute(b.sum(), b.var(), b.min(), accumulate="bf16")
    got = s.toarray()
    assert got.dtype == np.float32
    assert np.max(np.abs(got - exact) / np.maximum(np.abs(exact), 1e-6)) \
        < 1e-2
    assert _bits(mn.toarray(), x.min(axis=0))
    t = ref.array(x, mesh)
    ts = ref.compute(t.sum(), t.var(), accumulate="bf16")[0].toarray()
    np.testing.assert_allclose(got, ts, rtol=1e-5)


def test_accumulate_scope_and_validation():
    x = _acc()
    with bolt.accumulate("bf16"):
        s = bolt.compute(bolt.array(x, CPU).sum())
        assert s.toarray().dtype == np.float32
    with pytest.raises(ValueError, match="accumulate mode"):
        bolt.compute(bolt.array(x, CPU).sum(), accumulate="f16")
    xi = np.arange(48, dtype=np.int64).reshape(12, 4)
    si = bolt.compute(bolt.array(xi, CPU).sum(), accumulate="bf16")
    assert np.array_equal(si.toarray(), xi.sum(axis=0))


def test_accumulate_rejects_filter_groups_explicitly():
    f = bolt.array(_x(), CPU).filter(PRED)
    with pytest.raises(ValueError, match="in-memory"):
        bolt.compute(f.sum(), accumulate="bf16")


def _xi(shape=(16, 6, 4)):
    return ((np.arange(np.prod(shape)) % 101) - 50).astype(
        np.int32).reshape(shape)


def test_accumulate_int8_parity_locked_for_int_pipeline():
    xi = _xi()
    got = bolt.compute(bolt.array(xi, CPU).map(lambda v: v).sum(),
                       accumulate="int8")
    out = got.toarray()
    assert out.dtype == np.int32
    assert np.array_equal(out, np.sum(xi.astype(np.int8), axis=0,
                                      dtype=np.int32))


def test_accumulate_int8_fused_group_mixes_exact_order_stats():
    xi = _xi()
    m = bolt.array(xi, CPU).map(lambda v: v * 2)
    s, mn, mx = bolt.compute(m.sum(), m.min(), m.max(), accumulate="int8")
    vals = xi * 2
    assert np.array_equal(s.toarray(), np.sum(vals.astype(np.int8), axis=0,
                                              dtype=np.int32))
    assert np.array_equal(mn.toarray(), vals.min(axis=0))
    assert np.array_equal(mx.toarray(), vals.max(axis=0))


def test_accumulate_int8_leaves_float_pipelines_and_moments_exact():
    x = _x(seed=21)
    b = bolt.array(x, CPU).map(lambda v: v + 1)
    s, _ = bolt.compute(b.sum(), b.var(), accumulate="int8")
    assert _bits(s.toarray(), bolt.array(x, CPU).map(lambda v: v + 1)
                 .sum().toarray())
    xi = _xi()
    mean8 = bolt.compute(bolt.array(xi, CPU).map(lambda v: v).mean(),
                         accumulate="int8")
    assert _bits(mean8.toarray(), bolt.array(xi, CPU).mean().toarray())


# ---------------------------------------------------------------------------
# concurrency: a join racing a resolution, consistent counter snapshots
# ---------------------------------------------------------------------------

def test_try_join_racing_resolve_never_strands_a_member():
    x = _x((32, 4), seed=5)
    oracle_sum, oracle_var = (x * 2).sum(axis=0), (x * 2).var(axis=0)
    for _ in range(20):
        b = bolt.array(x, CPU).map(lambda v: v * 2)
        first = b.sum()
        got = {}

        def reader():
            got["sum"] = first.toarray()

        def joiner():
            got["var"] = b.var().toarray()

        ts = [threading.Thread(target=reader, daemon=True),
              threading.Thread(target=joiner, daemon=True)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert not any(t.is_alive() for t in ts)
        assert np.allclose(got["sum"], oracle_sum)
        assert np.allclose(got["var"], oracle_var)


def test_fused_counter_snapshots_are_lock_consistent():
    import sys
    x = _x((8, 3), seed=9)
    c0 = engine.counters()
    stopped = threading.Event()
    bad = []

    def snapshotter():
        while not stopped.is_set():
            d = _delta(c0)
            if d["fused_stat_terminals"] != 2 * d["fused_stat_groups"]:
                bad.append(d)

    def hammer():
        for _ in range(10):
            m = bolt.array(x, CPU).map(lambda v: v + 3)
            bolt.compute(m.sum(), m.max())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        snap = threading.Thread(target=snapshotter, daemon=True)
        workers = [threading.Thread(target=hammer, daemon=True)
                   for _ in range(6)]
        snap.start()
        for w in workers:
            w.start()
        for w in workers:
            w.join(120)
        stopped.set()
        snap.join(10)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers) and not snap.is_alive()
    assert not bad
    assert _delta(c0) == {"fused_stat_groups": 60,
                          "fused_stat_terminals": 120}


# ---------------------------------------------------------------------------
# test_statcounter.py
# ---------------------------------------------------------------------------

def _s():
    return np.random.RandomState(7).randn(20, 4)


@pytest.mark.parametrize("stats", ["all", ("mean",)])
def test_statcounter_merge_stream(stats):
    x = _s()
    c, r = StatCounter(values=list(x), stats=stats), RefStatCounter(
        values=list(x), stats=stats)
    assert c.count() == r.count() == 20
    np.testing.assert_allclose(c.mean(), r.mean(), rtol=1e-12)
    assert np.allclose(c.mean(), x.mean(axis=0))
    if stats == "all":
        for name in ("variance", "stdev", "max", "min", "sampleVariance",
                     "sampleStdev"):
            np.testing.assert_allclose(getattr(c, name)(),
                                       getattr(r, name)(), rtol=1e-12)
        assert np.allclose(c.sampleVariance(), x.var(axis=0, ddof=1))


def test_statcounter_merge_stats_parallel_and_empty():
    x = _s()
    parts = [x[:3], x[3:11], x[11:]]
    total = StatCounter(values=list(parts[0]))
    for p in parts[1:]:
        total = total.mergeStats(StatCounter(values=list(p)))
    assert total.count() == 20
    assert np.allclose(total.mean(), x.mean(axis=0))
    assert np.allclose(total.variance(), x.var(axis=0))
    a = StatCounter()
    a.mergeStats(StatCounter(values=list(x)))
    assert a.count() == 20 and np.allclose(a.mean(), x.mean(axis=0))
    b = StatCounter(values=list(x))
    b.mergeStats(StatCounter())
    assert b.count() == 20


def test_statcounter_repr():
    assert "count: 3" in repr(StatCounter(values=[1.0, 2.0, 3.0]))


def test_groups_free_their_source_without_the_cycle_collector():
    # a group holds its members weakly and drops its source once resolved:
    # a large base is freed with the last array that needs it, not at the
    # next cyclic garbage collection
    import gc
    import weakref

    def plus1(v):
        return v + 1

    # the first sum of a callable traces it (make_fx leaves cyclic
    # garbage of its own): compile it before the collector stops
    bolt.array(_x(seed=23), CPU).map(plus1).sum().toarray()
    gc.collect()
    gc.disable()
    try:
        for read in (True, False):
            b = bolt.array(_x(seed=23), CPU)
            base = weakref.ref(b._data)
            m = b.map(plus1)
            s, v = m.sum(), m.var()
            if read:
                s.toarray()
                assert s._spending is None and v._spending.group.base is None
            del b, m, s, v
            assert base() is None, read
    finally:
        gc.enable()


_BLOCK_SPECS = (
    ("sum", None, {}), ("mean", None, {}), ("var", None, {"ddof": 1}),
    ("std", None, {}), ("min", None, {}), ("max", None, {}),
    ("ptp", None, {}), ("prod", None, {}), ("any", None, {}),
    ("all", None, {}), ("mean", (0, 2), {"keepdims": True}),
    ("var", (1,), {}), ("max", (2,), {"keepdims": True}),
    ("sum", (), {}), ("mean", (1, 2), {}), ("min", (0, 1, 2), {}))


def _block_chain(b, k):
    if k == 0:
        return np.exp(-(b ** 2)) * 0.5 - 1       # compiles: sum takes B1
    return b.map(lambda v: v - v.mean())          # does not compile


def _block_terms(c, specs):
    return [getattr(c, n)(axis=ax, **kw) for n, ax, kw in specs]


@pytest.mark.parametrize("records", [1, 3])
def test_stat_chains_apply_by_blocks_equal_the_whole(monkeypatch,
                                                     applications, records):
    # a chain longer than one block is applied block by block and never
    # held whole: a slot over the key axes folds its blocks' partials, a
    # slot over value axes joins its blocks' results.  A group's members
    # equal their standalone terminals bit for bit, and every value
    # equals the whole chain's (min/max exactly)
    x = _x((12, 6, 4), seed=24)
    want = [[t.toarray() for t in _block_terms(
        _block_chain(bolt.array(x, CPU), k), _BLOCK_SPECS)]
        for k in (0, 1)]
    monkeypatch.setattr(garray, "_BLOCK_BYTES", records * 6 * 4 * 8)
    for k in (0, 1):
        c = _block_chain(bolt.array(x, CPU), k)
        del applications[:]
        group = bolt.compute(*_block_terms(c, _BLOCK_SPECS))
        # one application of the chain, block by block
        assert applications == [len(c._chain[1])] * -(-12 // records)
        for spec, got, w in zip(_BLOCK_SPECS, group, want[k]):
            alone = _block_terms(_block_chain(bolt.array(x, CPU), k),
                                 [spec])[0]
            assert _bits(got.toarray(), alone.toarray()), (k, spec)
            got = got.toarray()
            assert got.shape == w.shape and got.dtype == w.dtype, (k, spec)
            if spec[0] in ("min", "max", "ptp", "any", "all"):
                assert np.array_equal(got, w), (k, spec)
            else:
                np.testing.assert_allclose(got, w, rtol=1e-12, atol=1e-13,
                                           err_msg=str((k, spec)))


@pytest.mark.parametrize("records", [1, 5])
def test_blocked_stats_of_two_key_axes_match_reference(mesh, monkeypatch,
                                                       applications,
                                                       records):
    # two key axes flatten into the blocks' one record axis: a stat over
    # both folds, over the second alone reduces the mapped tensor the
    # blocks were written into; f64 moments within 1e-12, integer sums
    # and extrema exact
    x = np.random.RandomState(25).randn(4, 3, 5) * 100
    cases = [(x, ("mean", "var", "std")),
             (x.astype(np.int32), ("sum", "max", "min"))]
    monkeypatch.setattr(garray, "_BLOCK_BYTES", records * 5 * 8)
    for data, names in cases:
        for axis in (None, (0, 1), (1,), (0, 2), (2,)):
            for name in names:
                got = getattr(bolt.array(data, CPU, axis=(0, 1)).map(
                    lambda v: v * 3 - 1, axis=(0, 1)), name)(axis=axis)
                want = getattr(ref.array(data, mesh, axis=(0, 1)).map(
                    lambda v: v * 3 - 1, axis=(0, 1)), name)(axis=axis)
                assert got.dtype == want.dtype, (name, axis)
                if data.dtype == np.int32:
                    assert np.array_equal(got.toarray(), want.toarray())
                else:
                    np.testing.assert_allclose(
                        got.toarray(), want.toarray(), rtol=1e-12,
                        err_msg=str((name, axis)))
    # one group over the three kinds of slot: one pass of blocks, each
    # member its standalone terminal bit for bit
    specs = ((None, "var"), ((1,), "mean"), ((2,), "std"), ((0, 2), "max"))

    def chain():
        return bolt.array(x, CPU, axis=(0, 1)).map(lambda v: v * 3 - 1,
                                                   axis=(0, 1))

    c = chain()
    assert c.split == 2
    del applications[:]
    group = bolt.compute(*(getattr(c, n)(axis=a) for a, n in specs))
    assert applications == [1] * -(-12 // records)
    for (a, n), got in zip(specs, group):
        assert _bits(got.toarray(), getattr(chain(), n)(axis=a).toarray())
