"""The port's dispatch engine (``bolt_tpu_torch/engine.py``) against the
reference's (``bolt_tpu/engine.py``).

The assertions of ``tests/test_engine.py`` on the port, on the CPU, from
the same seeded numpy inputs: program-cache hits and misses, builds once
per key, the counters and their consistent snapshots, tenant scopes,
coalesced builds, donation and its guard, and the fused filter
terminals, whose values equal ``bolt_tpu``'s (``rtol=1e-10`` in f64;
``equal_nan`` where a NaN record survives).  Two reference tests have no
CPU counterpart here:

* ``test_cached_entries_stay_inspectable`` reads the XLA HLO of a cached
  entry; a torch program is an eager callable with no text to read;
* ``test_persistent_cache_roundtrip`` builds and reloads an XLA
  executable; the port's persistent artifacts are the ``nvcc``-built
  kernel libraries, so the round trip is the card test
  ``tests/test_torch_card.py::test_persistent_cache_roundtrip_on_card``,
  and the CPU test below checks the directory mapping.

Then the donation rules the reference does not have, because the port
writes a donated result into the base's own storage: the refusals (a
shared chain, a live parent, a view, the caller's tensor), the in-place
write bit for bit against the out-of-place path at blocks of 1, 3 and
every record, and the caller's tensor left unchanged.  The reference's
own ``test_clone_shared_chain_blocks_donation`` fails on this Python
(ROADMAP C); its port below passes.
"""

import threading
import time

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch import engine, profile
from bolt_tpu_torch.gpu import array as garray

CPU = torch.device("cpu")


def _x():
    x = np.random.RandomState(0).randn(16, 6, 4)
    x[3] = np.nan          # a poison record the filters drop
    return x


def PRED(v):
    return ~torch.isnan(v).any() & (v.sum() > 0)


def REF_PRED(v):
    import jax.numpy as jnp
    return ~jnp.isnan(v).any() & (v.sum() > 0)


def _keep(x):
    return x[[bool(not np.isnan(v).any() and v.sum() > 0) for v in x]]


def _arr(x):
    return bolt.array(x, context=CPU)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-10, atol=1e-10, equal_nan=True)


# ----------------------------------------------------------------------
# counters
# ----------------------------------------------------------------------

def test_counters_monotonic_and_hit_miss():
    b = _arr(_x())
    f = lambda v: v * 2
    c0 = engine.counters()
    b.map(f).sum().toarray()
    c1 = engine.counters()
    # a fresh pipeline must MISS (new key) and dispatch at least once
    assert c1["misses"] > c0["misses"]
    assert c1["dispatches"] > c0["dispatches"]
    assert c1["dispatch_seconds"] >= c0["dispatch_seconds"]
    b.map(f).sum().toarray()
    c2 = engine.counters()
    # the identical pipeline must HIT (same key, no new build)
    assert c2["hits"] > c1["hits"]
    assert c2["misses"] == c1["misses"]
    for k in c2:
        assert c2[k] >= c0[k], k


def test_aot_compiles_once_per_key(mesh):
    x = np.random.RandomState(1).randn(8, 5)
    b = _arr(x)
    f = lambda v: v + 3
    first = b.map(f).sum().toarray()
    c1 = engine.counters()
    for _ in range(3):
        out = b.map(f).sum().toarray()
    c2 = engine.counters()
    # three more identical dispatches: no new build (the trace and the
    # shape inference are paid once)
    assert c2["aot_compiles"] == c1["aot_compiles"]
    assert c2["dispatches"] >= c1["dispatches"] + 3
    assert np.array_equal(out, first)
    _close(out, ref.array(x, mesh).map(lambda v: v + 3).sum().toarray())


def test_counters_through_profile():
    _arr(np.ones((8, 3))).sum().toarray()
    c = profile.engine_counters()
    for key in ("hits", "misses", "aot_compiles", "lower_seconds",
                "compile_seconds", "dispatches", "dispatch_seconds",
                "donations", "persistent_hits"):
        assert key in c
    txt = profile.engine_report()
    assert "aot_compiles" in txt and "compile_seconds" in txt


# the port's own keys: the host synchronisations it counts (engine.host_sync)
PORT_ONLY_KEYS = {"host_syncs", "host_sync_seconds", "dispatch_sync_seconds"}


def test_counter_keys_are_the_references():
    from bolt_tpu import engine as ref_engine
    assert set(engine.counters()) == set(ref_engine.counters()) \
        | PORT_ONLY_KEYS
    assert not PORT_ONLY_KEYS & set(ref_engine.counters())
    for k, v in ref_engine._SCHEMA.items():
        assert type(engine._SCHEMA[k]) is type(v), k


def test_mapexpr_lookups_count_once():
    # a chain's expression program compiled inside an engine build is
    # that build's work: the lookup adds no second miss
    b = _arr(np.random.RandomState(4).randn(8, 3))
    f = lambda v: v * 7 - 1
    c0 = engine.counters()
    b.map(f).sum().toarray()
    c1 = engine.counters()
    assert c1["misses"] - c0["misses"] == 1
    assert c1["aot_compiles"] - c0["aot_compiles"] == 1
    # outside any build, the compiler's own cache counts into the engine
    from bolt_tpu_torch.ops import mapexpr
    g = lambda v: v - 5
    mapexpr.compile((g,), (3,), torch.float64)
    mapexpr.compile((g,), (3,), torch.float64)
    c2 = engine.counters()
    assert (c2["misses"] - c1["misses"], c2["hits"] - c1["hits"]) == (1, 1)


def test_map_shape_inference_runs_once_per_key():
    b = _arr(np.random.RandomState(5).randn(8, 3))
    calls = []

    def f(v):
        calls.append(v.shape)
        return v + 1

    b.map(f)
    n = len(calls)
    b.map(f)
    b.map(f).sum().toarray()
    # shape inference once; the sum then applies the chain to real data
    assert n == 1
    assert all(c == (8, 3) or c == (3,) for c in calls[n:])
    assert garray._EVAL_CACHE[("map", f, (3,), str(torch.float64))] == \
        ((3,), torch.float64)


# ----------------------------------------------------------------------
# persistent cache: the directory of the nvcc-built kernel libraries
# ----------------------------------------------------------------------

def test_persistent_cache_points_the_build_directory(tmp_path):
    from bolt_tpu_torch.ops import _build
    d = str(tmp_path / "kernel-cache")
    try:
        assert engine.persistent_cache(d) == d
        assert engine.persistent_cache_dir() == d
        assert _build.build_dir() == d
        # nothing is built there yet: warm_start loads nothing and says
        # so in the counters
        c0 = engine.counters()
        assert engine.warm_start(d) == d
        assert _build.load_built() == []
        c1 = engine.counters()
        assert c1["persistent_hits"] == c0["persistent_hits"]
        assert c1["persistent_warm_hits"] == c0["persistent_warm_hits"]
    finally:
        engine.persistent_cache(enable=False)
    assert engine.persistent_cache_dir() is None
    assert _build.build_dir() == _build.DEFAULT_BUILD_DIR


# ----------------------------------------------------------------------
# donation-aware terminals
# ----------------------------------------------------------------------

def test_sole_owned_chain_donates_and_guards(mesh):
    x = _x()
    with engine.donation(0):
        d = _arr(x).map(lambda v: v + 1)            # parent is a temp
        n0 = engine.counters()["donations"]
        out = d.sum()
        assert engine.counters()["donations"] == n0 + 1
        _close(out.toarray(), (x + 1).sum(axis=0))
        with pytest.raises(RuntimeError, match="donated"):
            d.toarray()
    want = ref.array(x, mesh).map(lambda v: v + 1).sum().toarray()
    _close(out.toarray(), want)


def test_referenced_parent_never_donates():
    x = _x()
    with engine.donation(0):
        src = _arr(x)                               # parent stays live
        d = src.map(lambda v: v * 2)
        n0 = engine.counters()["donations"]
        d.sum().toarray()
        d.cache()
        assert engine.counters()["donations"] == n0
        # both the parent and the deferred chain remain readable
        assert np.array_equal(src.toarray(), x, equal_nan=True)
        assert np.array_equal(d.toarray(), x * 2, equal_nan=True)


def test_clone_shared_chain_blocks_donation():
    # _clone shares the CHAIN TUPLE with the original; donation must see
    # the shared tuple and refuse, or the clone would read a base the
    # terminal had overwritten
    x = _x()
    with engine.donation(0):
        b = _arr(x).map(lambda v: v + 1)            # sole-owned base
        c = b._clone()
        n0 = engine.counters()["donations"]
        b.sum()
        b.cache()
        assert engine.counters()["donations"] == n0
        assert np.array_equal(c.toarray(), x + 1, equal_nan=True)
        # the clone gone, the chain is sole-owned again
        d = _arr(x).map(lambda v: v + 1)
        e = d._clone()
        del e
        d.cache()
        assert engine.counters()["donations"] == n0 + 1


def test_zero_survivor_raise_leaves_donated_guard():
    x = _x()
    with engine.donation(0):
        f = _arr(x).filter(lambda v: v.sum() > 1e9)
        with pytest.raises(TypeError, match="empty"):
            f.reduce(np.add)
        with pytest.raises(RuntimeError, match="donated"):
            f.toarray()


def test_donation_floor_defaults_keep_small_arrays_readable():
    # below the floor nothing donates, so interactive reuse keeps working
    assert engine.donation_min_bytes() >= 1
    d = _arr(_x()).map(lambda v: v + 1)
    d.sum()
    d.mean()                                           # still readable
    assert d.toarray().shape == (16, 6, 4)


def test_donating_reduce_and_chunked_map(mesh):
    x = np.abs(_x())
    x[3] = 1.0                                         # drop the NaNs here
    with engine.donation(0):
        d = _arr(x).map(lambda v: v + 1)
        out = d.reduce(np.maximum)
        _close(out.toarray(), (x + 1).max(axis=0))
        with pytest.raises(RuntimeError, match="donated"):
            d.cache()
        d2 = _arr(x).map(lambda v: v * 3)
        got = d2.chunk(size=(3,), axis=(0,)).map(lambda blk: blk * 2)
        _close(got.unchunk().toarray(), x * 6)
        with pytest.raises(RuntimeError, match="donated"):
            d2.toarray()
    want = ref.array(x, mesh).map(lambda v: v * 3).chunk(
        size=(3,), axis=(0,)).map(lambda blk: blk * 2).unchunk().toarray()
    _close(got.unchunk().toarray(), want)


# ----------------------------------------------------------------------
# donation on the card's terms: refusals and the in-place write
# ----------------------------------------------------------------------

def test_view_base_refuses_donation():
    x = np.random.RandomState(6).randn(8, 6, 4)
    with engine.donation(0):
        # a reshape's tensor views the parent's storage
        d = _arr(x).reshape(8, 24).map(lambda v: v + 1)
        assert d._chain[0]._base is not None
        n0 = engine.counters()["donations"]
        d.sum()
        d.cache()
        assert engine.counters()["donations"] == n0
        assert np.array_equal(d.toarray(), x.reshape(8, 24) + 1)


def test_held_base_tensor_refuses_donation():
    x = np.random.RandomState(7).randn(8, 6)
    with engine.donation(0):
        b = _arr(x)
        t = b.totorch()                             # the caller holds it
        v = t[2:5]                                  # and a view of it
        d = b.map(lambda r: r * 2)
        del b
        n0 = engine.counters()["donations"]
        d.cache()
        assert engine.counters()["donations"] == n0
        assert np.array_equal(t.numpy(), x) and np.array_equal(
            v.numpy(), x[2:5])
        del t
        # only the view is left: its storage is the base's
        e = _arr(x)
        w = e.totorch()[1:3]
        f = e.map(lambda r: r * 2)
        del e
        f.cache()
        assert engine.counters()["donations"] == n0
        assert np.array_equal(w.numpy(), x[1:3])


def test_user_tensor_is_never_overwritten():
    t = torch.from_numpy(np.random.RandomState(8).randn(12, 5))
    keep = t.clone()
    with engine.donation(0):
        d = bolt.array(t, context=CPU).map(lambda v: v + 1)
        n0 = engine.counters()["donations"]
        d.cache()                   # bolt.array copied t: the copy donates
        assert engine.counters()["donations"] == n0 + 1
        assert torch.equal(t, keep)
        assert np.array_equal(d.toarray(), keep.numpy() + 1)


@pytest.mark.parametrize("records", [1, 3, None])
def test_inplace_write_equals_out_of_place(monkeypatch, records):
    # blocks of 1, 3 and every record (None: the default block holds all)
    x = np.random.RandomState(9).randn(10, 4, 3).astype(np.float32)
    if records is not None:
        monkeypatch.setattr(garray, "_BLOCK_BYTES", records * 4 * 3 * 4)
    chains = [(lambda v: v * 1.5 + 1,),
              (lambda v: torch.sin(v), lambda v: v - v.mean()),
              (garray._WithKeysFunc(lambda kv: kv[1] + kv[0][0]),)]
    for funcs in chains:
        def fresh():
            b = _arr(x)
            for f in funcs:
                if isinstance(f, garray._WithKeysFunc):
                    b = b.map(f.func, with_keys=True)
                else:
                    b = b.map(f)
            return b
        with engine.donation(None):
            want = fresh().toarray()
        with engine.donation(0):
            d = fresh()
            ptr = d._chain[0].data_ptr()    # no local of the base: it
            #                                 would be a second owner
            n0 = engine.counters()["donations"]
            got = d.cache().toarray()
            assert engine.counters()["donations"] == n0 + 1
            # the result lives in the base's own storage
            assert d.totorch().data_ptr() == ptr
        assert np.array_equal(got, want)


def test_inplace_stacked_and_chunk_maps_equal_out_of_place(monkeypatch):
    monkeypatch.setattr(garray, "_BLOCK_BYTES", 3 * 6 * 8)
    x = np.random.RandomState(10).randn(11, 6)
    f = lambda blk: blk - blk.mean(0, keepdim=True)
    g = lambda c: c * 2 + 1
    for run in (lambda b: b.stacked(2).map(f).unstack(),
                lambda b: b.chunk(size=(3,), axis=(0,)).map(g).unchunk()):
        with engine.donation(None):
            want = run(_arr(x).map(lambda v: v + 1)).toarray()
        with engine.donation(0):
            d = _arr(x).map(lambda v: v + 1)
            ptr = d._chain[0].data_ptr()
            out = run(d)
            assert out.totorch().data_ptr() == ptr
            with pytest.raises(RuntimeError, match="donated"):
                d.toarray()
        assert np.array_equal(out.toarray(), want)


def test_width_changing_terminal_drops_the_base():
    x = np.random.RandomState(11).randn(9, 4)
    with engine.donation(0):
        d = _arr(x).map(lambda v: v + 1)
        ref_base = __import__("weakref").ref(d._chain[0])
        out = d.stacked(4).map(lambda blk: blk[:, :2]).unstack()
        assert ref_base() is None          # freed when the terminal returned
        assert np.array_equal(out.toarray(), (x + 1)[:, :2])


# ----------------------------------------------------------------------
# fused single-pass filter -> reduce
# ----------------------------------------------------------------------

def test_filter_stat_fuses_without_compaction(mesh):
    x = _x()
    b = _arr(x)
    keep = _keep(x)
    fused = lambda fam: sum(1 for k in engine._CACHE if k[0] == fam)
    n_compact = fused("filter-fused")
    out = b.filter(PRED).sum()
    got = out.toarray()                   # first read dispatches (lazy)
    # ONE pass: the mask folded into the reduce — no compaction program
    assert fused("filter-fused") == n_compact
    assert fused("filter-stat") >= 1
    _close(got, keep.sum(axis=0))
    _close(got, ref.array(x, mesh).filter(REF_PRED).sum().toarray())


@pytest.mark.parametrize("name", ["sum", "prod", "any", "all", "mean",
                                  "var", "std", "max", "min"])
def test_fused_filter_stat_parity(mesh, name):
    x = _x()
    b = _arr(x)
    keep = _keep(x)
    got = getattr(b.filter(PRED), name)()
    # the eager oracle: resolve the compaction first, then reduce
    eager = b.filter(PRED)
    eager._resolve_filter()
    want = getattr(eager, name)()
    _close(got.toarray(), want.toarray())
    ref_keep = getattr(keep, name)(axis=0)
    _close(got.toarray(), ref_keep)
    _close(got.toarray(), getattr(ref.array(x, mesh).filter(REF_PRED),
                                  name)().toarray())


def test_fused_filter_reduce_parity_and_nan_records(mesh):
    x = _x()                       # row 3 is NaN and must stay inert
    b = _arr(x)
    keep = _keep(x)
    got = b.filter(PRED).reduce(np.maximum)
    _close(got.toarray(), np.maximum.reduce(keep))
    got2 = b.filter(PRED).reduce(lambda p, q: p + q)
    _close(got2.toarray(), keep.sum(axis=0))
    _close(got2.toarray(), ref.array(x, mesh).filter(REF_PRED).reduce(
        lambda p, q: p + q).toarray())


def test_fused_filter_all_false_mask():
    x = _x()
    b = _arr(x)
    nothing = lambda v: v.sum() > 1e9
    assert np.array_equal(b.filter(nothing).sum().toarray(), np.zeros((6, 4)))
    assert np.isnan(b.filter(nothing).mean().toarray()).all()
    with pytest.raises(ValueError, match="zero-size"):
        b.filter(nothing).max()
    with pytest.raises(TypeError, match="empty"):
        b.filter(nothing).reduce(np.add)


def test_fused_filter_keepdims_and_ddof(mesh):
    x = _x()
    b = _arr(x)
    keep = _keep(x)
    out = b.filter(PRED).sum(keepdims=True)
    assert out.toarray().shape == (1, 6, 4)
    v = b.filter(PRED).var(ddof=1)
    _close(v.toarray(), keep.var(axis=0, ddof=1))
    _close(v.toarray(), ref.array(x, mesh).filter(REF_PRED).var(
        ddof=1).toarray())


def test_deferred_filter_still_resolves_for_other_consumers():
    x = _x()
    b = _arr(x)
    keep = _keep(x)
    f = b.filter(PRED)
    assert f.pending
    assert f.dtype == x.dtype      # known without dispatching
    assert f.shape == keep.shape   # resolves
    assert not f.pending
    assert np.array_equal(f.toarray(), keep)
    f2 = b.filter(PRED)
    assert np.array_equal(f2.toarray(), keep)
    f3 = b.filter(PRED).map(lambda v: v * 2)
    assert np.array_equal(f3.toarray(), keep * 2)


# ----------------------------------------------------------------------
# counters: consistent snapshots + the analysis feed
# ----------------------------------------------------------------------

def test_counters_snapshot_is_consistent_under_concurrent_increments():
    n_threads, per_thread = 4, 500
    start = engine.counters()["diagnostics"]
    seen = []
    stop = threading.Event()

    def snapshotter():
        while not stop.is_set():
            seen.append(engine.counters()["diagnostics"])

    def hammer():
        for _ in range(per_thread):
            engine.record_diagnostics(1)

    snap = threading.Thread(target=snapshotter)
    snap.start()
    workers = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    stop.set()
    snap.join()
    assert engine.counters()["diagnostics"] == start + n_threads * per_thread
    assert seen == sorted(seen)
    c = engine.counters()
    c["diagnostics"] += 10 ** 6
    assert engine.counters()["diagnostics"] != c["diagnostics"]


def test_engine_counters_include_analysis_tallies():
    c = engine.counters()
    for key in ("diagnostics", "strict_checks", "strict_rejections"):
        assert key in c
    txt = profile.engine_report()
    assert "diagnostics" in txt and "strict_rejections" in txt


def test_strict_guard_runs_at_the_terminals():
    seen = []
    engine.set_strict_guard(lambda arr, op: seen.append(op))
    try:
        b = _arr(np.random.RandomState(12).randn(8, 3))
        b.map(lambda v: v + 1).sum()
        b.map(lambda v: v + 1).reduce(np.add)
        b.map(lambda v: v + 1).cache()
        b.filter(lambda v: v.sum() > 0).toarray()
        b.stacked(3).map(lambda blk: blk * 2)
        b.chunk(size=(2,), axis=(0,)).map(lambda c: c + 1)
    finally:
        engine.set_strict_guard(None)
    assert seen == ["sum()", "reduce()", "map-chain materialisation",
                    "filter() compaction", "stacked().map()", "chunk().map()"]


def test_fused_filter_donates_sole_owned_base():
    x = _x()
    keep = _keep(x)
    with engine.donation(0):
        d = _arr(x).filter(PRED)
        n0 = engine.counters()["donations"]
        out = d.sum()
        assert engine.counters()["donations"] == n0 + 1
        _close(out.toarray(), keep.sum(axis=0))
        with pytest.raises(RuntimeError, match="donated"):
            d.toarray()


# ---------------------------------------------------------------------
# concurrent identical builds coalesce
# ---------------------------------------------------------------------

def test_concurrent_same_key_builds_coalesce():
    calls = []

    def builder():
        calls.append(1)
        time.sleep(0.3)           # widen the race window: every other
        #                           thread must arrive mid-build
        return lambda t: t + 1

    key = ("test-coalesce-build", object())
    c0 = engine.counters()
    outs = []

    def go():
        outs.append(engine.get(key, builder))

    threads = [threading.Thread(target=go, daemon=True) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    c1 = engine.counters()
    assert len(calls) == 1                    # the builder ran ONCE
    assert all(o is outs[0] for o in outs)    # everyone shares the entry
    assert c1["misses"] - c0["misses"] == 1
    assert (c1["hits"] - c0["hits"]
            + c1["coalesced_builds"] - c0["coalesced_builds"]) == 5


def test_concurrent_same_signature_compiles_once():
    # the reference compiles per argument signature; a torch program is
    # built once per key, and racing calls of the entry build nothing
    key = ("test-coalesce-compile", object())
    entry = engine.get(key, lambda: lambda t: t * 3)
    x = torch.arange(8.0)
    c0 = engine.counters()
    outs = []

    def go():
        outs.append(entry(x).numpy())

    threads = [threading.Thread(target=go, daemon=True) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    c1 = engine.counters()
    assert c1["aot_compiles"] - c0["aot_compiles"] == 0
    assert c1["dispatches"] - c0["dispatches"] == 8
    assert all(np.array_equal(o, np.arange(8.0) * 3) for o in outs)


def test_failed_build_wakes_waiters_who_rebuild():
    state = {"n": 0}

    def flaky_builder():
        state["n"] += 1
        if state["n"] == 1:
            time.sleep(0.2)
            raise RuntimeError("first build fails")
        return lambda t: t - 1

    key = ("test-coalesce-fail", object())
    results = []

    def go():
        try:
            results.append(engine.get(key, flaky_builder))
        except RuntimeError as exc:
            results.append(exc)

    threads = [threading.Thread(target=go, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    errs = [r for r in results if isinstance(r, RuntimeError)]
    live = [r for r in results if not isinstance(r, RuntimeError)]
    assert len(errs) == 1 and len(live) == 2
    assert live[0] is live[1]


# ---------------------------------------------------------------------
# per-tenant counter scoping, the schedule digest, NaN checks
# ---------------------------------------------------------------------

def test_tenant_scope_mirrors_engine_counters():
    t0 = engine.tenant_counters("unit-tenant")
    g0 = engine.counters()
    with engine.tenant("unit-tenant"):
        _arr(np.ones((8, 4))).map(lambda v: v + 1).sum().toarray()
    t1 = engine.tenant_counters("unit-tenant")
    g1 = engine.counters()
    assert t1["dispatches"] > t0["dispatches"]
    assert t1["dispatches"] - t0["dispatches"] \
        <= g1["dispatches"] - g0["dispatches"]
    t2 = engine.tenant_counters("unit-tenant")
    _arr(np.ones((8, 4))).sum().toarray()
    assert engine.tenant_counters("unit-tenant") == t2


def test_schedule_digest_folds_every_dispatch():
    n0, d0 = engine.schedule_digest()
    f = lambda v: v * 4
    _arr(np.ones((8, 4))).map(f).sum().toarray()
    n1, d1 = engine.schedule_digest()
    assert n1 == n0 + 1 and d1 != d0
    tail = engine.schedule_recent()[-1]
    assert tail.startswith("('stat', 'sum'") and " at 0x" not in tail


def test_debug_nans_raises_on_a_nan_output():
    b = _arr(np.array([[1.0, -1.0], [2.0, 3.0]]))
    profile.debug_nans(True)
    try:
        with pytest.raises(FloatingPointError, match="nan"):
            b.map(lambda v: torch.sqrt(v)).sum().toarray()
        assert b.map(lambda v: v + 1).sum().toarray().tolist() == [5.0, 4.0]
    finally:
        profile.debug_nans(False)
    assert np.isnan(b.map(lambda v: torch.sqrt(v)).sum().toarray()).any()
