"""The port's ``bolt_tpu_torch.obs``: structured tracing, metrics
registry, timeline export — ``tests/test_obs.py`` on the port, on the CPU
(``context=torch.device("cpu")``), at its four contracts:

* the TRACER — nested spans, explicit cross-thread parent handoff
  (the streaming prefetch thread's ingest spans parent under the main
  thread's run span), instant events, and near-zero disabled cost (the
  ring stays empty, ``begin`` returns ``None``, no open-span leaks);
* the METRICS registry — typed counters/gauges/log2-bucket histograms,
  lock-consistent counter groups, and the migration invariant:
  ``profile.engine_counters()`` returns the SAME keys/types as before,
  now backed by the registry's ``"engine"`` group;
* the EXPORTERS — Chrome trace-event JSON that reloads with balanced,
  properly nested B/E pairs, the ``obs.report()`` text tree, and the
  ``obs.timeline(path)`` arm-run-write scope;
* the PROFILE satellites — ``timeit`` on pytree outputs + ``iters``
  validation, ``memory_stats`` degraded shape, ``overlap_efficiency``/
  ``engine_report`` empty-counter edges.

Values of the pipelines traced here equal ``bolt_tpu``'s on the same
numpy inputs (``rtol=1e-10`` in f64).  The reference's lint test BLT106
is in ``tests/test_torch_lint.py``.
"""

import importlib.util
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch import engine, obs, profile
from bolt_tpu_torch.obs import metrics as obs_metrics

CPU = torch.device("cpu")

pytestmark = pytest.mark.obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _tracer_reset():
    """Every test leaves the process tracer exactly as tier-1 expects:
    disarmed, empty ring, zero active spans."""
    obs.disable()
    obs.clear()
    yield
    obs.disable()
    obs.clear()


# ----------------------------------------------------------------------
# tracer: span API
# ----------------------------------------------------------------------

def test_span_nesting_and_attrs():
    obs.enable()
    with obs.span("outer", kind="test") as sp:
        sp.set(extra=1)
        with obs.span("inner"):
            pass
    got = obs.spans()
    assert [s.name for s in got] == ["inner", "outer"]  # completion order
    inner, outer = got
    assert inner.pid == outer.sid and outer.pid == 0
    assert outer.attrs == {"kind": "test", "extra": 1}
    assert inner.duration is not None and outer.duration >= inner.duration
    assert obs.active_count() == 0


def test_span_decorator_and_event():
    obs.enable()

    @obs.span("decorated", tag="d")
    def work(n):
        obs.event("mark", n=n)
        return n * 2

    assert work(21) == 42
    names = [s.name for s in obs.spans()]
    assert names == ["mark", "decorated"]
    mark = obs.spans()[0]
    assert mark.kind == "I" and mark.attrs == {"n": 21}
    assert mark.pid == obs.spans()[1].sid       # event nests in the span


def test_span_error_attr_and_no_leak():
    obs.enable()
    with pytest.raises(ValueError):
        with obs.span("boom"):
            raise ValueError("x")
    (sp,) = obs.spans()
    assert sp.attrs["error"] == "ValueError"
    assert obs.active_count() == 0


def test_begin_end_cancel_and_ring_bound():
    obs.enable(ring=4)
    sp = obs.begin("probe")
    obs.cancel(sp)                              # abandoned: never lands
    assert obs.spans() == [] and obs.active_count() == 0
    for i in range(10):
        obs.end(obs.begin("s%d" % i))
    got = obs.spans()
    assert len(got) == 4                        # bounded ring, oldest gone
    assert [s.name for s in got] == ["s6", "s7", "s8", "s9"]


def test_disabled_tracer_is_inert_no_ring_growth(mesh):
    """The acceptance edge: tracing DISABLED, the instrumented hot paths
    (engine get/dispatch, terminals, a streamed reduction) must leave
    the ring empty and no span open — counter-only cost."""
    assert not obs.enabled()
    assert obs.begin("anything") is None        # no allocation path
    obs.end(None)                               # and end tolerates it
    x = np.arange(8 * 6, dtype=np.float64).reshape(8, 6)
    got = bolt.array(x, context=CPU).map(lambda v: v + 1).sum().toarray()
    src = bolt.fromcallback(lambda idx: x[idx], x.shape, CPU,
                            dtype=np.float64, chunks=2)
    src.sum().toarray()
    np.testing.assert_allclose(
        got, ref.array(x, mesh).map(lambda v: v + 1).sum().toarray(),
        rtol=1e-10)
    assert obs.spans() == []
    assert obs.active_count() == 0


def test_explicit_cross_thread_parent_handoff():
    obs.enable()
    with obs.span("root"):
        parent = obs.current()
        assert parent is not None and parent.name == "root"
        done = threading.Event()

        def worker():
            with obs.span("child", parent=parent):
                pass
            done.set()

        th = threading.Thread(target=worker)
        th.start()
        assert done.wait(10)
        th.join()
    child = [s for s in obs.spans() if s.name == "child"][0]
    root = [s for s in obs.spans() if s.name == "root"][0]
    assert child.pid == root.sid
    assert child.tid != root.tid


# ----------------------------------------------------------------------
# tracer x streaming executor: parenting + overlap evidence
# ----------------------------------------------------------------------

def _slow_blocks(x, nblocks, delay):
    for blk in np.array_split(x, nblocks):
        time.sleep(delay)
        yield blk


def test_stream_prefetch_thread_spans_parent_under_run(mesh):
    """The tentpole wiring: a streamed ``fromiter(...).sum()`` yields a
    real timeline — ingest spans recorded BY THE PREFETCH THREAD parent
    under the main thread's ``stream.run`` span (explicit context
    handoff), and their wall-clock intervals overlap the main thread's
    per-slab compute spans (ingest hidden behind compute — the span
    twin of ``overlap_efficiency() > 0``)."""
    x = np.arange(32 * 4 * 8, dtype=np.float64).reshape(32, 4, 8)
    obs.enable()
    got = bolt.fromiter(_slow_blocks(x, 8, 0.004), x.shape, CPU,
                        dtype=np.float64).sum()
    assert np.allclose(np.asarray(got.toarray()), x.sum(axis=0))
    np.testing.assert_allclose(got.toarray(), ref.fromiter(
        iter(np.array_split(x, 8)), x.shape, mesh,
        dtype=np.float64).sum().toarray(), rtol=1e-10)
    sp = obs.spans()
    runs = [s for s in sp if s.name == "stream.run"]
    ingest = [s for s in sp if s.name == "stream.ingest"]
    compute = [s for s in sp if s.name == "stream.compute"]
    assert len(runs) == 1 and len(ingest) == 8 and len(compute) == 8
    run = runs[0]
    assert run.attrs["terminal"] == "sum" and run.attrs["slabs"] == 8
    # parenting crossed the thread boundary by explicit handoff
    assert all(s.pid == run.sid for s in ingest)
    assert all(s.tid != run.tid for s in ingest)
    assert all(s.tname == "bolt-stream-prefetch" for s in ingest)
    # compute stays on the run's own thread, nested under it
    assert all(s.pid == run.sid and s.tid == run.tid for s in compute)
    # every span closed inside the run's interval
    assert obs.active_count() == 0
    assert all(run.t0 <= s.t0 and s.t1 <= run.t1 + 1e-9
               for s in ingest + compute)
    # wall-clock overlap: some slab's ingest ran WHILE another computed
    overlapped = any(i.t0 < c.t1 and c.t0 < i.t1
                     for i in ingest for c in compute)
    assert overlapped, "double buffering left no ingest/compute overlap"
    # transfers nest under their ingest span with byte attribution
    transfers = [s for s in sp if s.name == "stream.transfer"]
    ingest_ids = {s.sid for s in ingest}
    assert transfers and all(t.pid in ingest_ids for t in transfers)
    assert sum(t.attrs["bytes"] for t in transfers) == x.nbytes


def test_stream_fault_leaves_no_open_spans(mesh):
    obs.enable()

    def bad_blocks():
        yield np.ones((4, 8), np.float64)
        raise RuntimeError("mid-stream failure")

    src = bolt.fromiter(bad_blocks(), (8, 8), CPU, dtype=np.float64)
    with pytest.raises(RuntimeError, match="mid-stream failure"):
        src.sum().cache()                  # the read streams (lazy)
    assert obs.active_count() == 0


# ----------------------------------------------------------------------
# metrics registry
# ----------------------------------------------------------------------

def test_counter_gauge_types_and_reset():
    reg = obs_metrics.Registry()
    c = reg.counter("calls")
    f = reg.counter("seconds", initial=0.0)
    g = reg.gauge("depth")
    c.inc()
    c.inc(4)
    f.inc(0.25)
    g.set(3)
    g.high_water(7)
    g.high_water(2)
    assert c.value == 5 and isinstance(c.value, int)
    assert f.value == 0.25 and isinstance(f.value, float)
    assert g.value == 7
    assert reg.counter("calls") is c            # get-or-create
    reg.reset()
    assert c.value == 0 and f.value == 0.0 and g.value == 0


def test_histogram_log2_buckets():
    reg = obs_metrics.Registry()
    h = reg.histogram("lat", lo=-4, hi=4)
    for v in (0.0, 0.01, 0.3, 1.0, 1.9, 6.0, 1000.0):
        h.observe(v)
    assert h.count == 7
    assert abs(h.sum - 1009.21) < 1e-9
    buckets = h.buckets()
    assert len(buckets) == (4 - (-4)) + 2
    by_bound = dict(buckets)
    assert by_bound[float(2 ** -4)] == 2        # 0.0 and 0.01 underflow
    assert by_bound[0.5] == 1                   # 0.3 in [0.25, 0.5)
    assert by_bound[2.0] == 2                   # 1.0 and 1.9 in [1, 2)
    assert by_bound[8.0] == 1                   # 6.0 in [4, 8)
    assert by_bound[float("inf")] == 1          # 1000.0 overflow
    snap = h.snapshot()
    assert snap["count"] == 7 and sum(snap["counts"]) == 7


def test_counter_group_update_is_atomic_against_snapshots():
    reg = obs_metrics.Registry()
    grp = reg.group("g", {"a": 0, "b": 0})
    stop = threading.Event()
    torn = []

    def reader():
        while not stop.is_set():
            s = grp.snapshot()
            if s["a"] != s["b"]:
                torn.append(s)
                return

    th = threading.Thread(target=reader)
    th.start()
    for _ in range(3000):
        grp.update(a=1, b=1)
    stop.set()
    th.join()
    assert not torn
    assert grp.snapshot() == {"a": 3000, "b": 3000}
    grp.update(_maxima={"a": 10})               # high-water: no-op here
    assert grp["a"] == 3000


def test_obs_modules_are_stdlib_only():
    """The port's obs modules and ``_lockdep`` load standalone by path,
    importing nothing but the standard library (no torch, numpy, jax or
    reference package)."""
    import ast
    import sys
    pkg = os.path.join(REPO, "bolt_tpu_torch")
    paths = [os.path.join(pkg, "obs", f) for f in sorted(os.listdir(
        os.path.join(pkg, "obs"))) if f.endswith(".py")]
    paths.append(os.path.join(pkg, "_lockdep.py"))
    std = set(sys.stdlib_module_names)
    for path in paths:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top in std or top == "bolt_tpu_torch" and \
                    n.startswith("bolt_tpu_torch.obs"), (path, n)
    for name in ("trace", "metrics"):
        path = os.path.join(pkg, "obs", "%s.py" % name)
        spec = importlib.util.spec_from_file_location("obs_" + name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)            # raises on non-stdlib deps


# ----------------------------------------------------------------------
# migration invariant: engine counters unchanged, registry-backed
# ----------------------------------------------------------------------

_EXPECTED_ENGINE_KEYS = {
    # (key, is_float)
    "hits": False, "misses": False, "aot_compiles": False,
    "lower_seconds": True, "compile_seconds": True,
    "dispatches": False, "dispatch_seconds": True, "fallbacks": False,
    "donations": False, "persistent_hits": False,
    "persistent_misses": False, "persistent_warm_hits": False,
    "diagnostics": False,
    "strict_checks": False, "strict_rejections": False,
    "transfer_bytes": False, "transfer_seconds": True,
    "stream_chunks": False, "stream_ingest_seconds": True,
    "stream_compute_seconds": True, "stream_wall_seconds": True,
    "stream_overlap_seconds": True, "stream_prefetch_depth": False,
    "stream_upload_threads": False, "stream_inflight_high_water": False,
    "stream_retries": False, "stream_resumes": False,
    "checkpoint_bytes": False, "checkpoint_seconds": True,
    "fused_stat_groups": False, "fused_stat_terminals": False,
    "coalesced_builds": False, "coalesced_compiles": False,
    "batched_dispatches": False, "batched_requests": False,
    "codec_encode_seconds": True, "codec_bytes_raw": False,
    "codec_bytes_wire": False,
    "shuffle_bytes": False, "spill_bytes": False,
    "shuffle_seconds": True,
}


def test_engine_counters_snapshot_unchanged_post_migration(mesh):
    """The regression gate for the registry migration: identical key
    set, identical int/float types, snapshot-not-live-view semantics,
    and the values ARE the registry's ``engine`` group."""
    bolt.ones((8, 4), context=CPU).map(lambda v: v * 2).sum().toarray()
    c = profile.engine_counters()
    assert set(c) == set(_EXPECTED_ENGINE_KEYS)
    for k, is_float in _EXPECTED_ENGINE_KEYS.items():
        if is_float:
            assert isinstance(c[k], float), (k, type(c[k]))
        else:
            assert isinstance(c[k], int) and not isinstance(c[k], bool), \
                (k, type(c[k]))
    assert c["dispatches"] > 0 and c["misses"] > 0
    # a snapshot, not a live view
    c["dispatches"] += 10 ** 6
    assert engine.counters()["dispatches"] != c["dispatches"]
    # backed by the obs registry: same numbers through the other door
    reg = obs.registry().snapshot()
    for k in _EXPECTED_ENGINE_KEYS:
        assert reg["engine.%s" % k] == engine.counters()[k], k
    # and the group is THE store, not a copy: an increment lands in both
    d0 = engine.counters()["dispatches"]
    bolt.ones((8, 4), context=CPU).sum().toarray()
    assert obs.registry().snapshot()["engine.dispatches"] \
        == engine.counters()["dispatches"] >= d0 + 1


def test_dispatch_histogram_rides_along(mesh):
    h = obs.registry().get("engine.dispatch_seconds.hist")
    n0 = h.count
    bolt.ones((8, 3), context=CPU).map(lambda v: v + 5).sum().toarray()
    assert h.count > n0                         # every dispatch observed
    assert h.sum >= 0.0


# ----------------------------------------------------------------------
# exporters
# ----------------------------------------------------------------------

def test_chrome_export_round_trip_pairs_b_e_events(tmp_path, mesh):
    """Exported JSON reloads, and per thread the B/E events balance with
    stack discipline (every E matches the innermost open B's name)."""
    path = str(tmp_path / "trace.json")
    x = np.arange(16 * 6, dtype=np.float64).reshape(16, 6)
    with obs.timeline(path):
        got = bolt.array(x, context=CPU).map(lambda v: v * 3).sum()
        got = got.toarray()
        src = bolt.fromcallback(lambda idx: x[idx], x.shape, CPU,
                                dtype=np.float64, chunks=4)
        src.map(lambda v: v + 1).sum().toarray()
    np.testing.assert_allclose(
        got, ref.array(x, mesh).map(lambda v: v * 3).sum().toarray(),
        rtol=1e-10)
    doc = json.load(open(path))
    evs = doc["traceEvents"]
    assert evs, "empty timeline"
    stacks = {}
    pairs = 0
    for e in evs:
        if e.get("ph") == "B":
            stacks.setdefault(e["tid"], []).append(e)
        elif e.get("ph") == "E":
            st = stacks.get(e["tid"])
            assert st, "E without open B on tid %s" % e["tid"]
            b = st.pop()
            assert b["name"] == e["name"], (b["name"], e["name"])
            assert e["ts"] >= b["ts"]
            pairs += 1
    assert all(not st for st in stacks.values()), "unbalanced B events"
    assert pairs >= 10
    names = {e["name"] for e in evs}
    assert {"stream.run", "stream.ingest", "stream.compute",
            "engine.dispatch"} <= names
    # thread metadata rides along for the viewer's track labels
    assert any(e.get("ph") == "M" and e.get("name") == "thread_name"
               for e in evs)


def test_timeline_restores_disarmed_state_and_writes_on_error(tmp_path):
    path = str(tmp_path / "fail.json")
    assert not obs.enabled()
    with pytest.raises(RuntimeError):
        with obs.timeline(path):
            with obs.span("doomed"):
                pass
            raise RuntimeError("body failed")
    assert not obs.enabled()                    # restored
    doc = json.load(open(path))                 # file written anyway
    assert any(e.get("name") == "doomed" for e in doc["traceEvents"])


def test_report_tree_aggregates(mesh):
    obs.enable()
    bolt.ones((8, 4), context=CPU).map(lambda v: v + 2).sum().toarray()
    txt = obs.report()
    assert "span" in txt and "total_s" in txt
    assert "array.stat" in txt and "engine.dispatch" in txt
    obs.disable()
    obs.clear()
    assert "no spans recorded" in obs.report()


# ----------------------------------------------------------------------
# profile satellites
# ----------------------------------------------------------------------

def test_timeit_blocks_on_pytree_outputs(mesh):
    b = bolt.ones((8, 4), context=CPU)

    def fn():
        return {"s": b.sum(), "pair": (b.mean()._data, 3.5)}

    result, secs = profile.timeit(fn, iters=2, warmup=1)
    assert secs > 0
    assert np.allclose(result["s"].toarray(), np.full(4, 8.0))
    assert result["pair"][1] == 3.5             # non-array leaf survives


def test_timeit_rejects_bad_iters():
    with pytest.raises(ValueError, match="iters >= 1"):
        profile.timeit(lambda: 1, iters=0)
    with pytest.raises(ValueError, match="iters >= 1"):
        profile.timeit(lambda: 1, iters=-3)


def test_overlap_efficiency_empty_and_partial_counters():
    assert profile.overlap_efficiency({}) == 0.0
    assert profile.overlap_efficiency(
        {"stream_ingest_seconds": 0.0, "stream_overlap_seconds": 0.0}) \
        == 0.0
    assert profile.overlap_efficiency({"stream_ingest_seconds": 2.0,
                                       "stream_overlap_seconds": 1.0}) \
        == 0.5
    # a fresh-process shaped dict with keys missing entirely
    assert profile.overlap_efficiency({"hits": 3}) == 0.0


def test_engine_report_no_activity_edge():
    assert "(no engine activity)" in profile.engine_report({})
    zeros = {k: (0.0 if f else 0)
             for k, f in _EXPECTED_ENGINE_KEYS.items()}
    assert "(no engine activity)" in profile.engine_report(zeros)
    live = dict(zeros, dispatches=3, dispatch_seconds=0.5)
    txt = profile.engine_report(live)
    assert "dispatches" in txt and "0.5000" in txt


def test_memory_stats_degrades_to_empty_dict():
    class NoStats:
        pass                                    # not a device at all

    assert profile.memory_stats(NoStats()) == {}
    assert profile.memory_stats(CPU) == {}
    assert profile.memory_stats("cpu") == {}
    s = profile.memory_stats()                  # whatever this machine has
    assert isinstance(s, dict)
    if not torch.cuda.is_available():
        assert s == {}
