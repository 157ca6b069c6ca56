"""The port's serving layer (``bolt_tpu_torch/serve.py``) against the
reference's (``bolt_tpu/serve.py``): the assertions of
``tests/test_serve.py`` and of ``tests/test_concurrency.py``'s two serve
tests, on the port, on the CPU.

The same numpy sources stream through the port (``torch.device("cpu")``)
and through ``bolt_tpu`` on the 8-device CPU mesh.  The records are
integer-valued f32, so every sum is exact in any order: a served result
equals the port's standalone run and the reference's bit for bit.  The
port's lock witness (``bolt_tpu_torch/_lockdep.py``) is armed over every
test, as the reference's suites run under theirs, and a test fails on a
violation it recorded.

Differences from the reference's file, each for a stated reason:
* ``test_blt010_rejects_impossible_pipeline`` keeps the admission half;
  ``test_blt010_check_forecasts_the_rejection`` holds ``analysis.check``'s
  BLT010 to the reference's (its byte figures) and adds ``strict()``;
* ``test_concurrent_streamed_runs_overlap_across_tenants`` replaces the
  reference's wall-clock ratio (1.3x, which comes and goes with the
  host's load) by proof of overlap: every tenant's source meets one
  ``threading.Barrier`` at its first slab, which only concurrent runs
  can pass; the ratio is logged by ``chip_smoke.py`` phase 13 on the
  card;
* the warm start's persistent artifacts are the ``nvcc``-built kernel
  libraries, which the CPU never builds: ``test_start_warm_...`` checks
  the attached directory and that no build ran, and the card test
  ``test_torch_card.py::test_start_warm_child_runs_no_nvcc`` counts the
  warm hits.
"""

import re
import threading
import time

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch import _lockdep, analysis, engine, obs, serve, stream
from bolt_tpu_torch.obs import metrics as _metrics

pytestmark = pytest.mark.serve

CPU = torch.device("cpu")

ADD1 = lambda v: v + 1    # noqa: E731 — hoisted: tenants must SHARE
#                           stage callables for cross-tenant coalescing
REF_ADD1 = lambda v: v + 1    # noqa: E731


def _x(shape=(64, 8, 4)):
    return np.arange(np.prod(shape), dtype=np.float32).reshape(shape)


def _pipeline(x, chunks=16):
    src = bolt.fromcallback(lambda idx: x[idx], x.shape, CPU,
                            dtype=np.float32, chunks=chunks)
    return src.map(ADD1).sum()


def _ref_sum(x, mesh, chunks=16):
    """The reference's streamed ``map(v + 1).sum()`` of ``x``."""
    src = ref.fromcallback(lambda idx: x[idx], x.shape, mesh,
                           dtype=np.float32, chunks=chunks)
    return np.asarray(src.map(REF_ADD1).sum().toarray())


def _bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(autouse=True)
def _no_leaked_server():
    yield
    assert serve.active() is None, "a test leaked an active server"


@pytest.fixture(autouse=True)
def _witness():
    """The port's lock witness, armed over the test."""
    before = len(_lockdep.violations())
    was = _lockdep.enabled()
    _lockdep.enable()
    try:
        yield
    finally:
        if not was:
            _lockdep.disable()
    new = _lockdep.violations()[before:]
    assert not new, "lockdep violations during test:\n" + "\n".join(new)


# ---------------------------------------------------------------------
# the scheduler: submit, futures, results
# ---------------------------------------------------------------------

def test_submit_array_pipeline_and_callable(mesh):
    x = _x()
    want = _ref_sum(x, mesh)
    with serve.serving(workers=2) as sv:
        f1 = sv.submit(_pipeline(x), tenant="a")
        f2 = sv.submit(lambda: 41 + 1, tenant="b")
        out = f1.result(timeout=60)
        assert _bits(out.toarray(), want)
        assert _bits(out.toarray(), (x + 1).sum(axis=0))
        assert f2.result(timeout=60) == 42
        assert f1.done() and f2.done()
        assert f1.wait_seconds >= 0.0 and f1.run_seconds > 0.0


def test_submit_rejects_non_pipelines():
    with serve.serving(workers=1) as sv:
        with pytest.raises(TypeError):
            sv.submit(42)


def test_future_delivers_the_pipeline_exception():
    def boom():
        raise ValueError("tenant bug")
    with serve.serving(workers=1) as sv:
        f = sv.submit(boom, tenant="a")
        with pytest.raises(ValueError, match="tenant bug"):
            f.result(timeout=60)
        assert isinstance(f.exception(), ValueError)


def test_module_level_submit_lazy_default_server():
    try:
        f = serve.submit(lambda: "ok")
        assert f.result(timeout=60) == "ok"
        assert serve.active() is not None
    finally:
        serve.stop()


def test_start_refuses_a_second_server():
    with serve.serving(workers=1):
        with pytest.raises(RuntimeError, match="already active"):
            serve.start()


def test_supervise_waits_for_the_pod_layer():
    # the pod layer is ported (A12c): supervise=True owns a recovery
    # supervisor, which idles in one process and goes with the server
    from bolt_tpu_torch.parallel import supervisor
    sv = serve.Server(workers=1, supervise=True)
    try:
        assert supervisor.active() is sv.supervisor
        st = sv.stats()["pod"]
        assert st["supervised"] and st["budget_share"] == 1.0
        assert not sv.pod_paused()
    finally:
        sv.close()
    assert supervisor.active() is None and serve.active() is None


# ---------------------------------------------------------------------
# N tenants, bit-identical, ONE build
# ---------------------------------------------------------------------

def test_tenants_bit_identical_to_single_tenant_run(mesh):
    x = _x()
    single = np.asarray(_pipeline(x).toarray())     # single-tenant run
    want = _ref_sum(x, mesh)
    assert _bits(single, want)
    with serve.serving(workers=4) as sv:
        futs = [sv.submit(_pipeline(x), tenant="t%d" % i)
                for i in range(4)]
        outs = [f.result(timeout=120) for f in futs]
    for out in outs:
        assert _bits(out.toarray(), single)


def test_n_identical_tenants_compile_exactly_once():
    x = _x()
    _pipeline(x).toarray()          # warm python paths
    engine.clear()
    c0 = engine.counters()
    with serve.serving(workers=4) as sv:
        futs = [sv.submit(_pipeline(x), tenant="t%d" % i)
                for i in range(4)]
        [f.result(timeout=120) for f in futs]
    c1 = engine.counters()
    four = {k: c1[k] - c0[k] for k in ("misses", "aot_compiles")}
    engine.clear()
    c0 = engine.counters()
    _pipeline(x).toarray()
    c1 = engine.counters()
    one = {k: c1[k] - c0[k] for k in ("misses", "aot_compiles")}
    # 4 concurrent cold tenants build EXACTLY what one cold tenant does
    assert four == one, (four, one)


def test_per_tenant_engine_counters_scoped():
    x = _x()
    t0 = {t: engine.tenant_counters(t)["transfer_bytes"]
          for t in ("scoped-a", "scoped-b")}
    with serve.serving(workers=2) as sv:
        fa = sv.submit(_pipeline(x), tenant="scoped-a")
        fb = sv.submit(_pipeline(x), tenant="scoped-b")
        fa.result(timeout=120)
        fb.result(timeout=120)
        st = sv.stats()
    for t in ("scoped-a", "scoped-b"):
        moved = engine.tenant_counters(t)["transfer_bytes"] - t0[t]
        assert moved == x.nbytes, (t, moved)     # the whole ingest, ONCE
        assert st["tenants"][t]["completed"] == 1
        assert st["tenants"][t]["transfer_bytes"] >= x.nbytes


def test_tenant_scope_nests_and_restores():
    assert engine.current_tenant() is None
    with engine.tenant("outer"):
        assert engine.current_tenant() == "outer"
        with engine.tenant("inner"):
            assert engine.current_tenant() == "inner"
        assert engine.current_tenant() == "outer"
    assert engine.current_tenant() is None


# ---------------------------------------------------------------------
# the device-memory arbiter
# ---------------------------------------------------------------------

def test_arbiter_grants_fifo_within_round_robin_across_tenants():
    arb = serve.DeviceArbiter(10)
    assert arb.acquire(10, "hold")
    order = []
    threads = []

    def waiter(name, tenant):
        assert arb.acquire(10, tenant)
        order.append(name)
        arb.release(10)

    # enqueue a1, a2 (tenant A) then b1 (tenant B), deterministically
    for name, tenant in (("a1", "A"), ("a2", "A"), ("b1", "B")):
        th = threading.Thread(target=waiter, args=(name, tenant),
                              daemon=True)
        th.start()
        threads.append(th)
        deadline = time.time() + 5
        while arb.waiting() < len(threads) and time.time() < deadline:
            time.sleep(0.005)
    assert arb.waiting() == 3
    arb.release(10)
    for th in threads:
        th.join(timeout=10)
    # round-robin ACROSS tenants: A's head, then B's, then A's second
    assert order == ["a1", "b1", "a2"]
    assert arb.in_use() == 0


def test_arbiter_oversized_request_runs_alone():
    arb = serve.DeviceArbiter(100)
    assert arb.acquire(1000, "big")       # larger than the whole budget
    assert arb.in_use() == 1000
    got = []
    th = threading.Thread(target=lambda: got.append(arb.acquire(10, "s")),
                          daemon=True)
    th.start()
    time.sleep(0.05)
    assert not got                        # blocked while the giant holds
    arb.release(1000)
    th.join(timeout=10)
    assert got == [True]
    arb.release(10)


def test_arbiter_large_request_survives_sustained_small_traffic():
    # the anti-starvation barrier: a near-budget request is seated even
    # while another tenant streams small acquisitions continuously
    arb = serve.DeviceArbiter(100)
    stop = threading.Event()
    got = []

    def small_traffic():
        while not stop.is_set():
            if arb.acquire(10, "chatty", stop=stop):
                time.sleep(0.001)
                arb.release(10)

    chatty = [threading.Thread(target=small_traffic, daemon=True)
              for _ in range(2)]
    for th in chatty:
        th.start()
    time.sleep(0.05)                       # traffic established

    def big():
        got.append(arb.acquire(90, "big"))
    th = threading.Thread(target=big, daemon=True)
    th.start()
    th.join(30)                            # bounded starvation
    stop.set()
    for c in chatty:
        c.join(10)
    assert got == [True]
    arb.release(90)


def test_close_wait_true_drains_leased_jobs(mesh):
    # a queued IN-MEMORY job blocked on the arbiter while a clean
    # close(wait=True) runs must complete, not fail as "cancelled"; only
    # close(wait=False) may abort a pending lease wait
    x = _x((32, 8, 4))
    pipe = bolt.array(x, CPU).map(ADD1).sum()
    est = analysis.working_set_bytes(pipe)
    assert est and est > 0
    want = np.asarray(ref.array(x, mesh).map(REF_ADD1).sum().toarray())
    sv = serve.start(workers=2, budget_bytes=est + 40, queue_limit=8)
    try:
        def holder():
            lease = sv.arbiter.lease("holder")
            assert lease.acquire(est + 30)     # leaves < est available
            time.sleep(0.4)
            lease.close()
            return "held"
        f1 = sv.submit(holder, tenant="a")
        time.sleep(0.1)                        # holder owns the budget
        f2 = sv.submit(bolt.array(x, CPU).map(ADD1).sum(), tenant="b")
    finally:
        serve.stop(wait=True)                  # drain DURING f2's wait
    assert f1.result(timeout=10) == "held"
    out = f2.result(timeout=10)                # ran after the drain
    assert _bits(out.toarray(), want)
    arb = serve.DeviceArbiter(10)
    assert arb.acquire(10, "hold")
    stop = threading.Event()
    got = []
    th = threading.Thread(
        target=lambda: got.append(arb.acquire(10, "w", stop=stop)),
        daemon=True)
    th.start()
    time.sleep(0.05)
    stop.set()
    th.join(timeout=10)
    assert got == [False] and arb.waiting() == 0
    arb.release(10)


def test_lease_close_returns_outstanding_bytes():
    arb = serve.DeviceArbiter(100)
    lease = arb.lease("t")
    assert lease.acquire(60) and lease.acquire(30)
    lease.release(40)
    assert arb.in_use() == 50 and lease.outstanding() == 50
    lease.close()
    assert arb.in_use() == 0
    lease.close()                          # idempotent
    lease.release(10 ** 9)                 # clamped, never negative
    assert arb.in_use() == 0


def _reset_arbiter_high_water():
    # serve metrics are process-cumulative: reset the high-water gauge so
    # THIS test's bound is what gets asserted
    g = _metrics.registry().gauge("serve.arbiter_in_use_high_water")
    g.reset()
    return g


def test_streamed_run_respects_budget_smaller_than_ring(mesh):
    # a budget below slab x ring: the starvation valve shallows the
    # pipeline instead of deadlocking; the result stays bit-exact and the
    # bytes in use never pass the budget
    x = _x((64, 8, 4))
    slab_bytes = 16 * 8 * 4 * 4
    hw = _reset_arbiter_high_water()
    with stream.uploaders(2):
        with serve.serving(workers=1, budget_bytes=slab_bytes + 1) as sv:
            out = sv.submit(_pipeline(x, chunks=16),
                            tenant="tight").result(timeout=120)
            assert sv.arbiter.in_use() == 0
    assert _bits(out.toarray(), _ref_sum(x, mesh))
    assert 0 < hw.value <= slab_bytes + 1


def test_streamed_lease_counts_wire_bytes_under_a_codec():
    # an armed codec leases its wire slabs: bf16 halves f32's bytes
    x = _x((64, 8, 4))
    slab_bytes = 16 * 8 * 4 * 2
    hw = _reset_arbiter_high_water()
    with serve.serving(workers=1, budget_bytes=slab_bytes) as sv:
        with stream.codec("bf16"):
            out = sv.submit(_pipeline(x, chunks=16),
                            tenant="wire").result(timeout=120)
    assert 0 < hw.value <= slab_bytes
    with stream.codec("bf16"):
        assert _bits(out.toarray(), _pipeline(x, chunks=16).toarray())


def test_concurrent_streams_share_the_budget(mesh):
    x = _x((64, 8, 4))
    want = _ref_sum(x, mesh)
    hw = _reset_arbiter_high_water()
    with serve.serving(workers=3, budget_bytes=x.nbytes) as sv:
        futs = [sv.submit(_pipeline(x), tenant="t%d" % i)
                for i in range(3)]
        outs = [f.result(timeout=120) for f in futs]
    assert 0 < hw.value <= x.nbytes        # never past the global budget
    for out in outs:
        assert _bits(out.toarray(), want)


def test_swap_budget_reads_the_serving_arbiter():
    assert stream.swap_budget() is None
    with serve.serving(workers=1, budget_bytes=12345):
        assert stream.swap_budget() == 12345
        with stream.spill(None, budget=77):
            assert stream.swap_budget() == 77   # the spill scope wins
    assert stream.swap_budget() is None


# ---------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------

def test_reject_policy_raises_when_queue_full():
    gate = threading.Event()
    with serve.serving(workers=1, queue_limit=1, policy="reject") as sv:
        r0 = sv.stats()["totals"]["rejected"]   # counters are cumulative
        running = threading.Event()

        def slow():
            running.set()
            gate.wait(30)
            return "slow"
        f1 = sv.submit(slow, tenant="a")
        assert running.wait(10)            # worker busy; queue empty
        f2 = sv.submit(lambda: "queued", tenant="a")   # fills the queue
        with pytest.raises(serve.AdmissionError, match="queue is full"):
            sv.submit(lambda: "over", tenant="a")
        gate.set()
        assert f1.result(timeout=60) == "slow"
        assert f2.result(timeout=60) == "queued"
        st = sv.stats()
        assert st["totals"]["rejected"] - r0 == 1
        assert st["queue_depth"] == 0


def test_queue_policy_blocks_submitter_until_room():
    gate = threading.Event()
    with serve.serving(workers=1, queue_limit=1, policy="queue") as sv:
        running = threading.Event()

        def slow():
            running.set()
            gate.wait(30)
            return "slow"
        sv.submit(slow, tenant="a")
        assert running.wait(10)
        sv.submit(lambda: 1, tenant="a")   # fills the bounded queue
        done = []

        def blocked_submit():
            done.append(sv.submit(lambda: 2, tenant="a"))
        th = threading.Thread(target=blocked_submit, daemon=True)
        th.start()
        time.sleep(0.1)
        assert not done                    # backpressure: submit blocked
        gate.set()
        th.join(timeout=30)
        assert done and done[0].result(timeout=60) == 2


def test_blt010_rejects_impossible_pipeline(mesh):
    x = _x((64, 8, 4))   # ONE slab of 8 KB: can never degrade into 4 KB
    with serve.serving(workers=1, budget_bytes=4096) as sv:
        r0 = sv.stats()["totals"]["rejected"]
        arr = _pipeline(x, chunks=64)
        assert analysis.admission_floor_bytes(arr) == 64 * 8 * 4 * 4
        with pytest.raises(serve.AdmissionError, match="BLT010"):
            sv.submit(arr, tenant="a")
        assert sv.stats()["totals"]["rejected"] - r0 == 1
        # a slab-shrunk twin of the same pipeline IS admissible: the floor
        # is the slab, not the ring
        small = _pipeline(x, chunks=8)
        assert analysis.admission_floor_bytes(small) <= 4096
        out = sv.submit(small, tenant="a").result(timeout=120)
        assert _bits(out.toarray(), _ref_sum(x, mesh, chunks=8))


def test_working_set_estimates():
    x = _x((64, 8, 4))
    src = bolt.fromcallback(lambda idx: x[idx], x.shape, CPU,
                            dtype=np.float32, chunks=16)
    ring = stream.prefetch_depth() + stream.pool_size(src._stream)
    est = analysis.working_set_bytes(src.map(ADD1))
    assert est == 16 * 8 * 4 * 4 * ring
    b = bolt.array(x, CPU).map(ADD1)
    assert analysis.working_set_bytes(b) == 2 * x.nbytes
    assert analysis.working_set_bytes(np.ones(3)) is None


def test_close_without_wait_fails_pending_jobs():
    gate = threading.Event()
    sv = serve.start(workers=1, queue_limit=4)
    try:
        running = threading.Event()

        def slow():
            running.set()
            gate.wait(30)
        sv.submit(slow, tenant="a")
        assert running.wait(10)
        f2 = sv.submit(lambda: 2, tenant="a")
        gate.set()
    finally:
        serve.stop(wait=False)
    with pytest.raises(RuntimeError):
        f2.result(timeout=60)
    with pytest.raises(RuntimeError, match="closed"):
        sv.submit(lambda: 3)


# ---------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------

def test_serve_metrics_and_no_leaked_spans():
    x = _x()
    obs.clear()
    obs.enable()
    try:
        with serve.serving(workers=2) as sv:
            futs = [sv.submit(_pipeline(x), tenant="m%d" % i)
                    for i in range(3)]
            [f.result(timeout=120) for f in futs]
        assert obs.active_count() == 0     # every serve.run span closed
        names = [s.name for s in obs.spans()]
        assert "serve.run" in names
        reg = _metrics.registry().snapshot()
        assert reg["serve.completed"] >= 3
        assert reg["serve.queue_wait_seconds.hist"]["count"] >= 3
    finally:
        obs.disable()
        obs.clear()


def test_concurrent_streamed_runs_overlap_across_tenants(mesh):
    # tenants whose ingest has storage-class latency OVERLAP under the
    # scheduler: each tenant's source meets one barrier at its first slab,
    # which four runs pass only together (a serial schedule breaks it)
    x = _x((48, 8, 4))
    meet = threading.Barrier(4, timeout=30)

    def make():
        def read(idx):
            if idx[0].start == 0:
                meet.wait()
            time.sleep(0.01)
            return x[idx]
        src = bolt.fromcallback(read, x.shape, CPU, dtype=np.float32,
                                chunks=8)
        return src.map(ADD1).sum()

    with serve.serving(workers=4) as sv:
        futs = [sv.submit(make(), tenant="t%d" % i) for i in range(4)]
        outs = [f.result(timeout=120) for f in futs]
    assert not meet.broken
    want = _ref_sum(x, mesh, chunks=8)
    for out in outs:
        assert _bits(out.toarray(), want)


# ---------------------------------------------------------------------
# fault policy: tenant-failure isolation, per-submit retries= and
# deadline=
# ---------------------------------------------------------------------

def test_tenant_stream_failure_returns_lease_and_isolates(mesh):
    # ONE tenant's streamed pipeline dies mid-run: its future carries the
    # original error, its arbiter bytes come back, and the OTHER tenants'
    # futures are untouched
    x = _x()
    boom = RuntimeError("tenant-a storage died")
    fired = []

    def flaky(idx):
        fired.append(idx)
        if len(fired) >= 2:
            raise boom
        return x[idx]

    want = _ref_sum(x, mesh)
    with serve.serving(workers=2, budget_bytes=64 << 20) as sv:
        bad = bolt.fromcallback(flaky, x.shape, CPU, dtype=np.float32,
                                chunks=16).map(ADD1).sum()
        fa = sv.submit(bad, tenant="iso-a")
        fbs = [sv.submit(_pipeline(x), tenant="iso-b")
               for _ in range(3)]
        with pytest.raises(RuntimeError, match="storage died"):
            fa.result(timeout=120)
        for f in fbs:                      # neighbours unaffected
            assert _bits(f.result(timeout=120).toarray(), want)
        st = sv.stats()
        assert st["arbiter"]["in_use_bytes"] == 0   # lease returned
        assert st["tenants"]["iso-a"]["failed"] == 1
        assert st["tenants"]["iso-b"]["completed"] == 3
        assert st["tenants"]["iso-b"]["failed"] == 0


def test_submit_retries_reruns_and_counts():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError("transient %d" % len(calls))
        return "ok"

    with serve.serving(workers=1) as sv:
        t0 = sv.stats()
        f = sv.submit(flaky, tenant="retry-r", retries=2)
        assert f.result(timeout=60) == "ok"
        assert len(calls) == 3
        st = sv.stats()
        assert st["totals"]["retried"] - t0["totals"]["retried"] == 2
        assert st["tenants"]["retry-r"]["retried"] == 2
        assert st["tenants"]["retry-r"]["completed"] == 1


def test_submit_retries_a_peer_loss():
    # PeerLostError is the reference's retryable pod outage; the port
    # keeps the type so submit(retries=) retries it the same way
    calls = []

    def lost_once():
        calls.append(1)
        if len(calls) == 1:
            raise serve.PeerLostError("peer 1 lost")
        return "recovered"

    with serve.serving(workers=1) as sv:
        assert sv.submit(lost_once, retries=1).result(timeout=60) \
            == "recovered"
    assert len(calls) == 2


def test_submit_retries_exhausted_chains_attempts():
    def always():
        raise ValueError("still broken")

    with serve.serving(workers=1) as sv:
        f = sv.submit(always, tenant="r", retries=1)
        exc = f.exception(timeout=60)
    assert isinstance(exc, RuntimeError) and "after 1 retries" in str(exc)
    assert isinstance(exc.__cause__, ValueError)          # final attempt
    assert isinstance(exc.__cause__.__cause__, ValueError)  # original


def test_submit_deadline_expires_in_queue():
    release = threading.Event()

    def blocker():
        release.wait(30)
        return 1

    with serve.serving(workers=1) as sv:
        e0 = sv.stats()["totals"]["expired"]
        f1 = sv.submit(blocker, tenant="x")
        f2 = sv.submit(lambda: 2, tenant="x", deadline=0.05)
        time.sleep(0.2)                    # the deadline passes queued
        release.set()
        assert f1.result(timeout=60) == 1
        with pytest.raises(serve.DeadlineError,
                           match="before the job started"):
            f2.result(timeout=60)
        st = sv.stats()
        assert st["totals"]["expired"] - e0 == 1
        assert st["totals"]["failed"] >= 1


def test_submit_deadline_stops_retries():
    calls = []

    def failing():
        calls.append(1)
        time.sleep(0.08)
        raise ValueError("attempt %d" % len(calls))

    with serve.serving(workers=1) as sv:
        f = sv.submit(failing, tenant="d", retries=50, deadline=0.1)
        exc = f.exception(timeout=60)
    assert isinstance(exc, (ValueError, RuntimeError))
    assert len(calls) < 50                 # the deadline cut retries off


def test_submit_deadline_validation():
    with serve.serving(workers=1) as sv:
        with pytest.raises(ValueError, match="positive"):
            sv.submit(lambda: 1, deadline=0)


# ---------------------------------------------------------------------
# weighted fair share
# ---------------------------------------------------------------------

def test_weights_validation():
    with pytest.raises(ValueError, match="positive integer"):
        serve.Server(workers=1, weights={"a": 0}).close()


def _ordered_pops(weights, jobs):
    """Submit ``jobs`` (a list of tenant tags) while ONE worker is held on
    a blocker job, release, and return the order the scheduler ran them
    in: the weighted round-robin's observable."""
    order = []
    gate = threading.Event()

    def blocker():
        gate.wait(30)

    def tagged(t):
        return lambda: order.append(t)

    with serve.serving(workers=1, weights=weights) as sv:
        hold = sv.submit(blocker, tenant="hold")
        time.sleep(0.15)              # the worker is inside blocker now
        futs = [sv.submit(tagged(t), tenant=t) for t in jobs]
        gate.set()
        hold.result(timeout=60)
        for f in futs:
            f.result(timeout=60)
    return order


def test_default_weights_keep_round_robin_order():
    order = _ordered_pops(None, ["a"] * 4 + ["b"] * 4)
    assert order == ["a", "b", "a", "b", "a", "b", "a", "b"]


def test_weighted_fair_share_serves_weight_jobs_per_turn():
    order = _ordered_pops({"a": 3}, ["a"] * 6 + ["b"] * 2)
    assert order == ["a", "a", "a", "b", "a", "a", "a", "b"]


def test_weighted_fair_share_starvation_freedom():
    order = _ordered_pops({"a": 5}, ["a"] * 12 + ["b"])
    assert "b" in order
    assert order.index("b") <= 5, order


def test_weight_turn_forfeited_when_queue_drains():
    order = _ordered_pops({"a": 3}, ["a", "a", "b", "b"])
    assert order == ["a", "a", "b", "b"]


# ---------------------------------------------------------------------
# warm start
# ---------------------------------------------------------------------

def test_start_warm_serves_first_request_without_fresh_compiles(
        mesh, tmp_path):
    """``Server(start_warm=dir)`` attaches the kernel build directory an
    earlier process filled and arms the warm tally for the server's life;
    the first request builds its program (``aot_compiles``) but runs no
    ``nvcc`` (``persistent_misses`` flat).  The CPU builds no library, so
    the warm hits are counted on the card
    (``test_torch_card.py::test_start_warm_child_runs_no_nvcc``)."""
    cache = str(tmp_path / "warm-kernels")
    x = _x((32, 8, 4))
    want = np.asarray(ref.array(x, mesh).map(REF_ADD1).sum().toarray())

    def make():
        return bolt.array(x, CPU).map(ADD1).sum()

    try:
        engine.clear()
        c0 = engine.counters()
        with serve.serving(workers=1, start_warm=cache) as sv:
            assert sv.warm_dir == cache
            assert engine.persistent_cache_dir() == cache
            assert engine._WARM_ARMED
            out = sv.submit(make(), tenant="w").result(timeout=120)
        c1 = engine.counters()
        assert not engine._WARM_ARMED      # the tally ends with the server
        assert engine.persistent_cache_dir() == cache   # still attached
        assert _bits(out.toarray(), want)
        assert c1["persistent_misses"] == c0["persistent_misses"], \
            "warm start ran nvcc"
        assert c1["aot_compiles"] > c0["aot_compiles"]
    finally:
        engine.persistent_cache(enable=False)


# ---------------------------------------------------------------------
# tests/test_concurrency.py's serve tests
# ---------------------------------------------------------------------

def test_arbiter_resize_race_is_clean_under_lockdep():
    """One thread oscillates the budget while workers lease through it;
    the armed witness fails the test on any inversion, and the end state
    catches lost grants or releases."""
    arb = serve.DeviceArbiter(1 << 20)
    stop = threading.Event()
    errors = []

    def resizer():
        budgets = [1 << 18, 1 << 20, 1 << 16, 1 << 21]
        i = 0
        while not stop.is_set():
            arb.resize(budgets[i % len(budgets)])
            i += 1

    def worker(tenant):
        try:
            lease = arb.lease(tenant)
            for k in range(200):
                nbytes = 1 << (10 + k % 8)
                arb.acquire(nbytes, tenant=tenant)
                arb.release(nbytes)
                assert lease.acquire(nbytes)
                lease.release(nbytes)
            assert lease.outstanding() == 0
            lease.close()
        except Exception as exc:                # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=("t%d" % i,))
               for i in range(4)]
    rs = threading.Thread(target=resizer)
    rs.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    rs.join(timeout=10)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    assert arb.in_use() == 0                   # conservation: all paid back
    assert arb.waiting() == 0


def test_thread_census_empty_after_server_teardown(mesh):
    assert obs.thread_census() == {}, \
        "another test leaked worker threads"
    x = np.arange(64, dtype=np.float64).reshape(8, 8)
    with serve.serving(workers=2) as sv:
        census = obs.thread_census()
        assert census.get("bolt-serve-worker") == 2
        src = bolt.fromcallback(lambda idx: x[idx], x.shape, CPU,
                                dtype=np.float64, chunks=4)
        f = sv.submit(src.map(ADD1).sum())
        got = np.asarray(f.result(timeout=60).toarray())
    want = np.asarray(ref.fromcallback(
        lambda idx: x[idx], x.shape, mesh, dtype=np.float64,
        chunks=4).map(REF_ADD1).sum().toarray())
    assert _bits(got, want)
    assert obs.thread_census() == {}, "server teardown leaked threads"


def _figures(msg):
    """The byte figures of a diagnostic's message (``~12.0 MB``,
    ``0.0 MiB``...), in order."""
    return re.findall(r"(\d+(?:\.\d+)?) (GB|MB|MiB|B)\b", msg)


def test_blt010_check_forecasts_the_rejection(mesh):
    """The checker half of the reference's BLT010 test: while a server
    runs with a budget below the pipeline's floor, check() reports the
    error BLT010 with the reference's byte figures; the slab-shrunk twin
    and any pipeline without a server check clean."""
    from bolt_tpu import analysis as ref_analysis, serve as ref_serve
    x = _x((64, 8, 4))
    with ref_serve.serving(workers=1, budget_bytes=4096):
        src = ref.fromcallback(lambda idx: x[idx], x.shape, mesh,
                               dtype=np.float32, chunks=64)
        want = ref_analysis.check(src.map(REF_ADD1).sum())
    with serve.serving(workers=1, budget_bytes=4096) as sv:
        arr = _pipeline(x, chunks=64)
        rep = analysis.check(arr)
        assert rep.has("BLT010") and not rep.ok
        [d] = [d for d in rep.diagnostics if d.code == "BLT010"]
        [w] = [d for d in want.diagnostics if d.code == "BLT010"]
        assert d.severity == w.severity == "error"
        assert _figures(d.message) == _figures(w.message)
        with pytest.raises(serve.AdmissionError, match="BLT010"):
            sv.submit(arr, tenant="a")
        assert not analysis.check(_pipeline(x, chunks=8)).has("BLT010")
        # under strict() the refused pipeline never reaches the worker
        with analysis.strict():
            with pytest.raises(analysis.PipelineError, match="BLT010"):
                _pipeline(x, chunks=64).toarray()
    assert not analysis.check(_pipeline(x, chunks=64)).has("BLT010")
