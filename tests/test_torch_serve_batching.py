"""The port's continuous micro-batching (``bolt_tpu_torch/gpu/batched.py``
and ``Server(batching=...)``) against the reference's
(``bolt_tpu/tpu/batched.py``): the assertions of
``tests/test_serve_batching.py``, on the port, on the CPU.

Queued requests sharing a batch key coalesce into ONE batched dispatch
whose every lane equals its standalone dispatch bit for bit
(``np.array_equal``, never a tolerance); partial batches take bucketed
widths, so steady state builds nothing new; a lone request takes the
standalone path; attribution survives coalescing; a failed claim or
dispatch degrades every request to its standalone dispatch; and a stop
with queued requests fails them pointedly.

The bases are integer-valued f32 (``RandomState(i).randint(-8, 9)``), so
the standalone results also equal ``bolt_tpu``'s on the same records: sums
and materialised chains bit for bit, ``var`` within ``rtol=1e-6`` (f32
moments in another order).  On the CPU a compiled ``sum`` runs
``kernels.fused_map_reduce_lanes``'s plain version; the card tests
(``test_torch_card.py``) hold the kernel itself.  The port's lock witness
is armed over every test.

``test_batchable_pipelines_under_a_batching_server`` checks the batch
keys the BLT015 forecast reads; ``test_blt015_forecast_gated_on_a_
batching_server`` holds the forecast itself to the reference's, under a
batching server and after it.
"""

import threading
import time

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch import _lockdep, analysis, engine, obs, serve
from bolt_tpu_torch.gpu import batched
from bolt_tpu_torch.obs import metrics as _metrics
from bolt_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.serve

CPU = torch.device("cpu")

ADD1 = lambda v: v + 1        # noqa: E731 — hoisted: same-key requests
MUL2 = lambda v: v * 2        # noqa: E731   share stage callables
REF_ADD1 = lambda v: v + 1    # noqa: E731


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


def _records(i, shape=(32, 8)):
    return np.random.RandomState(i).randint(-8, 9, shape).astype(
        np.float32)


def _bases(n=6, shape=(32, 8)):
    return [bolt.array(_records(i, shape), CPU).cache() for i in range(n)]


def _bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and np.array_equal(got, want)


def _parked(sv):
    """Park the server's one worker on a gate; returns ``(gate,
    blocker future)``."""
    gate = threading.Event()
    return gate, sv.submit(gate.wait)


# ---------------------------------------------------------------------
# the batch key
# ---------------------------------------------------------------------

def test_batch_key_equality_and_difference():
    bs = _bases(2)
    k1 = batched.batch_key(bs[0].map(ADD1).sum())
    k2 = batched.batch_key(bs[1].map(ADD1).sum())
    assert k1 is not None and k1 == k2          # same shape/func/terminal
    assert batched.batch_key(bs[0].map(ADD1).min()) != k1   # terminal
    assert batched.batch_key(bs[0].map(MUL2).sum()) != k1   # callable
    other = bolt.array(np.ones((16, 8), np.float32), CPU)
    assert batched.batch_key(other.map(ADD1).sum()) != k1   # shape
    assert batched.batch_key(bs[0].map(ADD1).sum(axis=(0, 1))) != k1
    # the chain-materialise form is its own key family
    kc = batched.batch_key(bs[0].map(ADD1))
    assert kc is not None and kc[0] == "chain" and kc != k1


def test_batch_key_ineligible_shapes():
    bs = _bases(1)
    assert batched.batch_key(bs[0].filter(lambda v: v.sum() > 0)) is None
    assert batched.batch_key(bs[0]) is None       # nothing lazy
    x = np.ones((16, 8), np.float32)
    src = bolt.fromcallback(lambda idx: x[idx], (16, 8), CPU,
                            dtype=np.float32, chunks=4)
    assert batched.batch_key(src.map(ADD1).sum()) is None   # a stream
    # a donating chain refuses to batch (donation stays standalone)
    with engine.donation(0):
        donating = bolt.array(x, CPU).map(ADD1)
        assert batched.batch_key(donating.sum()) is None


# ---------------------------------------------------------------------
# coalesced dispatch: bit-identity, bucketing, counters
# ---------------------------------------------------------------------

def test_batched_stat_bit_identical_and_counted(mesh):
    bs = _bases()
    refs = [np.asarray(b.map(ADD1).sum().toarray()) for b in bs]
    for i, r in enumerate(refs):
        theirs = ref.array(_records(i), mesh).map(REF_ADD1).sum()
        assert _bits(r, np.asarray(theirs.toarray()))
    c0 = engine.counters()
    with serve.serving(workers=2, batching={"max_batch": 8,
                                            "linger": 0.02}) as sv:
        futs = [sv.submit(bs[i % 6].map(ADD1).sum(),
                          tenant="t%d" % (i % 3)) for i in range(12)]
        outs = [np.asarray(f.result(timeout=120).toarray())
                for f in futs]
    c1 = engine.counters()
    for i, out in enumerate(outs):
        assert _bits(out, refs[i % 6])
    assert c1["batched_dispatches"] > c0["batched_dispatches"]
    assert c1["batched_requests"] - c0["batched_requests"] >= 2
    widths = [f.batch_width for f in futs if f.batch_width]
    assert widths and all(w >= 2 for w in widths)
    asm = [f.assembly_seconds for f in futs if f.batch_width]
    assert all(a is not None and a >= 0 for a in asm)


def test_partial_bucket_pads_and_stays_bit_identical(monkeypatch):
    bs = _bases(3)
    refs = [np.asarray(b.map(ADD1).sum().toarray()) for b in bs]
    lanes = []
    real = K.fused_map_reduce_lanes

    def counted(xs, program, cols=False):
        lanes.append(len(xs))
        return real(xs, program, cols=cols)

    monkeypatch.setattr(K, "fused_map_reduce_lanes", counted)
    K.reset_launches()
    with serve.serving(workers=1, batching={"max_batch": 8,
                                            "linger": 0.05}) as sv:
        gate, blocker = _parked(sv)
        futs = [sv.submit(bs[i].map(ADD1).sum()) for i in range(3)]
        gate.set()
        outs = [np.asarray(f.result(timeout=120).toarray())
                for f in futs]
        blocker.result(timeout=30)
    for out, want in zip(outs, refs):
        assert _bits(out, want)
    # 3 requests in the 4-bucket: ONE coalesced dispatch, its sum one
    # lanes call of the 3 real lanes (the pad lane is not computed), and
    # no standalone map-reduce
    assert [f.batch_width for f in futs] == [3, 3, 3]
    assert lanes == [3]
    assert ("batched", batched.batch_key(bs[0].map(ADD1).sum()), 4) \
        in engine._CACHE


def test_multistat_group_rides_one_batched_dispatch(mesh):
    bs = _bases(4)

    def group(i):
        m = bs[i].map(ADD1)
        return m.sum(), m.var()

    refs = []
    for i in range(4):
        s, v = bolt.compute(*group(i))
        refs.append((np.asarray(s.toarray()), np.asarray(v.toarray())))
        rm = ref.array(_records(i), mesh).map(REF_ADD1)
        np.testing.assert_array_equal(refs[-1][0], rm.sum().toarray())
        np.testing.assert_allclose(refs[-1][1], rm.var().toarray(),
                                   rtol=1e-6)
    with serve.serving(workers=1, batching={"max_batch": 4,
                                            "linger": 0.05}) as sv:
        gate, blocker = _parked(sv)
        pairs = [group(i) for i in range(4)]
        futs = [sv.submit(p[0]) for p in pairs]   # submit ONE member
        gate.set()
        outs_s = [np.asarray(f.result(timeout=120).toarray())
                  for f in futs]
        blocker.result(timeout=30)
        # the sibling member resolved in the SAME batched dispatch
        outs_v = [np.asarray(p[1].toarray()) for p in pairs]
    for i in range(4):
        assert _bits(outs_s[i], refs[i][0])
        assert _bits(outs_v[i], refs[i][1])


def test_chain_materialise_batched(mesh):
    bs = _bases(4)
    refs = [np.asarray(b.map(ADD1).toarray()) for b in bs]
    for i, r in enumerate(refs):
        assert _bits(r, np.asarray(
            ref.array(_records(i), mesh).map(REF_ADD1).toarray()))
    with serve.serving(workers=1, batching={"max_batch": 4,
                                            "linger": 0.05}) as sv:
        gate, blocker = _parked(sv)
        futs = [sv.submit(bs[i].map(ADD1)) for i in range(4)]
        gate.set()
        outs = [np.asarray(f.result(timeout=120).toarray())
                for f in futs]
        blocker.result(timeout=30)
    for out, want in zip(outs, refs):
        assert _bits(out, want)
    assert all(f.batch_width == 4 for f in futs)


def test_zero_fresh_compiles_across_bucketed_widths():
    bs = _bases()

    def make(i=0):
        return bs[i % 6].map(ADD1).sum()

    make().cache()                     # the standalone program
    with serve.serving(workers=1, batching={"max_batch": 8,
                                            "linger": 0.05}) as sv:
        warmed = batched.warm(make, buckets=sv.batching.buckets)
        assert warmed == (2, 4, 8)
        c0 = engine.counters()
        for burst in (1, 2, 3, 5, 8):  # every width buckets to 2/4/8
            gate, blocker = _parked(sv)
            futs = [sv.submit(make(i)) for i in range(burst)]
            gate.set()
            [f.result(timeout=120) for f in futs]
            blocker.result(timeout=30)
        c1 = engine.counters()
    assert c1["misses"] == c0["misses"]
    assert c1["aot_compiles"] == c0["aot_compiles"]


def test_single_request_takes_the_standalone_path():
    bs = _bases(1)
    want = np.asarray(bs[0].map(ADD1).sum().toarray())
    c0 = engine.counters()
    with serve.serving(workers=1, batching=True) as sv:
        f = sv.submit(bs[0].map(ADD1).sum())
        out = np.asarray(f.result(timeout=120).toarray())
    c1 = engine.counters()
    assert _bits(out, want)
    assert f.batch_width is None and f.assembly_seconds is None
    assert c1["batched_dispatches"] == c0["batched_dispatches"]


# ---------------------------------------------------------------------
# the deferred reduce door
# ---------------------------------------------------------------------

def test_reduce_defers_only_under_a_batching_server(mesh):
    bs = _bases(4)
    # no batching server: reduce is eager (concrete at once)
    out = bs[0].map(ADD1).reduce(torch.add)
    assert out._spending is None
    want = [np.asarray(b.map(ADD1).reduce(torch.add).toarray()) for b in bs]
    for i, w in enumerate(want):
        assert _bits(w, np.asarray(ref.array(_records(i), mesh).map(
            REF_ADD1).reduce(np.add).toarray()))
    with serve.serving(workers=1, batching={"max_batch": 4,
                                            "linger": 0.05}) as sv:
        # armed: reduce defers as a pending handle...
        lone = bs[0].map(ADD1).reduce(torch.add)
        assert lone._spending is not None
        # ...whose standalone read is bit-identical to eager
        assert _bits(lone.toarray(), want[0])
        gate, blocker = _parked(sv)
        futs = [sv.submit(bs[i].map(ADD1).reduce(torch.add))
                for i in range(4)]
        gate.set()
        outs = [np.asarray(f.result(timeout=120).toarray())
                for f in futs]
        blocker.result(timeout=30)
    for got, w in zip(outs, want):
        assert _bits(got, w)
    assert all(f.batch_width == 4 for f in futs)
    # the server closed: the door is shut again
    assert bs[0].map(ADD1).reduce(torch.add)._spending is None


def test_deferred_reduce_keeps_eager_error_contracts():
    b = _bases(1)[0]
    with serve.serving(workers=1, batching=True):
        # a reducer that breaks the value-shape contract refuses the lazy
        # door and raises at CALL time, like the eager path
        with pytest.raises(ValueError, match="value shape"):
            b.map(ADD1).reduce(lambda a, c: torch.stack([a, c]))
        empty = bolt.array(np.ones((0, 4), np.float32), CPU)
        with pytest.raises(TypeError, match="empty"):
            empty.reduce(torch.add)
    serve.stop()


# ---------------------------------------------------------------------
# attribution, fair share, stats
# ---------------------------------------------------------------------

def test_per_tenant_accounting_survives_coalescing():
    bs = _bases(4)
    tenants = ("acct-a", "acct-b")     # unique: registry groups are
    #                                    process-wide across tests
    with serve.serving(workers=1, batching={"max_batch": 4,
                                            "linger": 0.05}) as sv:
        before = {t: sv.stats()["tenants"].get(t, {}) for t in tenants}
        gate, blocker = _parked(sv)
        futs = [sv.submit(bs[i].map(ADD1).sum(),
                          tenant=tenants[i % 2]) for i in range(4)]
        gate.set()
        [f.result(timeout=120) for f in futs]
        blocker.result(timeout=30)
        st = sv.stats()
    for t in tenants:
        entry = st["tenants"][t]
        b4 = before[t]
        assert entry["submitted"] - b4.get("submitted", 0) == 2
        assert entry["completed"] - b4.get("completed", 0) == 2
        assert entry["run_seconds"] > b4.get("run_seconds", 0.0)
        assert entry["queue_wait_seconds"] >= 0.0


def test_stats_batching_block_and_degraded_shapes():
    with serve.serving(workers=1) as sv:
        assert sv.stats()["batching"] == {}       # no batching policy
    _metrics.registry().histogram(
        "serve.batch_occupancy.hist", lo=0, hi=9).reset()
    with serve.serving(workers=1, batching={"max_batch": 4,
                                            "linger": 0.01}) as sv:
        st = sv.stats()["batching"]
        assert st["max_batch"] == 4 and st["buckets"] == (2, 4)
        assert st["occupancy"] == {}              # no coalesced dispatch
        b = _bases(2)
        gate, blocker = _parked(sv)
        futs = [sv.submit(b[i].map(ADD1).sum(), tenant="statsq")
                for i in (0, 1)]
        # the live queue depth is visible while parked
        assert sv.stats()["tenants"]["statsq"]["queue_depth"] == 2
        gate.set()
        [f.result(timeout=120) for f in futs]
        blocker.result(timeout=30)
        assert sv.stats()["tenants"]["statsq"]["queue_depth"] == 0
        occ = sv.stats()["batching"]["occupancy"]
        assert occ["dispatches"] >= 1 and occ["mean"] >= 2


def test_batchable_pipelines_under_a_batching_server():
    # the half of the reference's BLT015 test that needs no checker: the
    # batch keys the forecast reads, and the server that arms them
    b = _bases(1)[0]
    assert serve.active() is None
    with serve.serving(workers=1, batching=True) as sv:
        assert serve.active().batching is sv.batching is not None
        assert batched.batch_key(b.map(ADD1).sum()) is not None
        assert batched.batch_key(b.map(ADD1)) is not None
        assert batched.batch_key(
            b.map(ADD1).filter(lambda v: v.sum() > 0)) is None
    assert serve.active() is None and not batched.armed()


def test_batch_policy_validation():
    with pytest.raises(ValueError, match="max_batch"):
        serve.BatchPolicy(max_batch=1)
    with pytest.raises(ValueError, match="linger"):
        serve.BatchPolicy(linger=-1)
    with pytest.raises(ValueError, match="buckets"):
        serve.BatchPolicy(buckets=(1, 2))
    with pytest.raises(ValueError, match="bucket"):
        serve.BatchPolicy(max_batch=16, buckets=(2, 4))
    with pytest.raises(ValueError, match="bucket"):
        serve.BatchPolicy(max_batch=4, buckets=(8,))
    pol = serve.BatchPolicy(buckets=(4, 8))
    assert pol.max_batch == 8 and pol.buckets == (4, 8)
    with pytest.raises(ValueError, match="batching"):
        serve.Server(batching="yes")


# ---------------------------------------------------------------------
# degradation and races: batching is never a failure mode
# ---------------------------------------------------------------------

def test_dispatch_failure_degrades_to_standalone(monkeypatch):
    bs = _bases(4)
    refs = [np.asarray(b.map(ADD1).sum().toarray()) for b in bs]

    def boom(batch, buckets):
        raise RuntimeError("injected batched-dispatch failure")

    monkeypatch.setattr(batched, "dispatch", boom)
    with serve.serving(workers=1, batching={"max_batch": 4,
                                            "linger": 0.05}) as sv:
        gate, blocker = _parked(sv)
        futs = [sv.submit(bs[i].map(ADD1).sum()) for i in range(4)]
        gate.set()
        outs = [np.asarray(f.result(timeout=120).toarray())
                for f in futs]
        blocker.result(timeout=30)
        assert sv.stats()["arbiter"]["in_use_bytes"] == 0
    for out, want in zip(outs, refs):
        assert _bits(out, want)               # the standalone path ran
    assert all(f.batch_width is None for f in futs)
    assert all(f.assembly_seconds is None for f in futs)


def test_concurrent_reader_waits_for_the_claimed_fill():
    bs = _bases(2)
    refs = [np.asarray(b.map(ADD1).sum().toarray()) for b in bs]
    arrs = [b.map(ADD1).sum() for b in bs]
    key = batched.batch_key(arrs[0])
    b = batched.claim(arrs, key)
    assert b is not None
    got = {}

    def reader():
        # resolve() during the claim WAITS for the batched fill, then
        # adopts it: never a second dispatch
        got["v"] = np.asarray(arrs[0].toarray())

    th = threading.Thread(target=reader)
    th.start()
    time.sleep(0.05)
    assert "v" not in got
    batched.dispatch(b, (2,))
    th.join(timeout=30)
    assert not th.is_alive()
    assert _bits(got["v"], refs[0])
    assert _bits(arrs[1].toarray(), refs[1])


def test_partial_claim_keeps_the_healthy_majority():
    bs = _bases(3)
    refs = [np.asarray(b.map(ADD1).sum().toarray()) for b in bs]
    with serve.serving(workers=1, batching={"max_batch": 4,
                                            "linger": 0.05}) as sv:
        gate, blocker = _parked(sv)
        arrs = [bs[i].map(ADD1).sum() for i in range(3)]
        futs = [sv.submit(a) for a in arrs]
        # a user thread resolves request 1 while it sits queued
        raced = np.asarray(arrs[1].toarray())
        gate.set()
        outs = [np.asarray(f.result(timeout=120).toarray())
                for f in futs]
        blocker.result(timeout=30)
    assert _bits(raced, refs[1])
    for out, want in zip(outs, refs):
        assert _bits(out, want)
    # the two healthy requests coalesced; the raced one ran standalone
    assert futs[1].batch_width is None
    assert futs[0].batch_width == 2 and futs[2].batch_width == 2


def test_unclaim_releases_readers_to_standalone():
    bs = _bases(2)
    arrs = [b.map(ADD1).sum() for b in bs]
    key = batched.batch_key(arrs[0])
    b = batched.claim(arrs, key)
    assert b is not None
    batched.unclaim(b)
    for arr, base in zip(arrs, bs):
        assert _bits(arr.toarray(), base.map(ADD1).sum().toarray())


def test_claimed_group_declines_new_members():
    b = _bases(1)[0]
    m = b.map(ADD1)
    h = m.sum()
    other = _bases(2)[1].map(ADD1).sum()
    bt = batched.claim([h, other], batched.batch_key(h))
    assert bt is not None
    # a sibling terminal arriving mid-claim does not join the claimed
    # group (try_join declines)
    v = m.var()
    assert v._spending is None or v._spending.group is not h._spending.group
    batched.dispatch(bt, (2,))
    assert _bits(h.toarray(), b.map(ADD1).sum().toarray())
    assert _bits(v.toarray(), b.map(ADD1).var().toarray())


def test_deferred_reduce_ignores_accumulate_like_eager():
    b = _bases(1)[0]
    eager = bolt.compute(b.map(ADD1).reduce(torch.add), accumulate="bf16")
    with serve.serving(workers=1, batching=True):
        h = b.map(ADD1).reduce(torch.add)
        assert h._spending is not None            # the door is armed
        deferred = bolt.compute(h, accumulate="bf16")
        assert _bits(deferred.toarray(), eager.toarray())
    serve.stop()


def test_estimate_fast_path_matches_admission_floor():
    from bolt_tpu_torch.serve import _estimate
    b = _bases(1)[0]
    for arr in (b.map(ADD1).sum(), b.map(ADD1).var()):
        assert _estimate(arr) == analysis.admission_floor_bytes(arr)


def test_warm_dispatches_not_counted_as_realised_coalescing():
    b = _bases(1)[0]

    def make():
        return b.map(ADD1).sum()

    with serve.serving(workers=1, batching={"max_batch": 4,
                                            "linger": 0.01}) as sv:
        c0 = engine.counters()
        batched.warm(make, buckets=sv.batching.buckets)
        c1 = engine.counters()
        assert c1["batched_dispatches"] == c0["batched_dispatches"]
        assert c1["batched_requests"] == c0["batched_requests"]
        # warm DID run the bucket programs (builds, or hits when an
        # earlier test built them)
        assert (c1["hits"] + c1["misses"]) > (c0["hits"] + c0["misses"])
        assert c1["dispatches"] > c0["dispatches"]


def test_failed_constructor_does_not_leak_the_armed_door():
    assert not batched.armed()
    with pytest.raises(ValueError, match="weight"):
        serve.Server(batching=True, weights={"a": 0})
    assert not batched.armed()
    b = _bases(1)[0]
    assert b.map(ADD1).reduce(torch.add)._spending is None


def test_gather_width_capped_by_the_arbiter_budget():
    # 4 queued same-key requests whose COMBINED batched footprint
    # (members + a stacked copy, about 2x) exceeds the budget: the gather
    # caps the width so coalescing cannot bypass the arbitration that
    # would have serialised them standalone
    shape = (4096, 32)                     # 512 KB a request
    bs = _bases(4, shape=shape)
    refs = [np.asarray(b.map(ADD1).sum().toarray()) for b in bs]
    est = bs[0]._data.numel() * bs[0]._data.element_size()
    budget = int(4.5 * est)                # fits 2 lanes + stack, not 4
    with serve.serving(workers=1, budget_bytes=budget,
                       batching={"max_batch": 4, "linger": 0.05}) as sv:
        gate, blocker = _parked(sv)
        futs = [sv.submit(bs[i].map(ADD1).sum()) for i in range(4)]
        gate.set()
        outs = [np.asarray(f.result(timeout=120).toarray())
                for f in futs]
        blocker.result(timeout=30)
        assert sv.stats()["arbiter"]["in_use_bytes"] == 0
    for out, want in zip(outs, refs):
        assert _bits(out, want)
    assert all((f.batch_width or 1) <= 2 for f in futs)


def test_occupancy_counts_realised_dispatches_only(monkeypatch):
    h = _metrics.registry().histogram("serve.batch_occupancy.hist",
                                      lo=0, hi=9)
    h.reset()
    bs = _bases(3)

    def boom(batch, buckets):
        raise RuntimeError("injected")

    monkeypatch.setattr(batched, "dispatch", boom)
    with serve.serving(workers=1, batching={"max_batch": 4,
                                            "linger": 0.05}) as sv:
        gate, blocker = _parked(sv)
        futs = [sv.submit(bs[i].map(ADD1).sum()) for i in range(3)]
        gate.set()
        [f.result(timeout=120) for f in futs]
        blocker.result(timeout=30)
    # the gather degraded to standalone dispatches: NO occupancy sample
    assert h.snapshot()["count"] == 0


# ---------------------------------------------------------------------
# Server.stop with queued-but-unstarted requests
# ---------------------------------------------------------------------

def _park_and_queue(sv, batchable):
    bs = _bases(4)
    gate = threading.Event()
    blocker = sv.submit(lambda: gate.wait(10))
    time.sleep(0.05)                   # the worker is inside the blocker
    if batchable:
        futs = [sv.submit(bs[i].map(ADD1).sum()) for i in range(4)]
    else:
        futs = [sv.submit(lambda i=i: i) for i in range(4)]
    return gate, blocker, futs


@pytest.mark.parametrize("batching", [None, {"max_batch": 4,
                                             "linger": 0.01}])
@pytest.mark.parametrize("batchable", [True, False])
def test_stop_fails_queued_unstarted_futures_pointedly(batching, batchable):
    sv = serve.start(workers=1, batching=batching)
    try:
        gate, blocker, futs = _park_and_queue(sv, batchable)
        releaser = threading.Thread(target=lambda: (time.sleep(0.2),
                                                    gate.set()))
        releaser.start()
        t0 = time.perf_counter()
        serve.stop(wait=False)
        elapsed = time.perf_counter() - t0
        releaser.join()
        assert elapsed < 8.0                        # no hang
        for f in futs:
            with pytest.raises(RuntimeError,
                               match="closed before this job ran"):
                f.result(timeout=5)
            assert f.done() and f.batch_width is None
        assert sv.arbiter.in_use() == 0
        assert sv.arbiter.waiting() == 0
    finally:
        if serve.active() is sv:
            serve.stop(wait=False)


def test_close_wait_true_drains_queued_batched_jobs():
    bs = _bases(3)
    refs = [np.asarray(b.map(ADD1).sum().toarray()) for b in bs]
    sv = serve.start(workers=1, batching={"max_batch": 4,
                                          "linger": 0.01})
    try:
        gate = threading.Event()
        blocker = sv.submit(lambda: gate.wait(10))
        time.sleep(0.05)
        futs = [sv.submit(bs[i].map(ADD1).sum()) for i in range(3)]
        gate.set()
        serve.stop(wait=True)          # drain: queued jobs RUN first
        for f, want in zip(futs, refs):
            assert _bits(f.result(timeout=5).toarray(), want)
        assert blocker.done()
    finally:
        if serve.active() is sv:
            serve.stop(wait=False)


# ---------------------------------------------------------------------
# span / arbiter hygiene
# ---------------------------------------------------------------------

def test_batched_serving_leaks_no_spans_or_bytes():
    bs = _bases(4)
    obs.clear()
    obs.enable()
    try:
        with serve.serving(workers=2, batching={"max_batch": 4,
                                                "linger": 0.02}) as sv:
            futs = [sv.submit(bs[i % 4].map(ADD1).sum(),
                              tenant="t%d" % (i % 2)) for i in range(8)]
            [f.result(timeout=120) for f in futs]
            assert sv.stats()["arbiter"]["in_use_bytes"] == 0
        assert obs.active_count() == 0
        names = {s.name for s in obs.spans()}
        assert "serve.batch" in names
        assert "serve.batched_dispatch" in names
    finally:
        obs.disable()
        obs.clear()


# ---------------------------------------------------------------------
# width autotuning
# ---------------------------------------------------------------------

def test_autotune_buckets_derive_from_occupancy_histogram():
    hist = [(1.0, 0), (2.0, 10), (4.0, 30), (8.0, 1), (16.0, 0),
            (float("inf"), 0)]
    got = batched.autotune_buckets(hist, max_batch=16, min_share=0.05)
    assert got == (2, 4, 16)
    assert batched.autotune_buckets(
        [(2.0, 1), (float("inf"), 5)], max_batch=8) == (2, 8)
    assert batched.autotune_buckets([(2.0, 0)], max_batch=8) is None


def test_autotune_exact_power_occupancy_keeps_its_width():
    got = batched.autotune_buckets([(8.0, 100)], max_batch=16)
    assert got == (4, 8, 16)
    assert batched.bucket_width(4, got) == 4


def test_batch_policy_rearm_respects_the_autotune_knob():
    static = serve.BatchPolicy(max_batch=16)
    before = static.buckets
    assert static.rearm([(4.0, 100), (float("inf"), 0)]) is False
    assert static.buckets == before            # static knobs untouched

    tuned = serve.BatchPolicy(max_batch=16, autotune=True)
    assert "autotune" in repr(tuned)
    assert tuned.rearm([(4.0, 100), (float("inf"), 0)]) is True
    assert tuned.buckets == (2, 4, 16)
    assert tuned.buckets[-1] == tuned.max_batch
    assert tuned.rearm([(4.0, 0)]) is False
    assert tuned.buckets == (2, 4, 16)


def test_warm_rearms_an_autotune_policy_from_live_occupancy():
    bs = _bases(8)

    def make(i=0):
        return bs[i % 8].map(ADD1).sum()

    pol = serve.BatchPolicy(max_batch=8, linger=0.05, autotune=True)
    with serve.serving(workers=1, queue_limit=64, batching=pol) as sv:
        assert sv.batching is pol
        gate, blocker = _parked(sv)
        futs = [sv.submit(make(i), tenant="t") for i in range(4)]
        gate.set()
        [f.result(timeout=60) for f in futs]
        blocker.result(timeout=30)
        before = tuple(pol.buckets)
        warmed = batched.warm(make, policy=pol)
        assert tuple(warmed) == tuple(pol.buckets)
        assert pol.buckets[-1] == pol.max_batch
        assert set(pol.buckets) <= set(before) | {pol.max_batch}


def test_warm_with_static_policy_keeps_buckets():
    bs = _bases(4)

    def make(i=0):
        return bs[i % 4].map(ADD1).sum()

    pol = serve.BatchPolicy(max_batch=4)
    with serve.serving(workers=1, batching=pol) as sv:
        before = tuple(sv.batching.buckets)
        warmed = batched.warm(make, policy=pol)
        assert tuple(pol.buckets) == before
        assert tuple(warmed) == before


# ---------------------------------------------------------------------
# the lanes wrapper and every batched terminal, on the CPU
# ---------------------------------------------------------------------

@pytest.mark.parametrize("cols", [False, True])
def test_lanes_wrapper_plain_equals_standalone_per_lane(cols):
    from bolt_tpu_torch.ops import mapexpr
    xs = [torch.from_numpy(_records(i, (16, 12))) for i in range(5)]
    prog = mapexpr.compile((ADD1,), (12,) if cols else (16, 12),
                           torch.float32)
    out = K.fused_map_reduce_lanes(xs, prog, cols=cols)
    assert out.shape == ((5, 12) if cols else (5,))
    for i, x in enumerate(xs):
        one = K.fused_map_reduce_cols(x, prog) if cols else \
            K.fused_map_reduce_program(x, prog)
        assert torch.equal(out[i], one)
    with pytest.raises(ValueError, match="one shape"):
        K.fused_map_reduce_lanes([xs[0], xs[0][:8]], prog, cols=cols)


@pytest.mark.parametrize("name", ["sum", "mean", "var", "std", "min", "max",
                                  "prod", "ptp", "reduce", "chain"])
def test_every_batched_terminal_equals_its_standalone(name):
    bs = _bases(4, shape=(24, 3, 4))

    def make(i):
        m = bs[i].map(ADD1)
        if name == "chain":
            return m
        if name == "reduce":
            return m.reduce(torch.add)
        return getattr(m, name)()

    with serve.serving(workers=1, batching={"max_batch": 4,
                                            "linger": 0.05}) as sv:
        want = [np.asarray(make(i).toarray()) for i in range(4)]
        gate, blocker = _parked(sv)
        futs = [sv.submit(make(i)) for i in range(4)]
        gate.set()
        outs = [np.asarray(f.result(timeout=120).toarray())
                for f in futs]
        blocker.result(timeout=30)
    for got, w in zip(outs, want):
        assert _bits(got, w)
    assert all(f.batch_width == 4 for f in futs)


def test_blt015_forecast_gated_on_a_batching_server(mesh):
    """The checker half of the reference's BLT015 test, beside the
    reference's own forecasts on the same pipelines."""
    from bolt_tpu import analysis as ref_analysis, serve as ref_serve
    b = _bases(1)[0]
    rb = ref.array(_records(0, (32, 8)), mesh)
    assert not analysis.check(b.map(ADD1).sum()).has("BLT015")
    with ref_serve.serving(workers=1, batching=True):
        want = [ref_analysis.check(p).has("BLT015") for p in (
            rb.map(REF_ADD1).sum(), rb.map(REF_ADD1),
            rb.map(REF_ADD1).filter(lambda v: v.sum() > 0))]
    with serve.serving(workers=1, batching=True):
        got = [analysis.check(p).has("BLT015") for p in (
            b.map(ADD1).sum(), b.map(ADD1),
            b.map(ADD1).filter(lambda v: v.sum() > 0))]
        [d] = [d for d in analysis.check(b.map(ADD1).sum()).diagnostics
               if d.code == "BLT015"]
        assert d.severity == "info" and "stat form" in d.message
    assert got == want == [True, True, False]
    assert not analysis.check(b.map(ADD1).sum()).has("BLT015")
