"""The pod liveness layer of the port (``bolt_tpu_torch/parallel/
podwatch.py``), the in-process half: counterparts of the reference's
``tests/test_podwatch.py``, test for test.

Transports, the heartbeat watch and its death latch, the collective
watchdog (``wait_ready``/``reraise``/``check``/``guard``), the watchdog
barrier, the serving layer's drain and resume, the checkpoint layer's
pod abort format and topology remap, BLT013.  "Peers" are FAKES (the
test writes their heartbeat files), so everything runs in one process;
the real kill -9 scenarios live in ``tests/test_torch_pod_recovery.py``.

Where the two packages can meet they are held against each other: the
reference's ``FileTransport`` reads what the port's writes (the same
marker names), and both classifiers agree on the transport signatures.
Timings are the reference's bounds (a verdict within 2x the deadline).
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from bolt_tpu.parallel import podwatch as ref_podwatch

import bolt_tpu_torch as bolt
from bolt_tpu_torch import _chaos, _lockdep, checkpoint, obs, serve
from bolt_tpu_torch.parallel import multihost, podwatch
from bolt_tpu_torch.parallel.podwatch import (FileTransport, PeerLostError,
                                              is_transport_error)

CPU = torch.device("cpu")

# the messages the installed torch's gloo raises at a dead peer (found
# by killing one rank of a two-rank pod) and past the group timeout
GLOO_CLOSED = ("[/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:553] "
               "Connection closed by peer [127.0.0.1]:44948. This is "
               "typically caused by a remote worker crashing.")
GLOO_TIMEOUT = ("[/pytorch/third_party/gloo/gloo/transport/tcp/"
                "unbound_buffer.cc:78] Timed out waiting 2000ms for recv "
                "operation to complete")
GLOO_PAIR = "Application timeout caused pair closure"


@pytest.fixture
def watchdir(tmp_path):
    """A clean watch per test: no stray callbacks, no running watch, the
    lock witness armed, the serve counters put back."""
    with podwatch._CB_LOCK:
        saved_d = dict(podwatch._DEATH_CBS)
        saved_r = dict(podwatch._REFORM_CBS)
        podwatch._DEATH_CBS.clear()
        podwatch._REFORM_CBS.clear()
    before = len(_lockdep.violations())
    was = _lockdep.enabled()
    _lockdep.enable()
    yield str(tmp_path)
    podwatch.stop()
    _chaos.clear()
    if not was:
        _lockdep.disable()
    with podwatch._CB_LOCK:
        podwatch._DEATH_CBS.clear()
        podwatch._REFORM_CBS.clear()
        podwatch._DEATH_CBS.update(saved_d)
        podwatch._REFORM_CBS.update(saved_r)
    from bolt_tpu_torch.obs import metrics as _metrics
    reg = _metrics.registry()
    for name in list(reg.names()):
        if name == "serve" or name.startswith("serve/"):
            m = reg.get(name)
            if hasattr(m, "reset"):
                m.reset()
    new = _lockdep.violations()[before:]
    assert not new, "lockdep violations during test:\n" + "\n".join(new)


class _FakePeer:
    """A background thread impersonating pod rank ``pid`` on the file
    transport: beats until told to die (or to say farewell)."""

    def __init__(self, transport, pid, interval=0.03):
        self.transport = transport
        self.pid = pid
        self.interval = interval
        self.stop_ev = threading.Event()
        self.seq = 0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop_ev.is_set():
            self.seq += 1
            self.transport.beat(self.pid, self.seq)
            self.stop_ev.wait(self.interval)

    def kill(self):
        self.stop_ev.set()
        self.thread.join()

    def farewell(self):
        self.transport.farewell(self.pid)
        self.kill()


def _start(watchdir, nproc=2, pid=0, interval=0.05, timeout=0.4):
    assert podwatch.start(nproc, pid, dir=watchdir, interval=interval,
                          timeout=timeout)
    return podwatch._WATCH.transport


# ---------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------

def test_peerlost_error_attrs():
    e = PeerLostError("gone", peer=2, slab=7, phase="slab program")
    assert e.peer == 2 and e.slab == 7 and e.phase == "slab program"
    assert isinstance(e, RuntimeError)
    # the re-exports: one type wherever a caller catches it
    assert serve.PeerLostError is PeerLostError
    assert multihost.PeerLostError is PeerLostError


@pytest.mark.parametrize("text,want", [
    ("UNKNOWN: Gloo all-reduce failed: Connection closed by peer", True),
    ("UNAVAILABLE: failed to send RPC to coordination service", True),
    ("shape mismatch (3, 4)", False),
    (GLOO_CLOSED, True), (GLOO_TIMEOUT, True), (GLOO_PAIR, True)])
def test_transport_error_classifier(text, want):
    assert is_transport_error(ValueError(text)) is want
    if "Gloo" in text or "coordination" in text or "shape" in text:
        # the reference's own cases: both classifiers agree
        assert ref_podwatch.is_transport_error(ValueError(text)) is want


def test_file_transport_roundtrip(tmp_path):
    t = FileTransport(str(tmp_path), epoch=3)
    t.beat(0, 1)
    t.beat(1, 5)
    assert t.read() == {0: 1, 1: 5}
    t.beat(1, 6)
    assert t.read()[1] == 6
    assert t.read_farewells() == set()
    t.farewell(1)
    assert t.read_farewells() == {1}
    assert t.read() == {0: 1, 1: 6}   # a farewell is not a beat
    # barrier markers
    t.barrier_mark("ck", 0, 0)
    t.barrier_mark("ck", 0, 1)
    assert t.barrier_seen("ck", 0) == {0, 1}
    t.barrier_mark("ck", 2, 0)
    t.barrier_sweep("ck", 2, 0)       # removes own generation-0 marker
    assert t.barrier_seen("ck", 0) == {1}
    # the reference's transport reads the same markers
    rt = ref_podwatch.FileTransport(str(tmp_path), epoch=3)
    assert rt.read_farewells() == {1}
    assert rt.barrier_seen("ck", 0) == {1}


def test_watch_defaults_off_single_process(watchdir):
    assert podwatch.start(1, 0, dir=watchdir) is False
    assert not podwatch.active()
    assert podwatch.deadline() is None
    assert podwatch.dead_peers() == ()
    podwatch.check()                  # no-op without a watch
    podwatch.wait_ready(object())     # ditto
    assert podwatch.start(4, 0, dir=watchdir, timeout=0) is False


# ---------------------------------------------------------------------
# the death latch
# ---------------------------------------------------------------------

def test_peer_death_detected_and_latched(watchdir):
    deaths = []
    podwatch.on_peer_death(deaths.append)
    t = _start(watchdir)
    peer = _FakePeer(t, 1)
    try:
        deadline = time.monotonic() + 2.0
        while 1 not in {p for p, st in podwatch.peers().items()
                        if st["alive"]} and time.monotonic() < deadline:
            time.sleep(0.02)
        assert podwatch.peers()[1]["alive"]
        peer.kill()                   # the preemption
        t0 = time.monotonic()
        while not podwatch.dead_peers() and \
                time.monotonic() - t0 < 5 * 0.4:
            time.sleep(0.02)
        took = time.monotonic() - t0
        assert podwatch.dead_peers() == (1,)
        # the watchdog bound: a verdict within 2x the deadline
        assert took < 2 * 0.4 + 0.2
        assert deaths == [1]
        assert podwatch.alive_peers() == (0,)
        with pytest.raises(PeerLostError) as ei:
            podwatch.check(phase="unit", slab=3)
        assert ei.value.peer == 1 and ei.value.slab == 3
    finally:
        peer.kill()


def test_farewelled_peer_is_not_dead(watchdir):
    deaths = []
    podwatch.on_peer_death(deaths.append)
    t = _start(watchdir)
    peer = _FakePeer(t, 1)
    try:
        time.sleep(0.15)
        peer.farewell()               # leaves for a reform: silent, alive
        time.sleep(1.2)               # >> timeout
        assert podwatch.dead_peers() == ()
        assert deaths == []
        assert 1 in podwatch.alive_peers()
    finally:
        peer.kill()


def test_mark_dead_and_callbacks_once(watchdir):
    deaths = []
    h = podwatch.on_peer_death(deaths.append)
    _start(watchdir, nproc=3)
    podwatch.mark_dead(2)
    podwatch.mark_dead(2)             # latched: fires once
    assert deaths == [2]
    podwatch.remove_callback(h)
    podwatch.mark_dead(1)
    assert deaths == [2]              # deregistered


def test_coordination_error_latch(watchdir):
    """The reference's coordination-service latch has no counterpart (a
    torch.distributed pod has no coordination service); its job, a
    verdict from outside the heartbeat scan, is ``mark_dead`` naming the
    rank, which ``check()`` raises on."""
    assert not hasattr(podwatch, "coordination_error")
    deaths = []
    podwatch.on_peer_death(deaths.append)
    _start(watchdir, nproc=3)
    podwatch.mark_dead(2)
    assert deaths == [2]
    with pytest.raises(PeerLostError) as ei:
        podwatch.check()
    assert ei.value.peer == 2


def test_heartbeat_chaos_seam(watchdir):
    _chaos.inject("podwatch.heartbeat", nth=2, times=1)
    _start(watchdir)
    deadline = time.monotonic() + 2.0
    while _chaos.stats("podwatch.heartbeat")[0] < 3 and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    hits, trips = _chaos.stats("podwatch.heartbeat")
    assert hits >= 3 and trips == 1   # the raise was absorbed, the
    w = podwatch._WATCH               # watch kept beating
    assert w.beat_errors == 1


# ---------------------------------------------------------------------
# the collective watchdog
# ---------------------------------------------------------------------

class _NeverReady:
    def is_completed(self):
        return False


class _ReadyAfter:
    def __init__(self, n):
        self.n = n

    def is_completed(self):
        self.n -= 1
        return self.n <= 0


def test_wait_ready_returns_when_ready(watchdir):
    """A fake ``Work``, then a real one: an async gloo all_reduce of a
    one-rank pod brought up through ``multihost``."""
    import torch.distributed as dist
    t = _start(watchdir)
    peer = _FakePeer(t, 1)
    try:
        podwatch.wait_ready(_ReadyAfter(3), phase="unit")
        podwatch.wait_ready([_ReadyAfter(2), (_ReadyAfter(1),)])
        assert multihost.initialize(num_processes=1, process_id=0,
                                    device=CPU)
        try:
            x = torch.ones(4)
            work = dist.all_reduce(x, async_op=True)
            podwatch.wait_ready(work)
            assert work.is_completed()
            work.wait()
        finally:
            multihost.shutdown()
    finally:
        peer.kill()


def test_wait_ready_raises_on_dead_peer(watchdir):
    _start(watchdir, timeout=0.3)
    # peer 1 never beats: latched dead ~one timeout after start
    with pytest.raises(PeerLostError) as ei:
        podwatch.wait_ready(_NeverReady(), phase="slab-partial sync",
                            slab=5)
    assert ei.value.slab == 5
    assert ei.value.peer == 1


def test_reraise_classifies_transport_errors(watchdir):
    _start(watchdir, timeout=0.2)
    podwatch.mark_dead(1)
    gloo = RuntimeError(GLOO_CLOSED)
    with pytest.raises(PeerLostError) as ei:
        podwatch.reraise(gloo, phase="slab program", slab=2)
    assert ei.value.peer == 1
    assert ei.value.__cause__ is gloo
    # an unrelated error passes through untouched
    boom = ValueError("shape mismatch")
    podwatch._WATCH.dead.clear()
    with pytest.raises(ValueError, match="shape mismatch"):
        podwatch.reraise(boom, wait=False)
    # a transport error with nobody latched yet still converts (the
    # fast shape of a death), naming no peer
    with pytest.raises(PeerLostError) as ei:
        podwatch.reraise(RuntimeError(GLOO_TIMEOUT), wait=False)
    assert ei.value.peer is None


def test_reraise_classifies_secondary_deleted_array(watchdir):
    """A secondary sign converts to PeerLostError only when the
    heartbeat actually latched someone (within the grace window)."""
    _start(watchdir, timeout=0.2)
    deleted = RuntimeError("Array has been deleted with shape=float32[8].")
    assert podwatch.is_secondary_sign(deleted)
    assert not podwatch.is_transport_error(deleted)
    with pytest.raises(RuntimeError, match="has been deleted"):
        podwatch.reraise(deleted, wait=False)
    podwatch.mark_dead(1)
    with pytest.raises(PeerLostError) as ei:
        podwatch.reraise(deleted, phase="slab program", slab=3)
    assert ei.value.peer == 1
    assert ei.value.__cause__ is deleted
    # the grace window: the peer latches dead WHILE reraise waits
    podwatch._WATCH.dead.clear()
    t = threading.Timer(0.1, podwatch.mark_dead, args=(1,))
    t.start()
    try:
        with pytest.raises(PeerLostError) as ei:
            podwatch.reraise(deleted, phase="slab program", slab=4)
        assert ei.value.peer == 1
    finally:
        t.cancel()


def test_guard_contextmanager(watchdir):
    _start(watchdir, timeout=0.2)
    with podwatch.guard("unit"):
        pass                          # clean body passes through
    # a slab-less loss from inside (a collective's own watchdog) gains
    # the guard's slab
    with pytest.raises(PeerLostError) as ei:
        with podwatch.guard("slab program", slab=6):
            raise PeerLostError("lost", peer=1, phase="collective")
    assert ei.value.slab == 6 and ei.value.peer == 1
    podwatch.mark_dead(1)
    with pytest.raises(PeerLostError):
        with podwatch.guard("unit"):
            raise AssertionError("body must not run on a latched peer")


# ---------------------------------------------------------------------
# the watchdog barrier
# ---------------------------------------------------------------------

def test_barrier_completes_with_live_peer(watchdir):
    t = _start(watchdir)
    peer = _FakePeer(t, 1)
    try:
        done = []

        def arrive_late():
            time.sleep(0.15)
            t.barrier_mark("sync", 0, 1)
            done.append(True)

        th = threading.Thread(target=arrive_late, daemon=True)
        th.start()
        podwatch.barrier("sync")
        th.join()
        assert done == [True]
        # generation counting: a SECOND barrier of the same name waits
        # for generation-1 markers, not the stale generation-0 ones
        t.barrier_mark("sync", 1, 1)
        podwatch.barrier("sync")
    finally:
        peer.kill()


def test_barrier_converts_dead_peer(watchdir):
    t = _start(watchdir, timeout=0.3)
    peer = _FakePeer(t, 1)
    try:
        time.sleep(0.1)
        peer.kill()                   # dies before ever arriving
        t0 = time.monotonic()
        with pytest.raises(PeerLostError) as ei:
            podwatch.barrier("ckpt_w4")
        assert time.monotonic() - t0 < 2 * 0.3 + 0.3
        assert ei.value.peer == 1
        assert "barrier" in (ei.value.phase or "")
    finally:
        peer.kill()


def test_multihost_barrier_routes_through_watch(watchdir, monkeypatch):
    """multihost.barrier hits the chaos seam and the watchdog barrier
    while a watch runs (one process short-circuits first, so the width
    is faked)."""
    t = _start(watchdir)
    peer = _FakePeer(t, 1)
    try:
        monkeypatch.setattr(multihost, "process_count", lambda: 2)
        _chaos.inject("multihost.barrier", nth=1)
        with pytest.raises(_chaos.ChaosError):
            multihost.barrier("seamcheck")
        _chaos.clear()
        peer.kill()
        with pytest.raises(PeerLostError):
            multihost.barrier("deadcheck")
    finally:
        peer.kill()


# ---------------------------------------------------------------------
# serve: drain on death, resume on reform, retryable loss
# ---------------------------------------------------------------------

def test_serve_drains_and_resumes_on_pod_events(watchdir):
    t = _start(watchdir)
    peer = _FakePeer(t, 1)
    try:
        with serve.serving(workers=1, policy="reject") as sv:
            assert not sv.pod_paused()
            peer.kill()
            t0 = time.monotonic()
            while not sv.pod_paused() and time.monotonic() - t0 < 3:
                time.sleep(0.02)
            assert sv.pod_paused()
            assert sv.stats()["pod"]["paused"]
            assert sv.stats()["totals"]["peer_losses"] == 1
            with pytest.raises(serve.AdmissionError,
                               match="pod peer 1 was lost"):
                sv.submit(lambda: 42)
            podwatch.notify_reform()  # the reform completed
            assert not sv.pod_paused()
            assert sv.submit(lambda: 42).result(timeout=30) == 42
    finally:
        peer.kill()


def test_serve_retry_waits_out_the_reform(watchdir):
    t = _start(watchdir)
    peer = _FakePeer(t, 1)
    try:
        with serve.serving(workers=1) as sv:
            attempts = []

            def flaky():
                attempts.append(1)
                if len(attempts) == 1:
                    podwatch.mark_dead(1)     # the pod outage
                    raise PeerLostError("lost", peer=1)
                return "recovered"

            fut = sv.submit(flaky, tenant="t", retries=1)
            time.sleep(0.3)
            assert not fut.done()     # held behind the drain
            podwatch.notify_reform()
            assert fut.result(timeout=30) == "recovered"
            assert len(attempts) == 2
            assert sv.stats()["totals"]["retried"] == 1
    finally:
        peer.kill()


def test_serve_queue_policy_blocks_submit_during_drain(watchdir):
    t = _start(watchdir)
    peer = _FakePeer(t, 1)
    try:
        with serve.serving(workers=1, policy="queue") as sv:
            peer.kill()
            t0 = time.monotonic()
            while not sv.pod_paused() and time.monotonic() - t0 < 3:
                time.sleep(0.02)
            got = []

            def submit_blocked():
                got.append(sv.submit(lambda: "ok").result(timeout=30))

            th = threading.Thread(target=submit_blocked, daemon=True)
            th.start()
            time.sleep(0.3)
            assert got == []          # backpressure while draining
            podwatch.notify_reform()
            th.join(timeout=30)
            assert got == ["ok"]
    finally:
        peer.kill()


def test_serve_close_terminates_during_held_retry(watchdir):
    """close(wait=True) terminates even while a PeerLostError retry is
    held behind the drain and the reform never comes."""
    t = _start(watchdir)
    peer = _FakePeer(t, 1)
    try:
        sv = serve.start(workers=1)
        try:
            def doomed():
                podwatch.mark_dead(1)
                raise PeerLostError("lost", peer=1)

            fut = sv.submit(doomed, tenant="t", retries=3)
            t0 = time.monotonic()
            while not sv.pod_paused() and time.monotonic() - t0 < 3:
                time.sleep(0.02)
            assert sv.pod_paused()
        finally:
            t0 = time.monotonic()
            serve.stop(wait=True)     # must NOT deadlock
        assert time.monotonic() - t0 < 10
        assert isinstance(fut.exception(timeout=1), RuntimeError)
    finally:
        peer.kill()


def test_sustained_transport_failure_is_a_liveness_verdict(watchdir):
    """A transport that stops answering for a whole deadline (rank 0's
    TCPStore died, the shared dir is gone) latches a verdict, so guarded
    syncs raise instead of polling a silent watch forever.  Rank 1 beats
    until the store goes, so the last successful scan never finds a peer
    past its deadline, however late the sleep wakes."""
    t = _start(watchdir, timeout=0.3)
    peer = _FakePeer(t, 1)
    time.sleep(0.1)
    peer.kill()
    # the store is gone: moved aside in one step (a removal racing the
    # watch's next write could find a file it never listed), then
    # removed; every beat now fails
    os.rename(watchdir, watchdir + ".gone")
    shutil.rmtree(watchdir + ".gone")
    t0 = time.monotonic()             # now fails
    while time.monotonic() - t0 < 5 * 0.3:
        try:
            podwatch.check(phase="unit")
        except PeerLostError as e:
            assert "liveness transport failing" in str(e)
            break
        time.sleep(0.05)
    else:
        raise AssertionError("transport failure never latched")


# ---------------------------------------------------------------------
# span hygiene
# ---------------------------------------------------------------------

def test_watch_leaks_no_spans(watchdir):
    obs.clear()
    obs.enable()
    try:
        t = _start(watchdir)
        peer = _FakePeer(t, 1)
        time.sleep(0.3)
        peer.kill()
        deadline = time.monotonic() + 2.0
        while not podwatch.dead_peers() and time.monotonic() < deadline:
            time.sleep(0.02)
        with pytest.raises(PeerLostError):
            podwatch.barrier("leakcheck")
        podwatch.stop()
        assert obs.active_count() == 0
    finally:
        obs.disable()


# ---------------------------------------------------------------------
# checkpoint: the pod abort format and the topology remap
# ---------------------------------------------------------------------

@pytest.fixture
def pod3(monkeypatch):
    """A faked 3-rank pod for the checkpoint layer: no-op barriers and a
    settable rank."""
    cell = {"pid": 0}
    monkeypatch.setattr(multihost, "process_count", lambda: 3)
    monkeypatch.setattr(multihost, "process_index", lambda: cell["pid"])
    monkeypatch.setattr(multihost, "barrier", lambda name: None)
    return cell


def _save_all(tmp_path, pod3, fp, slabs, records, val, nproc=3):
    for pid in range(nproc):
        pod3["pid"] = pid
        checkpoint.stream_save(str(tmp_path), fp, slabs, records,
                               ([np.full(3, val, np.float32)], None),
                               multiprocess=True)
    pod3["pid"] = 0


def _leaf(got):
    return got[2][0][0].numpy()


def test_pod_abort_save_meta_advances_only(tmp_path, pod3):
    fp = ("fp-abort",)
    _save_all(tmp_path, pod3, fp, 4, 48, 4.0)
    # an abort at a LOWER watermark must not regress the meta
    checkpoint.stream_save(str(tmp_path), fp, 3, 36,
                           ([np.full(3, 3.0, np.float32)], None),
                           multiprocess=True, rendezvous=False)
    got = checkpoint.stream_load(str(tmp_path), fp, multiprocess=True)
    assert got[0] == 4
    # an abort at a HIGHER watermark advances it (no barrier, "abort")
    checkpoint.stream_save(str(tmp_path), fp, 5, 60,
                           ([np.full(3, 5.0, np.float32)], None),
                           multiprocess=True, rendezvous=False)
    got = checkpoint.stream_load(str(tmp_path), fp, multiprocess=True)
    assert got[0] == 5
    assert np.array_equal(_leaf(got), np.full(3, 5.0, np.float32))
    assert checkpoint._read_meta(str(tmp_path)).get("abort") is True


def test_torn_abort_never_flips_meta(tmp_path, pod3):
    """A fault between the abort's state write and its meta rename (the
    checkpoint.meta seam) leaves the OLD meta intact and loadable."""
    fp = ("fp-torn",)
    _save_all(tmp_path, pod3, fp, 4, 48, 4.0)
    _chaos.inject("checkpoint.meta", nth=1)
    try:
        with pytest.raises(_chaos.ChaosError):
            checkpoint.stream_save(
                str(tmp_path), fp, 6, 72,
                ([np.full(3, 6.0, np.float32)], None),
                multiprocess=True, rendezvous=False)
    finally:
        _chaos.clear()
    got = checkpoint.stream_load(str(tmp_path), fp, multiprocess=True)
    assert got[0] == 4
    assert np.array_equal(_leaf(got), np.full(3, 4.0, np.float32))


def test_topology_remap_load_after_shrink(tmp_path, pod3, monkeypatch):
    """A checkpoint cut by a 3-rank pod loads on a 2-rank (and a 1-rank)
    topology: any surviving shard is a whole resume point, and the remap
    is reported through ``info``."""
    fp = ("fp-remap",)
    _save_all(tmp_path, pod3, fp, 4, 48, 7.0)
    # the shrunk pod: old rank 1's shard may even be missing
    os.remove(os.path.join(str(tmp_path), "stream_state.p1.w4.npz"))
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    for newpid in (0, 1):
        pod3["pid"] = newpid
        info = {}
        got = checkpoint.stream_load(str(tmp_path), fp,
                                     multiprocess=True, info=info)
        assert got is not None and got[0] == 4 and got[1] == 48
        assert np.array_equal(_leaf(got), np.full(3, 7.0, np.float32))
        assert info == {"remapped_from": 3}
    # ...and on a single process
    monkeypatch.setattr(multihost, "process_count", lambda: 1)
    pod3["pid"] = 0
    info = {}
    got = checkpoint.stream_load(str(tmp_path), fp, multiprocess=False,
                                 info=info)
    assert got is not None and got[0] == 4
    assert info == {"remapped_from": 3}
    # a resumed run's next save records the remap
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    for newpid in (0, 1):
        pod3["pid"] = newpid
        checkpoint.stream_save(str(tmp_path), fp, 6, 72,
                               ([np.full(3, 9.0, np.float32)], None),
                               multiprocess=True, remap_from=3)
    meta = checkpoint._read_meta(str(tmp_path))
    assert meta["nproc"] == 2 and meta["remapped_from"] == 3
    # clearing on the SHRUNK pod sweeps every rank's shards
    pod3["pid"] = 0
    checkpoint.stream_clear(str(tmp_path), multiprocess=True)
    assert [p for p in os.listdir(str(tmp_path))
            if p.startswith("stream_")] == []


def test_single_process_clear_sweeps_pod_files(tmp_path, pod3,
                                               monkeypatch):
    fp = ("fp-sweep",)
    _save_all(tmp_path, pod3, fp, 2, 24, 1.0)
    monkeypatch.setattr(multihost, "process_count", lambda: 1)
    checkpoint.stream_clear(str(tmp_path), multiprocess=False)
    assert [p for p in os.listdir(str(tmp_path))
            if p.startswith("stream_")] == []


# ---------------------------------------------------------------------
# BLT013: a pod stream without a recovery path (a stream on an unbound
# two-rank layout, checked but never run)
# ---------------------------------------------------------------------

def ADD1(v):
    return v + 1


def _streamed(monkeypatch):
    """A stream source on a two-rank layout the checker sees as a pod
    (BLT012 quieted: it has its own tests)."""
    from bolt_tpu_torch import convert, stream
    lay = convert.mesh_from_reference((2,), ("k",))
    x = np.zeros((8, 4), np.float32)
    src = stream.StreamSource.from_callback(
        lambda idx: x[idx], x.shape, 1, np.float32, CPU, chunks=4,
        mesh=lay)
    monkeypatch.setattr(multihost, "mesh_process_count", lambda m: 2)
    monkeypatch.setattr(multihost, "slab_divisibility_error",
                        lambda *a: None)
    return stream.as_array(src).map(ADD1)


def test_blt013_no_checkpoint_dir(monkeypatch):
    from bolt_tpu_torch import analysis
    rep = analysis.check(_streamed(monkeypatch))
    assert rep.has("BLT013")
    d = [d for d in rep.diagnostics if d.code == "BLT013"][0]
    assert d.severity == "warning"
    assert "NO checkpoint dir" in d.message
    assert rep.ok                     # a warning, not an error


def test_blt013_quiet_with_checkpoint_dir(monkeypatch, tmp_path):
    from bolt_tpu_torch import analysis, stream
    arr = _streamed(monkeypatch)
    with stream.resumable(str(tmp_path)):
        rep = analysis.check(arr)
    assert not rep.has("BLT013")


def test_blt013_sub_pod_mesh(monkeypatch, tmp_path):
    from bolt_tpu_torch import analysis, stream
    arr = _streamed(monkeypatch)
    monkeypatch.setattr(multihost, "process_count", lambda: 4)
    with stream.resumable(str(tmp_path)):
        rep = analysis.check(arr)
    assert rep.has("BLT013")
    d = [d for d in rep.diagnostics if d.code == "BLT013"][0]
    assert "SUB-POD" in d.message


def test_explain_shows_recovery_plan(monkeypatch, tmp_path):
    from bolt_tpu_torch import analysis, stream
    arr = _streamed(monkeypatch)
    txt = analysis.explain(arr)
    assert "recovery plan" in txt
    assert "PeerLostError" in txt
    assert "BLT013" in txt            # the no-checkpoint shape
    with stream.resumable(str(tmp_path)):
        txt2 = analysis.explain(arr)
    assert "resume topology" in txt2 and str(tmp_path) in txt2


def test_config_reports_watchdog(watchdir):
    cfg = podwatch.config()
    assert set(cfg) == {"timeout", "interval", "transport", "nproc"}
    assert set(cfg) == set(ref_podwatch.config())
    _start(watchdir, nproc=3, interval=0.07, timeout=0.9)
    cfg = podwatch.config()
    assert cfg["timeout"] == 0.9 and cfg["interval"] == 0.07
    assert cfg["transport"] == "file" and cfg["nproc"] == 3


def test_blt108_exempts_podwatch():
    """The heartbeat thread lives in a blessed BLT108 home."""
    from bolt_tpu_torch.analysis import astlint
    assert any(e.endswith(os.path.join("parallel", "podwatch.py"))
               for e in astlint._EXEMPT["BLT108"])


def test_kv_transport_on_a_file_store(tmp_path):
    """The store transport over a c10d ``FileStore`` (what a harness pod
    without ``BOLT_POD_HB_DIR`` rides): beats, farewells, barrier marks
    and their sweep, the rejoin log and its clear, plans, notes and the
    quiesce marker, read back rank by rank."""
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    t = podwatch.KVTransport(store, epoch=2, nproc=3)
    t.beat(0, 1)
    t.beat(2, 4)
    assert t.read() == {0: 1, 2: 4}
    t.farewell(2)
    assert t.read_farewells() == {2}
    for pid in (0, 1, 2):
        t.barrier_mark("ck", 0, pid)
    assert t.barrier_seen("ck", 0) == {0, 1, 2}
    t.barrier_mark("ck", 2, 1)
    t.barrier_sweep("ck", 2, 1)
    assert t.barrier_seen("ck", 0) == {0, 2}
    t.rejoin_mark("w:1")
    t.rejoin_mark("w2")
    assert t.read_rejoin_marks() == {"w_1", "w2"}
    t.rejoin_clear("w_1")
    assert t.read_rejoin_marks() == {"w2"}
    t.rejoin_mark("w:1")              # a later announcement rings again
    assert t.read_rejoin_marks() == {"w_1", "w2"}
    assert t.plan_gens() == [] and t.plan_get(1) is None
    t.plan_set(1, '{"gen": 1}')
    t.plan_set(2, '{"gen": 2}')
    assert t.plan_gens() == [1, 2] and t.plan_get(2) == '{"gen": 2}'
    t.note_set("sched", 1, "abc")
    assert t.note_read("sched") == {1: "abc"}
    assert not t.quiesce_seen(4)
    t.quiesce_mark(4)
    assert t.quiesce_seen(4)
    assert not podwatch.KVTransport(store, epoch=3,
                                    nproc=3).quiesce_seen(4)


def test_collective_work_polled_against_the_watch(watchdir, monkeypatch):
    """With a watch running, ``multihost``'s collectives poll their
    ``Work`` against it: a latched dead peer raises PeerLostError naming
    it instead of blocking in the wait."""
    t = _start(watchdir, timeout=0.3)
    podwatch.mark_dead(1)

    class _Pending:
        def is_completed(self):
            return False

        def wait(self):
            raise AssertionError("never blocks in C++")

    with pytest.raises(PeerLostError) as ei:
        multihost._complete(_Pending())
    assert ei.value.peer == 1
    del t


def test_bolt_array_stream_unaffected_single_process():
    """No watch in one process: a streamed run neither enters the busy
    count nor meets a rendezvous."""
    x = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    s = bolt.fromcallback(lambda idx: x[idx], (8, 4), CPU,
                          dtype=np.float32, chunks=2)
    assert np.array_equal(s.map(ADD1).sum().toarray(), (x + 1).sum(0))
    assert podwatch.pod_busy() == 0 and not podwatch.active()
