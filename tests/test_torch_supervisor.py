"""The recovery supervisor of the port (``bolt_tpu_torch/parallel/
supervisor.py``), the in-process half: counterparts of the reference's
``tests/test_supervisor.py``, test for test.

The transport's rejoin door, plan channel, quiesce markers and their
sweeps, the watch's rejoin scan, the readiness rendezvous, the
slab-boundary quiesce gate, the supervisor's elect -> plan -> reform
drive (coordinator and follower), backoff and a second failure folded
in, the giveup, the quarantine, ``serve.Server(supervise=True)``, the
checkpoint digests (``checkpoint.corrupt`` seam) and BLT014.  "Peers"
are FAKES (the test writes their heartbeat and barrier markers), so
everything runs in one process and ``multihost.reform`` is
monkeypatched to a recorder; the real 3 -> 2 -> 3 scenario lives in
``tests/test_torch_pod_recovery.py``.

``test_stream_clear_sweeps_dead_markers`` is deterministic here: the
reference's version races its own watch thread (both wrote rank 0's beat
through ONE temporary name, so one rename could find the other's file
gone); the port's ``FileTransport`` gives each writer its own temporary
name, and the test waits for the watch's own beat before sweeping.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import bolt_tpu_torch as bolt
from bolt_tpu_torch import _chaos, _lockdep, checkpoint, obs, serve
from bolt_tpu_torch.parallel import multihost, podwatch, supervisor
from bolt_tpu_torch.parallel.podwatch import (FileTransport, PeerLostError,
                                              PodQuiesceError)
from bolt_tpu_torch.parallel.supervisor import SuperviseError, Supervisor

CPU = torch.device("cpu")


@pytest.fixture
def watchdir(tmp_path):
    """A clean watch/supervisor per test: no stray callbacks, no running
    watch, no leftover quiesce latch or armed chaos; the lock witness
    armed over the test."""
    with podwatch._CB_LOCK:
        saved = {name: dict(getattr(podwatch, name)) for name in
                 ("_DEATH_CBS", "_REFORM_CBS", "_REJOIN_CBS")}
        for name in saved:
            getattr(podwatch, name).clear()
    before = len(_lockdep.violations())
    was = _lockdep.enabled()
    _lockdep.enable()
    yield str(tmp_path)
    sup = supervisor.active()
    if sup is not None:
        sup.close()
    podwatch.stop()
    podwatch.clear_quiesce()
    _chaos.clear()
    if not was:
        _lockdep.disable()
    with podwatch._CB_LOCK:
        for name, cbs in saved.items():
            getattr(podwatch, name).clear()
            getattr(podwatch, name).update(cbs)
    # serve/supervisor counters are process-wide registry groups
    from bolt_tpu_torch.obs import metrics as _metrics
    reg = _metrics.registry()
    for name in list(reg.names()):
        if name.split("/")[0] in ("serve", "supervisor"):
            m = reg.get(name)
            if hasattr(m, "reset"):
                m.reset()
    new = _lockdep.violations()[before:]
    assert not new, "lockdep violations during test:\n" + "\n".join(new)


class _FakePeer:
    """A background thread impersonating pod process ``pid`` on the
    file transport: beats (and arrives at every barrier generation)
    until told to die."""

    def __init__(self, transport, pid, interval=0.03, barriers=()):
        self.transport = transport
        self.pid = pid
        self.interval = interval
        self.barriers = barriers      # names marked at every generation
        self.stop_ev = threading.Event()
        self.seq = 0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop_ev.is_set():
            self.seq += 1
            self.transport.beat(self.pid, self.seq)
            for name in self.barriers:
                for gen in range(8):
                    self.transport.barrier_mark(name, gen, self.pid)
            self.stop_ev.wait(self.interval)

    def kill(self):
        self.stop_ev.set()
        self.thread.join()


def _start(watchdir, nproc=2, pid=0, interval=0.05, timeout=0.4,
           **kw):
    assert podwatch.start(nproc, pid, dir=watchdir, interval=interval,
                          timeout=timeout, **kw)
    return podwatch._WATCH.transport


def _wait(pred, timeout=5.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError("%s never became true" % msg)
        time.sleep(0.02)


class _ReformRecorder:
    """Stands in for ``multihost.reform``: records each drive and
    fires the reform notification like the real door."""

    def __init__(self, fail_times=0, exc=None):
        self.calls = []
        self.fail_times = fail_times
        self.exc = exc

    def __call__(self, addr, num_processes, process_id=None, epoch=None,
                 init_timeout=None, **kw):
        if self.fail_times > 0:
            self.fail_times -= 1
            raise self.exc or RuntimeError("reform bring-up failed")
        self.calls.append({"addr": addr, "nproc": int(num_processes),
                           "pid": process_id, "epoch": epoch,
                           "init_timeout": init_timeout})
        podwatch.notify_reform()
        return process_id


@pytest.fixture
def reform_recorder(monkeypatch):
    rec = _ReformRecorder()
    monkeypatch.setattr(multihost, "reform", rec)
    return rec


# ---------------------------------------------------------------------
# transport: rejoin door, plan channel, quiesce markers, hygiene
# ---------------------------------------------------------------------

def test_transport_rejoin_and_plan_roundtrip(tmp_path):
    t = FileTransport(str(tmp_path), epoch=2)
    assert t.read_rejoin_marks() == set()
    t.rejoin_mark("w1b")
    t.rejoin_mark("odd/../ident")      # sanitised, never a path escape
    marks = t.read_rejoin_marks()
    assert "w1b" in marks and len(marks) == 2
    assert all(os.sep not in m for m in marks)
    t.rejoin_clear("w1b")
    assert "w1b" not in t.read_rejoin_marks()
    # the plan channel
    assert t.plan_gens() == [] and t.plan_get(1) is None
    t.plan_set(1, '{"gen": 1}')
    t.plan_set(3, '{"gen": 3}')
    assert t.plan_gens() == [1, 3]
    assert json.loads(t.plan_get(3)) == {"gen": 3}
    # quiesce markers are epoch-scoped
    assert not t.quiesce_seen(4)
    t.quiesce_mark(4)
    assert t.quiesce_seen(4) and not t.quiesce_seen(5)
    assert not FileTransport(str(tmp_path), epoch=3).quiesce_seen(4)


def test_transport_sweeps_and_stale_count(tmp_path):
    old = FileTransport(str(tmp_path), epoch=1)
    old.beat(0, 1)
    old.beat(1, 1)
    old.quiesce_mark(2)
    for g in (1, 2, 3, 4):
        old.plan_set(g, '{"gen": %d}' % g)
    new = FileTransport(str(tmp_path), epoch=3)
    new.beat(0, 1)
    assert new.stale_marker_count() == 3      # two beats + one quiesce
    new.sweep_epochs(keep_from=2)
    assert new.stale_marker_count() == 0
    assert new.plan_gens() == [3, 4]          # two-generation grace
    assert new.read()[0] == 1                 # own epoch untouched
    # the dead-peer sweep removes one pid's markers only
    new.beat(1, 5)
    new.sweep_peer(1)
    assert 1 not in new.read() and 0 in new.read()


def test_stream_clear_sweeps_dead_markers(watchdir, tmp_path,
                                          monkeypatch):
    """checkpoint.stream_clear sweeps latched-DEAD peers' heartbeat
    markers beside its shard sweep; this rank's own beats stay."""
    t = _start(watchdir, nproc=2)
    _wait(lambda: 0 in t.read(), msg="the watch's own beat")
    t.beat(0, 1)                      # a second writer of rank 0's beat
    t.beat(1, 7)                      # the (dead) peer's droppings
    podwatch.mark_dead(1)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    monkeypatch.setattr(multihost, "barrier", lambda name: None)
    ck = tmp_path / "ck"
    ck.mkdir()
    checkpoint.stream_clear(str(ck), multiprocess=True)
    assert 1 not in t.read()
    assert 0 in t.read()              # own beats stay


# ---------------------------------------------------------------------
# the rejoin door + the watch's rejoin scan
# ---------------------------------------------------------------------

def test_rejoin_requires_a_shared_medium(monkeypatch, tmp_path):
    monkeypatch.setattr(podwatch, "_ENV_HB_DIR", None)
    with pytest.raises(RuntimeError, match="BOLT_POD_HB_DIR"):
        podwatch.rejoin("w1b")
    tr = podwatch.rejoin("w1b", dir=str(tmp_path))
    assert "w1b" in tr.read_rejoin_marks()


def test_watch_scans_rejoin_once_per_ident(watchdir):
    seen = []
    podwatch.on_rejoin(seen.append)
    t = _start(watchdir)
    peer = _FakePeer(t, 1)
    try:
        podwatch.rejoin("w1b")        # rides the running watch transport
        _wait(lambda: seen == ["w1b"], msg="rejoin fanout")
        time.sleep(0.2)               # marker still present: no re-fire
        assert seen == ["w1b"]
        podwatch.rejoin("w2b")
        _wait(lambda: seen == ["w1b", "w2b"], msg="second rejoin")
    finally:
        peer.kill()


# ---------------------------------------------------------------------
# pre-collective readiness rendezvous + the quiesce gate
# ---------------------------------------------------------------------

def test_ready_rendezvous_noop_without_watch():
    assert podwatch.ready_rendezvous() is False


def test_ready_rendezvous_live_peer_passes(watchdir):
    t = _start(watchdir)
    peer = _FakePeer(t, 1, barriers=("bolt_stream_ready",))
    try:
        assert podwatch.ready_rendezvous() is True
    finally:
        peer.kill()


def test_ready_rendezvous_converts_pre_collective_death(watchdir):
    """A peer dead BEFORE the first collective dispatch surfaces as
    PeerLostError within ~2x the deadline — the closed ~30s gloo
    connect bound."""
    _start(watchdir, timeout=0.3)     # peer 1 never beats
    t0 = time.monotonic()
    with pytest.raises(PeerLostError) as ei:
        podwatch.ready_rendezvous()
    assert time.monotonic() - t0 < 2 * 0.3 + 0.3
    assert ei.value.peer == 1


def test_quiesce_gate_raises_at_the_watermark(watchdir):
    t = _start(watchdir)
    peer = _FakePeer(t, 1, barriers=("bolt_quiesce_gate",))
    try:
        podwatch.quiesce_gate(3)      # no request: passes through
        podwatch.request_quiesce("rejoin w1b")
        assert podwatch.quiesce_requested() == "rejoin w1b"
        with pytest.raises(PodQuiesceError) as ei:
            podwatch.quiesce_gate(4)
        assert ei.value.slab == 4 and ei.value.peer is None
        assert isinstance(ei.value, PeerLostError)   # retryable alike
        assert "rejoin w1b" in str(ei.value)
        # every process sees the same watermark marker
        assert t.quiesce_seen(4) and not t.quiesce_seen(3)
        podwatch.clear_quiesce()
        podwatch.quiesce_gate(5)      # cleared: passes through again
    finally:
        peer.kill()


def test_quiesce_gate_fenced_needs_no_barrier(watchdir):
    """The per-checkpoint path: process 0 publishes its decision with
    quiesce_pre BEFORE the checkpoint, whose own rendezvous barriers
    fence the marker — quiesce_gate(fenced=True) then decides without
    a second standalone barrier.  The fake peer here never marks the
    gate barrier, so any barrier wait would latch it dead and raise
    PeerLostError instead of the expected outcomes."""
    t = _start(watchdir)
    peer = _FakePeer(t, 1)            # no gate-barrier marks
    try:
        podwatch.quiesce_pre(7)       # no request: no marker
        podwatch.quiesce_gate(7, fenced=True)     # passes through
        assert not t.quiesce_seen(7)
        podwatch.request_quiesce("rejoin w1b")
        podwatch.quiesce_pre(8)       # pre-checkpoint publish
        assert t.quiesce_seen(8)
        with pytest.raises(PodQuiesceError) as ei:
            podwatch.quiesce_gate(8, fenced=True)
        assert ei.value.slab == 8
        podwatch.clear_quiesce()
    finally:
        podwatch.clear_quiesce()
        peer.kill()


def test_quiesce_gate_latches_peer_decision(watchdir):
    """Process 0 can decide the quiesce BEFORE this process's own
    supervisor scanned the rejoin marker: the gate must latch the
    LOCAL quiesce state when it sees the marker, so the serving layer
    holds the retry instead of re-running into a reforming pod."""
    t = _start(watchdir, nproc=2, pid=1)
    peer = _FakePeer(t, 0, barriers=("bolt_quiesce_gate",))
    try:
        t.quiesce_mark(6)             # the peer decider's marker
        assert podwatch.quiesce_requested() is None
        with pytest.raises(PodQuiesceError):
            podwatch.quiesce_gate(6)
        assert "peer quiesce" in podwatch.quiesce_requested()
    finally:
        peer.kill()


def test_serve_retry_holds_during_latched_quiesce(watchdir):
    """A PeerLostError retry must hold while the local quiesce latch
    is set even though the pod is NOT paused yet (the gate-trips-first
    window of the rejoin reform)."""
    with serve.serving(workers=1) as sv:
        attempts = []

        def flaky():
            attempts.append(1)
            if len(attempts) == 1:
                podwatch.request_quiesce("rejoin ['w2b']")
                raise PodQuiesceError("quiesced", slab=4)
            return "resumed"

        fut = sv.submit(flaky, tenant="t", retries=1)
        time.sleep(0.4)
        assert not fut.done()         # held on the latch alone
        podwatch.clear_quiesce()      # the recovery completed
        assert fut.result(timeout=30) == "resumed"
        assert len(attempts) == 2


def test_pod_busy_accounting():
    assert podwatch.pod_busy() == 0
    podwatch.pod_enter()
    podwatch.pod_enter()
    assert podwatch.pod_busy() == 2
    podwatch.pod_exit()
    podwatch.pod_exit()
    podwatch.pod_exit()               # never below zero
    assert podwatch.pod_busy() == 0


def test_epoch_pinning_and_doors(watchdir):
    assert podwatch.transport() is None
    _start(watchdir, epoch=7)
    assert podwatch.epoch() == 7
    assert podwatch.transport() is podwatch._WATCH.transport
    podwatch.stop()
    _start(watchdir)                  # unpinned: bumps past the pin
    assert podwatch.epoch() == 8


# ---------------------------------------------------------------------
# the supervisor: elect -> plan -> reform
# ---------------------------------------------------------------------

def test_supervisor_coordinator_drives_reform(watchdir, reform_recorder):
    """Peer death on the lowest-rank survivor: it elects itself,
    publishes the plan through the transport, and drives reform onto
    the survivors — hooks and counters around it."""
    t = _start(watchdir, nproc=3)
    peer1 = _FakePeer(t, 1)
    peer2 = _FakePeer(t, 2)
    events = []
    sup = Supervisor(backoff=0.05,
                     on_pause=lambda r: events.append(("pause", r)),
                     on_resume=lambda i: events.append(("resume", i)))
    try:
        _wait(lambda: set(podwatch.alive_peers()) == {0, 1, 2},
              msg="3-wide pod")
        epoch0 = podwatch.epoch()
        peer2.kill()
        _wait(lambda: sup.stats()["reforms"] == 1, timeout=10,
              msg="supervised reform")
        assert sup.wait_recovered(timeout=10)
        assert [c["nproc"] for c in reform_recorder.calls] == [2]
        call = reform_recorder.calls[0]
        assert call["pid"] == 0                      # lowest alive rank
        assert call["epoch"] == epoch0 + 2           # probe slot skipped
        plan = json.loads(t.plan_get(1))
        assert plan["members"] == [["i", 0], ["i", 1]]
        assert plan["addr"].split(":")[1] == call["addr"].split(":")[1]
        assert events[0] == ("pause", "peer death [2]")
        assert events[1][0] == "resume"
        assert events[1][1]["nproc"] == 2 and events[1][1]["rejoined"] == []
        st = sup.stats()
        assert st["peer_losses"] == 1 and st["reforms"] == 1
        assert st["giveups"] == 0 and st["failed"] is None
        assert st["last_reform_seconds"] >= 0
        assert st["generation"] == 1
    finally:
        sup.close()
        peer1.kill()
        peer2.kill()


def test_supervisor_follower_adopts_published_plan(watchdir,
                                                   reform_recorder):
    """A NON-lowest survivor polls the transport for the coordinator's
    plan and reforms from it (no out-of-band agreement anywhere)."""
    t = _start(watchdir, nproc=3, pid=1)
    peer0 = _FakePeer(t, 0)
    peer2 = _FakePeer(t, 2)
    sup = Supervisor(backoff=0.05)
    try:
        _wait(lambda: set(podwatch.alive_peers()) == {0, 1, 2},
              msg="3-wide pod")
        peer2.kill()
        _wait(lambda: podwatch.dead_peers() == (2,), msg="death latch")
        # the "coordinator" (fake peer 0) publishes a fresh generation
        # every beat until the follower adopts one — the follower polls
        # for generations NEWER than what it saw at attempt start, so a
        # single fixed generation could race its snapshot
        stop = threading.Event()

        def publish():
            g = 1
            while not stop.is_set():
                t.plan_set(g, json.dumps(
                    {"addr": "127.0.0.1:45678",
                     "members": [["i", 0], ["i", 1]],
                     "epoch": podwatch.epoch() + 2, "gen": g}))
                g += 1
                stop.wait(0.1)

        pub = threading.Thread(target=publish, daemon=True)
        pub.start()
        try:
            _wait(lambda: reform_recorder.calls, timeout=10,
                  msg="follower adoption")
        finally:
            stop.set()
            pub.join()
        assert sup.wait_recovered(timeout=10)
        call = reform_recorder.calls[0]
        assert call["addr"] == "127.0.0.1:45678"
        assert call["nproc"] == 2 and call["pid"] == 1
    finally:
        sup.close()
        peer0.kill()
        peer2.kill()


def test_supervisor_follower_adopts_pre_published_plan(watchdir,
                                                       reform_recorder):
    """The coordinator detects the death on its OWN clock: its plan
    can land on the transport BEFORE this follower's latch fires.  The
    follower must adopt that already-published generation (floor =
    last gen DRIVEN + 1, not max(existing) + 1 — the latter skips the
    plan forever and burns the whole retry budget)."""
    t = _start(watchdir, nproc=3, pid=2)
    peer0 = _FakePeer(t, 0)
    peer1 = _FakePeer(t, 1)
    sup = Supervisor(backoff=0.05)
    try:
        _wait(lambda: set(podwatch.alive_peers()) == {0, 1, 2},
              msg="3-wide pod")
        # the plan is ALREADY on the transport when the death latches
        t.plan_set(1, json.dumps(
            {"addr": "127.0.0.1:45679",
             "members": [["i", 0], ["i", 2]],
             "epoch": podwatch.epoch() + 2, "gen": 1}))
        peer1.kill()
        _wait(lambda: reform_recorder.calls, timeout=10,
              msg="pre-published plan adoption")
        assert sup.wait_recovered(timeout=10)
        call = reform_recorder.calls[0]
        assert call["addr"] == "127.0.0.1:45679"
        assert call["nproc"] == 2 and call["pid"] == 1
        assert sup.stats()["backoffs"] == 0   # adopted on attempt 1
    finally:
        sup.close()
        peer0.kill()
        peer1.kill()


def test_serve_giveup_releases_held_retries_and_submit(watchdir,
                                                       monkeypatch):
    """An abandoned recovery must not wedge the server: a held
    PeerLostError retry is delivered (loudly) once the supervisor
    gives up, and a queue-policy submitter blocked on the drain is
    rejected naming the giveup instead of waiting forever."""
    monkeypatch.setattr(supervisor, "_DEF_RETRIES", 1)
    monkeypatch.setattr(supervisor, "_DEF_BACKOFF", 0.02)
    rec = _ReformRecorder(fail_times=99)
    monkeypatch.setattr(multihost, "reform", rec)
    t = _start(watchdir, nproc=2)
    peer = _FakePeer(t, 1)
    try:
        with serve.serving(workers=1, supervise=True) as sv:

            def lost():
                # surface the loss once the drain is engaged, so the
                # retry actually HOLDS before the giveup releases it
                _wait(lambda: sv.pod_paused(), msg="drain before loss")
                raise PeerLostError("pod peer lost: process 1 died",
                                    peer=1)

            fut = sv.submit(lost, tenant="t", retries=5)
            peer.kill()
            _wait(lambda: sv.supervisor.stats()["giveups"] == 1,
                  timeout=15, msg="giveup")
            # the held retry releases and delivers the loss
            with pytest.raises((PeerLostError, RuntimeError)):
                fut.result(timeout=30)
            # a blocked submitter is rejected pointedly, not wedged
            with pytest.raises(serve.AdmissionError,
                               match="recovery abandoned"):
                sv.submit(lambda: 1, tenant="t")
    finally:
        peer.kill()


def test_supervisor_second_failure_mid_reform_folds_in(watchdir,
                                                       reform_recorder):
    """The chaos seam fails attempt 1; a SECOND death lands during the
    backoff — attempt 2 re-enters on the new survivor set and reforms
    onto it (the double-failure contract), with the backoff counted."""
    t = _start(watchdir, nproc=3)
    peer1 = _FakePeer(t, 1)
    peer2 = _FakePeer(t, 2)
    _chaos.inject("supervisor.elect", nth=1, times=1)
    sup = Supervisor(backoff=1.0)
    try:
        _wait(lambda: set(podwatch.alive_peers()) == {0, 1, 2},
              msg="3-wide pod")
        peer2.kill()
        # attempt 1 tripped; during its backoff the second victim dies
        _wait(lambda: _chaos.stats("supervisor.elect")[1] == 1,
              msg="first attempt tripped")
        peer1.kill()
        podwatch.mark_dead(1)
        _wait(lambda: sup.stats()["reforms"] == 1, timeout=15,
              msg="second-attempt reform")
        assert sup.wait_recovered(timeout=15)
        assert [c["nproc"] for c in reform_recorder.calls] == [1]
        plan = json.loads(t.plan_get(1))
        assert plan["members"] == [["i", 0]]
        st = sup.stats()
        assert st["backoffs"] == 1 and st["reforms"] == 1
        assert st["peer_losses"] == 2
    finally:
        sup.close()
        peer1.kill()
        peer2.kill()


def test_supervisor_giveup_exhausts_budget(watchdir, monkeypatch):
    """Every attempt fails and the budget runs out: the recovery is
    abandoned LOUDLY — wait_recovered raises the chained SuperviseError
    and the giveup is counted.  The pod stays drained but manual
    reform remains possible (the error says so)."""
    rec = _ReformRecorder(fail_times=99)
    monkeypatch.setattr(multihost, "reform", rec)
    t = _start(watchdir, nproc=2)
    peer = _FakePeer(t, 1)
    sup = Supervisor(retries=1, backoff=0.02)
    try:
        _wait(lambda: set(podwatch.alive_peers()) == {0, 1},
              msg="2-wide pod")
        peer.kill()
        _wait(lambda: sup.stats()["giveups"] == 1, timeout=10,
              msg="giveup")
        with pytest.raises(SuperviseError,
                           match="abandoned after 2 attempt"):
            sup.wait_recovered(timeout=10)
        st = sup.stats()
        assert st["giveups"] == 1 and st["backoffs"] == 1
        assert "reform bring-up failed" in st["failed"]
    finally:
        sup.close()
        peer.kill()


def test_supervisor_rejoin_reforms_up(watchdir, reform_recorder):
    """The rejoin door: an announced identity is folded into the plan
    as rank N, the membership GROWS, the consumed doorbell is swept,
    and a repeat announcement of a now-member is ignored."""
    t = _start(watchdir, nproc=2)
    peer = _FakePeer(t, 1)
    sup = Supervisor(backoff=0.05)
    try:
        _wait(lambda: set(podwatch.alive_peers()) == {0, 1},
              msg="2-wide pod")
        podwatch.rejoin("w2b")
        _wait(lambda: sup.stats()["reforms"] == 1, timeout=10,
              msg="reform-up")
        assert sup.wait_recovered(timeout=10)
        call = reform_recorder.calls[0]
        assert call["nproc"] == 3 and call["pid"] == 0
        plan = json.loads(t.plan_get(1))
        assert plan["members"] == [["i", 0], ["i", 1], ["r", "w2b"]]
        st = sup.stats()
        assert st["rejoins"] == 1 and st["reforms"] == 1
        assert st["peer_losses"] == 0
        _wait(lambda: t.read_rejoin_marks() == set(),
              msg="doorbell sweep")
        # no quiesce latch survives the recovery
        assert podwatch.quiesce_requested() is None
        # a member's re-announcement is a no-op (marker-sweep lag)
        sup._on_rejoin("w2b")
        time.sleep(0.2)
        assert sup.stats()["reforms"] == 1
    finally:
        sup.close()
        peer.kill()


def test_quarantine_tracks_identity_across_rank_remap(watchdir,
                                                      reform_recorder):
    """Strikes attach to the PERSISTENT identity, not the transient
    rank: a replacement that joined as "w1b" and then flaps dies at
    whatever rank the last reform gave it — the strike must land on
    "w1b" (and quarantine it), never on the birth identity "i1" of
    the rank it inherited."""
    t = _start(watchdir, nproc=2)
    peer = _FakePeer(t, 1)
    sup = Supervisor(backoff=0.05, quarantine_after=1)
    try:
        _wait(lambda: set(podwatch.alive_peers()) == {0, 1},
              msg="2-wide pod")
        peer.kill()                   # strike 1 for the ORIGINAL "i1"
        _wait(lambda: sup.stats()["reforms"] == 1, timeout=10,
              msg="shrink reform")
        podwatch.rejoin("w1b")        # replacement, DIFFERENT identity
        _wait(lambda: sup.stats()["rejoins"] == 1, timeout=10,
              msg="rejoin reform")
        # strike 1 latched the ORIGINAL "i1" (quarantine_after=1) —
        # the replacement identity starts clean
        assert sup.quarantined() == ["i1"]
        assert sup._ident_of(1) == "w1b"   # it holds rank 1 now
        sup._on_death(1)              # the REPLACEMENT flaps
        _wait(lambda: sup.stats()["reforms"] == 3, timeout=10,
              msg="second shrink")
        assert sup._strikes.get("w1b") == 1   # struck by identity,
        assert sup._strikes.get("i1") == 1    # NOT the rank's birth id
        _wait(lambda: sup.quarantined() == ["i1", "w1b"],
              msg="identity quarantine")
        n = sup.stats()["reforms"]
        sup._on_rejoin("w1b")         # further announcements ignored
        time.sleep(0.3)
        assert sup.stats()["reforms"] == n
        assert sup.stats()["quarantined"] == 1
    finally:
        sup.close()
        peer.kill()


def test_attach_normalizes_identity(watchdir, reform_recorder):
    """The transport sanitizes marker filenames, so the incumbents'
    plan names the SANITIZED identity — attach("worker:7") must match
    the plan's "worker_7" instead of timing out while every incumbent
    blocks in the reform bring-up."""
    tr = FileTransport(watchdir, epoch=0)
    got = {}

    def join():
        try:
            got["sup"] = supervisor.attach("worker:7", dir=watchdir,
                                           timeout=8)
        except Exception as exc:      # noqa: BLE001 — asserted below
            got["err"] = exc

    th = threading.Thread(target=join, daemon=True)
    th.start()
    _wait(lambda: tr.read_rejoin_marks() == {"worker_7"},
          msg="sanitized doorbell")
    tr.plan_set(1, json.dumps(
        {"addr": "127.0.0.1:45680",
         "members": [["i", 0], ["r", "worker_7"]],
         "epoch": 2, "gen": 1}))
    th.join(timeout=20)
    assert not th.is_alive() and "err" not in got, got.get("err")
    try:
        assert reform_recorder.calls[-1]["pid"] == 1
        assert got["sup"]._ident_of(1) == "worker_7"  # seeded map
        assert got["sup"]._ident_of(0) == "i0"
    finally:
        got["sup"].close()


def test_attach_seeds_generation_and_joined(watchdir, reform_recorder):
    """attach() must seed the new supervisor with the plan it joined
    by: the follower adoption floor is ``_gen + 1``, so a rejoiner
    left at gen 0 could re-adopt a RETAINED stale plan generation on
    its next recovery (sweep_epochs keeps the last two) and reform
    against a dead coordinator; and this plan's rejoiners are members
    now, so their sweep-lag doorbell duplicates must be dropped."""
    tr = FileTransport(watchdir, epoch=0)
    got = {}

    def join():
        got["sup"] = supervisor.attach("w1b", dir=watchdir, timeout=8)

    th = threading.Thread(target=join, daemon=True)
    th.start()
    _wait(lambda: tr.read_rejoin_marks() == {"w1b"}, msg="doorbell")
    tr.plan_set(3, json.dumps(
        {"addr": "127.0.0.1:45681",
         "members": [["i", 0], ["i", 2], ["r", "w1b"]],
         "epoch": 2, "gen": 3}))
    th.join(timeout=20)
    assert not th.is_alive()
    sup = got["sup"]
    try:
        assert sup.stats()["generation"] == 3   # floor starts past 3
        with sup._lock:
            assert "w1b" in sup._joined
        sup._on_rejoin("w1b")         # stale doorbell for a member
        assert sup.stats()["pending_rejoins"] == []
    finally:
        sup.close()


def test_new_recovery_clears_stale_giveup(watchdir, monkeypatch):
    """A stale giveup from a PAST recovery must not abort the next
    one: ``failed`` clears when a new recovery BEGINS — held retries
    and blocked submitters wait for its outcome — not only once it
    succeeds."""
    rec = _ReformRecorder()
    gate = threading.Event()
    seen = {}

    def gated_reform(*a, **kw):
        seen["failed_mid_recovery"] = sup.failed
        assert gate.wait(10)
        return rec(*a, **kw)

    monkeypatch.setattr(multihost, "reform", gated_reform)
    t = _start(watchdir, nproc=2)
    peer = _FakePeer(t, 1)
    sup = Supervisor(backoff=0.05)
    try:
        _wait(lambda: set(podwatch.alive_peers()) == {0, 1},
              msg="2-wide pod")
        sup.failed = RuntimeError("stale giveup")
        peer.kill()
        _wait(lambda: "failed_mid_recovery" in seen, timeout=10,
              msg="recovery reached reform")
        assert seen["failed_mid_recovery"] is None
        gate.set()
        assert sup.wait_recovered(timeout=10)
        assert sup.failed is None
    finally:
        gate.set()
        sup.close()
        peer.kill()


def test_relatch_of_same_death_is_one_strike(watchdir):
    """The liveness re-probe after a failed reform attempt starts a
    fresh watch where the SAME dead peer re-latches and fires the
    death callback again — that is one death, one strike, or a single
    transient reform failure would quarantine (default 2 strikes) a
    peer that never flapped and permanently block its rejoin."""
    sup = Supervisor(retries=0, backoff=0.02, quarantine_after=2)
    try:
        sup._stop.set()               # park the recovery thread:
        #                               intake only, no recovery drive
        sup._on_death(1)
        sup._on_death(1)              # probe re-latch, same death
        assert sup._strikes.get("i1") == 1
        assert sup.quarantined() == []
        assert sup.stats()["peer_losses"] == 1
    finally:
        sup.close()


def test_busy_pod_defers_growth_instead_of_reforming(watchdir,
                                                     reform_recorder,
                                                     monkeypatch):
    """A pod that never goes idle within the drain budget (e.g. an
    UNCHECKPOINTED stream can never observe the quiesce request) must
    NOT be reformed up — that would tear down the XLA backends under
    the live collective schedule.  The growth is deferred: the pod
    resumes untouched, no reform is driven, the quiesce latch clears,
    and the identity's next doorbell rings through again."""
    monkeypatch.setattr(supervisor, "_DEF_DRAIN", 0.3)
    t = _start(watchdir, nproc=2)
    peer = _FakePeer(t, 1)
    events = []
    sup = Supervisor(backoff=0.05,
                     on_resume=lambda i: events.append(i))
    try:
        _wait(lambda: set(podwatch.alive_peers()) == {0, 1},
              msg="2-wide pod")
        podwatch.pod_enter()          # a live pod run that never gates
        podwatch.rejoin("w1b")
        _wait(lambda: events, timeout=10, msg="deferred resume")
        assert events[0]["deferred"] == ["w1b"]
        assert events[0]["rejoined"] == []
        assert reform_recorder.calls == []        # pod untouched
        assert podwatch.quiesce_requested() is None
        assert sup.wait_recovered(timeout=10)
        assert sup.stats()["pending_rejoins"] == []
        # the latch reset lets the next doorbell ring through
        podwatch.pod_exit()
        podwatch.rejoin("w1b")
        _wait(lambda: sup.stats()["reforms"] == 1, timeout=10,
              msg="re-rung growth reforms once idle")
    finally:
        podwatch.clear_quiesce()
        sup.close()
        peer.kill()


def test_rank_never_defaults_to_zero_with_watch_down(watchdir):
    """With the watch down mid-recovery (a failed attempt whose
    re-probe also failed), the member must fail the attempt loudly
    rather than assume rank 0 — a non-zero survivor impersonating
    the coordinator would publish a conflicting plan and claim
    process_id 0 in the bring-up."""
    sup = Supervisor(retries=0, backoff=0.02)
    try:
        assert podwatch._WATCH is None
        with pytest.raises(SuperviseError, match="rank"):
            sup._my_rank()
    finally:
        sup.close()


def test_supervisor_quarantines_flapping_peer(watchdir, reform_recorder):
    """The documented flap contract (dies, rejoins, dies AGAIN =
    quarantine_after=2 strikes): the latch trips at the threshold
    strike itself, so the flapper's very next rejoin announcement is
    ignored — it is never re-admitted for one more reform cycle."""
    t = _start(watchdir, nproc=2)
    peer = _FakePeer(t, 1)
    sup = Supervisor(backoff=0.05, quarantine_after=2)
    try:
        _wait(lambda: set(podwatch.alive_peers()) == {0, 1},
              msg="2-wide pod")
        peer.kill()                   # strike 1 for identity "i1"
        _wait(lambda: sup.stats()["reforms"] == 1, timeout=10,
              msg="shrink reform")
        assert sup.quarantined() == []     # one strike: not latched
        podwatch.rejoin("i1")         # the flapper asks back in
        _wait(lambda: sup.stats()["rejoins"] == 1, timeout=10,
              msg="rejoin reform")
        sup._on_death(1)              # dies AGAIN: strike 2 latches
        _wait(lambda: sup.stats()["reforms"] == 3, timeout=10,
              msg="second shrink")
        _wait(lambda: sup.quarantined() == ["i1"], msg="quarantine")
        n_reforms = sup.stats()["reforms"]
        sup._on_rejoin("i1")          # announcement: ignored outright
        time.sleep(0.3)
        st = sup.stats()
        assert st["quarantined"] == 1
        assert st["reforms"] == n_reforms
        assert st["quarantine"] == ["i1"]
        assert sup.config()["quarantine"] == ["i1"]
    finally:
        sup.close()
        peer.kill()


def test_supervisor_no_transport_is_loud(watchdir):
    """A death with NO liveness watch running (so no surviving
    membership and no transport to carry a plan) abandons pointedly
    instead of spinning."""
    sup = Supervisor(retries=0, backoff=0.02)
    try:
        sup._on_death(1)              # no watch is running
        _wait(lambda: sup.stats()["giveups"] == 1, timeout=10,
              msg="giveup")
        with pytest.raises(SuperviseError, match="no surviving members"):
            sup.wait_recovered(timeout=10)
    finally:
        sup.close()


def test_supervisor_close_is_idempotent_and_detaches(watchdir):
    sup = Supervisor()
    assert supervisor.active() is sup
    sup.close()
    assert supervisor.active() is None
    sup.close()                       # second close: no-op
    # its callbacks are gone: a death after close never wakes it
    podwatch.mark_dead(1)
    assert sup.stats()["peer_losses"] == 0


# ---------------------------------------------------------------------
# serve integration: Server(supervise=True)
# ---------------------------------------------------------------------

def test_serve_supervised_recovery_rescales_budget(watchdir,
                                                   reform_recorder,
                                                   monkeypatch):
    """Peer death under supervise=True: admission drains, the
    supervisor reforms AUTOMATICALLY (no caller intervention), the
    arbiter budget rescales to the surviving share (degraded-capacity
    admission), and the queue resumes."""
    monkeypatch.setattr(multihost, "process_count", lambda: 3)
    t = _start(watchdir, nproc=3)
    peer1 = _FakePeer(t, 1)
    peer2 = _FakePeer(t, 2)
    try:
        with serve.serving(workers=1, budget_bytes=3000,
                           supervise=True) as sv:
            assert sv.supervisor is not None
            assert supervisor.active() is sv.supervisor
            st = sv.stats()["pod"]
            assert st["supervised"] and st["budget_share"] == 1.0
            peer2.kill()
            _wait(lambda: sv.stats()["totals"]["reforms"] == 1,
                  timeout=10, msg="supervised reform")
            assert sv.supervisor.wait_recovered(timeout=10)
            _wait(lambda: not sv.pod_paused(), msg="resume")
            assert reform_recorder.calls[0]["nproc"] == 2
            st = sv.stats()
            assert st["totals"]["reforms"] == 1
            assert st["totals"]["peer_losses"] == 1
            assert st["totals"]["supervise_seconds"] > 0
            assert abs(st["pod"]["budget_share"] - 2 / 3) < 1e-6
            assert sv.arbiter.budget == 2000
            # a job still runs on the degraded pod
            assert sv.submit(lambda: 41 + 1).result(timeout=30) == 42
        assert supervisor.active() is None    # close() took it down
    finally:
        peer1.kill()
        peer2.kill()


def test_serve_adopts_attached_supervisor(watchdir):
    """The rejoiner hands serve an EXISTING Supervisor
    (supervisor.attach's return): the server adopts it — hooks wired,
    not closed with the server (the supervisor outlives it)."""
    sup = Supervisor(backoff=0.05)
    try:
        with serve.serving(workers=1, supervise=sup) as sv:
            assert sv.supervisor is sup
            assert sup.on_pause == sv._sup_pause
        assert supervisor.active() is sup     # still running
        assert sup.on_pause is None           # hooks detached
    finally:
        sup.close()


def test_serve_reject_policy_names_supervised_recovery(watchdir):
    """During a supervised drain the reject-policy refusal names the
    recovery in progress, not a bare peer loss."""
    with serve.serving(workers=1, policy="reject") as sv:
        sv._sup_pause("rejoin ['w2b']")
        with pytest.raises(serve.AdmissionError,
                           match="supervised recovery in progress"):
            sv.submit(lambda: 1)
        sv._sup_resume({"nproc": 0, "rejoined": []})
        assert sv.submit(lambda: 1).result(timeout=30) == 1


# ---------------------------------------------------------------------
# checkpoint integrity digests
# ---------------------------------------------------------------------

def _save1(path, fp, val=3.0, slabs=2, records=24):
    checkpoint.stream_save(str(path), fp, slabs, records,
                           ([np.full(4, val, np.float32)], None))


def test_stream_save_records_digest_and_load_verifies(tmp_path):
    fp = ("fp-digest",)
    _save1(tmp_path, fp)
    meta = checkpoint._read_meta(str(tmp_path))
    assert len(meta["digest"]) == 64          # sha256 hex
    got = checkpoint.stream_load(str(tmp_path), fp)
    assert got[0] == 2 and np.array_equal(
        got[2][0][0].numpy(), np.full(4, 3.0, np.float32))


def test_corrupt_seam_is_refused_pointedly(tmp_path):
    """The checkpoint.corrupt chaos seam flips bytes under the atomic
    rename; stream_load must REFUSE the shard with an error naming the
    file — never feed a corrupt accumulator into the fold."""
    fp = ("fp-rot",)
    _chaos.inject("checkpoint.corrupt", nth=1)
    try:
        _save1(tmp_path, fp)
    finally:
        _chaos.clear()
    with pytest.raises(checkpoint.CheckpointCorruptError) as ei:
        checkpoint.stream_load(str(tmp_path), fp)
    assert "stream_state" in str(ei.value)    # names the file
    assert "delete the file" in str(ei.value)


def test_truncated_state_is_refused_pointedly(tmp_path):
    fp = ("fp-trunc",)
    _save1(tmp_path, fp)
    (state,) = [p for p in os.listdir(str(tmp_path))
                if p.startswith("stream_state")]
    spath = os.path.join(str(tmp_path), state)
    with open(spath, "r+b") as f:
        f.truncate(os.path.getsize(spath) // 2)
    with pytest.raises(checkpoint.CheckpointCorruptError,
                       match="corrupt"):
        checkpoint.stream_load(str(tmp_path), fp)


def test_pre_digest_checkpoint_refused(tmp_path):
    """The reference keeps loading a meta written before it recorded
    digests; every meta the port writes holds one, so a meta without it
    is not the port's and is refused pointedly (the port's contract,
    ``tests/test_torch_resume.py :: test_meta_without_a_digest_refused``),
    never adopted unverified."""
    fp = ("fp-old",)
    _save1(tmp_path, fp)
    mpath = os.path.join(str(tmp_path), "stream_meta.json")
    with open(mpath) as f:
        meta = json.load(f)
    del meta["digest"]
    with open(mpath, "w") as f:
        json.dump(meta, f)
    with pytest.raises(checkpoint.CheckpointCorruptError, match="digest"):
        checkpoint.stream_load(str(tmp_path), fp)


def test_pod_shard_digest_validates_any_adoption(tmp_path, monkeypatch):
    """Pod partials are psum-replicated, so process 0's meta digest
    validates ANY adopted shard — and refuses a rotted one on the
    topology-remap path."""
    cell = {"pid": 0}
    monkeypatch.setattr(multihost, "process_count", lambda: 3)
    monkeypatch.setattr(multihost, "process_index", lambda: cell["pid"])
    monkeypatch.setattr(multihost, "barrier", lambda name: None)
    fp = ("fp-pod",)
    for pid in range(3):
        cell["pid"] = pid
        checkpoint.stream_save(str(tmp_path), fp, 4, 48,
                               ([np.full(4, 7.0, np.float32)], None),
                               multiprocess=True)
    # the shrunk pod adopts shards and every one passes the digest
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    for pid in (0, 1):
        cell["pid"] = pid
        got = checkpoint.stream_load(str(tmp_path), fp,
                                     multiprocess=True)
        assert got[0] == 4
    # rot ONE adopted shard: its reader refuses pointedly
    with open(os.path.join(str(tmp_path),
                           "stream_state.p1.w4.npz"), "r+b") as f:
        f.seek(max(0, os.path.getsize(f.name) // 2))
        f.write(b"\xde\xad\xbe\xef")
    cell["pid"] = 1
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.stream_load(str(tmp_path), fp, multiprocess=True)


# ---------------------------------------------------------------------
# BLT014 + the supervised recovery plan in explain()
# ---------------------------------------------------------------------

def ADD1(v):
    return v + 1


def _pod_stream(monkeypatch, kind):
    """A stream on a two-rank layout the checker sees as a pod: a
    re-iterable ``fromiter`` block list, or a per-rank ``fromcallback``
    loader (BLT012 quieted: it has its own tests)."""
    from bolt_tpu_torch import convert, stream
    lay = convert.mesh_from_reference((2,), ("k",))
    x = np.zeros((8, 4), np.float32)
    if kind == "iter":
        src = stream.StreamSource.from_iter(
            [x[:4], x[4:]], x.shape, 1, np.float32, CPU, mesh=lay)
    else:
        src = stream.StreamSource.from_callback(
            lambda idx: x[idx], x.shape, 1, np.float32, CPU, chunks=4,
            mesh=lay)
    monkeypatch.setattr(multihost, "mesh_process_count", lambda m: 2)
    monkeypatch.setattr(multihost, "slab_divisibility_error",
                        lambda *a: None)
    return stream.as_array(src).map(ADD1)


def _iter_streamed(monkeypatch):
    return _pod_stream(monkeypatch, "iter")


def _cb_streamed(monkeypatch):
    return _pod_stream(monkeypatch, "callback")


def test_blt014_fromiter_under_supervision(watchdir, monkeypatch):
    from bolt_tpu_torch import analysis
    arr = _iter_streamed(monkeypatch)
    sup = Supervisor()
    try:
        rep = analysis.check(arr)
    finally:
        sup.close()
    assert rep.has("BLT014")
    d = [d for d in rep.diagnostics if d.code == "BLT014"][0]
    assert d.severity == "warning" and rep.ok
    assert "re-ingest" in d.message
    assert "per_process=True" in d.hint


def test_blt014_quiet_without_supervisor(monkeypatch):
    from bolt_tpu_torch import analysis
    arr = _iter_streamed(monkeypatch)
    assert not analysis.check(arr).has("BLT014")


def test_blt014_quiet_for_per_process_callback(watchdir, monkeypatch):
    from bolt_tpu_torch import analysis
    arr = _cb_streamed(monkeypatch)
    sup = Supervisor()
    try:
        rep = analysis.check(arr)
    finally:
        sup.close()
    assert not rep.has("BLT014")


def test_explain_shows_supervised_contract(watchdir, monkeypatch):
    from bolt_tpu_torch import analysis
    arr = _cb_streamed(monkeypatch)
    sup = Supervisor(retries=4, backoff=0.75)
    try:
        sup._quarantine.add("i9")
        txt = analysis.explain(arr)
    finally:
        sup.close()
    assert "SUPERVISED" in txt
    assert "4 retries" in txt and "0.75s" in txt
    assert "rejoin door" in txt and "i9" in txt
    # without a supervisor the plan stays the manual contract
    arr2 = _cb_streamed(monkeypatch)
    txt2 = analysis.explain(arr2)
    assert "recovery plan" in txt2 and "SUPERVISED" not in txt2


def test_blt108_exempts_supervisor():
    """The recovery thread lives in a blessed BLT108 home."""
    from bolt_tpu_torch.analysis import astlint
    assert any(e.endswith(os.path.join("parallel", "supervisor.py"))
               for e in astlint._EXEMPT["BLT108"])


def test_supervisor_spans_are_clean(watchdir, reform_recorder):
    """A full supervised recovery leaves zero open spans."""
    obs.clear()
    obs.enable()
    try:
        t = _start(watchdir, nproc=2)
        peer = _FakePeer(t, 1)
        sup = Supervisor(backoff=0.05)
        try:
            _wait(lambda: set(podwatch.alive_peers()) == {0, 1},
                  msg="2-wide pod")
            peer.kill()
            _wait(lambda: sup.stats()["reforms"] == 1, timeout=10,
                  msg="reform")
            assert sup.wait_recovered(timeout=10)
        finally:
            sup.close()
            peer.kill()
        podwatch.stop()
        assert obs.active_count() == 0
    finally:
        obs.disable()
