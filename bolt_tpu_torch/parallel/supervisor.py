"""Self-healing pods: the recovery supervisor.

Port of ``bolt_tpu/parallel/supervisor.py``.  ``podwatch`` makes a pod
failure survivable (a ``kill -9`` of one rank becomes a pointed
``PeerLostError`` on every survivor) and ``multihost.reform`` rebuilds
the process group on the survivors; this module closes the loop so the
recovery needs no caller: detect, drain, reform, resume, re-expand.

* **auto-recovery** — a :class:`Supervisor` on every member subscribes
  ``podwatch.on_peer_death``; on a loss the survivors each elect the
  SAME coordinator (the lowest surviving rank), which allocates a fresh
  port and publishes the reform **plan** (address, ordered member list,
  next transport epoch) through the heartbeat transport
  (``plan_set``/``plan_get``), and every survivor drives
  ``multihost.reform`` from the plan.  Attempts ride a bounded
  exponential backoff (``BOLT_SUPERVISE_RETRIES`` /
  ``BOLT_SUPERVISE_BACKOFF``); a SECOND failure during a reform fails
  that attempt and the loop re-enters on the new survivor set (a
  liveness re-probe on the plan's epoch re-reads who is alive);
* **re-expansion** — a restarted or replacement process rings the
  transport's REJOIN door (:func:`attach`); a pod shrunk to ONE rank
  keeps the door open through a one-rank watch on the shared
  directory (``podwatch.start(..., solo=True)``), so it can grow again.  Incumbents request a
  QUIESCE: an in-flight pod stream stops at its next slab-boundary
  checkpoint (``podwatch.quiesce_gate``), and once the process is idle
  the pod reforms UP.  Every rank's fold state is the same, so the
  topology remap that makes a shrink's resume exact makes growth exact;
* **quarantine** — a peer that keeps flapping
  (``BOLT_SUPERVISE_QUARANTINE`` strikes, default 2) is quarantined:
  its rejoin announcements are ignored.

``serve.Server(supervise=True)`` rides this: peer death drains
admission, the supervisor reforms, held ``retries=`` re-attempts resume
from the checkpoint, and the arbiter budget is rescaled to the
surviving share.  Observability: registry group ``supervisor``
(``reforms``/``rejoins``/``peer_losses``/``backoffs``/``giveups``/
``quarantined``/``supervise_seconds``), span ``supervisor.reform``,
instants ``supervisor.rejoin``/``supervisor.backoff``.

The plan/rejoin channel needs a medium that OUTLIVES the dead peer: the
shared-directory transport (``BOLT_POD_HB_DIR``) always qualifies; the
pod's own store, when it is a ``TCPStore``, lives in rank 0's process,
so store-backed supervision recovers from the loss of other ranks only
(the recovery loop then degrades loudly).

Deterministic fault points: ``supervisor.elect`` (top of every recovery
attempt) and ``supervisor.rejoin`` (the rejoin-door handler), seams of
``bolt_tpu_torch._chaos``.

Lint: the one recovery thread is created here, which BLT108 exempts
beside ``podwatch.py`` (pod-lifecycle plumbing).
"""

import json
import os
import socket
import threading
import time

from bolt_tpu_torch import _chaos
from bolt_tpu_torch import _lockdep
from bolt_tpu_torch.obs import metrics as _metrics
from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.obs.trace import clock as _clock
from bolt_tpu_torch.parallel import podwatch as _podwatch

# ---------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------

# bounded exponential backoff for the recovery loop: attempt k sleeps
# backoff * 2^k seconds before re-electing (a second failure mid-reform
# re-enters here; the budget keeps a permanently sick pod from spinning)
_DEF_RETRIES = max(0, int(os.environ.get("BOLT_SUPERVISE_RETRIES", "3")))
_DEF_BACKOFF = float(os.environ.get("BOLT_SUPERVISE_BACKOFF", "0.5"))

# strikes before a flapping peer is quarantined (each recovery a peer's
# death triggers is one strike; a quarantined identity's rejoin
# announcements are ignored)
_DEF_QUARANTINE = max(1, int(os.environ.get("BOLT_SUPERVISE_QUARANTINE",
                                            "2")))

# growth-recovery quiesce drain budget (seconds): how long to wait for
# in-flight pod streams to reach a slab-boundary checkpoint before the
# growth is DEFERRED (0 = the default max(60, 10x watchdog deadline))
_DEF_DRAIN = float(os.environ.get("BOLT_SUPERVISE_DRAIN", "0"))

# the host part of a published coordinator address: every member must
# be able to reach the elected coordinator here.  Localhost clusters
# (the test harness) use the default; a real pod sets the coordinator
# host its DNS/overlay resolves.
_DEF_HOST = os.environ.get("BOLT_SUPERVISE_HOST", "127.0.0.1")

_SCHEMA = {
    "peer_losses": 0,         # deaths observed (recovery triggers)
    "reforms": 0,             # successful reform drives (down or up)
    "rejoins": 0,             # identities folded back in by reform-up
    "backoffs": 0,            # failed attempts slept through
    "giveups": 0,             # recoveries abandoned (budget exhausted)
    "quarantined": 0,         # rejoin announcements ignored
    "supervise_seconds": 0.0,  # pause -> resume wall, totalled
}


class SuperviseError(RuntimeError):
    """The supervisor abandoned a recovery: the retry budget is
    exhausted (every attempt's failure chained below), or the
    transport cannot carry a plan (KV store died with the
    coordinator).  The pod is still drained — manual
    ``multihost.reform`` remains possible."""


def free_port(host="127.0.0.1"):
    """One OS-allocated free port (the elected coordinator binds the
    reform service here; the plan publishes it)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _fastfail_init_timeout():
    """The default reform bring-up window when the caller set none: a
    member that died between the plan and the bring-up must fail the
    attempt in SECONDS (so the loop re-enters on the new survivor set),
    not the 120 s default of ``multihost``.  Scaled off the liveness
    deadline when a watch is running; a healthy localhost bring-up
    completes in well under a second."""
    return max(15.0, 5 * (_podwatch.deadline() or 2.0))


# ---------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------

_ACTIVE = None
_ACTIVE_LOCK = _lockdep.lock("supervisor.active")


class Supervisor:
    """One pod member's recovery controller.  Construct it on every
    member (``serve.Server(supervise=True)`` does); it idles until the
    liveness watch reports a death or a rejoin, then drives the full
    recovery autonomously.  ``on_pause(reason)`` / ``on_resume(info)``
    hooks let a scheduler drain and resume admission around the
    reform (``info`` carries ``{"nproc", "rejoined", "reason"}``).

    Thread model: callbacks arrive from the watch thread and only
    enqueue; ONE supervisor thread runs recoveries, so two events
    cannot race two reforms."""

    def __init__(self, retries=None, backoff=None, host=None,
                 quarantine_after=None, on_pause=None, on_resume=None,
                 init_timeout=None, ident_map=None, gen=0, joined=None):
        self.retries = _DEF_RETRIES if retries is None else max(
            0, int(retries))
        self.backoff = _DEF_BACKOFF if backoff is None else float(backoff)
        self.host = host or _DEF_HOST
        self.quarantine_after = (_DEF_QUARANTINE if quarantine_after
                                 is None else max(1, int(quarantine_after)))
        self.on_pause = on_pause
        self.on_resume = on_resume
        # a reform bring-up waits for EVERY member to connect; a member
        # that died mid-reform must fail the attempt in seconds
        self.init_timeout = init_timeout
        self.failed = None             # the giveup error, if any
        self._lock = _lockdep.lock("supervisor.state")
        # last plan generation DRIVEN by this member — the follower
        # adoption floor is _gen + 1, so attach() must seed it with
        # the plan it joined by or a retained stale generation on the
        # transport could be re-adopted on this member's next recovery
        self._gen = int(gen)
        self._strikes = {}             # identity -> recovery triggers
        self._quarantine = set()
        self._pending_deaths = set()
        self._pending_rejoins = set()
        self._tried_gens = set()
        # rank -> PERSISTENT identity.  Ranks are remapped on every
        # reform, so strikes/quarantine keyed by rank would
        # misattribute a rejoiner's flapping to whichever incumbent
        # inherits its old rank; deaths strike the identity instead.
        # Unmapped ranks default to the birth identity "i<rank>";
        # attach() seeds the rejoiner's map from the plan it joined by.
        self._ident_by_rank = dict(ident_map or {})
        self._joined = set(joined or ())  # idents already folded in
        self._last = {}                # last recovery's timing
        self._recovered = threading.Event()
        self._recovered.set()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._probe = None             # (nproc, pid, dir, interval,
        #                                timeout) of the last live watch
        #                                — the liveness re-probe after a
        #                                failed reform attempt
        self._counters = _metrics.registry().group("supervisor", _SCHEMA)
        self._handles = (
            _podwatch.on_peer_death(self._on_death),
            _podwatch.on_rejoin(self._on_rejoin),
        )
        self._thread = threading.Thread(
            target=self._run, name="bolt-supervisor", daemon=True)
        self._thread.start()
        global _ACTIVE
        with _ACTIVE_LOCK:
            _ACTIVE = self

    # -- event intake (watch thread) -----------------------------------

    def _ident_of(self, pid):
        """The persistent identity currently holding rank ``pid``."""
        return self._ident_by_rank.get(int(pid), "i%d" % int(pid))

    def _on_death(self, pid):
        with self._lock:
            pid = int(pid)
            # one DEATH = one strike, not one liveness latch: the
            # re-probe after a failed reform attempt starts a fresh
            # watch where the same dead peer re-latches and fires this
            # callback again — without the dedupe a peer that died
            # exactly once would hit the default 2-strike quarantine
            # after one transient reform failure
            relatch = pid in self._pending_deaths
            self._pending_deaths.add(pid)
            ident = self._ident_of(pid)
            if not relatch:
                self._strikes[ident] = self._strikes.get(ident, 0) + 1
            # latch at the threshold strike IMMEDIATELY: the flapper's
            # very next rejoin is ignored — latching only at reform
            # success would re-admit it for one more full
            # quiesce/reform-up/shrink cycle first
            if self._strikes[ident] >= self.quarantine_after:
                self._quarantine.add(ident)
            # a dead member is no longer joined: its NEXT rejoin
            # announcement must ring through (not be dropped as
            # marker-sweep lag), or a restarted member could never
            # come back
            self._joined.discard(ident)
        if not relatch:
            self._counters.add("peer_losses")
        self._recovered.clear()
        self._wake.set()

    def _on_rejoin(self, ident):
        _chaos.hit("supervisor.rejoin")
        with self._lock:
            if ident in self._quarantine:
                self._counters.add("quarantined")
                _obs.event("supervisor.quarantined", ident=ident)
                return
            if ident in self._joined:
                return                # already a member (marker sweep lag)
            self._pending_rejoins.add(ident)
        _obs.event("supervisor.rejoin", ident=ident)
        self._recovered.clear()
        self._wake.set()

    # -- queries --------------------------------------------------------

    def quarantined(self):
        with self._lock:
            return sorted(self._quarantine)

    def stats(self):
        out = dict(self._counters.snapshot())
        with self._lock:
            out["quarantine"] = sorted(self._quarantine)
            out["generation"] = self._gen
            out["pending_deaths"] = sorted(self._pending_deaths)
            out["pending_rejoins"] = sorted(self._pending_rejoins)
            out.update(self._last)     # last_reform_seconds /
            #                            last_recovery_seconds
        out["failed"] = str(self.failed) if self.failed else None
        return out

    def config(self):
        """The supervised recovery contract ``explain()`` renders."""
        return {"retries": self.retries, "backoff": self.backoff,
                "quarantine_after": self.quarantine_after,
                "quarantine": self.quarantined(),
                "host": self.host}

    def wait_recovered(self, timeout=None):
        """Block until no recovery is pending (True), or ``timeout``
        elapses (False).  Raises the giveup error if the last recovery
        was abandoned."""
        ok = self._recovered.wait(timeout)
        if self.failed is not None:
            raise self.failed
        return ok

    # -- lifecycle ------------------------------------------------------

    def close(self):
        """Stop the supervisor: deregister the watch callbacks and
        join the recovery thread.  Does not touch the pod."""
        self._stop.set()
        self._wake.set()
        for h in self._handles:
            _podwatch.remove_callback(h)
        self._thread.join(timeout=10.0)
        global _ACTIVE
        with _ACTIVE_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    # -- the recovery driver (one thread) -------------------------------

    def _run(self):
        while True:
            self._wake.wait()
            if self._stop.is_set():
                return
            self._wake.clear()
            with self._lock:
                deaths = set(self._pending_deaths)
                rejoins = set(self._pending_rejoins)
            if not deaths and not rejoins:
                self._recovered.set()
                continue
            try:
                self._recover(deaths, rejoins)
            except Exception as exc:    # noqa: BLE001 — recorded giveup
                self.failed = exc
                self._counters.add("giveups")
                _obs.event("supervisor.giveup",
                           error=type(exc).__name__)
                _podwatch.clear_quiesce()   # held retries must not
                #                             wait on a dead recovery
                with self._lock:
                    self._pending_deaths.clear()
                    self._pending_rejoins.clear()
                self._recovered.set()   # wait_recovered re-raises

    def _members(self, rejoins):
        """The deterministic next-cluster membership: surviving
        incumbent ranks (ascending, quarantine excluded) then rejoiner
        identities (sorted).  Every survivor computes the same list;
        the coordinator's copy is the one the plan publishes."""
        alive = [p for p in _podwatch.alive_peers()
                 if self._ident_of(p) not in self._quarantine]
        members = [["i", int(p)] for p in alive]
        members += [["r", ident] for ident in sorted(rejoins)]
        return members

    def _recover(self, deaths, rejoins):
        """One full recovery: pause, (for growth) quiesce and drain
        in-flight pod streams, then the elect → plan → reform attempt
        loop with exponential backoff.  A death arriving mid-loop is
        folded into the next attempt's membership (the 'second failure
        mid-reform' contract)."""
        t0 = _clock()
        # a NEW recovery supersedes a past giveup: held retries and
        # blocked submitters must wait for THIS outcome, not abort on
        # the stale error (failed is re-set by _run if this one also
        # exhausts its budget)
        self.failed = None
        self._tried_gens = set()       # plans already driven (and
        #                                failed) this recovery — never
        #                                re-adopt one; the coordinator
        #                                publishes a fresh generation
        #                                every attempt
        reason = "peer death %s" % sorted(deaths) if deaths else \
            "rejoin %s" % sorted(rejoins)
        if self.on_pause is not None:
            try:
                self.on_pause(reason)
            except Exception:           # noqa: BLE001
                pass
        if rejoins and not deaths:
            # growth must not abandon a healthy in-flight collective
            # schedule: ask streams to stop at a slab-boundary
            # checkpoint, then wait for this process to go idle (the
            # quiesce gate or natural completion gets it there)
            _podwatch.request_quiesce("rejoin %s" % sorted(rejoins))
            busy_deadline = _clock() + (_DEF_DRAIN or max(
                60.0, 10 * (_podwatch.deadline() or 5.0)))
            while _podwatch.pod_busy() and _clock() < busy_deadline \
                    and not self._stop.is_set():
                self._stop.wait(0.05)
                with self._lock:        # a death mid-quiesce switches
                    if self._pending_deaths - deaths:  # to shrink mode
                        break
        from bolt_tpu_torch.parallel import multihost as _multihost
        if rejoins and not deaths and _podwatch.pod_busy() \
                and not self._stop.is_set():
            with self._lock:
                second = bool(self._pending_deaths - deaths)
            if not second:
                # the pod never went idle within the drain budget —
                # e.g. an UNCHECKPOINTED stream can never observe the
                # quiesce request (the gate rides the checkpoint
                # write).  Reforming up now would tear the process
                # group down under the live collective schedule, so
                # DEFER the growth: resume the pod untouched; the
                # rejoiner's attach() times out pointedly and its
                # next doorbell rings through (latch reset below).
                _podwatch.clear_quiesce()
                _obs.event("supervisor.rejoin_deferred",
                           idents=sorted(rejoins))
                with self._lock:
                    self._pending_rejoins -= rejoins
                for ident in rejoins:
                    _podwatch.rejoin_reset(ident)
                if self.on_resume is not None:
                    try:
                        n = int(_multihost.process_count())
                    except Exception:  # noqa: BLE001
                        n = 0
                    try:
                        self.on_resume({"nproc": n, "rejoined": [],
                                        "gen": self._gen,
                                        "deferred": sorted(rejoins)})
                    except Exception:  # noqa: BLE001
                        pass
                self._recovered.set()
                return
        w = _podwatch._WATCH
        if w is not None:
            self._probe = (w.nproc, w.pid,
                           getattr(w.transport, "path", None),
                           w.interval, w.timeout)
        delay = self.backoff
        attempt = 0
        while not self._stop.is_set():
            try:
                _chaos.hit("supervisor.elect")
                with self._lock:        # fold late arrivals in
                    deaths |= self._pending_deaths
                    rejoins |= {r for r in self._pending_rejoins
                                if r not in self._quarantine}
                members = self._members(rejoins)
                if not members:
                    raise SuperviseError(
                        "no surviving members to reform onto "
                        "(deaths %s, quarantine %s)"
                        % (sorted(deaths), sorted(self._quarantine)))
                plan = self._drive_plan(members)
                info = self._reform(plan, _multihost)
            except Exception as exc:    # noqa: BLE001 — one attempt
                attempt += 1
                if attempt > self.retries:
                    raise SuperviseError(
                        "supervised recovery abandoned after %d "
                        "attempt(s): %s" % (attempt, exc)) from exc
                self._counters.add("backoffs")
                _obs.event("supervisor.backoff", attempt=attempt,
                           delay=round(delay, 3),
                           error=type(exc).__name__)
                self._stop.wait(delay)
                delay *= 2
                self._reprobe()
                continue
            break
        if self._stop.is_set():
            return
        # success: bookkeeping, marker hygiene, resume
        _podwatch.clear_quiesce()
        with self._lock:
            self._gen = plan["gen"]
            self._pending_deaths -= deaths
            self._pending_rejoins -= rejoins
            self._joined |= rejoins
            # new rank -> identity: plan order IS the new rank order;
            # incumbents carry their identity from the OLD rank map
            self._ident_by_rank = {
                idx: (m[1] if m[0] == "r" else self._ident_of(m[1]))
                for idx, m in enumerate(plan["members"])}
            for ident in rejoins:
                strikes = self._strikes.get(ident, 0)
                if strikes >= self.quarantine_after:
                    self._quarantine.add(ident)
        tr = _podwatch.transport()
        if tr is not None:
            for ident in rejoins:       # consumed doorbells; removal
                try:                    # races across members are benign
                    tr.rejoin_clear(ident)
                except Exception:       # noqa: BLE001
                    pass
        self._counters.update(reforms=1, rejoins=len(rejoins),
                              supervise_seconds=_clock() - t0)
        with self._lock:
            self._last["last_recovery_seconds"] = _clock() - t0
        self.failed = None
        if self.on_resume is not None:
            try:
                self.on_resume(info)
            except Exception:           # noqa: BLE001
                pass
        self._recovered.set()

    def _drive_plan(self, members):
        """Elect + publish/fetch the reform plan for ``members``.  The
        coordinator is the LOWEST surviving incumbent rank; it
        allocates a fresh port and publishes {addr, members, epoch,
        gen} through the transport; followers poll the same generation
        until it lands.  Returns the plan dict."""
        tr = _podwatch.transport()
        if tr is None:
            raise SuperviseError(
                "no liveness transport to carry the reform plan (the "
                "watch is not running); supervision needs "
                "BOLT_POD_HB_DIR or a live KV store")
        incumbents = [m[1] for m in members if m[0] == "i"]
        me = self._my_rank()
        deadline = _podwatch.deadline() or 5.0
        if incumbents and me == incumbents[0]:
            gens = tr.plan_gens()
            gen = (max(gens) if gens else self._gen) + 1
            # epoch strides by 2: the +1 slot between plan epochs is
            # reserved for the liveness RE-PROBE after a failed
            # attempt (_reprobe), so probe beats can never pollute the
            # next cluster's namespace
            plan = {"addr": "%s:%d" % (self.host, free_port()),
                    "members": members,
                    "epoch": int(_podwatch.epoch()) + 2,
                    "gen": int(gen)}
            tr.plan_set(gen, json.dumps(plan))
            self._tried_gens.add(int(gen))
            return plan
        # follower: adopt the newest plan NEWER than the last one this
        # member drove that names it.  The floor must be self._gen + 1,
        # not max(existing)+1 — the coordinator detects the death on
        # its own clock and its plan may already be on the transport
        # before this member's latch fires (a later floor would skip
        # that plan forever and burn the whole retry budget waiting
        # for a generation nobody will publish)
        floor = self._gen + 1
        stall = _clock() + max(4 * deadline, 10.0)
        while _clock() < stall and not self._stop.is_set():
            for g in reversed(tr.plan_gens()):
                if g < floor:
                    break
                if g in self._tried_gens:
                    continue
                raw = tr.plan_get(g)
                if raw is None:
                    continue
                plan = json.loads(raw)
                if ["i", me] in plan["members"]:
                    self._tried_gens.add(int(g))
                    return plan
            self._stop.wait(0.05)
        raise SuperviseError(
            "no reform plan published for generation >= %d within "
            "%.1fs (coordinator rank %s may have died mid-reform)"
            % (floor, max(4 * deadline, 10.0),
               incumbents[0] if incumbents else None))

    def _my_rank(self):
        """This member's rank per the liveness watch.  Refuses to
        guess when the watch is down (a rank-0 default would let a
        non-zero survivor impersonate the coordinator and publish a
        conflicting plan): the attempt fails, the backoff loop
        re-probes, and the next attempt sees a live watch or gives
        up loudly."""
        w = _podwatch._WATCH
        if w is None:
            raise SuperviseError(
                "liveness watch is down mid-recovery — cannot "
                "determine this member's rank (the re-probe before "
                "the next attempt restarts it)")
        return w.pid

    def _reform(self, plan, _multihost):
        """Drive ``multihost.reform`` from one plan; returns the
        resume info dict."""
        me = self._my_rank()
        try:
            new_pid = plan["members"].index(["i", me])
        except ValueError:
            raise SuperviseError(
                "this process (rank %d) is not in the reform plan %s"
                % (me, plan["members"]))
        rejoined = [m[1] for m in plan["members"] if m[0] == "r"]
        sp = _obs.begin("supervisor.reform", gen=plan["gen"],
                        nproc=len(plan["members"]))
        t0 = _clock()
        try:
            _multihost.reform(plan["addr"], len(plan["members"]),
                              process_id=new_pid, epoch=plan["epoch"],
                              init_timeout=self.init_timeout
                              if self.init_timeout is not None
                              else _fastfail_init_timeout())
        finally:
            _obs.end(sp)
        with self._lock:
            self._last["last_reform_seconds"] = _clock() - t0
        if len(plan["members"]) == 1 and self._probe is not None \
                and self._probe[2] is not None:
            # a pod shrunk to one rank runs no liveness watch of its own:
            # keep its rejoin door open on the shared directory, so a
            # replacement process can grow it again
            _, _, path, interval, timeout = self._probe
            _podwatch.start(1, 0, dir=path, interval=interval,
                            timeout=timeout, epoch=plan["epoch"], solo=True)
        return {"nproc": len(plan["members"]), "rejoined": rejoined,
                "gen": plan["gen"], "pid": new_pid}

    def _reprobe(self):
        """After a failed reform attempt every survivor's watch is
        down (``multihost.reform`` stops it before the bring-up) —
        restart a liveness PROBE on the shared ``epoch()+1`` slot so
        the next attempt's membership reflects who is still actually
        alive: the second victim never beats on the probe epoch, drops
        out of ``alive_peers`` and fires the death callback (strike
        counted).  Every survivor lands on the same probe epoch
        because their epoch counters were synced by the last common
        watch and plan epochs stride by 2.  Best-effort: with no
        captured watch geometry (or a KV transport whose store died)
        the next attempt just fails fast again and burns a retry."""
        if _podwatch.active() or self._probe is None:
            return
        nproc, pid, path, interval, timeout = self._probe
        try:
            _podwatch.start(nproc, pid, dir=path, interval=interval,
                            timeout=timeout,
                            epoch=int(_podwatch.epoch()) + 1)
        except Exception:             # noqa: BLE001 — probe is advisory
            return
        # give every survivor's probe beats one deadline to land (the
        # scan latches never-seen peers dead after `timeout` anyway)
        self._stop.wait(timeout + 2 * interval)


# ---------------------------------------------------------------------
# module doors
# ---------------------------------------------------------------------

def active():
    """The process's installed :class:`Supervisor`, or ``None``."""
    return _ACTIVE


def attach(identity, dir=None, host=None, timeout=120, retries=None,
           backoff=None, device=None, backend=None):
    """The REJOINER's door: announce this (restarted or replacement)
    process to a running pod, wait for the incumbents' reform plan,
    join the re-expanded cluster, and return a running
    :class:`Supervisor` for it (a member that just proved pods flap
    should supervise like any other).

    ::

        sup = supervisor.attach("worker-7b", dir="/shared/hb")
        # ... this process is now rank k of the grown pod; re-submit
        # the pod pipeline and it resumes from the shared checkpoint

    ``identity`` is any string unique among concurrent rejoiners;
    ``dir`` the shared transport directory (default
    ``BOLT_POD_HB_DIR``); ``device`` and ``backend`` the rank's
    ``torch.device`` and the pod's backend, as ``multihost.initialize``
    takes them (a fresh process has brought nothing up).  Raises :class:`SuperviseError` when no plan
    naming this identity lands within ``timeout`` seconds (the pod may
    be gone, or this identity is quarantined)."""
    # the transport sanitizes marker filenames, so the incumbents'
    # plan names the SANITIZED identity — compare with the same form
    # or an identity like "worker:7" could never match its own plan
    identity = _podwatch._safe_ident(identity)
    tr = _podwatch.rejoin(identity, dir=dir)
    known = set(tr.plan_gens())
    t0 = _clock()
    plan = None
    while _clock() - t0 < timeout:
        for g in reversed(tr.plan_gens()):
            if g in known:
                break
            raw = tr.plan_get(g)
            if raw is None:
                continue
            cand = json.loads(raw)
            if ["r", identity] in cand["members"]:
                plan = cand
                break
        if plan is not None:
            break
        time.sleep(0.05)
    if plan is None:
        raise SuperviseError(
            "rejoin %r: no reform plan named this identity within "
            "%.0fs — the pod may be gone, idle with supervision off, "
            "or this identity is quarantined" % (identity, timeout))
    from bolt_tpu_torch.parallel import multihost as _multihost
    new_pid = plan["members"].index(["r", identity])
    sp = _obs.begin("supervisor.reform", gen=plan["gen"],
                    nproc=len(plan["members"]), rejoiner=1)
    try:
        _multihost.reform(plan["addr"], len(plan["members"]),
                          process_id=new_pid, epoch=plan["epoch"],
                          init_timeout=_fastfail_init_timeout(),
                          device=device, backend=backend)
    finally:
        _obs.end(sp)
    # seed the new member's rank -> identity map from the plan it
    # joined by, so ITS strike/quarantine attribution starts correct
    ident_map = {idx: (m[1] if m[0] == "r" else "i%d" % m[1])
                 for idx, m in enumerate(plan["members"])}
    # seed gen/joined from the plan too: the follower adoption floor
    # is _gen + 1, so a fresh supervisor at gen 0 could re-adopt a
    # RETAINED stale plan generation on its next recovery (sweep_epochs
    # keeps the last two) and reform against a dead coordinator; and
    # this plan's rejoiners are members now — their sweep-lag doorbell
    # duplicates must be dropped like the incumbents drop them
    return Supervisor(retries=retries, backoff=backoff, host=host,
                      ident_map=ident_map, gen=plan["gen"],
                      joined=[m[1] for m in plan["members"]
                              if m[0] == "r"])
