"""Multi-tenant serving layer: many pipelines, one engine, one card.

Port of ``bolt_tpu/serve.py``.  Everything below this module runs one
pipeline at a time; a process serving traffic runs many at once, and two
naive concurrent streams each assume they own the card's memory.  This
module lets N tenants share one process and one device:

* a **device-memory arbiter** (:class:`DeviceArbiter`): one process-wide
  bytes budget.  Streamed slab uploads (``bolt_tpu_torch.stream``
  acquires per slab, in slab order, and releases when the consumer
  confirms the slab retired) and in-memory jobs (the worker leases a
  pipeline's estimated working set) draw from it.  Waiters queue per
  tenant and are granted round-robin across tenants, FIFO within one;
  the executor's re-sequencer keeps each tenant's fold bit-exact
  whatever order grants come in;
* a **fair-share scheduler** (:class:`Server`): ``submit(pipeline,
  tenant=...)`` returns a :class:`Future`; worker threads pop jobs
  round-robin across per-tenant queues (``weights={tenant: n}`` serves
  up to *n* queued jobs of a tenant a turn), each tenant's own jobs in
  submission order;
* a **warm start**: ``Server(start_warm=dir)`` attaches a kernel build
  directory an earlier process filled (``engine.warm_start``), so the
  first request loads the ``nvcc``-built libraries without building
  them (``persistent_warm_hits``);
* **cross-tenant coalescing of identical programs**: the engine cache
  is keyed on program structure and coalesces concurrent identical
  builds, so N tenants running one pipeline shape build it once —
  provided they share the stage callables (hoist them to module level);
* **admission control with backpressure**: the queue is bounded
  (``queue_limit``); ``policy="queue"`` blocks the submitter until room
  frees, ``policy="reject"`` raises :class:`AdmissionError`.  A pipeline
  whose least working set (``analysis.admission_floor_bytes``) exceeds
  the whole budget can never run and is rejected at submit (the
  reference's BLT010 contract);
* **continuous micro-batching** (``Server(batching=...)``): queued
  requests sharing a batch key (``bolt_tpu_torch.gpu.batched.batch_key``:
  the same pipeline structure, shapes, dtypes, terminal and device),
  across tenants, coalesce into ONE batched dispatch, each lane's result
  bit for bit its standalone result; a compiled ``sum`` runs every lane
  in one lane-batched ``fused_map_reduce`` launch.  Partial batches
  take bucketed widths (powers of two up to ``max_batch``), so steady
  state builds nothing new; a worker that found a partner lingers up to
  ``linger`` seconds to fill the bucket, a lone request never waits.
  Every future keeps its own wait, assembly and run seconds and its
  ``batch_width``; the engine counts ``batched_dispatches``/
  ``batched_requests`` and ``serve.batch_occupancy.hist`` records the
  widths (``stats()["batching"]``).

Observability: queue depth and its high-water, per-job queue wait and run
seconds (per tenant, and a log2 histogram), the arbiter's bytes in use,
high-water and waits, all in ``bolt_tpu_torch.obs.registry()`` under
``serve.*``; every job runs inside ``engine.tenant(<name>)``, so engine
counters (transfer bytes, builds, dispatches) are also tallied per
tenant, streamed ingest included.

::

    with bolt_tpu_torch.serve.serving(workers=4) as sv:
        futs = [sv.submit(make_pipeline(), tenant=t) for t in tenants]
        outs = [f.result() for f in futs]

The module-level :func:`submit` lazily starts a default server, tuned by
``BOLT_SERVE_WORKERS`` / ``BOLT_SERVE_BUDGET`` /
``BOLT_SERVE_QUEUE_LIMIT`` / ``BOLT_SERVE_BATCHING`` (with
``BOLT_SERVE_MAX_BATCH`` and ``BOLT_SERVE_LINGER``).

On a pod (:mod:`bolt_tpu_torch.parallel.podwatch`) a peer death drains
admission: in-flight streamed futures fail with ``PeerLostError`` (their
leases return), workers start nothing new, and a reject-policy server
refuses submits, until ``multihost.reform`` notifies the liveness layer
and the queue resumes (:meth:`Server.pod_paused`, ``stats()["pod"]``).
A ``PeerLostError`` retry under ``submit(retries=)`` is held behind the
drain and behind a latched quiesce.  ``Server(supervise=True)`` attaches
a recovery supervisor (``parallel.supervisor``) that drives the reform
itself and rescales the arbiter budget to the surviving share of the pod
(``supervise=`` an existing ``Supervisor`` adopts it).
"""

import contextlib
import os
import threading
from collections import OrderedDict, deque

from bolt_tpu_torch import _lockdep
from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.obs import metrics as _metrics
from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.obs.trace import clock as _clock
from bolt_tpu_torch.parallel import podwatch as _podwatch
from bolt_tpu_torch.parallel.podwatch import PeerLostError  # noqa: F401 — the
#   retryable pod outage submit(retries=) honours, re-exported

# ---------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------

# the process-wide device-memory budget of the arbiter.  The default is
# deliberately conservative (1 GiB): serving N tenants means N rings and
# N in-flight windows, and the budget keeps their SUM bounded; size it to
# the card's free memory in production.
_DEF_BUDGET = int(os.environ.get("BOLT_SERVE_BUDGET", str(1 << 30)))
_DEF_WORKERS = max(1, int(os.environ.get("BOLT_SERVE_WORKERS", "4")))
_DEF_QUEUE = max(1, int(os.environ.get("BOLT_SERVE_QUEUE_LIMIT", "64")))
# continuous micro-batching is off unless armed (Server(batching=...);
# BOLT_SERVE_BATCHING=1 arms the default server and a bare Server())
_DEF_BATCHING = os.environ.get("BOLT_SERVE_BATCHING", "").lower() \
    in ("1", "true", "yes")

# per-tenant and global serve counters (registry groups "serve" and
# "serve/<tenant>")
_SCHEMA = {
    "submitted": 0,            # jobs accepted into the queue
    "rejected": 0,             # jobs refused (queue full / over budget)
    "completed": 0,            # jobs finished successfully
    "failed": 0,               # jobs whose pipeline raised
    "queue_wait_seconds": 0.0,  # total submit->start wait
    "run_seconds": 0.0,        # total start->finish execution time
    "retried": 0,              # per-submit retry attempts consumed
    "expired": 0,              # jobs failed on their deadline= budget
    "peer_losses": 0,          # pod peer deaths observed
    "reforms": 0,              # supervised reforms driven
    "rejoins": 0,              # identities folded back in by a reform up
    "supervise_seconds": 0.0,  # total pause -> resume recovery wall
}


class AdmissionError(RuntimeError):
    """A submission the server refused: the bounded queue is full under
    ``policy="reject"``, or the pipeline's least device working set
    exceeds the arbiter's whole budget (BLT010: it could never run)."""


class DeadlineError(RuntimeError):
    """A job's ``deadline=`` budget (seconds since submit) expired before
    it could start; delivered through ``Future.result()``."""


class BatchPolicy:
    """Continuous micro-batching policy (``Server(batching=...)``):

    * ``max_batch``: the widest coalesced dispatch (default
      ``BOLT_SERVE_MAX_BATCH`` / 16);
    * ``linger``: seconds a worker waits to FILL a batch once its gather
      found at least one partner (default ``BOLT_SERVE_LINGER`` /
      0.002); a lone request never lingers;
    * ``buckets``: the batch widths programs are built for (default
      powers of two up to ``max_batch``); a partial batch takes the next
      bucket, so steady state builds nothing new;
    * ``autotune`` (off by default): :meth:`rearm` (called by
      ``batched.warm(make, policy=...)``) re-derives the buckets from the
      observed ``serve.batch_occupancy.hist``
      (``batched.autotune_buckets``).
    """

    __slots__ = ("max_batch", "linger", "buckets", "autotune")

    def __init__(self, max_batch=None, linger=None, buckets=None,
                 autotune=False):
        from bolt_tpu_torch.gpu import batched as _batched
        self.autotune = bool(autotune)
        if buckets:
            buckets = tuple(sorted(int(b) for b in buckets))
            if buckets[0] < 2:
                raise ValueError("batch buckets must be >= 2, got %r"
                                 % (buckets,))
            if max_batch is None:
                max_batch = buckets[-1]
        self.max_batch = int(max_batch if max_batch is not None
                             else _batched.DEFAULT_MAX_BATCH)
        if self.max_batch < 2:
            raise ValueError("max_batch must be >= 2, got %d"
                             % self.max_batch)
        self.linger = float(linger if linger is not None
                            else _batched.DEFAULT_LINGER)
        if self.linger < 0:
            raise ValueError("linger must be >= 0 seconds, got %r"
                             % (linger,))
        self.buckets = buckets or _batched.buckets_for(self.max_batch)
        if self.buckets[-1] != self.max_batch:
            raise ValueError(
                "the largest bucket (%d) must EQUAL max_batch (%d): a "
                "smaller one cannot serve a full batch, a larger one "
                "would pad every dispatch past the promised widest "
                "width" % (self.buckets[-1], self.max_batch))

    def rearm(self, hist_buckets=None):
        """Autotune re-arm: replace :attr:`buckets` with the set
        ``batched.autotune_buckets`` derives from the observed
        ``serve.batch_occupancy.hist`` (``hist_buckets`` overrides the
        registry read).  True when the buckets were replaced; False when
        ``autotune`` is off or nothing was observed yet.  The derived set
        always ends at ``max_batch``."""
        if not self.autotune:
            return False
        from bolt_tpu_torch.gpu import batched as _batched
        if hist_buckets is None:
            hist_buckets = _metrics.registry().histogram(
                "serve.batch_occupancy.hist", lo=0, hi=9).buckets()
        derived = _batched.autotune_buckets(hist_buckets, self.max_batch)
        if derived is None:
            return False
        self.buckets = derived
        return True

    def __repr__(self):
        return ("BatchPolicy(max_batch=%d, linger=%g, buckets=%s%s)"
                % (self.max_batch, self.linger, self.buckets,
                   ", autotune" if self.autotune else ""))


# ---------------------------------------------------------------------
# the device-memory arbiter
# ---------------------------------------------------------------------

class _Ticket:
    __slots__ = ("nbytes", "granted", "skipped")

    def __init__(self, nbytes):
        self.nbytes = nbytes
        self.granted = False
        self.skipped = 0      # grants that bypassed this waiting head


# grants that may bypass a waiting head ticket before the arbiter stops
# feeding newer requests and drains toward it (without this barrier,
# sustained small-slab traffic keeps the bytes in use high forever and a
# large request never sees the budget it needs)
_STARVE_LIMIT = 64


class DeviceArbiter:
    """Process-wide bytes-weighted device-memory budget.

    ``acquire(nbytes, tenant)`` blocks until the bytes fit (or the
    caller's ``stop`` event fires); ``release(nbytes)`` returns them.
    Waiters queue FIFO per tenant and are granted round-robin across
    tenants, with one escape: a request larger than the whole budget is
    granted when nothing else holds bytes (it runs alone), so an
    oversized slab degrades to serial execution instead of hanging.

    Prefer :meth:`lease`: an :class:`ArbiterLease` tracks its own
    outstanding bytes and ``close()`` returns whatever an aborted run
    still held.
    """

    def __init__(self, budget_bytes):
        self.budget = int(budget_bytes)
        if self.budget <= 0:
            raise ValueError("arbiter budget must be positive, got %d"
                             % self.budget)
        self._cond = _lockdep.condition("serve.arbiter")
        self._used = 0
        self._queues = OrderedDict()       # tenant -> deque[_Ticket]
        self._ring = deque()               # tenants with waiters (RR)
        reg = _metrics.registry()
        self._g_used = reg.gauge("serve.arbiter_in_use_bytes")
        self._g_hw = reg.gauge("serve.arbiter_in_use_high_water")
        self._c_waits = reg.counter("serve.arbiter_waits")
        self._c_wait_s = reg.counter("serve.arbiter_wait_seconds", 0.0)

    def in_use(self):
        with self._cond:
            return self._used

    def waiting(self):
        """Queued (ungranted) requests across all tenants."""
        with self._cond:
            return sum(len(q) for q in self._queues.values())

    def _fits(self, nbytes):
        return self._used + nbytes <= self.budget or self._used == 0

    def _grant_locked(self):
        """Round-robin across tenants with waiters, FIFO within each:
        grant every head ticket that fits, looping until a full cycle
        grants nothing.  The rotation advances past a grantee, so the
        next grant starts at the tenant after the last one served."""
        made = True
        while made and self._ring:
            made = False
            # a head ticket bypassed more than _STARVE_LIMIT times becomes
            # the only grantable one: releases then drain toward it
            starved = None
            for q in self._queues.values():
                tk = q[0] if q else None
                if tk is not None and tk.skipped >= _STARVE_LIMIT and \
                        (starved is None or tk.skipped > starved.skipped):
                    starved = tk
            for _ in range(len(self._ring)):
                t = self._ring[0]
                q = self._queues.get(t)
                tk = q[0] if q else None
                if tk is not None and self._fits(tk.nbytes) \
                        and (starved is None or tk is starved):
                    q.popleft()
                    tk.granted = True
                    self._used += tk.nbytes
                    made = True
                    for q2 in self._queues.values():  # age bypassed heads
                        if q2 and q2[0] is not tk:
                            q2[0].skipped += 1
                    self._ring.rotate(-1)   # the next cycle starts after t
                    break                   # rescan from the new head
                self._ring.rotate(-1)
        for t in [t for t, q in self._queues.items() if not q]:
            del self._queues[t]
            try:
                self._ring.remove(t)
            except ValueError:
                pass
        self._g_used.set(self._used)
        self._g_hw.high_water(self._used)
        self._cond.notify_all()

    def acquire(self, nbytes, tenant="default", stop=None):
        """Block until ``nbytes`` fit in the budget (True), or until
        ``stop`` is set (False: nothing was acquired)."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            return True
        tk = _Ticket(nbytes)
        t0 = _clock()
        with self._cond:
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._ring.append(tenant)
            q.append(tk)
            self._grant_locked()
            waited = not tk.granted
            while not tk.granted:
                if stop is not None and stop.is_set():
                    # grants happen under this lock, so an ungranted
                    # ticket is still in its queue
                    q.remove(tk)
                    self._grant_locked()   # a later head may now fit
                    return False
                self._cond.wait(0.05)
        if waited:
            self._c_waits.inc()
            self._c_wait_s.inc(_clock() - t0)
        return True

    def release(self, nbytes):
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        with self._cond:
            self._used = max(0, self._used - nbytes)
            self._grant_locked()

    def resize(self, budget_bytes):
        """Re-point the budget.  Growing grants queued waiters at once;
        shrinking never claws back granted bytes (the budget stays
        over-committed until releases drain it)."""
        budget_bytes = int(budget_bytes)
        if budget_bytes <= 0:
            raise ValueError("arbiter budget must be positive, got %d"
                             % budget_bytes)
        with self._cond:
            self.budget = budget_bytes
            self._grant_locked()

    def lease(self, tenant="default"):
        return ArbiterLease(self, tenant)


class ArbiterLease:
    """One run's handle on the arbiter: it tracks its outstanding bytes,
    so an abort path returns everything it holds with one :meth:`close`
    (idempotent; a release of bytes never acquired is clamped to the
    outstanding balance)."""

    __slots__ = ("arbiter", "tenant", "_lock", "_out")

    def __init__(self, arbiter, tenant):
        self.arbiter = arbiter
        self.tenant = tenant
        self._lock = _lockdep.lock("serve.lease")
        self._out = 0

    def outstanding(self):
        with self._lock:
            return self._out

    def acquire(self, nbytes, stop=None):
        ok = self.arbiter.acquire(nbytes, self.tenant, stop=stop)
        if ok:
            with self._lock:
                self._out += int(nbytes)
        return ok

    def release(self, nbytes):
        with self._lock:
            n = min(int(nbytes), self._out)
            self._out -= n
        if n:
            self.arbiter.release(n)

    def close(self):
        with self._lock:
            n = self._out
            self._out = 0
        if n:
            self.arbiter.release(n)


# ---------------------------------------------------------------------
# futures
# ---------------------------------------------------------------------

class Future:
    """The handle :meth:`Server.submit` returns.  ``result(timeout)``
    blocks for the pipeline's value (re-raising its exception);
    ``wait_seconds``/``run_seconds`` are the job's queue and execution
    time once known; ``batch_width``/``assembly_seconds`` its coalesced
    dispatch's width and its gather window (``None`` when it ran
    standalone)."""

    __slots__ = ("tenant", "_event", "_result", "_exc", "submitted_s",
                 "started_s", "finished_s", "batch_width",
                 "assembly_seconds")

    def __init__(self, tenant):
        self.tenant = tenant
        self._event = threading.Event()
        self._result = None
        self._exc = None
        self.submitted_s = _clock()
        self.started_s = None
        self.finished_s = None
        # micro-batching: how many requests this job's coalesced dispatch
        # served, and its assembly window (gather scan + linger + claim:
        # pop to dispatch begin; the execution is run_seconds')
        self.batch_width = None
        self.assembly_seconds = None

    def done(self):
        return self._event.is_set()

    def _finish(self, result=None, exc=None):
        self._result = result
        self._exc = exc
        self.finished_s = _clock()
        self._event.set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("serve job still pending after %ss"
                               % timeout)
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("serve job still pending after %ss"
                               % timeout)
        return self._exc

    @property
    def wait_seconds(self):
        """Submit -> start queue wait (None until started)."""
        if self.started_s is None:
            return None
        return self.started_s - self.submitted_s

    @property
    def run_seconds(self):
        """Start -> finish execution time (None until finished)."""
        if self.started_s is None or self.finished_s is None:
            return None
        return self.finished_s - self.started_s

    def __repr__(self):
        state = ("done" if self.done()
                 else "running" if self.started_s is not None
                 else "queued")
        return "<serve.Future tenant=%r %s>" % (self.tenant, state)


# ---------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------

def _normalise(pipeline):
    """One job shape: a zero-argument callable returning the result.  A
    zero-argument callable runs as it is; a bolt array carrying lazy
    state (a pending stat, a deferred chain, a stream) resolves through
    ``.cache()`` and is returned; anything else is refused at once."""
    if callable(pipeline) and not hasattr(pipeline, "cache"):
        return pipeline, None
    cache = getattr(pipeline, "cache", None)
    if callable(cache):
        return (lambda: pipeline.cache()), pipeline
    raise TypeError(
        "serve.submit needs a zero-arg callable or a bolt array "
        "pipeline (got %r)" % type(pipeline).__name__)


def _estimate(arr):
    """The least device working set of a bolt-array pipeline (the
    admission floor: one slab for a stream, in its wire bytes under a
    codec; base + result in memory), or None when nothing can be
    estimated."""
    try:
        h = getattr(arr, "_spending", None)
        if h is not None and h.group.kind == "chain":
            # the small-request shape's fast path: a chain group's floor
            # is its one-pass read, analysis.working_set_bytes' answer
            base = h.group.base
            return int(base.numel()) * int(base.element_size())
        from bolt_tpu_torch.analysis import admission_floor_bytes
        return admission_floor_bytes(arr)
    except Exception:
        return None


class Server:
    """The multi-tenant scheduler: per-tenant FIFO queues drained
    round-robin by ``workers`` threads, every job leased against the
    shared :class:`DeviceArbiter` and run inside its tenant's
    ``engine.tenant`` scope.  See the module docstring."""

    def __init__(self, workers=None, budget_bytes=None, queue_limit=None,
                 policy="queue", weights=None, start_warm=None,
                 supervise=False, batching=None):
        if policy not in ("queue", "reject"):
            raise ValueError("policy must be 'queue' or 'reject', got %r"
                             % (policy,))
        if batching is None:
            batching = _DEF_BATCHING
        self.batching = None
        self._batched = None
        if batching:
            if batching is True:
                self.batching = BatchPolicy()
            elif isinstance(batching, BatchPolicy):
                self.batching = batching
            elif isinstance(batching, dict):
                self.batching = BatchPolicy(**batching)
            else:
                raise ValueError(
                    "batching must be True/False, a dict of BatchPolicy "
                    "kwargs, or a BatchPolicy (got %r)" % (batching,))
            # arm() happens at the END of __init__: a constructor that
            # raises past this point must not leak the armed count
        self.workers = int(workers if workers is not None
                           else _DEF_WORKERS)
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else _DEF_QUEUE)
        self.policy = policy
        # weighted fair share: tenant -> jobs served per turn (default 1,
        # the plain round-robin); any tenant with work is served within
        # one rotation
        self._weights = {}
        if weights:
            for t, w in dict(weights).items():
                w = int(w)
                if w < 1:
                    raise ValueError(
                        "tenant weight must be a positive integer, got "
                        "%r for tenant %r" % (w, t))
                self._weights[str(t)] = w
        self._credits = {}             # tenant -> credits left this turn
        # warm start: attach an earlier process's kernel build directory
        # before the first submit (engine.persistent_warm_hits is the
        # proof that no nvcc ran)
        self.warm_dir = None
        if start_warm is not None:
            self.warm_dir = _engine.warm_start(start_warm)
        self.arbiter = DeviceArbiter(budget_bytes if budget_bytes
                                     is not None else _DEF_BUDGET)
        self._cond = _lockdep.condition("serve.scheduler")
        self._queues = OrderedDict()       # tenant -> deque of jobs
        self._ring = deque()               # tenants with queued jobs
        self._depth = 0
        self._closing = False
        self._stop = threading.Event()     # workers exit once drained
        self._cancel = threading.Event()   # close(wait=False) only: a
        #                                    leased job's arbiter wait
        #                                    survives a clean drain
        # the pod half: a peer death drains admission until
        # multihost.reform notifies the liveness layer (deregistered on
        # close)
        self._pod_ok = threading.Event()
        self._pod_ok.set()
        self._pod_lost = None
        self._pod_reason = None
        self._pause_t0 = None
        self._pw_handles = (
            _podwatch.on_peer_death(self._on_peer_death),
            _podwatch.on_reform(self._on_pod_reform))
        # supervise=True: a recovery supervisor drives the reform itself
        # and the arbiter budget follows the surviving share of the pod;
        # an existing Supervisor (supervisor.attach's) is adopted
        self.supervisor = None
        self._own_supervisor = False
        self._budget0 = None
        self._pod_nproc0 = None
        if supervise:
            from bolt_tpu_torch.parallel import multihost as _multihost
            from bolt_tpu_torch.parallel import supervisor as _supervisor
            self._budget0 = self.arbiter.budget
            n = _multihost.process_count()
            self._pod_nproc0 = n if n > 1 else None
            if supervise is True:
                self.supervisor = _supervisor.Supervisor(
                    on_pause=self._sup_pause, on_resume=self._sup_resume)
                self._own_supervisor = True
            else:
                self.supervisor = supervise
                self.supervisor.on_pause = self._sup_pause
                self.supervisor.on_resume = self._sup_resume
        reg = _metrics.registry()
        self._counters = reg.group("serve", _SCHEMA)
        self._tc_cache = {}            # tenant -> registry group (memo)
        self._g_depth = reg.gauge("serve.queue_depth")
        self._g_depth_hw = reg.gauge("serve.queue_depth_high_water")
        self._h_wait = reg.histogram("serve.queue_wait_seconds.hist")
        # one observation per coalesced dispatch: the requests it served
        # (log2 buckets cover 1..256)
        self._h_occ = reg.histogram("serve.batch_occupancy.hist",
                                    lo=0, hi=9)
        self._threads = [
            threading.Thread(target=self._worker,
                             name="bolt-serve-worker-%d" % i, daemon=True)
            for i in range(self.workers)]
        for th in self._threads:
            th.start()
        if self.batching is not None:
            # last: nothing past here raises, so the armed count never
            # leaks without a server owning its disarm
            from bolt_tpu_torch.gpu import batched as _batched
            self._batched = _batched
            _batched.arm()            # opens reduce()'s lazy door

    # -- the pod half (bolt_tpu_torch.parallel.podwatch) ---------------

    def _on_peer_death(self, pid):
        """Liveness callback (watch thread): a pod peer died; drain
        admission until the pod reforms."""
        self._pod_lost = pid
        self._pod_ok.clear()
        self._counters.add("peer_losses")
        _obs.event("serve.peer_lost", peer=pid)
        with self._cond:
            self._cond.notify_all()

    def _on_pod_reform(self):
        """Liveness callback: ``multihost.reform`` rebuilt the pod;
        resume the queue."""
        self._pod_lost = None
        self._pod_ok.set()
        _obs.event("serve.pod_resumed")
        with self._cond:
            self._cond.notify_all()

    def pod_paused(self):
        """Is admission drained behind a pod peer loss or a supervised
        recovery?"""
        return not self._pod_ok.is_set()

    def _sup_pause(self, reason):
        """Supervisor hook: a recovery started (a death or a rejoin's
        quiesce); drain admission like a raw peer loss."""
        if self._pod_nproc0 is None:
            # a server built before multihost.initialize read a width
            # of 1: take the pre-loss width now, or the resume after a
            # shrink would count the SHRUNK width as full capacity
            from bolt_tpu_torch.parallel import multihost as _multihost
            n = _multihost.process_count()
            self._pod_nproc0 = n if n > 1 else None
        self._pod_reason = reason
        self._pause_t0 = _clock()
        self._pod_ok.clear()
        _obs.event("serve.supervise_pause", reason=str(reason))
        with self._cond:
            self._cond.notify_all()

    def _sup_resume(self, info):
        """Supervisor hook: the reform landed.  Count it, rescale the
        arbiter budget to the surviving share of the pod (BLT010 floors
        recompute against it on the next submit), resume the queue."""
        keys = {"rejoins": len(info.get("rejoined", ()))}
        if not info.get("deferred"):
            # a deferred growth resumed the pod untouched: no reform
            keys["reforms"] = 1
        if self._pause_t0 is not None:
            keys["supervise_seconds"] = _clock() - self._pause_t0
            self._pause_t0 = None
        self._counters.update(**keys)
        nproc = int(info.get("nproc") or 0)
        if nproc >= 1 and self._budget0 is not None:
            if nproc > (self._pod_nproc0 or 1):
                self._pod_nproc0 = nproc      # a full-capacity sighting
            if self._pod_nproc0 is not None:
                # a pod shrunk to one rank keeps its share (1/n): the
                # width it was built at is still the full capacity
                share = nproc / self._pod_nproc0
                self.arbiter.resize(max(1, int(self._budget0 * share)))
        self._pod_reason = None
        self._pod_lost = None
        self._pod_ok.set()
        _obs.event("serve.supervise_resume", nproc=nproc)
        with self._cond:
            self._cond.notify_all()

    # -- submission ----------------------------------------------------

    def _tenant_counters(self, tenant):
        # memoised: the registry lookup is a per-request cost at
        # small-request rates
        g = self._tc_cache.get(tenant)
        if g is None:
            g = self._tc_cache[tenant] = _metrics.registry().group(
                "serve/%s" % tenant, _SCHEMA)
        return g

    def _reject(self, tenant, why):
        self._counters.add("rejected")
        self._tenant_counters(tenant).add("rejected")
        raise AdmissionError(why)

    def submit(self, pipeline, tenant="default", retries=0,
               deadline=None):
        """Queue ``pipeline`` for tenant ``tenant``; returns a
        :class:`Future`.  Raises :class:`AdmissionError` when the
        pipeline can never fit the arbiter's budget (BLT010), or when the
        queue is full under ``policy="reject"``; under
        ``policy="queue"`` a full queue blocks the submitter until a
        worker frees a slot.

        ``retries=n`` re-runs a raising job up to *n* times on its worker
        (each attempt's exception chained to the one before; the lease
        spans the attempts and is always returned); ``deadline=s`` bounds
        the seconds since submit: a job still queued past it fails with
        :class:`DeadlineError` instead of running, and an expired
        deadline stops further retries.  Neither touches other tenants'
        futures."""
        if self._closing:
            raise RuntimeError("serve.Server is closed")
        tenant = str(tenant)
        if not self._pod_ok.is_set():
            # admission is drained behind a pod loss: a reject-policy
            # server refuses, a queue-policy one applies backpressure
            # until the pod reforms
            if self.policy == "reject":
                why = ("pod peer %s was lost" % self._pod_lost
                       if self._pod_lost is not None
                       else "supervised recovery in progress (%s)"
                       % self._pod_reason)
                self._reject(tenant,
                             "admission drained: %s and the pod has "
                             "not reformed yet (multihost.reform "
                             "resumes the queue)" % why)
            while not self._pod_ok.wait(0.05):
                if self._closing:
                    raise RuntimeError("serve.Server is closed")
                sup = self.supervisor
                if sup is not None and sup.failed is not None:
                    self._reject(tenant,
                                 "supervised recovery abandoned (%s); "
                                 "admission stays drained until a "
                                 "manual multihost.reform" % sup.failed)
        retries = max(0, int(retries))
        if deadline is not None:
            deadline = float(deadline)
            if deadline <= 0:
                raise ValueError("deadline must be positive seconds "
                                 "since submit, got %r" % (deadline,))
        job, arr = _normalise(pipeline)
        # the submitter's ingest codec rides into the worker: stream
        # scopes are thread-local, and the admission floor below already
        # priced the wire bytes
        from bolt_tpu_torch import stream as _streamlib
        cname = _streamlib.current_codec()
        if cname is not None:
            inner = job

            def job():
                with _streamlib.codec(cname):
                    return inner()
        est = _estimate(arr) if arr is not None else None
        if est is not None and est > self.arbiter.budget:
            # BLT010: it could never run, and admitting it would wedge a
            # worker forever
            self._reject(tenant,
                         "pipeline needs ~%d bytes of device memory but "
                         "the serving budget is %d bytes (BLT010); "
                         "shrink the slabs/operand or raise "
                         "budget_bytes" % (est, self.arbiter.budget))
        fut = Future(tenant)
        # a stream leases per slab inside the executor: an upfront worker
        # lease on top would charge the budget twice (and deadlock it
        # when the budget is about one slab).  A stream is a raw
        # stream-backed array or a pending stat of a stream group.
        streaming = False
        if arr is not None:
            if getattr(arr, "_stream", None) is not None:
                streaming = True
            else:
                h = getattr(arr, "_spending", None)
                if h is not None and h.group.kind == "stream":
                    streaming = True
        # the batch key: None keeps the job standalone (callables,
        # streams, donating chains, batching off)
        bkey = None
        bt = self._batched            # close() clears it: a submit racing
        if bt is not None and arr is not None and not streaming:
            bkey = bt.batch_key(arr)  # a close gets the closed error
        admitted = False
        with self._cond:
            while self._depth >= self.queue_limit and not self._closing \
                    and self.policy != "reject":
                self._cond.wait(0.05)     # backpressure: block submitter
            if self._closing:
                raise RuntimeError("serve.Server is closed")
            if self._depth < self.queue_limit:
                q = self._queues.get(tenant)
                if q is None:
                    q = self._queues[tenant] = deque()
                    self._ring.append(tenant)
                q.append((fut, job, None if streaming else est, retries,
                          deadline, bkey,
                          arr if bkey is not None else None))
                self._depth += 1
                self._g_depth.set(self._depth)
                self._g_depth_hw.high_water(self._depth)
                self._cond.notify_all()
                admitted = True
        if not admitted:
            self._reject(tenant,
                         "admission queue is full (%d queued, limit %d, "
                         "policy='reject')" % (self.queue_limit,
                                               self.queue_limit))
        self._counters.add("submitted")
        self._tenant_counters(tenant).add("submitted")
        return fut

    # -- the worker loop -----------------------------------------------

    def _pop(self):
        """The next job, weighted round-robin across tenants (FIFO within
        one); None once the server is draining and every queue is empty.
        A tenant at the head of the ring is served up to its weight of
        jobs before the rotation advances; a tenant whose queue drains
        mid-turn forfeits the rest of its turn."""
        with self._cond:
            while True:
                if not self._pod_ok.is_set() and not self._stop.is_set():
                    # a pod loss drains: running jobs finish (or fail
                    # with PeerLostError), nothing new starts until the
                    # reform (a closing server still drains)
                    self._cond.wait(0.05)
                    continue
                for _ in range(len(self._ring)):
                    t = self._ring[0]
                    q = self._queues.get(t)
                    if not q:
                        self._ring.rotate(-1)
                        continue
                    item = q.popleft()
                    credit = self._credits.pop(
                        t, self._weights.get(t, 1)) - 1
                    if not q:
                        del self._queues[t]
                        self._ring.remove(t)
                    elif credit > 0:
                        self._credits[t] = credit   # stay at the head
                    else:
                        self._ring.rotate(-1)
                    self._depth -= 1
                    self._g_depth.set(self._depth)
                    self._cond.notify_all()
                    return t, item
                if self._stop.is_set():
                    return None
                self._cond.wait(0.05)

    def _run_attempts(self, job, fut, tenant, nretry, deadline):
        """Run one job under its retry/deadline policy: an expired
        deadline or a cancelling close stops further attempts, and the
        chaining is ``utils.chain_retry_step``, the streaming executor's
        one policy."""
        from bolt_tpu_torch.utils import chain_retry_step
        attempt = 0
        prev = None
        while True:
            try:
                return job()
            except BaseException as exc:    # noqa: BLE001 — delivered
                expired = deadline is not None and \
                    _clock() - fut.submitted_s > deadline
                allowed = attempt < nretry and not expired \
                    and not self._cancel.is_set()
                if allowed and isinstance(exc, PeerLostError):
                    # a pod outage is retryable, but only once the pod
                    # reforms: hold the re-attempt behind the admission
                    # drain, and behind a latched quiesce (rank 0 can
                    # trip the gate before this process's supervisor
                    # pauses).  A deadline, a cancel, a closing server
                    # or a supervisor giveup cuts the hold off.
                    while allowed and (
                            not self._pod_ok.wait(0.05)
                            or _podwatch.quiesce_requested()
                            is not None):
                        if _podwatch.quiesce_requested() is not None:
                            self._stop.wait(0.05)
                        if self._cancel.is_set() or self._stop.is_set() \
                                or (deadline is not None
                                    and _clock() - fut.submitted_s
                                    > deadline):
                            allowed = False
                        sup = self.supervisor
                        if sup is not None and sup.failed is not None:
                            allowed = False
                if allowed:
                    self._counters.add("retried")
                    self._tenant_counters(tenant).add("retried")
                    _obs.event("serve.retry", tenant=tenant,
                               attempt=attempt + 1,
                               error=type(exc).__name__)
                prev = chain_retry_step(exc, prev, attempt, allowed,
                                        "serve job", "submit retries=")
                attempt += 1

    def _worker(self):
        while True:
            got = self._pop()
            if got is None:
                return
            tenant, item = got
            extras = ()
            t_gather = _clock()
            if item[5] is not None and self.batching is not None:
                extras = self._gather_batch(item[5], item[2])
            if extras:
                self._run_batch([(tenant, item)] + extras, t_gather)
            else:
                self._run_one(tenant, item)

    def _run_one(self, tenant, item):
        """Run one job standalone."""
        fut, job, est, nretry, deadline = item[:5]
        fut.started_s = _clock()
        wait = fut.started_s - fut.submitted_s
        self._counters.add("queue_wait_seconds", wait)
        self._tenant_counters(tenant).add("queue_wait_seconds", wait)
        self._h_wait.observe(wait)
        sp = _obs.begin("serve.run", tenant=tenant,
                        queued_s=round(wait, 6))
        lease = self.arbiter.lease(tenant) if est else None
        try:
            with _engine.tenant(tenant):
                if deadline is not None and wait > deadline:
                    # expired while queued: fail without running
                    self._counters.add("expired")
                    self._tenant_counters(tenant).add("expired")
                    raise DeadlineError(
                        "deadline %.3fs exceeded before the job "
                        "started (queued %.3fs)" % (deadline, wait))
                # stop on cancel only: a close(wait=True) drain lets a
                # queued leased job wait out the arbiter and run
                if lease is not None and not lease.acquire(
                        est, stop=self._cancel):
                    raise RuntimeError(
                        "server cancelled before the job's working "
                        "set (%d bytes) was granted" % est)
                out = self._run_attempts(job, fut, tenant, nretry,
                                         deadline)
            fut._finish(result=out)
            key = "completed"
        except BaseException as exc:    # noqa: BLE001 — delivered
            fut._finish(exc=exc)        # through Future.result()
            key = "failed"
        finally:
            if lease is not None:
                lease.close()           # leases are ALWAYS returned
            _obs.end(sp)
        run_s = fut.finished_s - fut.started_s
        self._counters.update(**{key: 1, "run_seconds": run_s})
        self._tenant_counters(tenant).update(
            **{key: 1, "run_seconds": run_s})

    # -- continuous micro-batching (gpu/batched.py) ----------------------

    def _gather_batch(self, bkey, head_est):
        """Pull queued jobs sharing ``bkey``, across tenants and FIFO
        within each, up to the policy's ``max_batch``, lingering up to
        ``linger`` seconds to fill the bucket once a partner was found (a
        gather that finds nothing returns at once).  The width is also
        capped by the arbiter's budget: the coalesced lease is the
        members' working sets plus a bucket-width stacked copy, and a
        batch must not bypass the arbitration that would have serialised
        its requests.  Gathered jobs bypass the rotation's credits:
        coalescing only speeds up jobs that would each pay a dispatch."""
        pol = self.batching
        limit = pol.max_batch - 1       # the popped head is lane 0
        est = int(head_est or 0)
        if est:
            # equal keys mean equal per-request estimates: pick the widest
            # W with (W + bucket_width(W)) * est within the budget
            from bolt_tpu_torch.gpu.batched import bucket_width
            w = 1
            for cand in range(pol.max_batch, 1, -1):
                if (cand + bucket_width(cand, pol.buckets)) * est \
                        <= self.arbiter.budget:
                    w = cand
                    break
            limit = min(limit, w - 1)
        out = []
        t0 = None
        while limit > 0:
            with self._cond:
                for t in list(self._queues):
                    if len(out) >= limit:
                        break
                    q = self._queues[t]
                    keep = deque()
                    # stop once the batch fills: examined jobs of another
                    # key go back to the FRONT in order, the tail is never
                    # touched
                    while q and len(out) < limit:
                        it = q.popleft()
                        if it[5] == bkey:
                            out.append((t, it))
                            self._depth -= 1
                        else:
                            keep.append(it)
                    if keep:
                        q.extendleft(reversed(keep))
                    elif not q:
                        del self._queues[t]
                        self._ring.remove(t)
                        self._credits.pop(t, None)
                if out:
                    self._g_depth.set(self._depth)
                    self._cond.notify_all()   # free blocked submitters
                full = len(out) >= limit
                stopping = (self._closing or self._stop.is_set()
                            or self._cancel.is_set())
            if full or stopping or pol.linger <= 0 or not out:
                return out
            now = _clock()
            if t0 is None:
                t0 = now
            rem = pol.linger - (now - t0)
            if rem <= 0:
                return out
            with self._cond:
                self._cond.wait(rem)    # a submit notifies the cond
        return out      # a budget-capped width under 2: the head runs
        #                 standalone under its own arbitration

    def _run_batch(self, items, t_gather):
        """One coalesced dispatch serving ``len(items)`` same-key
        requests: each request's wait, deadline and counters first, then
        ONE claimed batched program (``batched.claim``/``dispatch``),
        then each request adopts its lane through the normal retry path.
        A failed claim or dispatch leaves every live request to its
        standalone dispatch: batching never adds a failure mode.  The
        coalesced dispatch serves several tenants, so it runs outside any
        ``engine.tenant`` scope: its engine counters land in the global
        tally only."""
        width = len(items)
        bsp = _obs.begin("serve.batch", width=width)
        t_start = _clock()
        live = []
        lease = None
        # counters apply once per (batch, tenant): locked registry
        # updates are a per-request cost at small-request rates
        agg = {}

        def _acc(tenant, **deltas):
            d = agg.setdefault(tenant, {})
            for k, v in deltas.items():
                d[k] = d.get(k, 0 if isinstance(v, int) else 0.0) + v
        try:
            for t, it in items:
                fut, _, est, _, dl = it[:5]
                fut.started_s = t_start
                wait = t_start - fut.submitted_s
                _acc(t, queue_wait_seconds=wait)
                self._h_wait.observe(wait)
                if dl is not None and wait > dl:
                    _acc(t, expired=1)
                    self._finish_batched(t, fut, None, DeadlineError(
                        "deadline %.3fs exceeded before the job "
                        "started (queued %.3fs)" % (dl, wait)), _acc)
                    continue
                live.append((t, it))
            # one lease covers the coalesced dispatch: the members'
            # working sets plus a bucket-width stacked copy, under the
            # head tenant
            total_est = sum(it[2] or 0 for _, it in live)
            if len(live) > 1 and total_est:
                total_est += self._batched.bucket_width(
                    len(live), self.batching.buckets) * max(
                    it[2] or 0 for _, it in live)
            if live and total_est:
                lease = self.arbiter.lease(live[0][0])
                if not lease.acquire(total_est, stop=self._cancel):
                    lease.close()
                    lease = None
                    for t, it in live:
                        self._finish_batched(t, it[0], None, RuntimeError(
                            "server cancelled before the batch's "
                            "working set (%d bytes) was granted"
                            % total_est), _acc)
                    live = []
            batch = None
            if len(live) > 1:
                try:
                    batch = self._batched.claim(
                        [it[6] for _, it in live], live[0][1][5])
                    if batch is not None:
                        # assembly: pop to dispatch begin (gather, linger
                        # and claim; the execution is run_seconds')
                        asm = _clock() - t_gather
                        self._batched.dispatch(batch,
                                               self.batching.buckets)
                        # realised coalescing only: members claim dropped
                        # run standalone below and keep None
                        served = {id(a) for a in batch.arrs}
                        self._h_occ.observe(len(served))
                        for _, it in live:
                            if id(it[6]) in served:
                                it[0].batch_width = len(served)
                                it[0].assembly_seconds = asm
                except BaseException:   # noqa: BLE001 — degrade: the
                    if batch is not None:   # adoption below dispatches
                        self._batched.unclaim(batch)   # standalone
            for t, it in live:
                fut, job, _, nretry, dl = it[:5]
                sp = _obs.begin("serve.run", tenant=t, batched=width)
                try:
                    try:
                        with _engine.tenant(t):
                            out = self._run_attempts(job, fut, t,
                                                     nretry, dl)
                        self._finish_batched(t, fut, out, None, _acc)
                    except BaseException as exc:    # noqa: BLE001
                        self._finish_batched(t, fut, None, exc, _acc)
                finally:
                    _obs.end(sp)
        finally:
            if lease is not None:
                lease.close()           # leases are ALWAYS returned
            for t, deltas in agg.items():
                self._counters.update(**deltas)
                self._tenant_counters(t).update(**deltas)
            _obs.end(bsp)

    def _finish_batched(self, tenant, fut, result, exc, acc):
        """Deliver one batched request's outcome as the standalone path
        does, its counters into the batch's per-tenant aggregate."""
        if exc is None:
            fut._finish(result=result)
            key = "completed"
        else:
            fut._finish(exc=exc)
            key = "failed"
        acc(tenant, **{key: 1,
                       "run_seconds": fut.finished_s - fut.started_s})

    # -- lifecycle / introspection -------------------------------------

    def queue_depth(self):
        with self._cond:
            return self._depth

    def stats(self):
        """A status dict: global serve counters, queue depth, the
        arbiter's state, a ``"batching"`` summary, and per tenant its
        serve counters, live queue depth and scoped engine counters
        (transfer bytes, dispatches, builds).

        ``"batching"`` is ``{}`` on a server without a batching policy,
        and its ``"occupancy"`` is ``{}`` until the first coalesced
        dispatch; ``"tenants"`` is ``{}`` before any submit, and a tenant
        that only queued still appears with its live ``queue_depth``."""
        reg = _metrics.registry()
        with self._cond:
            depths = {t: len(q) for t, q in self._queues.items()}
        out = {"queue_depth": self.queue_depth(),
               "queue_depth_high_water": self._g_depth_hw.value,
               "arbiter": {"budget_bytes": self.arbiter.budget,
                           "in_use_bytes": self.arbiter.in_use(),
                           "in_use_high_water": reg.gauge(
                               "serve.arbiter_in_use_high_water").value,
                           "waits": reg.counter(
                               "serve.arbiter_waits").value},
               "pod": {"paused": self.pod_paused(),
                       "lost_peer": self._pod_lost,
                       "reason": self._pod_reason,
                       "supervised": self.supervisor is not None,
                       "quarantine": (self.supervisor.quarantined()
                                      if self.supervisor is not None
                                      else []),
                       "budget_share": (
                           self.arbiter.budget / self._budget0
                           if self._budget0 else 1.0)},
               "batching": self._batching_stats(),
               "totals": self._counters.snapshot(),
               "tenants": {}}
        for name in reg.names():
            if name.startswith("serve/"):
                t = name.split("/", 1)[1]
                entry = dict(reg.get(name).snapshot())
                eng = _engine.tenant_counters(t)
                entry["transfer_bytes"] = eng["transfer_bytes"]
                entry["dispatches"] = eng["dispatches"]
                entry["aot_compiles"] = eng["aot_compiles"]
                entry["queue_depth"] = depths.pop(t, 0)
                out["tenants"][t] = entry
        for t, d in depths.items():
            # queued before its counter group existed: its live depth
            out["tenants"].setdefault(t, {})["queue_depth"] = d
        return out

    def _batching_stats(self):
        """``stats()["batching"]``: ``{}`` when batching is off; else the
        policy's knobs and the realised coalescing (the engine's
        process-wide ``batched_dispatches``/``batched_requests`` and an
        occupancy summary of ``serve.batch_occupancy.hist``)."""
        pol = self.batching
        if pol is None:
            return {}
        ec = _engine.counters()
        occ = {}
        snap = self._h_occ.snapshot()
        if snap["count"]:
            occ = {"dispatches": snap["count"],
                   "mean": round(snap["sum"] / snap["count"], 2),
                   "buckets": [(b, c) for b, c in self._h_occ.buckets()
                               if c]}
        return {"max_batch": pol.max_batch,
                "linger": pol.linger,
                "buckets": pol.buckets,
                "batched_dispatches": ec["batched_dispatches"],
                "batched_requests": ec["batched_requests"],
                "occupancy": occ}

    def close(self, wait=True):
        """Stop the server.  ``wait=True`` drains queued jobs first and
        joins the workers; ``wait=False`` fails every queued job with a
        RuntimeError and returns once the workers end their current
        job."""
        with self._cond:
            self._closing = True
            if not wait:
                self._cancel.set()
                while self._queues:
                    _, q = self._queues.popitem()
                    for fut, *_ in q:
                        fut._finish(exc=RuntimeError(
                            "serve.Server closed before this job ran"))
                self._ring.clear()
                self._depth = 0
                self._g_depth.set(0)
            self._stop.set()
            self._cond.notify_all()
        for th in self._threads:
            th.join()
        for h in self._pw_handles:
            _podwatch.remove_callback(h)   # a closed server must not
            #                                pause or resume from beyond
        if self.supervisor is not None:
            if self._own_supervisor:
                self.supervisor.close()
            else:                          # adopted: detach our hooks
                self.supervisor.on_pause = None
                self.supervisor.on_resume = None
        if self.warm_dir is not None:
            # the warm tally covers this server's lifetime; the directory
            # stays attached
            _engine.disarm_warm_start()
        if self._batched is not None:
            self._batched.disarm()     # closes reduce()'s lazy door
            self._batched = None       # (idempotent across re-close)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(wait=exc == (None, None, None))


# ---------------------------------------------------------------------
# the module-level (default-server) doors
# ---------------------------------------------------------------------

_ACTIVE = None
_ACTIVE_LOCK = _lockdep.lock("serve.active")


def start(workers=None, budget_bytes=None, queue_limit=None,
          policy="queue", weights=None, start_warm=None,
          supervise=False, batching=None):
    """Start and install THE process server (at most one: the arbiter is
    a global budget only if there is one of it).  Returns the
    :class:`Server`."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError(
                "a serve.Server is already active; stop() it first "
                "(the device-memory budget must have one owner)")
        _ACTIVE = Server(workers=workers, budget_bytes=budget_bytes,
                         queue_limit=queue_limit, policy=policy,
                         weights=weights, start_warm=start_warm,
                         supervise=supervise, batching=batching)
        return _ACTIVE


def stop(wait=True):
    """Stop and uninstall the active server (no-op when none is)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        sv, _ACTIVE = _ACTIVE, None
    if sv is not None:
        sv.close(wait=wait)


def active():
    """The installed :class:`Server`, or None."""
    return _ACTIVE


def device_arbiter():
    """The active server's :class:`DeviceArbiter` (None when no server
    runs): the door ``bolt_tpu_torch.stream`` checks per run."""
    sv = _ACTIVE
    return sv.arbiter if sv is not None else None


def submit(pipeline, tenant="default", retries=0, deadline=None):
    """Submit through the active server, starting the default one (tuned
    by the environment) when none runs."""
    global _ACTIVE
    sv = _ACTIVE
    if sv is None:
        with _ACTIVE_LOCK:
            if _ACTIVE is None:
                _ACTIVE = Server()
            sv = _ACTIVE
    return sv.submit(pipeline, tenant=tenant, retries=retries,
                     deadline=deadline)


@contextlib.contextmanager
def serving(workers=None, budget_bytes=None, queue_limit=None,
            policy="queue", weights=None, start_warm=None,
            supervise=False, batching=None):
    """Scoped server lifetime::

        with bolt_tpu_torch.serve.serving(workers=4) as sv:
            fut = sv.submit(pipeline, tenant="a")
            out = fut.result()

    Drains and stops on a clean exit; cancels queued jobs when the body
    raised.  ``weights={tenant: n}`` weights the round-robin;
    ``start_warm=dir`` loads an earlier process's kernel libraries;
    ``batching=True`` (or a :class:`BatchPolicy` or a dict of its
    arguments) arms continuous micro-batching."""
    sv = start(workers=workers, budget_bytes=budget_bytes,
               queue_limit=queue_limit, policy=policy, weights=weights,
               start_warm=start_warm, supervise=supervise,
               batching=batching)
    try:
        yield sv
    except BaseException:
        stop(wait=False)
        raise
    else:
        stop(wait=True)
