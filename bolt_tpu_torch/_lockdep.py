"""Runtime lockdep witness: the port's ONE lock inventory, ranked.

Port of ``bolt_tpu/_lockdep.py``.  Every ``Lock``/``RLock``/``Condition``
in ``bolt_tpu_torch`` is created through the factories below with a NAME
from :data:`RANKS` — the declared lock hierarchy, so the inventory below
IS the package's complete set of mutexes.  Ranks order the hierarchy
outermost-first: a thread may only acquire a lock of STRICTLY HIGHER
rank than every lock it already holds (re-entry on the same
RLock/Condition is exempt).  This module is an opt-in witness in the
spirit of Linux lockdep:

* **Off by default, one flag check when off**: the wrappers delegate
  straight to the raw primitive.  Arm with ``BOLT_LOCKDEP=1`` or
  :func:`enable`.
* **Armed**: each thread's acquisition stack is tracked; an
  acquisition that violates the rank order is recorded as a violation
  (never raised mid-flight by default — a witness that throws inside a
  worker loop would turn a diagnosis into an outage;
  ``enable(raise_on_violation=True)`` opts into throwing for tests
  that want the traceback at the acquisition site).  The observed
  nesting EDGES are kept for inspection (:func:`edges`) and cycle
  checking (:func:`check`).
* **Dispatch guard**: the engine calls :func:`note_dispatch` at every
  program dispatch; holding any ranked lock across a dispatch — a
  thread contending that lock then waits for a whole program — is a
  violation unless the lock is in :data:`DISPATCH_SAFE`
  (``multistat.group`` holds by design: ``resolve()`` runs the group's
  program under the group lock so a racing ``try_join`` can never
  extend a group mid-dispatch).

Counters land in the obs metrics registry (group ``"lockdep"``) when
the registry is importable; a thread-local busy flag keeps the
witness's own bookkeeping — which takes the registry's (ranked!) lock
— from recursing into itself.

Stdlib-only and importable standalone (``importlib`` path-load).
Modules that are themselves stdlib-only (``obs/trace.py``,
``obs/metrics.py``) load this module by path under the canonical name
``bolt_tpu_torch._lockdep`` so the package import later adopts the
SAME instance (one inventory, one witness state, however the process
started).
"""

import os
import sys
import threading
import traceback

# ---------------------------------------------------------------------
# the declared hierarchy
# ---------------------------------------------------------------------
#
# Rank = nesting depth: LOWER ranks are OUTER locks (taken first, held
# longest), HIGHER ranks are leaves.  The names of the locks that have
# a counterpart in bolt_tpu keep the reference's names and ranks; the
# load-bearing chains the table encodes:
#
#   multistat.group -> engine.order -> ops.build / mapexpr.programs ->
#                    obs.registry   (resolve() dispatches the group's
#                    program under the group lock; a dispatch may load
#                    a kernel library or compile a chain's expression
#                    program)
#   engine.cache -> mapexpr.programs (a builder may compile a chain's
#                    expression program; the engine's own builds run
#                    outside its lock, so this is the worst case)
#   stream.reseq / stream.uploader_hw / stream.ring -> obs.registry
#   serve.active -> (Server construction: scheduler, arbiter, registry
#                    gauges)
#   serve.scheduler / serve.arbiter -> obs.registry   (queue gauges set
#                    under the condition)
#
# obs.registry is the LEAF: every counter increment in the package
# ends there, from under any other lock.
RANKS = {
    # process-wide singleton gates (held across whole-subsystem
    # construction/teardown, so they sit OUTSIDE everything)
    "serve.active": 10,        # serve.py _ACTIVE_LOCK
    "analysis.strict": 14,     # analysis/__init__.py _ACTIVE_LOCK
    "batched.arm": 16,         # gpu/batched.py _ARM_LOCK
    # stat groups hold their lock across the WHOLE resolution, the
    # dispatch included (see DISPATCH_SAFE below): an OUTER lock
    "multistat.group": 18,     # gpu/multistat._StatGroup.lock
    # the serving scheduler and its device-memory arbiter
    "serve.scheduler": 34,     # serve.Server._cond
    "serve.lease": 36,         # serve.ArbiterLease._lock
    "serve.arbiter": 38,       # serve.DeviceArbiter._cond
    # the streaming executor's delivery/accounting locks
    "stream.reseq": 40,        # stream._Reseq._cond
    "stream.uploader_hw": 42,  # stream uploader high-water lock
    "stream.ring": 44,         # stream._PinnedRing._lock
    # the dispatch engine: enqueue order, per-signature compile
    # coalescing (no counterpart under torch: kept for the inventory),
    # the program cache
    "engine.order": 50,        # engine._ORDER_LOCK
    "engine.compile": 52,      # (the reference's per-signature lock)
    "engine.cache": 54,        # engine._LOCK
    # the port's own caches: chain expression programs and the kernel
    # libraries (loaded at a dispatch's first launch, so above the
    # order lock; built by nvcc under it)
    "mapexpr.programs": 56,    # ops/mapexpr.py _LOCK
    "ops.build": 58,           # ops/_build.py _LOCK
    # leaf caches / utility registries
    "gpu.lru": 60,             # gpu/array.py _LRU_LOCK (shape inference)
    "chaos.registry": 68,      # _chaos.py _LOCK (hit() fires from
    #                            under arbitrary locks; leaf by fiat)
    # observability: EVERY lock's critical section may count/trace
    "obs.trace": 70,           # obs/trace.py _LOCK
    "obs.registry": 72,        # obs/metrics.py Registry._lock (LEAF)
}

# locks that may, BY DESIGN, be held across an engine dispatch.
# multistat.group: _StatGroup.resolve() runs the group's program
# while holding the group lock — the lock is what makes the
# dispatched-group membership immutable; the dispatch inside is a
# single-threaded tail (claimants wait on the group EVENT, not the
# lock).
DISPATCH_SAFE = frozenset({"multistat.group"})

_MAX_VIOLATIONS = 256         # bounded: a hot inversion must not OOM

_ENABLED = os.environ.get("BOLT_LOCKDEP", "").lower() in ("1", "true")
_RAISE = False
_STATE_LOCK = threading.Lock()   # RAW internal lock (guards the
#                                  violation/edge records; deliberately
#                                  outside the inventory — the witness
#                                  cannot witness itself)
_VIOLATIONS = []
_EDGES = set()                   # (outer_name, inner_name) observed
_TLS = threading.local()         # .held: [[wrapper, count], ...]
#                                  .busy: reentrancy guard
_ACQUIRES = [0, 0]               # [tracked acquires, published]: a plain
#                                  GIL-racy tally — counting through the
#                                  registry would serialise EVERY lock
#                                  acquisition in the process on the
#                                  registry lock (measured 6x on the
#                                  concurrent-tenant perf suite); the
#                                  total is flushed to the obs group at
#                                  each dispatch check and on stats()


def _held():
    st = getattr(_TLS, "held", None)
    if st is None:
        st = _TLS.held = []
    return st


_GROUP = None


def _counters():
    """The obs counter group, or ``None`` standalone (the registry
    import must stay lazy: this module loads standalone by path, and
    obs.metrics itself creates its lock through us)."""
    global _GROUP
    if _GROUP is None:
        mod = sys.modules.get("bolt_tpu_torch.obs.metrics")
        if mod is None:
            return None
        try:
            _GROUP = mod.registry().group("lockdep", {
                "acquires": 0,        # tracked acquisitions while armed
                "violations": 0,      # rank inversions + unsafe
                #                       dispatches
                "dispatch_checks": 0,  # note_dispatch() calls armed
            })
        except Exception:
            return None
    return _GROUP


def _count(key, flush_acquires=False):
    if getattr(_TLS, "busy", False):
        return
    grp = _counters()
    if grp is None:
        return
    _TLS.busy = True
    try:
        if flush_acquires:
            delta = _ACQUIRES[0] - _ACQUIRES[1]
            if delta > 0:
                _ACQUIRES[1] += delta
                grp.update(**{key: 1, "acquires": delta})
                return
        grp.add(key)
    finally:
        _TLS.busy = False


def _record(kind, message):
    site = ""
    for fr in reversed(traceback.extract_stack(limit=8)[:-3]):
        if os.sep + "_lockdep" not in fr.filename:
            site = "%s:%d" % (os.path.basename(fr.filename), fr.lineno)
            break
    text = "%s: %s [thread %s, %s]" % (
        kind, message, threading.current_thread().name, site)
    with _STATE_LOCK:
        if len(_VIOLATIONS) < _MAX_VIOLATIONS:
            _VIOLATIONS.append(text)
    _count("violations")
    if _RAISE:
        raise LockOrderError(text)


class LockOrderError(RuntimeError):
    """A lock-hierarchy violation, raised at the acquisition site when
    the witness was armed with ``enable(raise_on_violation=True)``."""


def _note_acquire(wrapper):
    if getattr(_TLS, "busy", False):
        return
    held = _held()
    for ent in held:
        if ent[0] is wrapper:
            if wrapper._reentrant:
                ent[1] += 1
                return
            _record("self-deadlock",
                    "re-acquiring non-reentrant lock %r already held"
                    % wrapper.name)
            break
    _ACQUIRES[0] += 1
    rank = wrapper.rank
    new_edges = []
    for ent in held:
        o = ent[0]
        if o.rank >= rank and o is not wrapper:
            _record("inversion",
                    "acquiring %r (rank %d) while holding %r (rank %d)"
                    " — the declared order is the reverse"
                    % (wrapper.name, rank, o.name, o.rank))
        if o.name != wrapper.name:
            new_edges.append((o.name, wrapper.name))
    if new_edges:
        with _STATE_LOCK:
            _EDGES.update(new_edges)
    held.append([wrapper, 1])


def _note_release(wrapper):
    if getattr(_TLS, "busy", False):
        return
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is wrapper:
            held[i][1] -= 1
            if held[i][1] <= 0:
                del held[i]
            return
    # release of a lock acquired before arming: not a violation


class _Wrapped:
    """Delegating lock wrapper: raw-primitive speed when the witness is
    off (one module-global flag check), per-thread tracking when armed.
    ``name``/``rank`` are the inventory identity; every instance
    created under the same name shares the rank (per-object instances
    — one lock per ``_Reseq``, per ``_StatGroup`` — are the same
    hierarchy level)."""

    __slots__ = ("name", "rank", "_raw", "_reentrant")

    def __init__(self, name, raw, reentrant):
        if name not in RANKS:
            raise ValueError(
                "lock name %r is not in the declared bolt_tpu_torch lock "
                "inventory (bolt_tpu_torch/_lockdep.RANKS); add it WITH a "
                "rank before using it" % (name,))
        self.name = name
        self.rank = RANKS[name]
        self._raw = raw
        self._reentrant = reentrant

    def acquire(self, blocking=True, timeout=-1):
        if _ENABLED:
            _note_acquire(self)
        got = self._raw.acquire(blocking, timeout)
        if _ENABLED and not got:
            _note_release(self)
        return got

    def release(self):
        self._raw.release()
        if _ENABLED:
            _note_release(self)

    def locked(self):
        return self._raw.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return "<lockdep %s rank=%d %r>" % (
            "rlock" if self._reentrant else "lock", self.rank, self.name)


class _WrappedCondition(_Wrapped):
    """Condition wrapper: the condition's internal release/reacquire
    inside ``wait`` is invisible to the witness ON PURPOSE — the
    waiting thread acquires nothing while parked, and on wake it holds
    exactly what it held before, so its stack entry stays valid."""

    __slots__ = ()

    def wait(self, timeout=None):
        return self._raw.wait(timeout)

    def wait_for(self, predicate, timeout=None):
        return self._raw.wait_for(predicate, timeout)

    def notify(self, n=1):
        self._raw.notify(n)

    def notify_all(self):
        self._raw.notify_all()


def lock(name):
    """A named ``threading.Lock`` from the declared inventory."""
    return _Wrapped(name, threading.Lock(), reentrant=False)


def rlock(name):
    """A named ``threading.RLock`` from the declared inventory."""
    return _Wrapped(name, threading.RLock(), reentrant=True)


def condition(name):
    """A named ``threading.Condition`` (own RLock) from the declared
    inventory."""
    return _WrappedCondition(name, threading.Condition(), reentrant=True)


# ---------------------------------------------------------------------
# arming / inspection
# ---------------------------------------------------------------------

def enable(raise_on_violation=False):
    """Arm the witness (process-wide).  Violations are RECORDED by
    default; ``raise_on_violation=True`` additionally raises
    :class:`LockOrderError` at the offending acquisition (test mode —
    the traceback lands at the real site)."""
    global _ENABLED, _RAISE
    _RAISE = bool(raise_on_violation)
    _ENABLED = True


def disable():
    """Disarm the witness (records are kept until :func:`reset`)."""
    global _ENABLED, _RAISE
    _ENABLED = False
    _RAISE = False


def enabled():
    return _ENABLED


def reset():
    """Clear recorded violations and observed edges."""
    with _STATE_LOCK:
        del _VIOLATIONS[:]
        _EDGES.clear()


def violations():
    """Snapshot list of recorded violation strings."""
    with _STATE_LOCK:
        return list(_VIOLATIONS)


def stats():
    """Witness tallies ``{acquires, violations}`` (process lifetime).
    Also flushes the acquire tally into the obs ``lockdep`` counter
    group when the registry is importable."""
    grp = _counters()
    if grp is not None and not getattr(_TLS, "busy", False):
        _TLS.busy = True
        try:
            delta = _ACQUIRES[0] - _ACQUIRES[1]
            if delta > 0:
                _ACQUIRES[1] += delta
                grp.update(acquires=delta)
        finally:
            _TLS.busy = False
    with _STATE_LOCK:
        n_viol = len(_VIOLATIONS)
    return {"acquires": _ACQUIRES[0], "violations": n_viol}


def edges():
    """Sorted observed nesting edges ``(outer_name, inner_name)``."""
    with _STATE_LOCK:
        return sorted(_EDGES)


def held_names():
    """Names the CALLING thread currently holds (outer first)."""
    return [ent[0].name for ent in _held()]


def check():
    """Cycles in the observed edge graph (each as a name list).  With
    every lock ranked a cycle implies a recorded inversion too; this is
    the belt-and-braces view tests assert empty."""
    with _STATE_LOCK:
        graph = {}
        for a, b in _EDGES:
            graph.setdefault(a, set()).add(b)
    cycles, done = [], set()

    def dfs(node, stack, on_stack):
        done.add(node)
        on_stack.add(node)
        stack.append(node)
        for nxt in graph.get(node, ()):
            if nxt in on_stack:
                cycles.append(stack[stack.index(nxt):] + [nxt])
            elif nxt not in done:
                dfs(nxt, stack, on_stack)
        stack.pop()
        on_stack.discard(node)

    for node in sorted(graph):
        if node not in done:
            dfs(node, [], set())
    return cycles


def note_dispatch(what="engine.dispatch"):
    """Engine seam: called at every program dispatch.  Holding a ranked
    lock here (outside :data:`DISPATCH_SAFE`) is the
    held-lock-across-collective hazard — another thread blocked on that
    lock can never reach its own enqueue, and a cross-device rendezvous
    wedges."""
    if not _ENABLED:
        return
    _count("dispatch_checks", flush_acquires=True)
    for ent in _held():
        name = ent[0].name
        if name not in DISPATCH_SAFE:
            _record("dispatch-under-lock",
                    "%s while holding %r (rank %d); dispatching under "
                    "a lock stalls every thread contending it for a "
                    "full device round-trip — release before "
                    "dispatching, or add the lock to DISPATCH_SAFE "
                    "with a written justification"
                    % (what, name, ent[0].rank))
