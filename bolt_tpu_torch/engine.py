"""Central dispatch engine: ONE keyed program cache, its counters, the
donation policy and the dispatch order.

Port of ``bolt_tpu/engine.py``.  Every op family of the gpu backend
builds its program through :func:`get` (``_cached_jit`` in each module):
``get(key, builder)`` runs ``builder`` once per key — the shape
inference, the ``make_fx`` trace of a chain into an expression program
(``ops/mapexpr.py``) and whatever else a program needs before it can run
— and returns a dispatcher that calls the built program, counted and
timed, on every later use.  Under torch a program is an eager Python
callable over device tensors, so what the reference's ahead-of-time
compile buys (no trace on a cached call) is what a hit buys here.

What the reference's XLA terms mean here:

* a *build* (``misses``, ``aot_compiles``, ``lower_seconds``) is the
  builder's run: shape inference and the ``make_fx`` trace a miss pays;
* ``compile_seconds`` is ``nvcc`` time: the port's only compiler builds
  the CUDA kernel libraries (``ops/_build.py``), once per source digest;
* ``dispatches``/``dispatch_seconds`` are the host time of a cached
  program's call (launches are asynchronous; device completion is
  :func:`bolt_tpu_torch.profile.timeit`'s job);
* the persistent cache (:func:`persistent_cache`) is the directory of
  the ``nvcc``-built libraries, the only compiled artifacts that outlive
  a process: ``persistent_hits`` counts libraries loaded without
  ``nvcc``, ``persistent_misses`` real builds.

The engine also owns the **donation policy** of the pipeline terminals
(``gpu/array.py :: _chain_donate_ok``): a terminal consuming a deferred
chain may take its base tensor when the chain is the base's sole owner
and the base is at least :func:`donation_min_bytes` big.  Where the
output has the base's record shape and dtype, the terminal writes it
into the base's own storage block by block; otherwise it drops the base
as soon as it has read it.  The consumed array raises on any later
read.  ``donation(min_bytes)`` scopes the policy; ``donation(None)``
turns it off.

Keys follow the reference's convention: (op-tag, user funcs, shape,
dtype, split, device, extras) — hashable, and holding no tensor, so a
cached entry pins no device memory.
"""

import contextlib
import hashlib
import os
import re
import threading
from collections import OrderedDict, deque

from bolt_tpu_torch import _lockdep
from bolt_tpu_torch.obs import metrics as _metrics
from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.obs.trace import clock as _clock

# ---------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------

CACHE_MAX = 512                      # keyed entries (the reference's bound)

# donation floor: terminals donate sole-owned chain bases at or above this
# size.  The default is device-memory scale (64 MB): donation's win is the
# one-shot multi-GB chain whose input and output cannot both fit, while
# its cost — the consumed array serves ONE terminal — would surprise the
# interactive reuse of modest arrays.  None = off.
_DONATE_MIN_BYTES = int(os.environ.get("BOLT_DONATE_MIN_BYTES",
                                       str(64 << 20)))

_LOCK = _lockdep.rlock("engine.cache")   # guards the program cache
_CACHE = OrderedDict()               # key -> _Dispatch
_BUILDING = {}                       # key -> Event: in-flight builds, so
#                                      concurrent same-key misses coalesce

# The counters live in the obs metrics registry as the group "engine",
# under the reference's keys.  A key with no counterpart under torch stays
# 0, and its comment says why.
_SCHEMA = {
    "hits": 0,                # get() found the key
    "misses": 0,              # get() built a new entry (builder ran)
    "aot_compiles": 0,        # builds: one per miss (shape inference and
    #                           the make_fx trace run in the builder)
    "lower_seconds": 0.0,     # wall time inside builders
    "compile_seconds": 0.0,   # wall time inside nvcc (kernel libraries)
    "dispatches": 0,          # cached programs called through the engine
    "dispatch_seconds": 0.0,  # host wall time of those calls
    "fallbacks": 0,           # 0: every program is the eager callable its
    #                           builder returned; there is no second path
    "donations": 0,           # terminal donations granted
    "persistent_hits": 0,     # kernel libraries loaded without nvcc
    "persistent_misses": 0,   # kernel libraries nvcc had to build
    "persistent_warm_hits": 0,  # persistent hits while warm_start() is
    #                             armed
    "diagnostics": 0,         # findings of a static checker
    "strict_checks": 0,       # pre-dispatch checks of a strict scope
    "strict_rejections": 0,   # dispatches a strict scope refused
    # host->device traffic (bolt_tpu_torch.stream: the counted transfer)
    "transfer_bytes": 0,      # host bytes shipped to the device
    "transfer_seconds": 0.0,  # seconds inside counted transfers, summed
    #                           across uploader workers
    # the streaming executor; overlap_seconds is ingest time hidden
    # behind compute: max(0, ingest + compute - wall) per run
    "stream_chunks": 0,             # slabs streamed
    "stream_ingest_seconds": 0.0,   # produce + encode + upload, summed
    #                                 across workers
    "stream_compute_seconds": 0.0,  # consumer dispatch + sync time
    "stream_wall_seconds": 0.0,     # end-to-end wall of streamed runs
    "stream_overlap_seconds": 0.0,  # ingest hidden behind compute
    "stream_prefetch_depth": 0,     # high-water configured prefetch depth
    "stream_upload_threads": 0,     # high-water concurrent uploaders
    "stream_inflight_high_water": 0,  # high-water slab partials
    #                                   dispatched but not yet confirmed
    # 0 until the stream's retries and checkpoints are ported
    "stream_retries": 0,
    "stream_resumes": 0,
    "checkpoint_bytes": 0,
    "checkpoint_seconds": 0.0,
    # stat groups (gpu/multistat.py): one tally per group resolved
    # together, and the pending terminals it served
    "fused_stat_groups": 0,
    "fused_stat_terminals": 0,
    # concurrent lookups of one key that waited for the build in flight
    # instead of building again
    "coalesced_builds": 0,
    "coalesced_compiles": 0,  # 0: no per-signature compile under torch
    # 0 until the serving layer's micro-batching is ported
    "batched_dispatches": 0,
    "batched_requests": 0,
    # codec-encoded ingest (gpu/codec.py): raw - wire = bytes saved;
    # transfer_bytes tallies the wire bytes
    "codec_encode_seconds": 0.0,
    "codec_bytes_raw": 0,
    "codec_bytes_wire": 0,
    # 0 until the streamed shuffle is ported
    "shuffle_bytes": 0,
    "spill_bytes": 0,
    "shuffle_seconds": 0.0,
}

_COUNTERS = _metrics.registry().group("engine", _SCHEMA)

# ---------------------------------------------------------------------
# per-tenant counter scoping
# ---------------------------------------------------------------------
#
# A `tenant(name)` scope tags the calling thread; while active, every
# engine-counter increment ALSO lands in the registry group
# "engine/<name>" (same schema, same lock).  The scope is thread-local;
# bolt_tpu_torch.stream carries it into its uploader threads, so a
# streamed run's ingest traffic is attributed to the tenant that ran it.

_TENANT_TLS = threading.local()


def current_tenant():
    """The calling thread's active tenant tag (``None`` outside any
    :func:`tenant` scope)."""
    return getattr(_TENANT_TLS, "name", None)


@contextlib.contextmanager
def tenant(name):
    """Scope the calling thread's tenant tag::

        with bolt_tpu_torch.engine.tenant("team-a"):
            pipeline.sum().toarray()     # counters also land in
                                         # engine.tenant_counters("team-a")

    ``tenant(None)`` clears the tag inside the scope."""
    old = getattr(_TENANT_TLS, "name", None)
    _TENANT_TLS.name = None if name is None else str(name)
    try:
        yield
    finally:
        _TENANT_TLS.name = old


def _tenant_group():
    name = getattr(_TENANT_TLS, "name", None)
    if name is None:
        return None
    return _metrics.registry().group("engine/%s" % name, _SCHEMA)


_COUNTERS.set_mirror(_tenant_group)


def tenant_counters(name):
    """Consistent snapshot of tenant ``name``'s engine counters (all
    zeros until a :func:`tenant` scope for that name does counted
    work)."""
    return _metrics.registry().group("engine/%s" % name, _SCHEMA).snapshot()


# distributions riding on the same registry lock (log2 buckets)
_DISPATCH_HIST = _metrics.registry().histogram(
    "engine.dispatch_seconds.hist", lo=-20, hi=8)
_TRANSFER_HIST = _metrics.registry().histogram(
    "engine.transfer_bytes.hist", lo=6, hi=36)


def counters():
    """A CONSISTENT snapshot dict of the engine counters, taken under the
    registry lock every increment holds."""
    return _COUNTERS.snapshot()


def reset_counters():
    _COUNTERS.reset()


def clear():
    """Drop every cached program (counters are left alone)."""
    with _LOCK:
        _CACHE.clear()


def cache_len():
    with _LOCK:
        return len(_CACHE)


# ---------------------------------------------------------------------
# the persistent cache: the nvcc-built kernel libraries
# ---------------------------------------------------------------------

_PERSISTENT_DIR = None
_WARM_ARMED = False


def persistent_cache(cache_dir=None, enable=True):
    """Point the kernel build directory at ``cache_dir``::

        bolt_tpu_torch.engine.persistent_cache("kernel-cache")

    The libraries ``nvcc`` builds from ``ops/csrc`` are named by a digest
    of their source and flags, so a later process with the same sources
    loads them from there without running ``nvcc``
    (``persistent_hits``).  ``cache_dir=None`` is the checkout's own
    ``build/bolt_tpu_torch``.  ``enable=False`` returns to that default
    directory and reports ``None``.  Returns the resolved directory.
    Any call disarms a prior :func:`warm_start`."""
    global _PERSISTENT_DIR, _WARM_ARMED
    from bolt_tpu_torch.ops import _build
    _WARM_ARMED = False
    if not enable:
        _build.set_build_dir(None)
        _PERSISTENT_DIR = None
        return None
    cache_dir = os.path.abspath(cache_dir or _build.DEFAULT_BUILD_DIR)
    os.makedirs(cache_dir, exist_ok=True)
    _build.set_build_dir(cache_dir)
    _PERSISTENT_DIR = cache_dir
    return cache_dir


def persistent_cache_dir():
    """The directory set by :func:`persistent_cache`, or ``None``."""
    return _PERSISTENT_DIR


def warm_start(cache_dir):
    """Attach the kernel libraries at ``cache_dir`` (built there by an
    earlier process) and load every one that is already built, so the
    first kernel launch runs no ``nvcc``; each load counts a
    ``persistent_hits`` and a ``persistent_warm_hits``, until
    :func:`disarm_warm_start`.  Returns the resolved directory."""
    global _WARM_ARMED
    from bolt_tpu_torch.ops import _build
    out = persistent_cache(cache_dir)
    _WARM_ARMED = True
    _build.load_built()
    return out


def disarm_warm_start():
    """Stop counting persistent hits as warm-start hits (the directory
    stays attached)."""
    global _WARM_ARMED
    _WARM_ARMED = False


def record_library(built, seconds=0.0):
    """Tally one kernel library: built by ``nvcc`` in ``seconds``
    (``built``), or loaded from the build directory without it (fed by
    ``ops/_build.py``)."""
    if built:
        _COUNTERS.update(persistent_misses=1, compile_seconds=seconds)
    elif _WARM_ARMED:
        _COUNTERS.update(persistent_hits=1, persistent_warm_hits=1)
    else:
        _COUNTERS.add("persistent_hits")


# ---------------------------------------------------------------------
# donation policy
# ---------------------------------------------------------------------

# per-thread scope overrides (a stack; innermost wins) over the
# process-wide default _DONATE_MIN_BYTES
_DONATE_TLS = threading.local()


def donation_min_bytes():
    """Effective donation floor in bytes for the calling thread
    (innermost :func:`donation` scope, else the process default), or
    ``None`` when terminal donation is off."""
    st = getattr(_DONATE_TLS, "stack", None)
    if st:
        return st[-1]
    return _DONATE_MIN_BYTES


def set_donation_min_bytes(n):
    """Set the PROCESS-WIDE donation floor (``None`` turns terminal
    donation off); per-thread :func:`donation` scopes override it."""
    global _DONATE_MIN_BYTES
    _DONATE_MIN_BYTES = None if n is None else int(n)


@contextlib.contextmanager
def donation(min_bytes):
    """Scope the terminal-donation floor::

        with bolt_tpu_torch.engine.donation(0):      # donate at any size
            out = bolt.ones(shape, mode="gpu").map(f).sum()

    ``donation(None)`` turns donation off inside the scope.  The scope is
    THREAD-LOCAL: one thread's one-shot-chain scope must not make a
    concurrent thread's arrays single-terminal."""
    st = getattr(_DONATE_TLS, "stack", None)
    if st is None:
        st = _DONATE_TLS.stack = []
    st.append(None if min_bytes is None else int(min_bytes))
    try:
        yield
    finally:
        st.pop()


def donation_granted():
    """Count a granted terminal donation (called by the op layers); a
    timeline carries it as an instant ``engine.donate`` mark under the
    consuming terminal's span."""
    _COUNTERS.add("donations")
    _obs.event("engine.donate")


def record_fused_stats(n_terminals):
    """Tally one stat group resolving ``n_terminals`` pending terminals
    from one application of its chain or one mask pass
    (gpu/multistat.py)."""
    _COUNTERS.update(fused_stat_groups=1,
                     fused_stat_terminals=int(n_terminals))


# ---------------------------------------------------------------------
# static-analysis hooks
# ---------------------------------------------------------------------
#
# A strict scope installs a pre-dispatch guard here, which the op layers
# call right before a dispatching terminal enters get() — one attribute
# read when no guard is set.

_STRICT_GUARD = None


def set_strict_guard(fn):
    """Install (or clear, with ``None``) the pre-dispatch checker hook."""
    global _STRICT_GUARD
    _STRICT_GUARD = fn


def strict_guard(arr, op):
    """Run the installed pre-dispatch checker on ``arr`` for terminal
    ``op``; nothing when no guard is set."""
    g = _STRICT_GUARD
    if g is not None:
        g(arr, op)


def record_diagnostics(n):
    """Tally ``n`` checker findings."""
    if n:
        _COUNTERS.add("diagnostics", n)


def strict_checked():
    _COUNTERS.add("strict_checks")


def strict_rejected():
    _COUNTERS.add("strict_rejections")
    _obs.event("engine.strict_reject")


# ---------------------------------------------------------------------
# transfer / streaming accounting (fed by bolt_tpu_torch.stream)
# ---------------------------------------------------------------------

def record_transfer(nbytes, seconds):
    """Tally one counted host->device transfer."""
    _COUNTERS.update(transfer_bytes=int(nbytes), transfer_seconds=seconds)
    _TRANSFER_HIST.observe(int(nbytes))


def record_codec(raw_bytes, wire_bytes, seconds):
    """Tally one slab encode on an uploader worker, applied atomically."""
    _COUNTERS.update(codec_bytes_raw=int(raw_bytes),
                     codec_bytes_wire=int(wire_bytes),
                     codec_encode_seconds=seconds)


def record_stream(chunks, ingest_s, compute_s, wall_s, overlap_s, depth,
                  uploaders=1, inflight=1):
    """Tally one completed streamed run; the depth, the run's concurrent
    uploader high-water and its in-flight high-water keep process
    maxima."""
    _COUNTERS.update(_maxima={"stream_prefetch_depth": int(depth),
                              "stream_upload_threads": int(uploaders),
                              "stream_inflight_high_water": int(inflight)},
                     stream_chunks=int(chunks),
                     stream_ingest_seconds=ingest_s,
                     stream_compute_seconds=compute_s,
                     stream_wall_seconds=wall_s,
                     stream_overlap_seconds=overlap_s)


# ---------------------------------------------------------------------
# the dispatch order and its digest
# ---------------------------------------------------------------------
#
# ONE program order per process: every dispatch runs its program under
# this lock, so threads sharing the card enqueue whole programs, never
# interleaved launches, and the schedule digest below IS the enqueue
# order.  The slow path (a build) runs outside it.

_ORDER_LOCK = _lockdep.rlock("engine.order")


def order_lock():
    """The process-wide dispatch-order lock, for seams outside this
    module that enqueue work of their own."""
    return _ORDER_LOCK


# Every dispatch folds its program key (with CPython addresses stripped:
# `<function f at 0x..>` varies per process, the qualified name does not)
# into a sha256 chain, so two processes can compare what they ran and in
# which order.
_SCHED_DIGEST = hashlib.sha256(b"bolt-schedule").hexdigest()
_SCHED_COUNT = 0
_SCHED_RECENT = deque(maxlen=64)      # always-on tail, for error context
_SCHED_LOG = [] if os.environ.get("BOLT_SCHED_LOG", "") == "1" else None


def _stable_key(key):
    """Cross-process-stable rendering of a program key: repr with CPython
    object addresses stripped."""
    return re.sub(r" at 0x[0-9a-fA-F]+", "", repr(key))


def _schedule_note(key):
    """Fold one dispatch into the schedule digest.  Caller holds
    _ORDER_LOCK."""
    global _SCHED_DIGEST, _SCHED_COUNT
    text = _stable_key(key)
    _SCHED_DIGEST = hashlib.sha256(
        (_SCHED_DIGEST + "|" + text).encode()).hexdigest()
    _SCHED_COUNT += 1
    _SCHED_RECENT.append(text)
    if _SCHED_LOG is not None:
        _SCHED_LOG.append(text)


def schedule_digest():
    """``(count, hexdigest)`` of this process's dispatch schedule so far
    (read under the order lock)."""
    with _ORDER_LOCK:
        return _SCHED_COUNT, _SCHED_DIGEST


def schedule_recent():
    """The last few (<= 64) stabilised program keys dispatched."""
    with _ORDER_LOCK:
        return list(_SCHED_RECENT)


def schedule_log():
    """The FULL ordered key log, or ``None`` unless armed
    (:func:`schedule_log_arm` / ``BOLT_SCHED_LOG=1``)."""
    with _ORDER_LOCK:
        return None if _SCHED_LOG is None else list(_SCHED_LOG)


def schedule_log_arm(on=True):
    """Arm (or drop) full schedule-key logging."""
    global _SCHED_LOG
    with _ORDER_LOCK:
        _SCHED_LOG = [] if on else None


def schedule_reset():
    """Reset digest, count and logs."""
    global _SCHED_DIGEST, _SCHED_COUNT
    with _ORDER_LOCK:
        _SCHED_DIGEST = hashlib.sha256(b"bolt-schedule").hexdigest()
        _SCHED_COUNT = 0
        _SCHED_RECENT.clear()
        if _SCHED_LOG is not None:
            del _SCHED_LOG[:]


# ---------------------------------------------------------------------
# NaN checking (profile.debug_nans)
# ---------------------------------------------------------------------

_DEBUG_NANS = False


def set_debug_nans(enable):
    """Arm (or disarm) the NaN check of every dispatch's outputs."""
    global _DEBUG_NANS
    _DEBUG_NANS = bool(enable)


def debug_nans_enabled():
    return _DEBUG_NANS


def _check_nans(out, key):
    """Raise ``FloatingPointError`` when a floating tensor of ``out`` (a
    tensor, or a tuple/list of them) holds a NaN."""
    import torch
    parts = out if isinstance(out, (tuple, list)) else (out,)
    for t in parts:
        if isinstance(t, torch.Tensor) and (
                t.is_floating_point() or t.is_complex()) and \
                bool(torch.isnan(t).any()):
            raise FloatingPointError(
                "invalid value (nan) in the output of program %s"
                % _stable_key(key[:1] if isinstance(key, tuple) else key))


# ---------------------------------------------------------------------
# the keyed dispatch path
# ---------------------------------------------------------------------

_WORK_TLS = threading.local()


def in_program():
    """True while the calling thread runs an engine build or dispatch:
    work inside one is accounted to it (``ops/mapexpr.py`` counts its
    own cache only outside)."""
    return getattr(_WORK_TLS, "depth", 0) > 0


@contextlib.contextmanager
def _working():
    _WORK_TLS.depth = getattr(_WORK_TLS, "depth", 0) + 1
    try:
        yield
    finally:
        _WORK_TLS.depth -= 1


class _Dispatch:
    """The callable :func:`get` returns: calls the built program under
    the order lock, counted and timed."""

    __slots__ = ("fn", "key")

    def __init__(self, fn, key=None):
        self.fn = fn
        self.key = key               # what the schedule digest folds

    def __call__(self, *args):
        _lockdep.note_dispatch()     # armed witness: no ranked lock may
        #                              be held across a dispatch
        sp = _obs.begin("engine.dispatch")
        t0 = _clock()
        try:
            with _working(), _ORDER_LOCK:
                _schedule_note(self.key)
                out = self.fn(*args)
            if _DEBUG_NANS:
                _check_nans(out, self.key)
        finally:
            dt = _clock() - t0
            _COUNTERS.update(dispatches=1, dispatch_seconds=dt)
            _DISPATCH_HIST.observe(dt)
            _obs.end(sp)
        return out


def get(key, builder):
    """The engine's dispatch lookup: returns a callable running the
    program ``builder`` returns, built at most once per key and shared
    LRU-style across every op family.

    ``builder`` returns a callable whose closure captures only geometry
    and user callables — never tensors (a cached entry must not pin
    device memory).  ``key`` must be hashable and determine the program
    (op tag, user funcs, shapes, dtypes, split, device, donation, ...).

    Concurrent misses on the SAME key coalesce: the first caller builds,
    the rest wait and adopt its entry (``coalesced_builds``).  A failed
    build wakes the waiters, which then build for themselves (the
    exception propagates to the owner alone)."""
    waited = False                      # each lookup counts exactly ONCE:
    while True:                         # hit, miss, or coalesced wait
        with _LOCK:
            entry = _CACHE.get(key)
            if entry is not None:
                if not waited:
                    _COUNTERS.add("hits")
                _CACHE.move_to_end(key)
                return entry
            ev = _BUILDING.get(key)
            if ev is None:
                ev = _BUILDING[key] = threading.Event()
                break                   # this thread owns the build
            if not waited:
                _COUNTERS.add("coalesced_builds")
                waited = True
        ev.wait()
        # the owner either inserted the entry (the re-check above finds
        # it) or failed (loop again: this thread may become the owner)
    if not waited:
        _COUNTERS.add("misses")
    # build OUTSIDE the lock: builders trace (slow) and may re-enter
    sp = _obs.begin("engine.build")
    if sp is not None and isinstance(key, tuple) and key:
        sp.set(family=str(key[0]))
    t0 = _clock()
    try:
        with _working():
            entry = _Dispatch(builder(), key=key)
    except BaseException:
        with _LOCK:
            _BUILDING.pop(key, None)
        ev.set()                        # waiters retry (and may rebuild)
        raise
    finally:
        _obs.end(sp)
    _COUNTERS.update(aot_compiles=1, lower_seconds=_clock() - t0)
    with _LOCK:
        # an evict/clear may have raced; insert (or adopt) under the lock
        existing = _CACHE.get(key)
        if existing is not None:
            _CACHE.move_to_end(key)
            entry = existing
        else:
            _CACHE[key] = entry
            if len(_CACHE) > CACHE_MAX:
                _CACHE.popitem(last=False)
        _BUILDING.pop(key, None)
    ev.set()
    return entry


def evict(key):
    """Drop one keyed entry."""
    with _LOCK:
        _CACHE.pop(key, None)
