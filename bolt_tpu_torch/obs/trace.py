"""Structured span tracer: the observability layer's timing backbone.

Port of ``bolt_tpu/obs/trace.py``.  Counters give totals but no
*structure*: they show that a streamed reduction spent 2 s ingesting,
but not whether the ingest was hidden behind compute, which slab
stalled, or how much of a terminal was a program build.  This module
adds the structure:

* :func:`span` — a context manager / decorator recording a named,
  attributed, *nested* time interval (``obs.span("stream.compute",
  slab=3)``); completed spans land in a bounded in-memory ring.
* :func:`begin` / :func:`end` — the allocation-free hot-path form the
  engine and executor call directly: when tracing is disabled,
  ``begin`` is one module-global check returning ``None`` and ``end``
  returns immediately, so instrumented dispatch paths stay counter-only.
* :func:`event` — a zero-duration instant mark (donation grants,
  strict-gate rejections).
* cross-thread nesting by EXPLICIT handoff: the streaming executor
  captures its run span and passes it as ``parent=`` to the spans its
  prefetch thread begins, so a timeline shows ingest *under* the run
  that caused it even though another thread did the work.
* :func:`clock` — the ONE blessed monotonic timer: timing code
  elsewhere in the package imports this symbol, so every duration in
  the system comes from the same clock and can be correlated on one
  timeline.

Tracing is OFF by default.  :func:`enable` arms it process-wide;
:func:`bolt_tpu_torch.obs.timeline` scopes it around one run and writes a
Chrome trace-event file.  This module imports ONLY the standard library.
"""

import functools
import itertools
import os
import sys
import threading
import time
from collections import deque

# THE timing primitive (see the module docstring)
clock = time.perf_counter


def _lockdep():
    """bolt_tpu_torch/_lockdep.py (the ranked lock inventory), loaded by path
    under its canonical name when the package is not imported: this
    module stays stdlib-only standalone, and a later ``bolt_tpu_torch``
    import adopts the SAME witness instance."""
    mod = sys.modules.get("bolt_tpu_torch._lockdep")
    if mod is None:
        import importlib.util
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "_lockdep.py")
        spec = importlib.util.spec_from_file_location(
            "bolt_tpu_torch._lockdep", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["bolt_tpu_torch._lockdep"] = mod
        spec.loader.exec_module(mod)
    return mod


_RING_DEFAULT = 4096

_ON = False                      # the one hot-path check
_LOCK = _lockdep().lock("obs.trace")   # guards ring + active count
_RING = deque(maxlen=_RING_DEFAULT)
_ACTIVE = 0                      # begun-but-not-ended spans (leak gate)
_IDS = itertools.count(1)
_TLS = threading.local()         # per-thread open-span stack


class Span:
    """One recorded interval: ``name``, ``attrs``, ids and timestamps.

    ``sid`` is the span's id, ``pid`` its parent span's id (0 = root);
    ``tid``/``tname`` identify the recording thread; ``t0``/``t1`` are
    :func:`clock` seconds (``t1`` is ``None`` while open).  ``kind`` is
    ``"S"`` for spans, ``"I"`` for instant events."""

    __slots__ = ("name", "attrs", "sid", "pid", "tid", "tname", "t0",
                 "t1", "kind")

    def __init__(self, name, attrs, sid, pid, tid, tname, t0, kind="S"):
        self.name = name
        self.attrs = attrs
        self.sid = sid
        self.pid = pid
        self.tid = tid
        self.tname = tname
        self.t0 = t0
        self.t1 = None
        self.kind = kind

    def set(self, **attrs):
        """Attach attributes to an open span; chainable."""
        self.attrs.update(attrs)
        return self

    @property
    def duration(self):
        """Seconds from begin to end (``None`` while still open)."""
        return None if self.t1 is None else self.t1 - self.t0

    def __repr__(self):
        dur = "open" if self.t1 is None else "%.6fs" % (self.t1 - self.t0)
        return "<Span %s sid=%d pid=%d %s>" % (self.name, self.sid,
                                               self.pid, dur)


class _NullSpan:
    """What :class:`span` yields while tracing is disabled: every method
    is a no-op, so ``with obs.span(...) as sp: sp.set(...)`` costs
    nothing when off."""

    __slots__ = ()

    def set(self, **attrs):
        return self

    duration = None


_NULL = _NullSpan()


def _stack():
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def enabled():
    """Is the tracer armed?"""
    return _ON


def enable(ring=None):
    """Arm tracing process-wide.  ``ring`` bounds the completed-span
    buffer (oldest spans fall off); ``None`` means the default capacity
    (4096) — every ``enable()`` states its capacity rather than
    inheriting whatever a previous scope set.  Returns the capacity in
    effect."""
    global _ON, _RING
    want = _RING_DEFAULT if ring is None else max(1, int(ring))
    with _LOCK:
        if want != _RING.maxlen:
            _RING = deque(_RING, maxlen=want)
        _ON = True
        return _RING.maxlen


def disable():
    """Disarm tracing (the ring keeps its completed spans for export)."""
    global _ON
    _ON = False


def clear():
    """Drop every completed span and zero the leak counter (open spans
    begun before ``clear`` still end cleanly — ``end`` tolerates an
    already-cleared ring)."""
    global _ACTIVE
    with _LOCK:
        _RING.clear()
        _ACTIVE = 0


def spans():
    """A consistent snapshot list of the completed-span ring (oldest
    first)."""
    with _LOCK:
        return list(_RING)


def active_count():
    """Spans begun but not yet ended — a nonzero value after a run means
    an instrumented path leaked a span (``scripts/bench_all.py --check``
    gates on this)."""
    with _LOCK:
        return _ACTIVE


def begin(name, parent=None, **attrs):
    """Open a span; the hot-path primitive.  Returns ``None`` when
    tracing is disabled — one module-global check, NO allocation — so
    per-dispatch instrumentation costs nothing until someone arms the
    tracer.  ``parent`` overrides the calling thread's current span (the
    explicit cross-thread handoff; see the streaming executor)."""
    global _ACTIVE
    if not _ON:
        return None
    st = _stack()
    if parent is None and st:
        parent = st[-1]
    th = threading.current_thread()
    sp = Span(name, attrs, next(_IDS), parent.sid if parent else 0,
              th.ident, th.name, clock())
    st.append(sp)
    with _LOCK:
        _ACTIVE += 1
    return sp


def end(sp, **attrs):
    """Close a span returned by :func:`begin` (no-op on ``None``)."""
    global _ACTIVE
    if sp is None:
        return
    sp.t1 = clock()
    if attrs:
        sp.attrs.update(attrs)
    st = getattr(_TLS, "stack", None)
    if st and sp in st:
        # pop through: defensive against misordered ends so the stack
        # can never grow without bound
        while st and st[-1] is not sp:
            st.pop()
        st.pop()
    with _LOCK:
        if _ACTIVE > 0:
            _ACTIVE -= 1
        _RING.append(sp)


def cancel(sp):
    """Abandon an open span: it leaves the thread stack and the leak
    counter but never lands in the ring.  For probes that turn out to
    have observed nothing (e.g. the streaming executor's ingest probe
    that hits end-of-source)."""
    global _ACTIVE
    if sp is None:
        return
    st = getattr(_TLS, "stack", None)
    if st and sp in st:
        while st and st[-1] is not sp:
            st.pop()
        st.pop()
    with _LOCK:
        if _ACTIVE > 0:
            _ACTIVE -= 1


def current():
    """The calling thread's innermost open span (``None`` outside any,
    or while disabled).  Capture it before starting a worker thread and
    pass it to ``begin(..., parent=...)`` there to keep the timeline
    nested across threads."""
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


def event(name, **attrs):
    """Record a zero-duration instant mark (donation grants, gate
    rejections); parents under the thread's current span.  Tolerates a
    concurrent ``disable()``: ``begin`` re-checks the flag and may
    return ``None``, in which case the mark is silently dropped rather
    than crashing the instrumented operation."""
    sp = begin(name, **attrs)
    if sp is None:
        return None
    sp.kind = "I"
    end(sp)
    return sp


class span:
    """Context manager AND decorator recording one named interval::

        with obs.span("chunk.map", blocks=n) as sp:
            ...
            sp.set(bytes=out.nbytes)

        @obs.span("analysis.check")
        def check(obj): ...

    When tracing is disabled the body runs against a shared no-op span
    (one small object per ``with``; hot per-dispatch paths use
    :func:`begin`/:func:`end` directly, which allocate nothing)."""

    __slots__ = ("_name", "_attrs", "_parent", "_live")

    def __init__(self, name, parent=None, **attrs):
        self._name = name
        self._attrs = attrs
        self._parent = parent
        self._live = None

    def __enter__(self):
        self._live = begin(self._name, parent=self._parent, **self._attrs)
        return self._live if self._live is not None else _NULL

    def __exit__(self, etype, evalue, tb):
        sp, self._live = self._live, None
        if sp is not None and etype is not None:
            sp.attrs["error"] = etype.__name__
        end(sp)
        return False

    def __call__(self, fn):
        name, attrs = self._name, self._attrs

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name, **attrs):
                return fn(*args, **kwargs)
        return wrapper


def origin():
    """Process identity for exporters: ``(pid, clock-epoch note)``."""
    return os.getpid()
