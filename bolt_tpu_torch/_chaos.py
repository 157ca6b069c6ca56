"""Deterministic chaos-injection registry: the named fault seams.

Port of ``bolt_tpu/_chaos.py``.  The streaming executor and its shuffle
call ``hit(point)`` at named seams — ``"stream.encode"`` (a slab's codec
encode on an uploader worker), ``"stream.upload"`` (the top of the
upload), ``"stream.dispatch"`` (the consumer, before each slab program),
``"stream.fold"`` (the final fold), ``"stream.shuffle"`` (before each
re-bucket of a streamed swap), ``"stream.spill"`` (before each spilled
bucket write), ``"stream.checkpoint"`` (a stream checkpoint write's
entry), ``"checkpoint.meta"`` (between its state rename and its meta
rename) and ``"checkpoint.corrupt"`` (a tripped fault flips bytes of the
state file just written); the pod layer at ``"multihost.barrier"``
(every named rendezvous) and ``"multihost.collective"`` (every
collective that moves data) — and this registry trips a chosen one
deterministically:

>>> from bolt_tpu_torch import _chaos as chaos
>>> chaos.inject("stream.upload", nth=3)          # 3rd upload raises
>>> chaos.inject("stream.upload", nth=3, exc=IOError("link down"))
>>> chaos.inject("stream.upload", nth=3, action="kill")   # SIGKILL self

``nth`` counts hits process-wide (1-based); ``times`` bounds how many
hits trip once armed (default 1: a retried upload then succeeds, as a
flaky storage fetch does; ``times=None`` keeps failing, the
retries-exhausted shape).  ``action="kill"`` delivers ``SIGKILL`` to the
own process: nothing runs after it, no ``finally``, no atexit.

The environment form arms a point before any code runs, for
subprocesses::

    BOLT_CHAOS="stream.upload:3:kill"       python job.py
    BOLT_CHAOS="stream.upload:3:raise"      python job.py
    BOLT_CHAOS="stream.upload:3:raise:disk gone" python job.py

Disarmed, a seam costs one module-global check.  Standard library only:
loadable with no torch in sight.
"""

import os
import signal
import sys


def _lockdep():
    """The lock inventory (bolt_tpu_torch/_lockdep.py), loaded by path
    under its canonical name when the package is not imported: this
    module stays loadable on its own, and a later package import adopts
    the SAME witness instance."""
    mod = sys.modules.get("bolt_tpu_torch._lockdep")
    if mod is None:
        import importlib.util
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "_lockdep.py")
        spec = importlib.util.spec_from_file_location(
            "bolt_tpu_torch._lockdep", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["bolt_tpu_torch._lockdep"] = mod
        spec.loader.exec_module(mod)
    return mod


_LOCK = _lockdep().lock("chaos.registry")
_POINTS = {}            # name -> _Spec
_ARMED = False          # the one hot-path check

# every seam the package calls hit() at
SEAMS = (
    "stream.encode",          # codec slab encode on an uploader worker
    "stream.upload",          # uploader-pool / prefetch ingest hot path
    "stream.dispatch",        # consumer, before each slab dispatch
    "stream.fold",            # the final pairwise fold
    "stream.shuffle",         # before each shuffle re-bucket dispatch
    "stream.spill",           # before each spilled-bucket write
    "stream.checkpoint",      # a stream checkpoint write's entry
    "checkpoint.meta",        # between the state rename and the meta's
    "checkpoint.corrupt",     # flips bytes of the state just written
    "multihost.barrier",      # every named cross-rank rendezvous
    "multihost.collective",   # every collective that moves data
)


class ChaosError(RuntimeError):
    """The default exception an armed fault point raises."""


class _Spec:
    __slots__ = ("point", "nth", "exc", "action", "times", "hits",
                 "trips")

    def __init__(self, point, nth, exc, action, times):
        self.point = point
        self.nth = max(1, int(nth))
        self.exc = exc
        self.action = action
        self.times = times          # None = unbounded
        self.hits = 0
        self.trips = 0


def inject(point, nth=1, exc=None, action="raise", times=1):
    """Arm fault point ``point`` to trip on its ``nth`` hit (1-based,
    counted process-wide across threads).

    ``action="raise"`` raises ``exc`` (default a :class:`ChaosError`
    naming the point) inside the seam; ``action="kill"`` delivers
    ``SIGKILL`` to this process.  ``times`` bounds the trips once armed
    (``None`` = every hit from ``nth`` on)."""
    if action not in ("raise", "kill"):
        raise ValueError("chaos action must be 'raise' or 'kill', got %r"
                         % (action,))
    global _ARMED
    with _LOCK:
        _POINTS[point] = _Spec(point, nth, exc, action, times)
        _ARMED = True
    return _POINTS[point]


def clear(point=None):
    """Disarm one fault point (or all of them)."""
    global _ARMED
    with _LOCK:
        if point is None:
            _POINTS.clear()
        else:
            _POINTS.pop(point, None)
        _ARMED = bool(_POINTS)


def active():
    """Names of the armed fault points."""
    with _LOCK:
        return sorted(_POINTS)


def stats(point):
    """``(hits, trips)`` for one point (``(0, 0)`` when never armed)."""
    with _LOCK:
        spec = _POINTS.get(point)
        return (spec.hits, spec.trips) if spec is not None else (0, 0)


def hit(point):
    """The seam call: count one hit of ``point`` and trip the armed fault
    when due.  One module-global check when nothing is armed."""
    if not _ARMED:
        return
    with _LOCK:
        spec = _POINTS.get(point)
        if spec is None:
            return
        spec.hits += 1
        due = spec.hits >= spec.nth and (
            spec.times is None or spec.trips < spec.times)
        if not due:
            return
        spec.trips += 1
        action, exc = spec.action, spec.exc
    if action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    raise exc if exc is not None else ChaosError(
        "chaos: injected fault at %r (hit %d)" % (point, spec.hits))


def _load_env():
    """Arm a fault point from ``BOLT_CHAOS=point:nth:action[:message]``."""
    raw = os.environ.get("BOLT_CHAOS")
    if not raw:
        return
    parts = raw.split(":", 3)
    if len(parts) < 2:
        raise ValueError(
            "BOLT_CHAOS must be 'point:nth[:action[:message]]', got %r"
            % raw)
    point, nth = parts[0], int(parts[1])
    action = parts[2] if len(parts) > 2 and parts[2] else "raise"
    exc = ChaosError(parts[3]) if len(parts) > 3 else None
    inject(point, nth=nth, exc=exc, action=action)


_load_env()
