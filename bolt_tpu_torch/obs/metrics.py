"""Typed metrics registry: the ONE backing store for the package's
numeric tallies.

Port of ``bolt_tpu/obs/metrics.py``: one store that every subsystem
counts into, with one snapshot/reset/lock discipline, and that can
enumerate "all metrics" for export:

* :class:`Counter` — monotonic int or float accumulator;
* :class:`Gauge` — last-value / high-water sample;
* :class:`Histogram` — fixed **log2 buckets**: observation ``v`` lands
  in bucket ``floor(log2(v))`` clamped to the configured exponent range,
  so a histogram over seconds spans microseconds..minutes in ~40 ints
  with no configuration per call site and O(1) updates;
* :class:`CounterGroup` — a fixed-schema counter family updated and
  snapshotted under ONE lock.  The dispatch engine's counters
  (:func:`bolt_tpu_torch.engine.counters`, re-exported as
  ``profile.engine_counters()``) are a ``CounterGroup`` named
  ``engine``, enumerable through :func:`snapshot` alongside everything
  else.

All metrics in one :class:`Registry` share a single re-entrant lock, so
a multi-key update (e.g. the streaming executor's six-counter tally) is
atomic against any snapshot.  Standard library only.
"""

import math
import os
import sys


def _lockdep():
    """bolt_tpu_torch/_lockdep.py (the ranked lock inventory), loaded by path
    under its canonical name when the package is not imported: this
    module stays stdlib-only standalone, and a later ``bolt_tpu_torch``
    import adopts the SAME witness instance.  The registry lock is the
    hierarchy's LEAF (``obs.registry``): every critical section in the
    package may count, so nothing may nest inside it."""
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


class Counter:
    """Monotonic accumulator.  The initial value fixes the type: ``0``
    counts ints, ``0.0`` accumulates float seconds/bytes."""

    __slots__ = ("name", "_lock", "_initial", "_value")

    def __init__(self, name, lock, initial=0):
        self.name = name
        self._lock = lock
        self._initial = initial
        self._value = initial

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = self._initial

    def snapshot(self):
        return self.value


class Gauge:
    """Last-value sample with a high-water helper."""

    __slots__ = ("name", "_lock", "_initial", "_value")

    def __init__(self, name, lock, initial=0):
        self.name = name
        self._lock = lock
        self._initial = initial
        self._value = initial

    def set(self, v):
        with self._lock:
            self._value = v

    def high_water(self, v):
        """Keep the maximum of the current value and ``v``."""
        with self._lock:
            if v > self._value:
                self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = self._initial

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed log2-bucket histogram over positive values.

    Bucket ``i`` (for ``lo <= i < hi``) counts observations ``v`` with
    ``2**i <= v < 2**(i+1)``; values below ``2**lo`` land in the
    underflow bucket, at or above ``2**hi`` in the overflow bucket.
    The defaults (``lo=-20, hi=8``) cover ~1 µs .. ~4 min for seconds
    and are equally sensible for MB-scale byte counts with
    ``Histogram(name, lo=10, hi=36)``."""

    __slots__ = ("name", "_lock", "lo", "hi", "_counts", "_sum", "_count")

    def __init__(self, name, lock, lo=-20, hi=8):
        if hi <= lo:
            raise ValueError("histogram needs hi > lo, got [%d, %d)"
                             % (lo, hi))
        self.name = name
        self._lock = lock
        self.lo = lo
        self.hi = hi
        # [underflow] + one per exponent + [overflow]
        self._counts = [0] * (hi - lo + 2)
        self._sum = 0.0
        self._count = 0

    def _index(self, v):
        if v <= 0:
            return 0                         # underflow (incl. 0)
        e = math.frexp(v)[1] - 1             # floor(log2(v))
        if e < self.lo:
            return 0
        if e >= self.hi:
            return len(self._counts) - 1     # overflow
        return e - self.lo + 1

    def observe(self, v):
        with self._lock:
            self._counts[self._index(v)] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def buckets(self):
        """``[(upper_bound, count)]`` — bounds are ``2**e`` with leading
        ``2**lo`` underflow and trailing ``inf`` overflow entries."""
        with self._lock:
            counts = list(self._counts)
        bounds = ([float(2.0 ** self.lo)]
                  + [float(2.0 ** (e + 1)) for e in range(self.lo, self.hi)]
                  + [float("inf")])
        return list(zip(bounds, counts))

    def reset(self):
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._sum = 0.0
            self._count = 0

    def snapshot(self):
        with self._lock:
            return {"count": self._count, "sum": self._sum,
                    "lo": self.lo, "hi": self.hi,
                    "counts": list(self._counts)}


class CounterGroup:
    """A fixed-schema family of counters behind ONE lock.

    ``schema`` maps key -> initial value (``0`` int / ``0.0`` float);
    iteration order is preserved in snapshots.  :meth:`update` applies
    any number of deltas (and optional high-water maxima) atomically —
    the multi-key form the engine's streaming tally needs — and
    :meth:`snapshot` returns a plain dict copied under the same lock, so
    a reader can never observe a half-applied update.

    :meth:`set_mirror` installs a scoping hook: a zero-arg provider
    returning another ``CounterGroup`` (or ``None``) consulted on EVERY
    increment, which then receives the same deltas under the same lock —
    the mechanism behind per-tenant engine-counter scoping
    (``bolt_tpu_torch.engine.tenant``): the provider reads a thread-local
    tenant tag and returns that tenant's group, so the global tally and
    the tenant tally can never disagree about one update."""

    __slots__ = ("name", "_lock", "_schema", "_vals", "_mirror")

    def __init__(self, name, lock, schema):
        self.name = name
        self._lock = lock
        self._schema = dict(schema)
        self._vals = dict(schema)
        self._mirror = None

    def set_mirror(self, provider):
        """Install (or clear, with ``None``) the mirror provider — a
        callable returning a sibling ``CounterGroup`` (same schema) or
        ``None``; it runs under the registry lock, so it must only do
        registry lookups (the lock is re-entrant)."""
        self._mirror = provider

    def _mirror_group(self):
        p = self._mirror
        if p is None:
            return None
        m = p()
        return m if m is not self else None     # never self-mirror

    def add(self, key, n=1):
        with self._lock:
            self._vals[key] += n
            m = self._mirror_group()
            if m is not None:
                m._vals[key] += n

    def update(self, _maxima=None, **deltas):
        """Atomically add every ``key=delta``; ``_maxima`` entries keep
        ``max(current, value)`` instead (prefetch-depth high-water)."""
        with self._lock:
            for grp in (self, self._mirror_group()):
                if grp is None:
                    continue
                for k, v in deltas.items():
                    grp._vals[k] += v
                if _maxima:
                    for k, v in _maxima.items():
                        if v > grp._vals[k]:
                            grp._vals[k] = v

    def __getitem__(self, key):
        with self._lock:
            return self._vals[key]

    def __contains__(self, key):
        return key in self._schema

    def keys(self):
        return self._schema.keys()

    def snapshot(self):
        with self._lock:
            return dict(self._vals)

    def reset(self):
        with self._lock:
            self._vals = dict(self._schema)


class Registry:
    """Name -> metric table; one shared re-entrant lock for everything
    registered (see module docstring for why that lock matters)."""

    def __init__(self):
        self._lock = _lockdep().rlock("obs.registry")
        self._metrics = {}

    def _register(self, name, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    def counter(self, name, initial=0):
        """Get-or-create a :class:`Counter` (idempotent per name)."""
        return self._register(name,
                              lambda: Counter(name, self._lock, initial))

    def gauge(self, name, initial=0):
        return self._register(name,
                              lambda: Gauge(name, self._lock, initial))

    def histogram(self, name, lo=-20, hi=8):
        return self._register(
            name, lambda: Histogram(name, self._lock, lo=lo, hi=hi))

    def group(self, name, schema):
        """Get-or-create a :class:`CounterGroup` with ``schema``."""
        return self._register(
            name, lambda: CounterGroup(name, self._lock, schema))

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self):
        """One consistent dict over every registered metric: group
        entries flatten to ``"<group>.<key>"``, histograms export their
        summary dict, counters/gauges their value."""
        with self._lock:
            out = {}
            for name, m in self._metrics.items():
                if isinstance(m, CounterGroup):
                    for k, v in m.snapshot().items():
                        out["%s.%s" % (name, k)] = v
                else:
                    out[name] = m.snapshot()
            return out

    def reset(self):
        with self._lock:
            for m in self._metrics.values():
                m.reset()


_REGISTRY = Registry()


def registry():
    """The process-wide default registry (the engine's counters live
    here under the group name ``engine``)."""
    return _REGISTRY


# every thread the package constructs carries one of these name
# prefixes
_THREAD_PREFIXES = (
    "bolt-serve-worker-",         # serve.py scheduler pool
    "bolt-stream-prefetch",       # stream.py dispenser/prefetch lead
    "bolt-stream-upload-",        # stream.py uploader pool
)


def thread_census():
    """Live bolt-owned worker threads, ``{name: count}`` grouped by
    the blessed thread-name prefixes.  Empty when every pool has been
    torn down — the hygiene invariant the test suite asserts (a leaked
    thread here is an executor that skipped its shutdown path)."""
    import threading
    out = {}
    for t in threading.enumerate():
        for p in _THREAD_PREFIXES:
            if t.name.startswith(p):
                key = p.rstrip("-")
                out[key] = out.get(key, 0) + 1
                break
    return out
