"""Tracing, timing and debug instrumentation.

Port of ``bolt_tpu/profile.py``:

* :func:`trace` — ``torch.profiler`` over a region, writing a Chrome
  trace under a log directory.
* :func:`annotate` — names a region in that trace: an ``obs`` span,
  so the range is ``bolt.<name>`` (and, on a CUDA device, an NVTX
  range too).
* :func:`timeit` — best wall-clock of a function, each run synchronised
  with the card, so the time includes the device's completion.
* :func:`throughput` — GB/s given bytes touched.
* :func:`instrument` — per-op-family program calls and builds.
* :func:`debug_nans` — raise on a NaN in any engine program's output.
* :func:`memory_stats` — the device allocator's counters under the
  reference's keys.
"""

import contextlib
import os
import time

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from bolt_tpu_torch.obs import trace as _obs


def _profiler_recording():
    """Whether a ``torch.profiler`` records now: torch's own flag, which
    ``profile.start()`` sets (a module attribute read, no allocation)."""
    return _autograd_profiler._is_profiler_enabled


def _open_range(name):
    """A profiler range ``name`` opened now and returned entered: torch's
    fast record function, a host-side range whose device operations link
    to it through the aten ops inside, and which puts no annotation of
    its own on the device's timeline."""
    rng = torch._C._profiler._RecordFunctionFast(name)
    rng.__enter__()
    return rng


# every obs span opens bolt.<name> while a profiler records
_obs.mirror(_profiler_recording, _open_range)


@contextlib.contextmanager
def trace(logdir):
    """Device-trace context manager::

        with bolt_tpu_torch.profile.trace("trace-dir"):
            b.map(f).sum().toarray()

    Records CPU activity and, where CUDA is available, the card's; the
    Chrome trace (``chrome://tracing``, Perfetto) lands in ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, "trace-%d.json" % os.getpid()))


@contextlib.contextmanager
def annotate(name):
    """Name a region in the trace timeline: the ``obs`` span ``name``,
    which the profiler shows as ``bolt.<name>`` while it records and the
    ring keeps while tracing is armed (an NVTX range too when CUDA is
    available)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with _obs.span(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _devices(result):
    """The CUDA devices of the tensors in ``result`` (a tensor, a gpu
    array — resolved, if it is lazy — or a tuple/list/dict of them)."""
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    if isinstance(result, dict):
        result = list(result.values())
    parts = result if isinstance(result, (tuple, list)) else (result,)
    out = set()
    for p in parts:
        if isinstance(p, (tuple, list, dict)):
            out |= _devices(p)
            continue
        t = p._data if isinstance(p, BoltArrayGPU) else p
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            out.add(t.device)
    return out


def _complete(result):
    for d in _devices(result):
        torch.cuda.synchronize(d)
    return result


def timeit(fn, iters=5, warmup=1):
    """``(result, best_seconds)`` for ``fn()`` over ``iters`` timed runs,
    each run synchronising the CUDA devices of the tensors it returns
    (a tensor, a bolt array, or a tuple/list/dict of them), so the time
    includes the device's completion.

    ``iters`` must be >= 1 (a "best of zero runs" has no answer);
    negative ``warmup`` counts as zero."""
    if iters < 1:
        raise ValueError(
            "timeit needs iters >= 1 (got %r): best-of is undefined over "
            "zero timed runs" % (iters,))
    result = None
    for _ in range(max(warmup, 0)):
        result = _complete(fn())
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        result = _complete(fn())
        best = min(best, time.perf_counter() - t0)
    return result, best


def throughput(nbytes, seconds):
    """GB/s for ``nbytes`` touched in ``seconds``."""
    return nbytes / 1e9 / seconds


def array_bytes(barray):
    """Logical payload bytes of a bolt array."""
    return int(np.prod(barray.shape, dtype=np.int64)) * barray.dtype.itemsize


def debug_nans(enable=True):
    """Arm (or disarm) the NaN check of every engine program: while armed,
    a program whose floating output holds a NaN raises
    ``FloatingPointError`` (off by default)."""
    from bolt_tpu_torch import engine
    engine.set_debug_nans(enable)


# the modules that bind _cached_jit by name
_MODULES = ("bolt_tpu_torch.gpu.array", "bolt_tpu_torch.gpu.chunk",
            "bolt_tpu_torch.gpu.multistat", "bolt_tpu_torch.gpu.npdispatch",
            "bolt_tpu_torch.gpu.stack", "bolt_tpu_torch.gpu.stats")


@contextlib.contextmanager
def instrument():
    """Context manager recording per-op-family program calls, builds and
    host dispatch time for every bolt operation run inside it::

        with bolt_tpu_torch.profile.instrument() as stats:
            b.map(f).sum().toarray()
            b.stats()
        print(bolt_tpu_torch.profile.report(stats))

    ``stats`` maps op family — the program key's prefix: ``"chain"``,
    ``"reduce"``, ``"stat"``, ``"multi-stat"``, ``"welford"``,
    ``"filter-fused"``, ``"swap"``, ``"stack-map"``, ... — to
    ``{"calls", "builds", "dispatch_s"}``.  ``builds`` counts cache
    misses — the rebuild detector: a pipeline that builds the same
    family every time (a fresh lambda per call) shows ``builds ==
    calls`` instead of ``builds == 1``.  ``dispatch_s`` is host time;
    use :func:`timeit` or :func:`trace` for the device's."""
    import importlib
    mods = [importlib.import_module(m) for m in _MODULES]
    # every module binds _cached_jit by name: snapshot and restore EACH
    # binding so nested contexts unwind cleanly
    saved = {m: m._cached_jit for m in mods}
    from bolt_tpu_torch import engine
    stats = {}

    def wrapped(key, builder):
        fam = key[0] if isinstance(key, tuple) and key else str(key)
        e = stats.setdefault(
            fam, {"calls": 0, "builds": 0, "dispatch_s": 0.0})

        def counting_builder():
            e["builds"] += 1
            return builder()

        fn = engine.get(key, counting_builder)

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            e["calls"] += 1
            e["dispatch_s"] += time.perf_counter() - t0
            return out
        return timed

    for m in saved:
        m._cached_jit = wrapped
    try:
        yield stats
    finally:
        for m, fn in saved.items():
            # restore only our own wrapper: a still-live inner context
            # keeps counting
            if m._cached_jit is wrapped:
                m._cached_jit = fn


def report(stats):
    """Human-readable table for :func:`instrument` results."""
    lines = ["%-18s %7s %7s %12s" % ("family", "calls", "builds",
                                     "dispatch_s")]
    for fam in sorted(stats):
        e = stats[fam]
        lines.append("%-18s %7d %7d %12.4f"
                     % (fam, e["calls"], e["builds"], e["dispatch_s"]))
    return "\n".join(lines)


def engine_counters():
    """Snapshot of the engine's counters (see
    :mod:`bolt_tpu_torch.engine`): program-cache ``hits``/``misses``,
    builds (``aot_compiles``, ``lower_seconds``), ``nvcc`` time
    (``compile_seconds``), ``dispatches``/``dispatch_seconds``,
    ``donations``, the kernel libraries' ``persistent_hits``/
    ``persistent_misses``, the transfer and streaming tallies.  The
    snapshot is consistent — taken under the lock every increment
    holds."""
    from bolt_tpu_torch import engine
    return engine.counters()


def reset_engine_counters():
    from bolt_tpu_torch import engine
    engine.reset_counters()


def overlap_efficiency(counters=None):
    """Fraction of streaming ingest time (host production + upload)
    hidden behind device compute: ``stream_overlap_seconds /
    stream_ingest_seconds``.  ``0.0`` when nothing has streamed (or a
    hand-built ``counters`` dict lacks the keys) instead of dividing by
    zero."""
    c = engine_counters() if counters is None else counters
    ingest = c.get("stream_ingest_seconds", 0.0) or 0.0
    if ingest <= 0.0:
        return 0.0
    return (c.get("stream_overlap_seconds", 0.0) or 0.0) / ingest


def engine_report(counters=None):
    """Human-readable table of the engine counters; a fresh process (or
    an all-zero ``counters`` dict) renders "(no engine activity)"."""
    c = engine_counters() if counters is None else counters
    lines = ["%-24s %12s" % ("counter", "value")]
    if not c or not any(v for v in c.values()):
        lines.append("(no engine activity)")
        return "\n".join(lines)
    for k in sorted(c):
        v = c[k]
        lines.append("%-24s %12s"
                     % (k, ("%.4f" % v) if isinstance(v, float) else v))
    return "\n".join(lines)


def memory_stats(device=None):
    """The CUDA caching allocator's counters of ``device`` (default: the
    current card) under the reference's keys: ``bytes_in_use``,
    ``peak_bytes_in_use`` and ``bytes_limit`` (the card's total memory,
    from ``torch.cuda.mem_get_info``), all ints.  ``{}`` — never an error
    — for a CPU device or where CUDA is not available, as the reference
    degrades on a backend without counters."""
    try:
        if device is not None and torch.device(device).type != "cuda":
            return {}
        if not torch.cuda.is_available():
            return {}
        s = torch.cuda.memory_stats(device)
        _, total = torch.cuda.mem_get_info(device)
    except Exception:       # noqa: BLE001 — the documented degraded shape
        return {}
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total)}
