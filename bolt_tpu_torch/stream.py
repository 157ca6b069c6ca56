"""Streaming out-of-core executor: a parallel-ingest, async-dispatch
host->device pipeline.

Port of the single-process part of ``bolt_tpu/stream.py``.  A lazy
:class:`StreamSource` (``fromcallback``/``fromiter`` with an explicit
dtype) describes host-resident data as record *slabs* (consecutive blocks
along the first key axis) plus a chain of per-record ``map`` stages, and
:func:`execute` runs a reduction terminal (``sum``, ``mean``, ``var``,
``std``, ``min``, ``max``, ``reduce``) over it without the whole array
ever living on the device:

* an **uploader pool** (default ``min(devices, 4)``, which is 1 on one
  card; ``BOLT_STREAM_UPLOAD_THREADS`` or the :func:`uploaders` scope)
  ingests slabs concurrently: for a random-access ``fromcallback`` source
  each worker produces its slab, ENCODES it when a codec is armed
  (:mod:`bolt_tpu_torch.gpu.codec`), copies the wire and its sidecars into
  a pinned host buffer taken from a ring allocated once per run, and
  issues a ``non_blocking`` copy on its own CUDA stream, recording an
  event; a pinned buffer is reused only after its copy's event completed.
  Sequential ``fromiter`` sources keep one produce+upload thread;
* a **re-sequencer** (:class:`_Reseq`) hands completed slabs to the
  consumer strictly in slab order; the consumer makes the compute stream
  wait on the slab's event (and records the slab's memory on the compute
  stream, so the caching allocator cannot hand it out while a kernel
  still reads it) and runs the slab program: decode, the map stages, the
  terminal's partial;
* **ring permits** bound the slabs alive at once at ``prefetch depth +
  pool size``; slab programs dispatch asynchronously into a bounded
  in-flight window, a deque of CUDA events: the permits of slabs the
  device has retired are released as their events complete (queried,
  never waited on), and the consumer waits only on overflow and for the
  final result;
* partials fold in a fixed **pairwise** order: the level-0 merge of each
  odd slab's partial with the preceding even slab's (:func:`_combine`),
  then a binary-counter tree (:class:`_PairFold`), so a lossless codec
  stays bit-identical to an uncompressed stream and power-of-two slab
  counts keep the Chan denominators exact.

Pinned memory and CUDA streams are used only when the source's device is
CUDA; with ``context=torch.device("cpu")`` the same executor runs with
plain host tensors.  A source callback or worker that raises aborts the
run: every pool thread is joined, the queued slabs are released and the
original exception is re-raised; a pool thread that dies without
delivering surfaces as a pointed ``RuntimeError``.

Accounting lands in :mod:`bolt_tpu_torch.engine` (``transfer_*``,
``stream_*``, ``codec_*``).  Not ported yet (ROADMAP A9): pods,
resume and checkpoints, in-run retries, the serving lease, streamed
``swap``/``chunk``/``stacked``/``filter`` stages and multi-stat groups.
Any consumer other than a streamed terminal — ``filter`` too —
materialises the source (:func:`materialize`), which needs the whole
array to fit.
"""

import contextlib
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.utils import iter_record_blocks, prod, tupleize

_clock = time.perf_counter

# ---------------------------------------------------------------------
# configuration: process defaults and thread-local scopes
# ---------------------------------------------------------------------

# prefetch depth: uploaded slabs that may wait ahead of the consumer beyond
# the pool's own in-hand slabs (the ring is bounded at depth + pool size)
_DEPTH = max(1, int(os.environ.get("BOLT_STREAM_DEPTH", "2")))

# uploader pool size: 0 = auto, min(devices, 4) per run
_UPLOADERS = max(0, int(os.environ.get("BOLT_STREAM_UPLOAD_THREADS", "0")))

# default slab budget when the caller gives no record count
_SLAB_BYTES = int(os.environ.get("BOLT_STREAM_SLAB_BYTES", str(64 << 20)))

# the process default codec NAME the codec() scopes override (None =
# uncompressed), validated lazily against the registry
_CODEC = os.environ.get("BOLT_STREAM_CODEC") or None

# the scopes are thread-local: a stream on another thread keeps its own
_SCOPE_TLS = threading.local()

# the last run's lead thread and whole pool (tests check they were joined)
_LAST_POOL = ()


def _scope_stack(name):
    st = getattr(_SCOPE_TLS, name, None)
    if st is None:
        st = []
        setattr(_SCOPE_TLS, name, st)
    return st


def prefetch_depth():
    """The calling thread's prefetch depth: the innermost
    :func:`prefetch` scope, else the process default."""
    st = _scope_stack("depth")
    return st[-1] if st else _DEPTH


def set_prefetch_depth(k):
    """Set the process-wide default prefetch depth (>= 1)."""
    global _DEPTH
    _DEPTH = max(1, int(k))


@contextlib.contextmanager
def prefetch(depth):
    """Scope the prefetch depth (thread-local)."""
    st = _scope_stack("depth")
    st.append(max(1, int(depth)))
    try:
        yield
    finally:
        st.pop()


def upload_threads():
    """The calling thread's configured pool size (innermost
    :func:`uploaders` scope, else the process default; 0 = auto)."""
    st = _scope_stack("uploaders")
    return st[-1] if st else _UPLOADERS


def set_upload_threads(n):
    """Set the process-wide default pool size (0 restores auto)."""
    global _UPLOADERS
    _UPLOADERS = max(0, int(n))


@contextlib.contextmanager
def uploaders(n):
    """Scope the uploader-pool size (``0`` = auto; thread-local)::

        with bolt_tpu_torch.stream.uploaders(4):
            src.map(f).sum()
    """
    st = _scope_stack("uploaders")
    st.append(max(0, int(n)))
    try:
        yield
    finally:
        st.pop()


def _codec_registry():
    from bolt_tpu_torch.gpu import codec as m
    return m


def current_codec():
    """The calling thread's codec NAME (innermost :func:`codec` scope,
    else the process default; ``None`` = uncompressed).  A source's own
    ``codec=`` wins over it (:func:`resolve_codec`)."""
    st = _scope_stack("codec")
    return st[-1] if st else _CODEC


def set_codec(name):
    """Set the process-wide default ingest codec (``None`` restores
    uncompressed); the :func:`codec` scopes override it."""
    global _CODEC
    if name is not None:
        _codec_registry().get(name)     # pointed unknown-codec error now
    _CODEC = name


@contextlib.contextmanager
def codec(name):
    """Scope codec-encoded ingest for streamed runs (thread-local)::

        with bolt_tpu_torch.stream.codec("bf16"):
            src.map(f).sum()     # slabs ship at half the bytes

    ``codec(None)`` restores uncompressed ingest inside the scope.  The
    lossless ``"delta-f32"`` is bit-identical to uncompressed streaming;
    lossy codecs are refused for order statistics and integer
    pipelines."""
    if name is not None:
        _codec_registry().get(name)
    st = _scope_stack("codec")
    st.append(name)
    try:
        yield
    finally:
        st.pop()


def resolve_codec(source):
    """The effective codec of a run over ``source``: the source's own
    ``codec=`` wins over the calling thread's scope/default; ``None`` =
    uncompressed.  Validates the codec against the source dtype."""
    name = source.codec if source.codec is not None else current_codec()
    if name is None:
        return None
    c = _codec_registry().get(name)
    c.wire_dtype(source.dtype)
    return c


def pool_size(source):
    """The uploader-pool size of a run over ``source``: the calling
    thread's configured count, else ``min(devices, 4)`` (one card: 1);
    ``fromiter`` sources always use one prefetch thread."""
    if source.kind != "callback":
        return 1
    n = upload_threads()
    return n if n >= 1 else 1


# ---------------------------------------------------------------------
# the counted transfer layer
# ---------------------------------------------------------------------

def transfer(x, device):
    """Counted host->device copy of the host array or tensor ``x`` (a copy
    on the CPU too: the result never aliases ``x``); tallies
    ``transfer_bytes``/``transfer_seconds`` after the copy has landed."""
    t0 = _clock()
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    out = t.to(device, copy=True)
    if out.device.type == "cuda":
        torch.cuda.current_stream(out.device).synchronize()
    _engine.record_transfer(t.numel() * t.element_size(), _clock() - t0)
    return out


def _encode_slab(codec_obj, block, delta_ok):
    """Host-side slab encode on an uploader worker, counted in the
    ``codec_*`` counters."""
    t0 = _clock()
    wire, side = codec_obj.encode(block, delta_ok)
    _engine.record_codec(int(block.nbytes),
                         wire.numel() * wire.element_size(), _clock() - t0)
    return wire, side


class _PinnedRing:
    """Pinned host buffers for one run's uploads, one per pool thread: a
    buffer goes back with the event of the copy that reads it and is
    handed out again only after that event has completed."""

    __slots__ = ("_lock", "_free")

    def __init__(self):
        self._lock = threading.Lock()
        self._free = deque()

    def take(self, nbytes):
        with self._lock:
            slot, ev = self._free.popleft() if self._free else (None, None)
        if ev is not None:
            ev.synchronize()
        if slot is None or slot.numel() < nbytes:
            slot = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return slot

    def give(self, slot, ev):
        with self._lock:
            self._free.append((slot, ev))


def _layout(parts):
    """16-byte-aligned byte offsets of ``parts`` packed into one buffer,
    and the buffer's size."""
    offs, total = [], 0
    for p in parts:
        offs.append(total)
        total += -(-p.numel() * p.element_size() // 16) * 16
    return offs, total


def _upload(parts, device, ring, copy_stream):
    """Ship one slab's host tensors ``parts`` (the wire block, then its
    sidecars) to ``device``; returns ``(tensors on the device, event,
    buffer)``.  On a CUDA device the parts are packed into a pinned buffer
    of ``ring`` and copied in one ``non_blocking`` copy on
    ``copy_stream``; ``event`` marks the copy's end and ``buffer`` is the
    device memory the tensors view.  On the CPU the host tensors are the
    slab (no event, no buffer).  Counted once, at the parts' own bytes,
    after the copy landed."""
    t0 = _clock()
    nbytes = sum(p.numel() * p.element_size() for p in parts)
    if device.type != "cuda":
        _engine.record_transfer(nbytes, _clock() - t0)
        return parts, None, None
    offs, total = _layout(parts)
    slot = ring.take(total)
    for p, off in zip(parts, offs):
        nb = p.numel() * p.element_size()
        slot[off:off + nb].view(p.dtype).view(p.shape).copy_(p)
    with torch.cuda.stream(copy_stream):
        buf = torch.empty(total, dtype=torch.uint8, device=device)
        buf.copy_(slot[:total], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(copy_stream)
    ring.give(slot, ev)
    ev.synchronize()     # honest transfer seconds; the copies of the other
    #                      workers and the compute stream run meanwhile
    _engine.record_transfer(nbytes, _clock() - t0)
    views = tuple(buf[off:off + p.numel() * p.element_size()]
                  .view(p.dtype).view(p.shape) for p, off in zip(parts, offs))
    return views, ev, buf


# ---------------------------------------------------------------------
# the lazy source
# ---------------------------------------------------------------------

class StreamSource:
    """A lazy out-of-core operand: host slabs plus device-side stages.

    ``kind='callback'`` sources produce any record range on demand
    (``fn(index_slices) -> block``) and can be streamed repeatedly;
    ``kind='iter'`` sources yield consecutive blocks, once per ``iter()``
    of the underlying iterable.  ``stages`` is the per-record chain,
    ``("map", func)`` each, applied to every slab on the device."""

    __slots__ = ("kind", "produce", "blocks", "shape", "split", "dtype",
                 "device", "slab", "stages", "codec", "_state", "_consumed")

    def __init__(self, kind, produce, blocks, shape, split, dtype, device,
                 slab, stages=(), codec=None):
        self.kind = kind
        self.produce = produce          # callback: fn(index_slices)
        self.blocks = blocks            # iter: the iterable of blocks
        self.shape = tuple(int(s) for s in shape)
        self.split = int(split)
        self.dtype = np.dtype(dtype)
        self.device = device
        self.slab = int(slab)
        self.stages = tuple(stages)
        self.codec = codec              # ingest codec NAME, or None
        self._state = None
        # a one-shot iterator streams once; the cell is shared by the
        # sources derived with with_stage (they share the iterator)
        self._consumed = [False]

    @classmethod
    def from_callback(cls, fn, shape, split, dtype, device, chunks=None,
                      codec=None):
        if codec is not None:
            _codec_registry().get(codec)    # pointed at construction
        slab = _slab_records(shape, dtype, chunks)
        return cls("callback", fn, None, shape, split, dtype, device, slab,
                   codec=codec)

    @classmethod
    def from_iter(cls, blocks, shape, split, dtype, device, codec=None):
        if codec is not None:
            _codec_registry().get(codec)
        # slab sizes are whatever the iterator yields
        slab = _slab_records(shape, dtype, None)
        return cls("iter", None, blocks, shape, split, dtype, device, slab,
                   codec=codec)

    def with_stage(self, stage):
        """A new source sharing the host side, one stage longer."""
        out = StreamSource(self.kind, self.produce, self.blocks, self.shape,
                           self.split, self.dtype, self.device, self.slab,
                           self.stages + (stage,), codec=self.codec)
        out._consumed = self._consumed
        return out

    def produce_slab(self, lo, hi):
        """One validated host block for records ``[lo, hi)`` (callback
        sources; the pool's workers call it concurrently, so the callback
        must be thread-safe)."""
        rest = self.shape[1:]
        index = (slice(lo, hi),) + tuple(slice(0, s) for s in rest)
        block = np.asarray(self.produce(index), dtype=self.dtype)
        if block.shape != (hi - lo,) + rest:
            raise ValueError(
                "fromcallback callback returned shape %s for index "
                "%s (expected %s)"
                % (block.shape, index, (hi - lo,) + rest))
        return block

    def slab_ranges(self):
        """``(lo, hi)`` record ranges of every slab, in key order."""
        n, slab = self.shape[0], self.slab
        return [(lo, min(lo + slab, n)) for lo in range(0, n, slab)]

    def slabs(self):
        """Yield an iterator source's ``(lo, hi, block)`` slabs in key
        order, validated and cast to the source dtype (callback sources
        go through :meth:`produce_slab`)."""
        if iter(self.blocks) is self.blocks:
            if self._consumed[0]:
                raise RuntimeError(
                    "this fromiter source was already streamed and its "
                    "iterator is exhausted (generators are one-shot); "
                    "materialise once and reuse the result, pass a "
                    "re-iterable (e.g. a list of blocks), or use "
                    "fromcallback for random-access sources")
            self._consumed[0] = True
        yield from iter_record_blocks(self.blocks, self.shape, self.dtype)

    def __repr__(self):
        return ("StreamSource(%s, shape=%s, split=%d, dtype=%s, slab=%d, "
                "stages=%d)" % (self.kind, self.shape, self.split,
                                self.dtype, self.slab, len(self.stages)))


def _slab_records(shape, dtype, chunks):
    n = int(shape[0])
    if chunks is not None:
        slab = int(chunks)
        if slab < 1:
            raise ValueError("chunks (records per slab) must be >= 1, "
                             "got %d" % slab)
        return min(slab, max(n, 1))
    rec = prod(shape[1:]) * np.dtype(dtype).itemsize
    return max(1, min(max(n, 1), _SLAB_BYTES // max(rec, 1)))


# ---------------------------------------------------------------------
# stages and the result they describe
# ---------------------------------------------------------------------

def _stage_apply(stage, split, x):
    """Apply one stage to the slab tensor ``x``: the materialised path's
    own map chain, so streamed and materialised results cannot drift."""
    if stage[0] == "map":
        from bolt_tpu_torch.gpu.array import _chain_apply
        return _chain_apply((stage[1],), split, x)
    raise ValueError("unknown stream stage %r" % (stage[0],))


class _ResultState:
    """What the stage chain produces: the result shape and numpy dtype,
    its split, and the record count ``n`` and value shape the terminals
    fold over."""

    __slots__ = ("shape", "dtype", "split", "n", "vshape")

    def __init__(self, shape, dtype, split):
        self.shape = shape
        self.dtype = dtype
        self.split = split
        self.n = prod(shape[:split])
        self.vshape = tuple(shape[split:])


def result_state(source):
    """Walk the stage chain on a one-record meta tensor (cached on the
    source)."""
    if source._state is None:
        from bolt_tpu_torch.gpu.array import numpy_dtype, torch_dtype
        x = torch.empty((1,) + source.shape[1:],
                        dtype=torch_dtype(source.dtype), device="meta")
        for stage in source.stages:
            x = _stage_apply(stage, source.split, x)
        shape = (source.shape[0],) + tuple(x.shape[1:])
        source._state = _ResultState(shape, numpy_dtype(x.dtype),
                                     source.split)
    return source._state


def map_stage(arr, func):
    """Record a per-record map on a stream-backed array (lazy)."""
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    return BoltArrayGPU._streamed(arr._stream.with_stage(("map", func)))


# ---------------------------------------------------------------------
# the terminal doors (NotImplemented: the caller materialises)
# ---------------------------------------------------------------------

_STAT_NAMES = ("sum", "mean", "var", "std", "min", "max")


def maybe_stat(arr, axis, name, keepdims, ddof):
    """Stream a statistic over all key axes; ``NotImplemented`` for any
    other geometry."""
    src = arr._stream
    if src is None or keepdims or name not in _STAT_NAMES:
        return NotImplemented
    st = result_state(src)
    if st.n == 0:
        return NotImplemented           # the materialised path's rules
    if axis is not None and tuple(sorted(tupleize(axis))) \
            != tuple(range(st.split)):
        return NotImplemented
    if name in ("mean", "var", "std") and np.issubdtype(
            st.dtype, np.complexfloating):
        return NotImplemented
    return execute(arr, name, ddof=ddof)


def maybe_reduce(arr, func, axes, keepdims):
    """Stream a ``reduce(func)`` over all key axes (``func`` already
    checked to batch under ``vmap``)."""
    src = arr._stream
    if src is None or keepdims:
        return NotImplemented
    st = result_state(src)
    if st.n == 0 or tuple(axes) != tuple(range(st.split)):
        return NotImplemented
    return execute(arr, "reduce", rfunc=func)


# ---------------------------------------------------------------------
# per-slab partials and their merges
# ---------------------------------------------------------------------

def _combine(terminal, rfunc, a, b):
    """The one partial-merge arithmetic, of the level-0 fold and of the
    tree above it.  ``a`` is the EARLIER partial; moments partials are
    ``(n, mu, M2)`` triples merged by Chan's parallel recurrence."""
    if terminal == "sum":
        return torch.add(a, b)
    if terminal == "min":
        return torch.minimum(a, b)
    if terminal == "max":
        return torch.maximum(a, b)
    if terminal == "reduce":
        return rfunc(a, b)
    n1, mu1, m21 = a
    n2, mu2, m22 = b
    n = n1 + n2
    delta = mu2 - mu1
    mu = mu1 + delta * (n2 / n)
    m2 = m21 + m22 + delta * delta * (n1 * n2 / n)
    return n, mu, m2


def _terminal_partial(terminal, flat, vshape, n, rfunc, dtype):
    """One slab's partial of ``terminal`` over its ``n`` flattened records
    ``flat`` (source numpy ``dtype`` after the stages): the materialised
    terminals' own arithmetic for sum/min/max/reduce, the statcounter
    triple ``(n, mu, M2)`` for mean/var/std."""
    from bolt_tpu_torch.gpu import dtypes
    from bolt_tpu_torch.gpu.array import _reduce_stat, _reduce_tree
    if terminal in ("sum", "min", "max"):
        return _reduce_stat(flat, terminal, (0,), False, None, dtype)
    if terminal == "reduce":
        return _reduce_tree(flat, rfunc, n, vshape)
    out_dt = dtypes.stat_dtype("mean", flat.dtype)
    cnt = torch.tensor(n, dtype=out_dt, device=flat.device)
    xf = flat.to(out_dt)
    mu = xf.sum(dim=0) / cnt
    dev = xf - mu
    return cnt, mu, (dev * dev).sum(dim=0)


def _finalise(terminal, ddof, moments):
    """The moments triple as the requested statistic."""
    n, mu, m2 = moments
    if terminal == "mean":
        return mu
    dd = torch.tensor(0.0 if ddof is None else ddof, dtype=n.dtype,
                      device=n.device)
    var = m2 / (n - dd)
    return torch.sqrt(var) if terminal == "std" else var


def _slab_partial(source, st, terminal, rfunc, codec_obj, use_kernel,
                  delta_ok, parts):
    """The program each slab runs: decode (when a codec is armed), the map
    stages, the terminal's partial.  ``use_kernel`` routes an int8
    ``sum`` with no stages through ``fused_decode_sum``, whose CUDA kernel
    launches on a card tensor or raises."""
    from bolt_tpu_torch.gpu.array import torch_dtype
    raw_dtype = torch_dtype(source.dtype)
    if codec_obj is None:
        x = parts[0]
    else:
        wire, side = parts[0], parts[1:]
        if use_kernel:
            from bolt_tpu_torch.ops.kernels import fused_decode_sum
            out = fused_decode_sum(wire, side[0], side[1])
            if out is not None:
                return out.to(raw_dtype)
        x = codec_obj.decode(wire, side, raw_dtype, delta_ok)
    for stage in source.stages:
        x = _stage_apply(stage, source.split, x)
    n = prod(tuple(x.shape[:source.split]))
    flat = x.reshape((n,) + st.vshape)
    return _terminal_partial(terminal, flat, st.vshape, n, rfunc, st.dtype)


class _PairFold:
    """Binary-counter pairwise tree over the pair partials (level 0 is
    merged in the consumer loop): leaf *i* merges at tree level
    ``trailing_zeros(i)``, so no more than log2(n) partials live."""

    __slots__ = ("_merge", "levels")

    def __init__(self, merge):
        self._merge = merge
        self.levels = []

    def push(self, x):
        lvl = 0
        while lvl < len(self.levels) and self.levels[lvl] is not None:
            x = self._merge(self.levels[lvl], x)
            self.levels[lvl] = None
            lvl += 1
        if lvl == len(self.levels):
            self.levels.append(x)
        else:
            self.levels[lvl] = x

    def result(self):
        acc = None
        for x in self.levels:
            if x is None:
                continue
            acc = x if acc is None else self._merge(x, acc)
        return acc


class _Reseq:
    """Slab-order re-sequencing between the pool and the consumer: workers
    insert completed slabs by index, the consumer pops them strictly in
    slab order, so the fold is deterministic whichever upload finishes
    first.  Also the fault funnel: the first worker exception is
    re-raised in the consumer, and a liveness poll turns pool threads that
    died without delivering into a pointed error."""

    __slots__ = ("_cond", "_slots", "_next", "_exc", "_total", "_dead_err")

    def __init__(self):
        self._cond = threading.Condition()
        self._slots = {}
        self._next = 0
        self._exc = None
        self._total = None
        self._dead_err = None

    def put(self, i, item):
        with self._cond:
            self._slots[i] = item
            self._cond.notify_all()

    def fault(self, exc):
        """Record the FIRST failure (later ones are consequences)."""
        with self._cond:
            if self._exc is None:
                self._exc = exc
            self._cond.notify_all()

    def finish(self, total):
        """Every slab dispensed: ``total`` is the slab count."""
        with self._cond:
            self._total = total
            self._cond.notify_all()

    def drain(self):
        """Release every queued slab (abort path)."""
        with self._cond:
            self._slots.clear()

    def _dead(self, threads):
        dead = [t for t in threads if not t.is_alive()] or threads
        key = tuple(sorted(t.ident or id(t) for t in dead))
        if self._dead_err is not None and self._dead_err[0] == key:
            return self._dead_err[1]
        names = list(dict.fromkeys(repr(t.name) for t in dead))
        err = RuntimeError(
            "streaming prefetch thread(s) %s died without delivering "
            "slab %d or an error (thread killed before it could enqueue "
            "— e.g. interpreter teardown); the stream cannot complete"
            % (", ".join(names), self._next))
        self._dead_err = (key, err)
        return err

    def next(self, threads, workers=None, timeout=0.1, stall_limit=300,
             idle=None):
        """The next ``(slab_i, item)`` in slab order, or ``None`` at the
        end of the stream.  Re-raises a recorded fault; raises when every
        ingesting thread is dead with the slab undelivered, or when the
        lead dispenser died before announcing the slab count and nothing
        arrived for ``stall_limit`` polls.  ``idle`` runs outside the lock
        before each wait."""
        ingesters = threads if workers is None else workers
        lead = threads[0]
        stalls = 0
        seen = -1
        while True:
            if idle is not None:
                idle()
            with self._cond:
                if self._next in self._slots:
                    i = self._next
                    self._next += 1
                    return i, self._slots.pop(i)
                if self._exc is not None:
                    raise self._exc
                if self._total is not None and self._next >= self._total:
                    return None
                if not any(t.is_alive() for t in ingesters):
                    raise self._dead(threads)
                if not lead.is_alive() and self._total is None:
                    if len(self._slots) != seen:
                        seen = len(self._slots)
                        stalls = 0
                    stalls += 1
                    if stalls > stall_limit:
                        raise self._dead(threads)
                self._cond.wait(timeout)


def _acquire(sem, stop):
    """Ring-permit acquire that gives up when the run is aborting."""
    while not stop.is_set():
        if sem.acquire(timeout=0.05):
            return True
    return False


# ---------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------

def execute(arr, terminal, ddof=None, rfunc=None):
    """Run the streamed reduction ``terminal`` over ``arr``'s source
    through the pipeline of the module docstring; returns a value-shaped
    ``BoltArrayGPU`` (``split=0``)."""
    global _LAST_POOL
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    source = arr._stream
    device = source.device
    st = result_state(source)
    depth = prefetch_depth()
    nwork = pool_size(source)
    codec_obj = resolve_codec(source)
    if codec_obj is not None and not codec_obj.lossless \
            and terminal in ("min", "max"):
        raise ValueError(
            "lossy codec %r refused for the order-statistic "
            "terminal(s) %s: min/max/ptp are exact by contract and "
            "a quantised extremum is never the answer the caller "
            "meant.  Use the lossless 'delta-f32' codec, or stream "
            "this terminal uncompressed" % (codec_obj.name, [terminal]))
    delta_ok = source.split < len(source.shape)
    # the reference's conditions for the decode-and-reduce kernel, read
    # once per run
    use_kernel = (codec_obj is not None and codec_obj.name == "int8"
                  and terminal == "sum" and not source.stages
                  and source.split == 1
                  and _codec_registry().kernel_enabled())
    on_card = device.type == "cuda"
    ring = _PinnedRing() if on_card else None
    compute_stream = torch.cuda.current_stream(device) if on_card else None

    # ring permits: at most depth + pool-size slabs alive at once; one is
    # always left for the dispenser, so the in-flight window is one less
    nring = depth + nwork
    window = nring - 1
    permits = threading.Semaphore(nring)
    stop = threading.Event()
    rsq = _Reseq()
    act_lock = threading.Lock()
    act = {"n": 0, "hw": 0}

    def _act(delta):
        with act_lock:
            act["n"] += delta
            act["hw"] = max(act["hw"], act["n"])

    def _ingest(block, copy_stream):
        """Encode (with a codec armed) and upload one host block; returns
        the slab as :func:`_upload` gives it."""
        if codec_obj is None:
            parts = (torch.from_numpy(np.ascontiguousarray(block)),)
        else:
            wire, side = _encode_slab(codec_obj, block, delta_ok)
            parts = (wire,) + tuple(torch.as_tensor(np.asarray(s))
                                    for s in side)
        return _upload(parts, device, ring, copy_stream)

    jobq = queue.Queue()

    def dispenser():
        """Callback sources: hand ``(slab_i, lo, hi)`` jobs to the pool in
        slab order, one ring permit each."""
        try:
            i = 0
            for lo, hi in source.slab_ranges():
                if not _acquire(permits, stop):
                    return
                jobq.put((i, lo, hi))
                i += 1
            rsq.finish(i)
        except BaseException as exc:        # noqa: BLE001 — re-raised in
            rsq.fault(exc)                  # the consumer thread
        finally:
            for _ in range(nwork):
                jobq.put(None)              # poison pills: the pool drains

    def worker():
        try:
            copy_stream = torch.cuda.Stream(device) if on_card else None
            while True:
                job = jobq.get()
                if job is None or stop.is_set():
                    return
                i, lo, hi = job
                _act(1)
                t0 = _clock()
                try:
                    slab = _ingest(source.produce_slab(lo, hi), copy_stream)
                finally:
                    _act(-1)
                rsq.put(i, (slab, _clock() - t0))
                del slab            # the consumer owns it now
        except BaseException as exc:        # noqa: BLE001
            rsq.fault(exc)

    def prefetch():
        """Iterator sources: one produce+upload thread (the iterable is
        sequential)."""
        try:
            copy_stream = torch.cuda.Stream(device) if on_card else None
            it = source.slabs()
            i = 0
            while True:
                if not _acquire(permits, stop):
                    return
                _act(1)
                t0 = _clock()
                try:
                    try:
                        _, _, block = next(it)
                    except StopIteration:
                        permits.release()
                        break
                    slab = _ingest(block, copy_stream)
                    del block
                finally:
                    _act(-1)
                rsq.put(i, (slab, _clock() - t0))
                del slab
                i += 1
            rsq.finish(i)
        except BaseException as exc:        # noqa: BLE001
            rsq.fault(exc)

    if source.kind == "callback":
        lead = threading.Thread(target=dispenser,
                                name="bolt-stream-prefetch", daemon=True)
        pool = [threading.Thread(target=worker,
                                 name="bolt-stream-upload-%d" % w,
                                 daemon=True) for w in range(nwork)]
        threads = [lead] + pool
    else:
        lead = threading.Thread(target=prefetch,
                                name="bolt-stream-prefetch", daemon=True)
        pool = [lead]
        threads = [lead]
    _LAST_POOL = tuple(threads)

    t_start = _clock()
    ingest = compute = 0.0
    nslabs = dispatched = confirmed = inflight_hw = 0
    fold = _PairFold(lambda a, b: _combine(terminal, rfunc, a, b))
    pend = None                 # the even slab's partial awaiting its pair
    pending_sync = deque()      # (slabs covered, event) not yet confirmed

    def _confirm_oldest():
        """Wait for the OLDEST unconfirmed pair partial (normally long
        retired) and release its ring permits."""
        nonlocal compute, confirmed
        cov, ev = pending_sync.popleft()
        t0 = _clock()
        if ev is not None:
            ev.synchronize()
        compute += _clock() - t0
        confirmed += cov
        permits.release(cov)

    def _retire():
        """Release the permits of every pair partial the device has
        already retired, without waiting: a window full of retired slabs
        would otherwise hold the ring's permits and starve the pool."""
        while pending_sync and (pending_sync[0][1] is None
                                or pending_sync[0][1].query()):
            _confirm_oldest()

    for th in threads:
        th.start()
    try:
        while True:
            got = rsq.next(threads, workers=pool, idle=_retire)
            if got is None:
                break
            _, ((parts, ev, buf), tsec) = got
            del got
            ingest += tsec
            t0 = _clock()
            if on_card:
                compute_stream.wait_event(ev)
                # the slab was allocated on its worker's copy stream:
                # keep the allocator from reusing it before the compute
                # stream is done with it
                buf.record_stream(compute_stream)
            part = _slab_partial(source, st, terminal, rfunc, codec_obj,
                                 use_kernel, delta_ok, parts)
            del parts, buf
            if pend is None:
                pend = part
            else:
                # the level-0 merge: the even slab's partial, then this one
                fold.push(_combine(terminal, rfunc, pend, part))
                pend = None
                done = None
                if on_card:
                    done = torch.cuda.Event()
                    done.record(compute_stream)
                pending_sync.append((2, done))
            nslabs += 1
            compute += _clock() - t0
            dispatched += 1
            inflight_hw = max(inflight_hw, dispatched - confirmed)
            # the bounded in-flight window: release what has retired, and
            # wait only on overflow
            _retire()
            while dispatched - confirmed > window and pending_sync:
                _confirm_oldest()
        if pend is not None:
            fold.push(pend)     # an odd slab count's tail joins as a leaf
            pend = None
    finally:
        stop.set()
        # the consumer's own poison pills, in case the dispenser died
        # before its finally could enqueue them
        for _ in range(len(threads)):
            jobq.put(None)
        for th in threads:
            th.join()
        rsq.drain()
        pending_sync.clear()
    if nslabs == 0:
        raise RuntimeError(
            "stream produced no slabs (empty source?) — nothing to "
            "reduce; the materialised path owns empty-input rules")
    t0 = _clock()
    out = fold.result()
    if terminal in ("mean", "var", "std"):
        out = _finalise(terminal, ddof, out)
    if on_card:
        compute_stream.synchronize()    # the run's one final sync
    compute += _clock() - t0
    wall = _clock() - t_start
    _engine.record_stream(nslabs, ingest, compute, wall,
                          max(0.0, ingest + compute - wall), depth,
                          uploaders=max(act["hw"], 1),
                          inflight=max(inflight_hw, 1))
    return BoltArrayGPU(out, 0, device)


# ---------------------------------------------------------------------
# materialisation (consumers that are not streamed)
# ---------------------------------------------------------------------

def materialize(source):
    """The CONCRETE array ``source`` describes: the base uploaded whole,
    then every recorded stage replayed through the normal map path, so a
    materialised stream equals never having streamed.  Needs the whole
    array to fit on the device."""
    return _replay_stages(_materialize_base(source), source.stages)


def _replay_stages(b, stages):
    for stage in stages:
        if stage[0] != "map":
            raise ValueError("unknown stream stage %r" % (stage[0],))
        b = b.map(stage[1], axis=tuple(range(b.split)))
    return b


def _materialize_base(source):
    """Upload the raw source: a callback source slab by slab into one
    device tensor (the pool produces the slabs concurrently, so no whole
    host copy exists), an iterator source assembled on the host first."""
    from bolt_tpu_torch.gpu.array import BoltArrayGPU, torch_dtype
    if source.kind != "callback":
        host = np.empty(source.shape, source.dtype)
        for lo, hi, block in source.slabs():
            host[lo:hi] = block
        return BoltArrayGPU(transfer(host, source.device), source.split,
                            source.device)
    t0 = _clock()
    data = torch.empty(source.shape, dtype=torch_dtype(source.dtype),
                       device=source.device)

    def fill(rng):
        lo, hi = rng
        data[lo:hi].copy_(torch.from_numpy(np.ascontiguousarray(
            source.produce_slab(lo, hi))))

    with ThreadPoolExecutor(max_workers=pool_size(source),
                            thread_name_prefix="bolt-stream-upload") as ex:
        list(ex.map(fill, source.slab_ranges()))
    if data.device.type == "cuda":
        torch.cuda.current_stream(data.device).synchronize()
    _engine.record_transfer(data.numel() * data.element_size(),
                            _clock() - t0)
    return BoltArrayGPU(data, source.split, source.device)
