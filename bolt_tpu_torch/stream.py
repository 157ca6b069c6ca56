"""Streaming out-of-core executor: a parallel-ingest, async-dispatch
host->device pipeline.

Port of the single-process part of ``bolt_tpu/stream.py``.  A lazy
:class:`StreamSource` (``fromcallback``/``fromiter`` with an explicit
dtype) describes host-resident data as record *slabs* (consecutive blocks
along the first key axis) plus a chain of device-side stages, applied to
every slab: per-record ``("map", func)``, chunked maps ``("chunk", func,
plan, pad, dtype)``, block-batched maps ``("stack", func, size, dtype)``,
a trailing ``("filter", pred)`` whose mask the terminals fold, and a
``("swap", perm, split)`` re-keying that the two-phase shuffle resolves
before any slab program runs.  :func:`execute` runs a reduction terminal
(``sum``, ``mean``, ``var``, ``std``, ``min``, ``max``, ``reduce``, or a
``"multi"`` group of several) over it without the whole array ever
living on the device:

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
  consumer strictly in slab order, and fences a late duplicate of a
  slab already queued or folded; the consumer makes the compute stream
  wait on the slab's event (and records the slab's memory on the compute
  stream, so the caching allocator cannot hand it out while a kernel
  still reads it) and runs the slab program: decode, the stages, the
  terminal's partial (masked by a trailing filter's predicate: a
  dropped record, NaN included, is an inert zero);
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
  counts keep the Chan denominators exact.  A multi-stat group folds a
  tuple of components (``sum``, the ``(n, mu, M2)`` moments, ``min``,
  ``max``) from ONE read of each slab, each component with its
  standalone arithmetic, so every member equals its standalone streamed
  terminal bit for bit.

A ``swap`` on a stream is a lazy stage; the terminal that consumes it
resolves it through the two-phase shuffle
(:mod:`bolt_tpu_torch.parallel.shuffle`): phase 1 streams the input
slabs through the same pool and permutes each on the device, phase 2
either copies them into the swapped array (resident) or spills buckets
of it to files (:mod:`bolt_tpu_torch.checkpoint`) that a fresh source
streams again (:func:`spill`).

Pinned memory and CUDA streams are used only when the source's device is
CUDA; with ``context=torch.device("cpu")`` the same executor runs with
plain host tensors.  Fault model: a source callback or worker that
raises aborts the run (every pool thread joined, queued slabs released,
the original exception re-raised); a pool thread that dies without
delivering surfaces as a pointed ``RuntimeError``; under
:func:`retries` (``BOLT_STREAM_RETRIES``) a failed ingest, dispatch,
re-bucket or spill write re-runs in place up to *n* times, and the
final error chains every attempt back to the original.  The named seams
of :mod:`bolt_tpu_torch._chaos` (``stream.encode``, ``stream.upload``,
``stream.dispatch``, ``stream.fold``, ``stream.shuffle``,
``stream.spill``, ``stream.checkpoint``) trip faults there
deterministically.

Resume: under :func:`resumable` (or a source's own ``checkpoint=dir``) a
run writes its retired-slab watermark and folded partial every ``every``
retired slabs (:mod:`bolt_tpu_torch.checkpoint`), and once more, best
effort, when it fails.  A run over the same source finds the checkpoint
by the run's fingerprint (:func:`_run_fingerprint`), skips the retired
slabs, restores the fold where it stood and ends with the uninterrupted
run's result bit for bit; success removes the checkpoint.

Accounting lands in :mod:`bolt_tpu_torch.engine` (``transfer_*``,
``stream_*``, ``codec_*``, ``shuffle_*``, ``spill_bytes``,
``checkpoint_*``), under the caller's engine tenant in the uploader
threads too; with tracing armed (:mod:`bolt_tpu_torch.obs`) a run is a
``stream.run`` span (a shuffle a ``stream.shuffle`` span, a checkpoint
write a ``stream.checkpoint`` span, a resume a ``stream.resume`` event),
and the ingest spans its threads begin parent under it by explicit
handoff.  Under a serving layer (``bolt_tpu_torch.serve``) a run leases
its slabs from the process-wide device-memory arbiter, in slab order and
in wire bytes, and returns each slab's bytes when the consumer confirms it
retired; a budget smaller than the ring shallows the pipeline instead of
deadlocking it.

On a pod (a mesh of more than one rank, one process each; the source's
``mesh``) the same executor runs on every rank over one slab schedule:
each rank produces and uploads only its own contiguous rows of every
slab (``multihost.local_slab_spec``: the ``fromcallback(...,
per_process=True)`` contract; a re-iterable ``fromiter`` slices its
rows out of each block), runs the slab program on them, and folds the
slab's partial across the ranks of the mesh axes the key axes are
sharded over (:func:`_pod_fold`, on the consumer thread in slab order,
one exchange a slab and a second for moments), so every rank's fold
holds the same bits.  A slab the key-axis assignment does not divide
(BLT012), a sidecar codec and a user ``reduce`` are refused before any
thread starts; checkpoints are one shard file a rank
(:mod:`bolt_tpu_torch.checkpoint`); a streamed ``swap`` exchanges each
slab's rows by one ``all_to_all`` (resident only).  Pod runs launch no
kernel: ``fused_decode_sum`` is off a pod (int8 is refused there).
Recovery (:mod:`bolt_tpu_torch.parallel.podwatch`): a pod run counts
itself busy (``pod_enter``/``pod_exit``), meets its peers at a readiness
rendezvous before its first exchange, guards each exchange so a dead
peer raises ``PeerLostError`` naming it and the in-flight slab, and
stops with ``PodQuiesceError`` at a slab-boundary checkpoint when the
supervisor asks; a checkpoint cut at another width resumes at its
watermark through the topology remap, with this run's per-rank rows.
Any other consumer — a filtered stream's shape, ``prod``/``all``/``any``,
``min``/``max`` under a filter, an axis other than all the key axes —
materialises the source (:func:`materialize`), which needs the whole
array to fit.
"""

import contextlib
import os
import queue
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bolt_tpu_torch import _chaos
from bolt_tpu_torch import _lockdep
from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.obs.trace import clock as _clock
from bolt_tpu_torch.parallel import podwatch as _podwatch
from bolt_tpu_torch.utils import iter_record_blocks, prod, tupleize

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

# in-run retry budget per slab step: 0 = fail-fast, n = a failed step
# re-runs in place up to n times before failing the run
_RETRIES = max(0, int(os.environ.get("BOLT_STREAM_RETRIES", "0")))

# checkpoint cadence under resumable(): the fold state is written every k
# retired slabs; each write drains the in-flight window and copies the
# value-shaped partials to the host
_CKPT_EVERY = max(1, int(os.environ.get("BOLT_CHECKPOINT_EVERY", "2")))

# the process default spill directory of a streamed swap whose output
# exceeds its resident budget (None: such a swap refuses)
_SPILL_DIR = os.environ.get("BOLT_STREAM_SPILL_DIR") or None

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
            src.map(f).sum().toarray()
    """
    st = _scope_stack("uploaders")
    st.append(max(0, int(n)))
    try:
        yield
    finally:
        st.pop()


def retry_limit():
    """The calling thread's per-slab retry budget (innermost
    :func:`retries` scope, else the process default; 0 = fail-fast)."""
    st = _scope_stack("retries")
    return st[-1] if st else _RETRIES


def set_retries(n):
    """Set the process-wide default per-slab retry budget."""
    global _RETRIES
    _RETRIES = max(0, int(n))


@contextlib.contextmanager
def retries(n):
    """Scope the per-slab retry budget (thread-local)::

        with bolt_tpu_torch.stream.retries(2):
            flaky_src.map(f).sum().toarray()   # each slab survives 2
                                               # failures
    """
    st = _scope_stack("retries")
    st.append(max(0, int(n)))
    try:
        yield
    finally:
        st.pop()


@contextlib.contextmanager
def spill(dir=None, budget=None):
    """Scope the out-of-core shuffle's spill policy (thread-local)::

        with bolt_tpu_torch.stream.spill("/scratch/shuffle", budget=1 << 30):
            big.swap((0,), (0,)).sum().toarray()   # a swapped output over
                                                   # 1 GiB spills to files

    ``dir`` is where bucket files land (``None`` keeps the
    ``BOLT_STREAM_SPILL_DIR`` default); ``budget`` caps the resident
    working set in bytes (``None``: unbounded)."""
    st = _scope_stack("spill")
    st.append((os.fspath(dir) if dir is not None else None,
               int(budget) if budget is not None else None))
    try:
        yield
    finally:
        st.pop()


def spill_scope():
    """The calling thread's innermost :func:`spill` scope as ``(dir,
    budget)``: the directory falls back to ``BOLT_STREAM_SPILL_DIR``, the
    budget is ``None`` when unset."""
    st = _scope_stack("spill")
    if st:
        d, b = st[-1]
        return (d if d is not None else _SPILL_DIR), b
    return _SPILL_DIR, None


def swap_budget():
    """The resident ceiling a streamed-swap resolution plans against: the
    innermost :func:`spill` scope's ``budget``, else the active serving
    arbiter's device budget, else ``None`` (unbounded)."""
    b = spill_scope()[1]
    if b is not None:
        return b
    sv = sys.modules.get("bolt_tpu_torch.serve")
    arb = sv.device_arbiter() if sv is not None else None
    return None if arb is None else int(arb.budget)


def _tenant_lease():
    """A device-memory lease from the active serving arbiter
    (``bolt_tpu_torch.serve``) for the calling thread's tenant, or
    ``None`` when no serving layer runs.  Found through ``sys.modules``,
    so streaming never imports (or starts) the serving layer."""
    sv = sys.modules.get("bolt_tpu_torch.serve")
    arb = sv.device_arbiter() if sv is not None else None
    if arb is None:
        return None
    return arb.lease(_engine.current_tenant() or "default")


def checkpoint_scope():
    """The calling thread's innermost :func:`resumable` scope as ``(dir,
    every)``, or ``None`` when streaming is not resumable."""
    st = _scope_stack("ckpt")
    return st[-1] if st else None


@contextlib.contextmanager
def resumable(dir, every=None):
    """Scope slab-level checkpointing for streamed runs (thread-local)::

        with bolt_tpu_torch.stream.resumable("/ckpt/run17"):
            src.map(f).sum().toarray()   # killed?  the same call resumes
                                         # from the last retired slab

    ``every`` is the cadence in retired slabs (default
    ``BOLT_CHECKPOINT_EVERY``, 2).  A source's own ``checkpoint=dir``
    (``fromcallback``/``fromiter``) wins over the scope.  A one-shot
    iterator cannot be resumed: it dies with the process."""
    st = _scope_stack("ckpt")
    st.append((os.fspath(dir),
               max(1, int(every)) if every is not None else _CKPT_EVERY))
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
            src.map(f).sum().toarray()     # slabs ship at half the bytes

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
    sp = _obs.begin("stream.transfer")
    t0 = _clock()
    try:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        out = t.to(device, copy=True)
        if out.device.type == "cuda":
            torch.cuda.current_stream(out.device).synchronize()
        nbytes = t.numel() * t.element_size()
        _engine.record_transfer(nbytes, _clock() - t0)
        if sp is not None:
            sp.set(bytes=nbytes)
    finally:
        _obs.end(sp)
    return out


def _encode_slab(codec_obj, block, delta_ok):
    """Host-side slab encode on an uploader worker, counted in the
    ``codec_*`` counters (the ``stream.encode`` chaos seam)."""
    _chaos.hit("stream.encode")
    sp = _obs.begin("stream.encode", codec=codec_obj.name)
    t0 = _clock()
    try:
        wire, side = codec_obj.encode(block, delta_ok)
        _engine.record_codec(int(block.nbytes),
                             wire.numel() * wire.element_size(),
                             _clock() - t0)
    finally:
        _obs.end(sp)
    return wire, side


class _PinnedRing:
    """Pinned host buffers for one run's uploads, one per pool thread: a
    buffer goes back with the event of the copy that reads it and is
    handed out again only after that event has completed."""

    __slots__ = ("_lock", "_free")

    def __init__(self):
        self._lock = _lockdep.lock("stream.ring")
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
    after the copy landed.  The ``stream.upload`` chaos seam."""
    _chaos.hit("stream.upload")
    sp = _obs.begin("stream.transfer")
    if sp is not None:
        sp.set(bytes=sum(p.numel() * p.element_size() for p in parts))
    try:
        return _upload_parts(parts, device, ring, copy_stream)
    finally:
        _obs.end(sp)


def _upload_parts(parts, device, ring, copy_stream):
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
    of the underlying iterable.  ``stages`` is the device-side chain
    applied to every slab (its stage kinds: the module docstring)."""

    __slots__ = ("kind", "produce", "blocks", "shape", "split", "dtype",
                 "device", "slab", "stages", "ckpt", "codec", "mesh",
                 "_state", "_consumed")

    def __init__(self, kind, produce, blocks, shape, split, dtype, device,
                 slab, stages=(), ckpt=None, codec=None, mesh=None):
        self.kind = kind
        self.produce = produce          # callback: fn(index_slices)
        self.blocks = blocks            # iter: the iterable of blocks
        self.shape = tuple(int(s) for s in shape)
        self.split = int(split)
        self.dtype = np.dtype(dtype)
        self.device = device
        self.slab = int(slab)
        self.stages = tuple(stages)
        self.ckpt = ckpt                # resumable checkpoint dir, or None
        self.codec = codec              # ingest codec NAME, or None
        # the pod's mesh (more than one rank: each rank ingests its own
        # rows of every slab), or None on one device or a one-rank mesh
        self.mesh = mesh
        self._state = None
        # a one-shot iterator streams once; the cell is shared by the
        # sources derived with with_stage (they share the iterator)
        self._consumed = [False]

    @classmethod
    def from_callback(cls, fn, shape, split, dtype, device, chunks=None,
                      checkpoint=None, codec=None, mesh=None):
        if codec is not None:
            _codec_registry().get(codec)    # pointed at construction
        slab = _slab_records(shape, dtype, chunks)
        return cls("callback", fn, None, shape, split, dtype, device, slab,
                   ckpt=_ckpt_dir(checkpoint), codec=codec, mesh=mesh)

    @classmethod
    def from_iter(cls, blocks, shape, split, dtype, device, checkpoint=None,
                  codec=None, mesh=None):
        if codec is not None:
            _codec_registry().get(codec)
        # slab sizes are whatever the iterator yields
        slab = _slab_records(shape, dtype, None)
        return cls("iter", None, blocks, shape, split, dtype, device, slab,
                   ckpt=_ckpt_dir(checkpoint), codec=codec, mesh=mesh)

    def with_stage(self, stage):
        """A new source sharing the host side, one stage longer."""
        out = StreamSource(self.kind, self.produce, self.blocks, self.shape,
                           self.split, self.dtype, self.device, self.slab,
                           self.stages + (stage,), ckpt=self.ckpt,
                           codec=self.codec, mesh=self.mesh)
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


def _ckpt_dir(checkpoint):
    return os.fspath(checkpoint) if checkpoint is not None else None


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
    """Apply one stage to the slab tensor ``x``: the materialised paths'
    own bodies (the map chain, ``gpu/chunk.py``'s uniform and general
    bodies, ``gpu/stack.py``'s block-batched body), so streamed and
    materialised results cannot drift.  A trailing filter is folded as a
    mask by the terminals, never applied here."""
    kind = stage[0]
    if kind == "map":
        from bolt_tpu_torch.gpu.array import _chain_apply
        return _chain_apply((stage[1],), split, x)
    if kind == "chunk":
        from bolt_tpu_torch.gpu.chunk import (_general_map_body,
                                              _uniform_map_body)
        _, func, plan, pad, dtype = stage
        canon = _canon(dtype)
        vshape = x.shape[split:]
        if not any(pad) and all(v % c == 0 for v, c in zip(vshape, plan)):
            return _uniform_map_body(x, func, split, plan, canon)
        return _general_map_body(x, func, split, plan, pad, canon)
    if kind == "stack":
        from bolt_tpu_torch.gpu.stack import _stack_map_body
        _, func, size, dtype = stage
        return _stack_map_body(x, func, split, size, _canon(dtype))
    if kind == "swap":
        # the transpose crosses slab boundaries: resolve_swaps runs first
        raise RuntimeError(
            "internal: a 'swap' stage reached slab execution without "
            "being resolved — resolve_swaps must run first")
    raise ValueError("unknown stream stage %r" % (kind,))


def _canon(dtype):
    if dtype is None:
        return None
    from bolt_tpu_torch.gpu.dtypes import torch_dtype
    return torch_dtype(dtype)


class _ResultState:
    """What the stage chain produces: the result shape (``None`` behind a
    filter, whose survivor count is unknown) and numpy dtype, its split,
    the record count ``n`` the terminals fold over (before a filter: a
    bound), the value shape, and the filter predicate ``pred``."""

    __slots__ = ("shape", "dtype", "split", "dynamic", "n", "vshape",
                 "pred")

    def __init__(self, shape, dtype, split, dynamic, n, vshape, pred):
        self.shape = shape
        self.dtype = dtype
        self.split = split
        self.dynamic = dynamic
        self.n = n
        self.vshape = vshape
        self.pred = pred


def stage_label(stage):
    """The label of one stage in an analysis report."""
    def _name(f):
        return getattr(f, "__name__", None) or type(f).__name__
    kind = stage[0]
    if kind == "map":
        return "map(%s)" % _name(stage[1])
    if kind == "chunk":
        return "chunk(plan=%s).map(%s)" % (tuple(stage[2]), _name(stage[1]))
    if kind == "stack":
        return "stacked(%d).map(%s)" % (stage[2], _name(stage[1]))
    if kind == "filter":
        return "filter(%s)" % _name(stage[1])
    if kind == "swap":
        return "swap(perm=%s, split=%d)" % (stage[1], stage[2])
    return kind


def stage_aval(stage, split, aval):
    """The result of one stage on the meta tensor ``aval`` (the
    reference's abstract value): the stage's own body run on a
    ``device="meta"`` tensor, memoised per (stage, split, shape, dtype)
    in ``gpu/array.py``'s shape-inference cache.  A ``swap`` permutes the
    shape without running anything.  Allocates and launches nothing."""
    if stage[0] == "swap":
        return aval.permute(stage[1])
    from bolt_tpu_torch.gpu.array import _cached_eval_shape, _meta
    shape, dtype = tuple(aval.shape), aval.dtype
    return _cached_eval_shape(
        ("stream-stage", stage, split, shape, str(dtype)),
        lambda: _stage_apply(stage, split, _meta(shape, dtype)))


def result_state(source):
    """Walk the stage chain on a meta tensor of the source's shape (no
    memory, no data; cached on the source) through :func:`stage_aval`,
    the checker's own walk."""
    if source._state is None:
        from bolt_tpu_torch.gpu.array import numpy_dtype, torch_dtype
        x = torch.empty(source.shape, dtype=torch_dtype(source.dtype),
                        device="meta")
        split = source.split
        pred = None
        for stage in source.stages:
            if stage[0] == "filter":
                pred = stage[1]         # a filter is always the last stage
                break
            x = stage_aval(stage, split, x)
            if stage[0] == "swap":
                split = stage[2]        # the swap redraws the key cut
        shape = tuple(x.shape)
        n = prod(shape[:split])
        vshape = shape[split:]
        dtype = numpy_dtype(x.dtype)
        if pred is None:
            source._state = _ResultState(shape, dtype, split, False, n,
                                         vshape, None)
        else:
            source._state = _ResultState(None, dtype, 1, True, n, vshape,
                                         pred)
    return source._state


def _probe_stage(src, stage):
    """``src`` one stage longer, its result walked now; ``None`` when the
    stage's callable cannot be traced on a meta tensor (the caller then
    materialises, where the error surfaces)."""
    from bolt_tpu_torch.gpu.array import (_is_trace_error,
                                          _raise_callable_bug)
    out = src.with_stage(stage)
    try:
        result_state(out)
    except (RuntimeError, TypeError) as exc:
        if not _is_trace_error(exc):
            _raise_callable_bug(stage[0], stage[1], exc,
                                result_state(src).vshape)
        return None
    return out


def as_array(source):
    """The lazy array over ``source``: a single-device array, or on a pod
    (``source.mesh``) a mesh array whose terminals stream every rank's
    rows of each slab and fold them across the ranks."""
    if source.mesh is not None:
        from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
        return BoltArrayMesh._streamed(source)
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    return BoltArrayGPU._streamed(source)


def map_stage(arr, func):
    """Record a per-record map on a stream-backed array (lazy)."""
    return as_array(arr._stream.with_stage(("map", func)))


def filter_stage(arr, pred):
    """Record a trailing filter predicate (lazy; the result's record
    count is unknown until a consumer other than a streamed terminal
    materialises it)."""
    return as_array(arr._stream.with_stage(("filter", pred)))


def chunked_map_stage(view, func, dtype):
    """Record a chunked per-block map on a streaming chunked view; the new
    view, or ``NotImplemented`` when the stage cannot stream (the caller
    materialises)."""
    from bolt_tpu_torch.gpu.chunk import ChunkedArray
    src = view._barray._stream
    st = result_state(src)
    if st.dynamic:
        return NotImplemented
    plan, pad = tuple(view._plan), tuple(view._padding)
    out = _probe_stage(src, ("chunk", func, plan, pad, dtype))
    if out is None:
        return NotImplemented
    vshape = st.vshape
    if not any(pad) and all(v % c == 0 for v, c in zip(vshape, plan)):
        grid = tuple(v // c for v, c in zip(vshape, plan))
        nst = result_state(out)
        new_plan = tuple(o // g for o, g in zip(nst.vshape, grid))
    else:
        new_plan = plan             # the general path keeps the blocks
    return ChunkedArray(as_array(out), new_plan, pad)


def stacked_map_stage(view, func, dtype):
    """Record a block-batched map on a streaming stacked view.

    Streams only when every slab holds a whole number of blocks
    (``records_per_slab % size == 0``): a stacked ``func`` mixes records
    within its block, so slab boundaries must fall on block boundaries.
    Misaligned geometries, iterator sources (their block sizes are not
    known ahead), a pending swap and a pod source (its rank boundaries
    would have to fall on block boundaries on every rank) materialise
    (``NotImplemented``)."""
    from bolt_tpu_torch.gpu.stack import StackedArray
    src = view._barray._stream
    st = result_state(src)
    size = int(view._size)
    if st.dynamic or src.kind != "callback" or has_swap(src) \
            or src.mesh is not None:
        return NotImplemented
    if (src.slab * prod(st.shape[1:st.split])) % size != 0:
        return NotImplemented
    out = _probe_stage(src, ("stack", func, size, dtype))
    if out is None:
        return NotImplemented
    return StackedArray(as_array(out), size)


def swap_stage(arr, perm, new_split):
    """Record a ``swap`` on a stream-backed array, lazily: the terminal
    that consumes it resolves it through the two-phase shuffle
    (:func:`resolve_swaps`).  ``NotImplemented`` (the caller materialises)
    behind a filter (the record count is unknown) and under a lossy codec
    (phase 1 decodes once, and a later lossy terminal would quantise
    again), and on a pod for an iterator source (each rank's output rows
    need random access to the source) or a swap that keeps the record
    axis leading."""
    src = arr._stream
    if result_state(src).dynamic:
        return NotImplemented
    codec_obj = resolve_codec(src)
    if codec_obj is not None and not codec_obj.lossless:
        return NotImplemented
    if src.mesh is not None and (src.kind != "callback" or perm[0] == 0):
        # the record axis staying leading re-lays every record out:
        # the mesh's materialised swap does that
        return NotImplemented
    return as_array(src.with_stage(
        ("swap", tuple(int(p) for p in perm), int(new_split))))


def has_swap(source):
    """Whether ``source`` carries an unresolved ``swap`` stage."""
    return any(s[0] == "swap" for s in source.stages)


def resolve_swaps(source):
    """Resolve every pending ``swap`` of ``source`` through the two-phase
    shuffle; a ``BoltArrayGPU``, concrete when the last resolution was
    resident (the stages after the swap replayed by the materialised
    paths), stream-backed over the spilled bucket files when it spilled
    (the stages after the swap ride the new source)."""
    b = _resolve_one_swap(source)
    while b._stream is not None and has_swap(b._stream):
        b = _resolve_one_swap(b._stream)
    return b


def _swap_resolved(arr):
    """Resolve ``arr``'s pending swaps in place (``arr`` adopts the
    result); the swap-free source to keep streaming, or ``None`` when
    the result is concrete."""
    arr._adopt_resolved(resolve_swaps(arr._stream))
    return arr._stream


# ---------------------------------------------------------------------
# the terminal doors (NotImplemented: the caller materialises)
# ---------------------------------------------------------------------

_STAT_NAMES = ("sum", "mean", "var", "std", "min", "max")


def maybe_stat(arr, axis, name, keepdims, ddof):
    """Stream a statistic over all key axes; ``NotImplemented`` for any
    other geometry, and for ``min``/``max`` under a filter (no survivor
    needs the materialised error)."""
    src = arr._stream
    if src is None or keepdims or name not in _STAT_NAMES:
        return NotImplemented
    if has_swap(src):
        src = _swap_resolved(arr)
        if src is None:
            return NotImplemented
    st = result_state(src)
    if st.n == 0:
        return NotImplemented           # the materialised path's rules
    if axis is not None and tuple(sorted(tupleize(axis))) \
            != tuple(range(st.split)):
        return NotImplemented
    if st.pred is not None and name in ("min", "max"):
        return NotImplemented
    if name in ("mean", "var", "std") and np.issubdtype(
            st.dtype, np.complexfloating):
        return NotImplemented
    return execute(arr, name, ddof=ddof)


def maybe_reduce(arr, func, axes, keepdims):
    """Stream a ``reduce(func)`` over all key axes (``func`` already
    checked to batch under ``vmap``); a filter materialises."""
    src = arr._stream
    if src is None or keepdims:
        return NotImplemented
    if has_swap(src):
        src = _swap_resolved(arr)
        if src is None:
            return NotImplemented
    st = result_state(src)
    if st.pred is not None or st.n == 0 \
            or tuple(axes) != tuple(range(st.split)):
        return NotImplemented
    if src.mesh is not None:
        # a user combine function has no fold over the ranks that the
        # per-slab exchange could run: materialise instead
        return NotImplemented
    return execute(arr, "reduce", rfunc=func)


# ---------------------------------------------------------------------
# per-slab partials and their merges
# ---------------------------------------------------------------------

# multi-stat accumulator components and the merge each rides ("moments"
# is the (n, mu, M2) triple every mean/var/std member shares)
_COMP_MERGE = {"sum": "sum", "min": "min", "max": "max",
               "moments": "moments"}


def _multi_comps(specs):
    """The component tuple of a multi-stat spec list: one moments triple
    serves every mean/var/std member, min and max serve their members
    and both halves of a ``ptp``."""
    names = [name for name, _ in specs]
    comps = []
    if "sum" in names:
        comps.append("sum")
    if any(n in ("mean", "var", "std") for n in names):
        comps.append("moments")
    if "min" in names or "ptp" in names:
        comps.append("min")
    if "max" in names or "ptp" in names:
        comps.append("max")
    return tuple(comps)


def _combine(terminal, rfunc, a, b, comps=None):
    """The one partial-merge arithmetic, of the level-0 fold and of the
    tree above it.  ``a`` is the EARLIER partial; moments partials are
    ``(n, mu, M2)`` triples merged by Chan's parallel recurrence (a
    filtered slab may keep no record: its count is 0); a ``"multi"``
    partial is a tuple of ``comps``, each merged by this function."""
    from bolt_tpu_torch.gpu.array import _COMBINE
    if terminal == "multi":
        return tuple(_combine(_COMP_MERGE[c], rfunc, x, y)
                     for c, x, y in zip(comps, a, b))
    if terminal in ("sum", "min", "max"):
        # the materialised folds: an unsigned dtype torch leaves out
        # merges in its carrier
        return _COMBINE[terminal](a, b)
    if terminal == "reduce":
        from bolt_tpu_torch.gpu.array import _user_call
        return _user_call(rfunc, (a, b))
    n1, mu1, m21 = a
    n2, mu2, m22 = b
    n = n1 + n2
    safe = torch.where(n > 0, n, torch.ones((), dtype=n.dtype,
                                            device=n.device))
    delta = mu2 - mu1
    mu = mu1 + delta * (n2 / safe)
    m2 = m21 + m22 + delta * delta * (n1 * n2 / safe)
    return n, mu, m2


def _terminal_partial(terminal, flat, mfull, vshape, n, rfunc, dtype):
    """One slab's partial of ``terminal`` over its ``n`` flattened records
    ``flat`` (numpy ``dtype`` after the stages): the materialised
    terminals' own arithmetic for sum/min/max/reduce, the statcounter
    triple ``(n, mu, M2)`` for ``"moments"``.  ``mfull`` is a filter's
    mask broadcast over the values (or ``None``): a dropped record is an
    inert zero of the sum and the moments, as in the materialised masked
    terminals."""
    from bolt_tpu_torch.gpu import dtypes
    from bolt_tpu_torch.gpu.array import _reduce_stat, _reduce_tree
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    if terminal == "sum":
        v = flat if mfull is None else dtypes.where(mfull, flat, zero)
        return _reduce_stat(v, "sum", (0,), False, None, dtype)
    if terminal in ("min", "max"):
        return _reduce_stat(flat, terminal, (0,), False, None, dtype)
    if terminal == "reduce":
        return _reduce_tree(flat, rfunc, n, vshape)
    out_dt = dtypes.stat_dtype("mean", flat.dtype)
    if mfull is None:
        cnt = torch.tensor(n, dtype=out_dt, device=flat.device)
        xf = flat.to(out_dt)
        mu = xf.sum(dim=0) / cnt
        dev = xf - mu
    else:
        cnt = mfull.reshape(n).to(out_dt).sum()
        xf = dtypes.where(mfull, flat, zero).to(out_dt)
        safe = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
        mu = xf.sum(dim=0) / safe
        dev = torch.where(mfull, xf - mu, torch.zeros_like(mu))
    return cnt, mu, (dev * dev).sum(dim=0)


def _finalise(terminal, ddof, moments):
    """The moments triple as the requested statistic (NaN where no
    record was kept)."""
    n, mu, m2 = moments
    nan = torch.full((), float("nan"), dtype=mu.dtype, device=mu.device)
    if terminal == "mean":
        return torch.where(n > 0, mu, nan)
    dd = torch.tensor(0.0 if ddof is None else ddof, dtype=n.dtype,
                      device=n.device)
    var = torch.where(n > 0, m2 / (n - dd), nan)
    return torch.sqrt(var) if terminal == "std" else var


def _finalise_multi(folded, comps, specs):
    """Each member of a multi-stat group from the folded components,
    finalised as its standalone streamed terminal is (``ptp`` is the
    max − min of the shared extrema)."""
    from bolt_tpu_torch.gpu import ufuncs
    by = dict(zip(comps, folded))
    outs = []
    for name, ddof in specs:
        if name in ("sum", "min", "max"):
            outs.append(by[name])
        elif name == "ptp":
            outs.append(ufuncs.binary("subtract", by["max"], by["min"]))
        else:
            outs.append(_finalise(name, ddof, by["moments"]))
    return outs


def _slab_partial(source, st, terminal, rfunc, codec_obj, use_kernel,
                  delta_ok, parts, comps=None, slab=0, pod=False):
    """The program each slab runs: decode (when a codec is armed), the
    stages, the terminal's partial (masked by a trailing filter).
    ``use_kernel`` routes an int8 ``sum`` with no stages through
    ``fused_decode_sum``, whose CUDA kernel launches on a card tensor or
    raises.  ``pod=True`` returns this rank's half of a pod slab instead
    (:func:`_pod_local`), which :func:`_pod_fold` completes across the
    ranks."""
    from bolt_tpu_torch.gpu.array import _pred_mask, torch_dtype
    raw_dtype = torch_dtype(source.dtype)
    if codec_obj is None:
        x = parts[0]
    else:
        wire, side = parts[0], parts[1:]
        dsp = _obs.begin("stream.decode", codec=codec_obj.name, slab=slab)
        try:
            if use_kernel:
                from bolt_tpu_torch.ops.kernels import fused_decode_sum
                out = fused_decode_sum(wire, side[0], side[1])
                if out is not None:
                    return out.to(raw_dtype)
            x = codec_obj.decode(wire, side, raw_dtype, delta_ok)
        finally:
            _obs.end(dsp)
    stages = source.stages[:-1] if st.pred is not None else source.stages
    for stage in stages:
        x = _stage_apply(stage, source.split, x)
    n = prod(tuple(x.shape[:source.split]))
    flat = x.reshape((n,) + st.vshape)
    mfull = None
    if st.pred is not None:
        mfull = _pred_mask(st.pred, flat).reshape(
            (n,) + (1,) * len(st.vshape))
    if pod:
        return _pod_local(terminal, comps, flat, mfull, st.vshape, n,
                          st.dtype)
    if terminal == "multi":
        return tuple(_terminal_partial(c, flat, mfull, st.vshape, n, None,
                                       st.dtype) for c in comps)
    return _terminal_partial(
        terminal if terminal in ("sum", "min", "max", "reduce")
        else "moments", flat, mfull, st.vshape, n, rfunc, st.dtype)


# ---------------------------------------------------------------------
# the pod slab: this rank's rows, folded across the ranks each slab
# ---------------------------------------------------------------------

def _pod_kinds(terminal, comps):
    """The components a pod slab folds (a group's, or the terminal's
    own; mean/var/std fold the moments)."""
    if terminal == "multi":
        return comps
    return (terminal if terminal in ("sum", "min", "max") else "moments",)


def _pod_local(terminal, comps, flat, mfull, vshape, n, dtype):
    """This rank's half of a pod slab over its ``n`` records: per
    component, the part that precedes the exchange — the sum, the
    extremum, or the moments' count and value sums (with the records and
    mask their M2 needs once the slab's mean is known)."""
    from bolt_tpu_torch.gpu import dtypes
    out = []
    for c in _pod_kinds(terminal, comps):
        if c != "moments":
            out.append((c, _terminal_partial(c, flat, mfull, vshape, n,
                                             None, dtype)))
            continue
        out_dt = dtypes.stat_dtype("mean", flat.dtype)
        if mfull is None:
            cnt = torch.tensor(n, dtype=out_dt, device=flat.device)
            xf = flat.to(out_dt)
        else:
            zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
            cnt = mfull.reshape(n).to(out_dt).sum()
            xf = dtypes.where(mfull, flat, zero).to(out_dt)
        out.append((c, cnt, xf.sum(dim=0), xf, mfull))
    return out


def _pod_merge(kind, a, b):
    """One exchanged component of rank ``b`` folded onto the ranks before
    it (``a``): the materialised folds, or the moments' count and sums
    added."""
    from bolt_tpu_torch.gpu.array import _COMBINE
    if kind == "moments":
        return a[0] + b[0], a[1] + b[1]
    return _COMBINE[kind](a, b)


def _pod_fold(local, terminal, group):
    """A pod slab's partial from every rank's half (:func:`_pod_local`),
    the same bits on every rank: ONE exchange of every component's
    pre-fold part over ``group`` (the ranks of the mesh axes the key axes
    shard over, so replicas are not counted twice), folded in rank order;
    then, when moments are folded, the slab's mean from the global count
    and sums, each rank's M2 about it, and a second exchange adding
    those (the reference's ``psum`` of the count and sums, then of M2).
    Runs on the consumer thread, in slab order, once a slab."""
    from bolt_tpu_torch.parallel import multihost
    kinds = [p[0] for p in local]
    pre = tuple((p[1], p[2]) if p[0] == "moments" else p[1]
                for p in local)
    trees = multihost.all_gather(pre, group)
    acc = trees[0]
    for t in trees[1:]:
        acc = tuple(_pod_merge(k, a, b) for k, a, b in zip(kinds, acc, t))
    out = list(acc)
    mom = [i for i, k in enumerate(kinds) if k == "moments"]
    if mom:
        mus, m2s = [], []
        for i in mom:
            cnt, sums = acc[i]
            xf, mfull = local[i][3], local[i][4]
            safe = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
            mu = sums / safe
            dev = xf - mu
            if mfull is not None:
                dev = torch.where(mfull, dev, torch.zeros_like(mu))
            mus.append(mu)
            m2s.append((dev * dev).sum(dim=0))
        trees = multihost.all_gather(tuple(m2s), group)
        m2 = list(trees[0])
        for t in trees[1:]:
            m2 = [a + b for a, b in zip(m2, t)]
        for i, mu, q in zip(mom, mus, m2):
            out[i] = (acc[i][0], mu, q)
    return tuple(out) if terminal == "multi" else out[0]


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

    __slots__ = ("_cond", "_slots", "_next", "_exc", "_total", "_fenced",
                 "_dead_err")

    def __init__(self):
        self._cond = _lockdep.condition("stream.reseq")
        self._slots = {}
        self._next = 0
        self._exc = None
        self._total = None
        self._fenced = 0
        self._dead_err = None

    def put(self, i, item):
        """Insert slab ``i``; False (dropping ``item``) for an index
        already handed to the consumer or already queued — the retry
        fence: a late duplicate of a slab's earlier attempt never folds
        twice."""
        with self._cond:
            if i < self._next or i in self._slots:
                self._fenced += 1
                return False
            self._slots[i] = item
            self._cond.notify_all()
            return True

    @property
    def fenced(self):
        """Duplicate deliveries the fence dropped."""
        with self._cond:
            return self._fenced

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
# the ingest half: the uploader pool, shared by execute and the shuffle
# ---------------------------------------------------------------------

class _Ingest:
    """One pass's ingest: a dispenser and ``nwork`` uploader workers for a
    callback source (its ``jobs``, ``(slab, lo, hi)`` each, in order), or
    one produce+upload thread for an iterator source, delivering
    ``(slab_parts, seconds, slab, lo, hi)`` through the re-sequencer;
    ``slab_parts`` is what :func:`_upload` returns.  At most ``depth +
    nwork`` slabs hold a ring permit; the consumer releases them
    (:meth:`release`).  A failed produce/encode/upload re-runs in place
    under the run's retry budget (:meth:`retry`).  ``skip`` is a resumed
    iterator run's ``(slabs, records)`` watermark: its thread drains that
    prefix first and refuses an iterator whose blocks no longer cut
    there.  ``mspec`` (a pod: ``multihost.LocalSlabSpec``) narrows every
    slab to this rank's rows: a callback source produces only them, an
    iterator's block is sliced to them, and only they are uploaded (and
    counted in ``transfer_bytes``)."""

    def __init__(self, source, codec_obj, delta_ok, depth, nwork, run_sp,
                 jobs=None, prefix="bolt-stream", skip=(0, 0), lease=None,
                 mspec=None):
        self.source = source
        self.mspec = mspec
        # the serving arbiter's lease (None: no serving layer): each slab
        # acquires its wire bytes in slab order before its upload
        self.lease = lease
        self.rec_bytes = 0 if lease is None else prod(source.shape[1:]) * (
            codec_obj.wire_dtype(source.dtype).itemsize
            if codec_obj is not None else source.dtype.itemsize)
        self.device = source.device
        self.codec_obj = codec_obj
        self.delta_ok = delta_ok
        self.depth = depth
        self.nwork = nwork
        self.nretry = retry_limit()     # scopes are per-thread: read here
        self.run_sp = run_sp
        self.jobs = jobs
        self.skip = skip
        self.on_card = self.device.type == "cuda"
        self.ring = _PinnedRing() if self.on_card else None
        self.permits = threading.Semaphore(depth + nwork)
        self.stop = threading.Event()
        self.rsq = _Reseq()
        self.jobq = queue.Queue()
        self._act_lock = _lockdep.lock("stream.uploader_hw")
        self._act = 0
        self.act_hw = 0
        # the pool's threads count under the caller's tenant, and their
        # spans parent under this run's span by explicit handoff
        self.tenant = _engine.current_tenant()
        if source.kind == "callback":
            lead = threading.Thread(target=self._dispenser,
                                    name="%s-prefetch" % prefix,
                                    daemon=True)
            self.pool = [threading.Thread(target=self._worker, args=(w,),
                                          name="%s-upload-%d" % (prefix, w),
                                          daemon=True)
                         for w in range(nwork)]
            self.threads = [lead] + self.pool
        else:
            lead = threading.Thread(target=self._prefetch,
                                    name="%s-prefetch" % prefix,
                                    daemon=True)
            self.pool = [lead]
            self.threads = [lead]

    def _busy(self, delta):
        """Count ``delta`` uploaders in or out of an ingest (the run's
        concurrent-uploader high-water)."""
        with self._act_lock:
            self._act += delta
            self.act_hw = max(self.act_hw, self._act)

    def retry(self, slab, attempt, prev, exc, what="slab"):
        """One failed attempt at ``slab``: burn a retry (counted, chained)
        or raise the run's final error (``utils.chain_retry_step``: the
        ORIGINAL exception at budget 0)."""
        from bolt_tpu_torch.utils import chain_retry_step
        allowed = attempt < self.nretry and not self.stop.is_set()
        if allowed:
            _engine.record_stream_retry()
            _obs.event("stream.retry", slab=slab, attempt=attempt + 1,
                       error=type(exc).__name__)
        return chain_retry_step(exc, prev, attempt, allowed,
                                "%s %d" % (what, slab),
                                "stream.retries / BOLT_STREAM_RETRIES")

    def _ingest(self, block, copy_stream):
        """Encode (with a codec armed) and upload one host block."""
        if self.codec_obj is None:
            parts = (torch.from_numpy(np.ascontiguousarray(block)),)
        else:
            wire, side = _encode_slab(self.codec_obj, block, self.delta_ok)
            parts = (wire,) + tuple(torch.as_tensor(np.asarray(s))
                                    for s in side)
        return _upload(parts, self.device, self.ring, copy_stream)

    def _dispenser(self):
        """Hand ``(j, slab, lo, hi)`` jobs to the pool in order, one ring
        permit each."""
        try:
            for j, (g, lo, hi) in enumerate(self.jobs):
                if not _acquire(self.permits, self.stop):
                    return
                if not self.lease_slab(lo, hi):
                    return
                self.jobq.put((j, g, lo, hi))
            self.rsq.finish(len(self.jobs))
        except BaseException as exc:        # noqa: BLE001 — re-raised in
            self.rsq.fault(exc)             # the consumer thread
        finally:
            for _ in range(self.nwork):
                self.jobq.put(None)         # poison pills: the pool drains

    def local(self, lo, hi):
        """The records of slab ``[lo, hi)`` this rank ingests."""
        return (lo, hi) if self.mspec is None \
            else self.mspec.local_range(lo, hi)

    def slab_bytes(self, lo, hi):
        """The arbiter bytes of this rank's part of the slab of records
        ``[lo, hi)``: its wire bytes (a codec's sidecar excluded)."""
        llo, lhi = self.local(lo, hi)
        return (lhi - llo) * self.rec_bytes

    def lease_slab(self, lo, hi):
        """Acquire a slab's bytes from the serving lease (True at once
        without one); False when the run stopped while waiting."""
        return self.lease is None or self.lease.acquire(
            self.slab_bytes(lo, hi), stop=self.stop)

    def _worker(self, wid):
        try:
            with _engine.tenant(self.tenant):
                copy_stream = torch.cuda.Stream(self.device) \
                    if self.on_card else None
                while True:
                    job = self.jobq.get()
                    if job is None or self.stop.is_set():
                        return
                    j, g, lo, hi = job
                    attempt, prev = 0, None
                    t0 = _clock()
                    while True:
                        self._busy(1)
                        sp = _obs.begin("stream.ingest", parent=self.run_sp,
                                        slab=g, worker=wid, attempt=attempt)
                        try:
                            slab = self._ingest(
                                self.source.produce_slab(*self.local(lo,
                                                                     hi)),
                                copy_stream)
                        except Exception as exc:
                            _obs.end(sp, error=type(exc).__name__)
                            self._busy(-1)
                            # retried in place: the job keeps its permit,
                            # and the re-sequencer fences a duplicate
                            prev = self.retry(g, attempt, prev, exc)
                            attempt += 1
                            continue
                        _obs.end(sp)
                        self._busy(-1)
                        break
                    self.rsq.put(j, (slab, _clock() - t0, g, lo, hi))
                    del slab            # the consumer owns it now
        except BaseException as exc:        # noqa: BLE001
            self.rsq.fault(exc)

    def _drain_prefix(self, it):
        """A resumed iterator run: skip the retired slabs, checking that
        the blocks still cut at the checkpointed record (a drifted
        iterator would fold wrong records, so it is refused)."""
        slabs, records = self.skip
        hi = 0
        for k in range(slabs):
            try:
                _, hi, block = next(it)
            except StopIteration:
                raise RuntimeError(
                    "resume checkpoint covers %d slabs but this iterator "
                    "ended after %d; the source is not the one the "
                    "checkpoint was cut from" % (slabs, k)) from None
            del block
        if hi != records:
            raise RuntimeError(
                "resume checkpoint was cut at record %d but this "
                "iterator's first %d slab(s) cover %d records — the block "
                "layout drifted; delete the checkpoint or restore the "
                "original source" % (records, slabs, hi))

    def _prefetch(self):
        """Iterator sources: one produce+upload thread (the iterable is
        sequential); the block is in hand, so a retry re-runs its encode
        and upload."""
        try:
            with _engine.tenant(self.tenant):
                copy_stream = torch.cuda.Stream(self.device) \
                    if self.on_card else None
                it = self.source.slabs()
                if self.skip[0]:
                    self._drain_prefix(it)
                i = 0
                while True:
                    if not _acquire(self.permits, self.stop):
                        return
                    self._busy(1)
                    g = self.skip[0] + i
                    sp = _obs.begin("stream.ingest", parent=self.run_sp,
                                    slab=g, worker=0)
                    t0 = _clock()
                    try:
                        try:
                            lo, hi, block = next(it)
                        except StopIteration:
                            self.permits.release()
                            _obs.cancel(sp)     # the probe saw the end
                            sp = None
                            break
                        if not self.lease_slab(lo, hi):
                            return
                        if self.mspec is not None:
                            llo, lhi = self.local(lo, hi)
                            block = block[llo - lo:lhi - lo]
                        attempt, prev = 0, None
                        while True:
                            try:
                                slab = self._ingest(block, copy_stream)
                                break
                            except Exception as exc:
                                prev = self.retry(g, attempt, prev, exc)
                                attempt += 1
                        del block
                    finally:
                        self._busy(-1)
                        _obs.end(sp)
                    self.rsq.put(i, (slab, _clock() - t0, g, lo, hi))
                    del slab
                    i += 1
                self.rsq.finish(i)
        except BaseException as exc:        # noqa: BLE001
            self.rsq.fault(exc)

    def start(self):
        global _LAST_POOL
        _LAST_POOL = tuple(self.threads)
        for th in self.threads:
            th.start()

    def next(self, idle=None):
        """The next delivered slab in order, or ``None`` at the end."""
        return self.rsq.next(self.threads, workers=self.pool, idle=idle)

    def release(self, k=1):
        self.permits.release(k)

    def close(self):
        """Stop the pass: every thread joined, queued slabs released."""
        self.stop.set()
        # the consumer's own poison pills, in case the dispenser died
        # before its finally could enqueue them
        for _ in range(len(self.threads)):
            self.jobq.put(None)
        for th in self.threads:
            th.join()
        self.rsq.drain()


def _retried(ing, slab, what, fn):
    """``fn()`` on the consumer, re-run in place under ``ing``'s retry
    budget."""
    attempt, prev = 0, None
    while True:
        try:
            return fn()
        except Exception as exc:
            prev = ing.retry(slab, attempt, prev, exc, what)
            attempt += 1


def _wait_slab(ing, slab_parts, compute_stream):
    """The compute stream waits for a delivered slab's copy; the slab's
    memory is recorded on it, so the allocator cannot reuse it while a
    kernel still reads it."""
    parts, ev, buf = slab_parts
    if ing.on_card:
        compute_stream.wait_event(ev)
        buf.record_stream(compute_stream)
    return parts


# ---------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------

def execute(arr, terminal, ddof=None, rfunc=None, specs=None, source=None):
    """Run the streamed reduction ``terminal`` over ``arr``'s source (or
    ``source``) through the pipeline of the module docstring; a
    value-shaped ``BoltArrayGPU`` (``split=0``).  ``terminal="multi"``
    streams a multi-stat group: ``specs`` is its ordered ``(name, ddof)``
    member list, each slab is read once for every member, and the result
    is a list of tensors, one per member, each finalised as its
    standalone streamed terminal is."""
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    if source is None:
        source = arr._stream
    if arr is not None:
        # a pending stat's group passes no array: its terminal was gated
        # at the call and its resolution is gated in multistat
        _engine.strict_guard(arr, "stream.%s()" % terminal)
    if has_swap(source):
        raise RuntimeError(
            "internal: execute() received a source with an unresolved "
            "swap stage — the terminal doors resolve swaps first "
            "(stream.resolve_swaps)")
    comps = _multi_comps(specs) if terminal == "multi" else None
    device = source.device
    st = result_state(source)
    depth = prefetch_depth()
    nwork = pool_size(source)
    codec_obj = resolve_codec(source)
    if codec_obj is not None and not codec_obj.lossless and (
            terminal in ("min", "max") or terminal == "multi"
            and any(c in ("min", "max") for c in comps)):
        names = [n for n, _ in specs] if specs else [terminal]
        raise ValueError(
            "lossy codec %r refused for the order-statistic "
            "terminal(s) %s: min/max/ptp are exact by contract and "
            "a quantised extremum is never the answer the caller "
            "meant.  Use the lossless 'delta-f32' codec, or stream "
            "this terminal uncompressed" % (codec_obj.name, names))
    mspec = _pod_plan(source, terminal, codec_obj)
    delta_ok = source.split < len(source.shape)
    # the reference's conditions for the decode-and-reduce kernel, read
    # once per run: no stage, no filter, not a pod
    use_kernel = (codec_obj is not None and codec_obj.name == "int8"
                  and terminal == "sum" and not source.stages
                  and source.split == 1 and mspec is None
                  and _codec_registry().kernel_enabled())
    ck = _Resume.open(source, terminal, ddof, rfunc, specs, codec_obj,
                      use_kernel)
    run_sp = _obs.begin("stream.run", terminal=terminal, depth=depth,
                        uploaders=nwork, kind=source.kind,
                        **({"codec": codec_obj.name}
                           if codec_obj is not None else {}))
    try:
        # under a serving layer the run's slabs draw on the process-wide
        # device-memory budget (the tenant tag rides into the pool threads)
        ing = _Ingest(source, codec_obj, delta_ok, depth, nwork, run_sp,
                      jobs=[(g, lo, hi) for g, (lo, hi)
                            in enumerate(source.slab_ranges())
                            if g >= ck.start]
                      if source.kind == "callback" else None,
                      skip=(ck.start, ck.records), lease=_tenant_lease(),
                      mspec=mspec)
        out, nslabs, ingest, compute, overlap, inflight_hw = _consume(
            ing, source, st, terminal, ddof, rfunc, comps, specs,
            codec_obj, use_kernel, delta_ok, ck)
        if run_sp is not None:
            run_sp.set(slabs=nslabs, ingest_s=round(ingest, 6),
                       compute_s=round(compute, 6), overlap_s=round(overlap, 6),
                       concurrent_uploaders=max(ing.act_hw, 1),
                       inflight_high_water=max(inflight_hw, 1))
        if terminal == "multi":
            return out
        return BoltArrayGPU(out, 0, device)
    finally:
        _obs.end(run_sp)


def _pod_plan(source, terminal, codec_obj):
    """A pod run's ingest contract (``multihost.LocalSlabSpec``), or
    ``None`` off a pod.  Every refusal of a pod run is decided here from
    the shape, the terminal, the codec and the mesh alone, before any
    thread starts, so every rank raises it alike and none is left
    waiting in an exchange: a user ``reduce``, a slab the key-axis
    assignment does not divide (BLT012) and a sidecar codec."""
    from bolt_tpu_torch.parallel import multihost
    mesh = source.mesh
    if mesh is None:
        return None
    if terminal == "reduce":
        raise ValueError(
            "streamed reduce(func) cannot run on a multi-process mesh: a "
            "user combine function has no mesh collective")
    err = multihost.slab_divisibility_error(
        mesh, source.shape, source.split,
        source.slab_ranges() if source.kind == "callback" else [])
    if err is not None:
        raise ValueError(err)           # BLT012: check() forecasts it
    err = multihost.sidecar_codec_error(codec_obj, mesh)
    if err is not None:
        raise ValueError(err)
    return multihost.local_slab_spec(source)


class _Resume:
    """One run's checkpoint plan (:func:`resumable`, or the source's own
    ``checkpoint=``): the directory and cadence, the run's fingerprint,
    and what a matching checkpoint restores: ``start`` retired slabs
    covering ``records`` records and the fold ``state`` (``(levels,
    pend)``, CPU tensors).  ``dir`` is ``None`` when the run is not
    resumable."""

    __slots__ = ("dir", "every", "fp", "codec", "start", "records",
                 "state", "pod", "box", "remap")

    def __init__(self, dir=None, every=None, fp=None, codec=None):
        self.dir, self.every, self.fp, self.codec = dir, every, fp, codec
        self.start = self.records = 0
        self.state = None
        # a pod run: per-rank shard files (and this rank's key box)
        self.pod = False
        self.box = None
        # the width that cut a checkpoint adopted through the topology
        # remap (recorded in every checkpoint this run writes)
        self.remap = None

    @classmethod
    def open(cls, source, terminal, ddof, rfunc, specs, codec_obj,
             use_kernel=False):
        """The plan of a run over ``source``, with the checkpoint a killed
        run of the same pipeline left loaded (and counted as a resume)."""
        scope = checkpoint_scope()
        if source.ckpt is not None:
            ck = cls(source.ckpt, scope[1] if scope else _CKPT_EVERY)
        elif scope is not None:
            ck = cls(*scope)
        else:
            return cls()
        from bolt_tpu_torch import checkpoint as _ckptlib
        mesh = source.mesh
        if mesh is not None:
            from bolt_tpu_torch.parallel import multihost, sharding
            if multihost.mesh_process_count(mesh) \
                    != multihost.process_count():
                # the checkpoint's barriers cover the whole pod: ranks
                # outside the mesh would never arrive
                raise ValueError(
                    "resumable checkpointing on a SUB-POD mesh is not "
                    "supported: this mesh spans %d of the runtime's %d "
                    "processes, and the checkpoint rendezvous barrier "
                    "covers the whole runtime.  Stream the checkpointed "
                    "run on a mesh covering every process (or drop "
                    "checkpoint=/resumable() for this sub-mesh run)"
                    % (multihost.mesh_process_count(mesh),
                       multihost.process_count()))
            ck.pod = True
            ck.box = sharding.box(mesh, sharding.key_spec(
                mesh, source.shape, source.split), source.shape)
        ck.codec = codec_obj.name if codec_obj is not None else None
        ck.fp = _run_fingerprint(source, terminal, ddof, rfunc, specs,
                                 ck.codec, use_kernel)
        info = {}
        got = _ckptlib.stream_load(ck.dir, ck.fp, multiprocess=ck.pod,
                                   box=ck.box, info=info)
        if got is not None:
            # a checkpoint cut at another width (a shrink or a growth)
            # resumes at its watermark with THIS run's per-rank rows
            ck.start, ck.records, ck.state = got
            ck.remap = info.get("remapped_from")
            _engine.record_stream_resume()
            _obs.event("stream.resume", slabs=ck.start, records=ck.records,
                       **({"remapped_from": ck.remap}
                          if ck.remap is not None else {}))
        return ck

    def write(self, slabs, records, levels, pend, abort=False):
        """Write the fold state of ``slabs`` retired slabs (the caller has
        drained the in-flight window).  On a pod every rank writes its
        shard at the same watermark; ``abort`` (a failing run's write)
        takes no barrier, since a peer may be gone: the fold state is the
        same on every rank, so one rank's shard is a whole resume
        point."""
        from bolt_tpu_torch import checkpoint as _ckptlib
        csp = _obs.begin("stream.checkpoint", slabs=slabs)
        t0 = _clock()
        try:
            nb = _ckptlib.stream_save(self.dir, self.fp, slabs, records,
                                      (list(levels), pend),
                                      multiprocess=self.pod,
                                      rendezvous=not abort,
                                      codec=self.codec, box=self.box,
                                      remap_from=self.remap)
            _engine.record_checkpoint(nb, _clock() - t0)
            if csp is not None:
                csp.set(bytes=nb)
        finally:
            _obs.end(csp)

    def clear(self):
        from bolt_tpu_torch import checkpoint as _ckptlib
        _ckptlib.stream_clear(self.dir, multiprocess=self.pod)


def _on_device(tree, device):
    """A restored fold state's tensors on the run's device."""
    if tree is None:
        return None
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_device(x, device) for x in tree)
    return tree.to(device)


def _consume(ing, source, st, terminal, ddof, rfunc, comps, specs,
             codec_obj, use_kernel, delta_ok, ck):
    """The consumer half of :func:`execute`: dispatch each delivered slab
    in order into the bounded in-flight window, fold, finalise; under a
    checkpoint plan ``ck``, restore the fold a resumed run left, write it
    every ``ck.every`` retired slabs and on failure, and clear it on
    success.  On a pod each slab's program runs on this rank's rows and
    its partial is folded across the ranks (:func:`_pod_fold`) before it
    joins the fold, so every rank's fold holds the same bits; a retried
    dispatch reruns only the rank's own program, before the exchange, so
    every rank issues the same exchanges in the same order."""
    from bolt_tpu_torch.parallel import multihost
    pod = ing.mspec is not None
    # a pod run, or any run of a one-rank pod whose supervisor keeps a
    # rejoin door open: busy for the supervisor, and stopped by its
    # quiesce at a checkpoint (a growth must not reform under it)
    watched = pod or (_podwatch.active()
                      and multihost.process_count() == 1)
    group = None
    if pod:
        group = source.mesh.group(multihost.key_collective_axes(
            source.mesh, source.shape, source.split))
    on_card = ing.on_card
    compute_stream = torch.cuda.current_stream(ing.device) \
        if on_card else None
    # one permit is always left for the dispenser, so the in-flight window
    # is one less than the ring
    window = ing.depth + ing.nwork - 1

    t_start = _clock()
    ingest = compute = 0.0
    nslabs = dispatched = confirmed = inflight_hw = 0
    fold = _PairFold(lambda a, b: _combine(terminal, rfunc, a, b, comps))
    pend = None                 # the even slab's partial awaiting its pair
    pend_bytes = 0              # that slab's leased bytes, still held
    pending_sync = deque()      # (slabs covered, event, leased bytes) not
    #                             yet confirmed
    lease = ing.lease
    done_records = ck.records   # records the folded slabs cover
    if ck.state is not None:
        # the fold exactly where the killed run left it: the tree's levels
        # and the unpaired partial, so the pairing and the tree order of
        # the slabs to come are the uninterrupted run's
        levels, pend = _on_device(ck.state, ing.device)
        fold.levels = list(levels)
        ck.state = None
    total = len(ing.jobs) if ing.jobs is not None else None

    def _confirm_oldest():
        """Wait for the OLDEST unconfirmed pair partial (normally long
        retired) and release its ring permits."""
        nonlocal compute, confirmed
        cov, ev, nb = pending_sync.popleft()
        ssp = _obs.begin("stream.sync", slabs=cov)
        t0 = _clock()
        try:
            if ev is not None:
                ev.synchronize()
        finally:
            _obs.end(ssp)
        compute += _clock() - t0
        confirmed += cov
        ing.release(cov)
        if lease is not None:
            lease.release(nb)

    def _retire():
        """Release the permits of every pair partial the device has
        already retired, without waiting: a window full of retired slabs
        would otherwise hold the ring's permits and starve the pool."""
        while pending_sync and (pending_sync[0][1] is None
                                or pending_sync[0][1].query()):
            _confirm_oldest()

    def _starved():
        """The serving arbiter's starvation valve (with :func:`_retire`,
        the re-sequencer's ``idle``): while some acquire is queued on the
        arbiter (this run's blocked feeder is one), confirm the oldest
        window entry, or sync the lone unpaired partial, so their slab
        bytes return and a budget smaller than the ring runs a shallower
        pipeline instead of deadlocking.  A feeder merely slow on its
        source leaves the window as it is."""
        nonlocal pend_bytes
        _retire()
        if lease.arbiter.waiting() == 0:
            return
        if pending_sync:
            _confirm_oldest()
        elif pend is not None and pend_bytes:
            # its slab program's input is released once the program ran:
            # only the value-shaped partial lives
            if on_card:
                compute_stream.synchronize()
            lease.release(pend_bytes)
            pend_bytes = 0

    def _dispatch(parts):
        _chaos.hit("stream.dispatch")
        return _slab_partial(source, st, terminal, rfunc, codec_obj,
                             use_kernel, delta_ok, parts, comps,
                             ck.start + nslabs, pod)

    def _checkpoint(abort=False):
        """Write the watermark and fold state: every slab counted in
        ``nslabs`` has its partial in the fold, and the in-flight window
        is drained first, so the state holds exactly those slabs."""
        while pending_sync:
            _confirm_oldest()
        ck.write(ck.start + nslabs, done_records, fold.levels, pend,
                 abort=abort)

    ing.start()
    if watched:
        # the supervisor's quiesce drain waits for this count to fall
        # before it reforms the pod up
        _podwatch.pod_enter()
    ready_done = False
    try:
        while True:
            got = ing.next(idle=_retire if lease is None else _starved)
            if got is None:
                break
            if pod and not ready_done:
                # every rank confirms its peers alive right before the
                # first exchange: a peer dead before dispatching raises
                # PeerLostError within ~2x BOLT_POD_TIMEOUT
                _podwatch.ready_rendezvous()
                ready_done = True
            _, (slab_parts, tsec, g, lo, hi) = got
            del got
            ingest += tsec
            t0 = _clock()
            parts = _wait_slab(ing, slab_parts, compute_stream)
            del slab_parts
            csp = _obs.begin("stream.compute", slab=nslabs,
                             **({"codec": codec_obj.name}
                                if codec_obj is not None else {}))
            try:
                part = _retried(ing, g, "slab dispatch",
                                lambda: _dispatch(parts))
                del parts
                if pod:
                    # a dead peer raises PeerLostError naming it and
                    # this slab, never a hang in the exchange
                    with _podwatch.guard("slab program", slab=g):
                        part = _pod_fold(part, terminal, group)
                nb = ing.slab_bytes(lo, hi)
                if pend is None:
                    pend = part
                    pend_bytes = nb
                else:
                    # the level-0 merge: the even slab's partial, then
                    # this one
                    fold.push(_combine(terminal, rfunc, pend, part, comps))
                    pend = None
                    done = None
                    if on_card:
                        done = torch.cuda.Event()
                        done.record(compute_stream)
                    pending_sync.append((2, done, nb + pend_bytes))
                    pend_bytes = 0
            finally:
                _obs.end(csp)
            # counted only once the slab's partial is in the fold: the
            # watermark of a checkpoint never runs ahead of its state
            nslabs += 1
            done_records = hi
            compute += _clock() - t0
            dispatched += 1
            inflight_hw = max(inflight_hw, dispatched - confirmed)
            # the bounded in-flight window: release what has retired, and
            # wait only on overflow
            _retire()
            while dispatched - confirmed > window and pending_sync:
                _confirm_oldest()
            # resumable: every ck.every retired slabs, but not after the
            # last slab of a known-size stream (the run clears it next)
            if ck.dir is not None and nslabs % ck.every == 0 \
                    and not (total is not None and nslabs >= total):
                # a pod's quiesce (a rejoined rank waits to be folded
                # in) stops here: rank 0 publishes its decision before
                # the checkpoint, whose barriers fence it, so every rank
                # raises the same PodQuiesceError at this watermark
                if watched:
                    _podwatch.quiesce_pre(ck.start + nslabs)
                _checkpoint()
                if watched:
                    _podwatch.quiesce_gate(ck.start + nslabs, fenced=True)
        if pend is not None:
            fold.push(pend)     # an odd slab count's tail joins as a leaf
            pend = None
        if ck.start + nslabs == 0:
            raise RuntimeError(
                "stream produced no slabs (empty source?) — nothing to "
                "reduce; the materialised path owns empty-input rules")
        _chaos.hit("stream.fold")
        fsp = _obs.begin("stream.fold", final=True)
        t0 = _clock()
        try:
            out = fold.result()
            if terminal == "multi":
                out = _finalise_multi(out, comps, specs)
            elif terminal in ("mean", "var", "std"):
                out = _finalise(terminal, ddof, out)
            if on_card:
                compute_stream.synchronize()    # the run's one final sync
        finally:
            _obs.end(fsp)
    except BaseException:
        # the run is failing: write the retired-slab watermark first, so
        # the next run resumes from here and not from the last periodic
        # checkpoint — best effort, never masking the original error
        if ck.dir is not None and nslabs:
            try:
                _checkpoint(abort=True)
            except Exception:       # noqa: BLE001 — the original failure
                pass                # is the story
        raise
    finally:
        if watched:
            _podwatch.pod_exit()
        ing.close()
        pending_sync.clear()
        if lease is not None:
            lease.close()       # every outstanding budget byte returns
    if ck.dir is not None:
        ck.clear()                  # success leaves no checkpoint behind
    compute += _clock() - t0
    wall = _clock() - t_start
    overlap = max(0.0, ingest + compute - wall)
    _engine.record_stream(nslabs, ingest, compute, wall, overlap,
                          ing.depth, uploaders=max(ing.act_hw, 1),
                          inflight=max(inflight_hw, 1))
    return out, nslabs, ingest, compute, overlap, inflight_hw


# ---------------------------------------------------------------------
# materialisation (consumers that are not streamed)
# ---------------------------------------------------------------------

def materialize(source):
    """The CONCRETE array ``source`` describes: a pending swap resolved
    by the shuffle, the base uploaded whole, then every recorded stage
    replayed through the materialised paths, so a materialised stream
    equals never having streamed.  Needs the whole array to fit on the
    device."""
    with _obs.span("stream.materialize", kind=source.kind,
                   stages=len(source.stages)):
        if has_swap(source):
            b = resolve_swaps(source)
            if b._stream is None:
                return b
            source = b._stream
        return _replay_stages(_materialize_base(source), source.stages)


def _replay_stages(b, stages):
    """Replay recorded stages on a concrete array through the materialised
    paths: the one replay of materialisation and of a resident shuffle's
    stages after its swap."""
    for stage in stages:
        kind = stage[0]
        if kind == "map":
            b = b.map(stage[1], axis=tuple(range(b.split)))
        elif kind == "chunk":
            from bolt_tpu_torch.gpu.chunk import ChunkedArray
            _, func, plan, pad, dtype = stage
            b = ChunkedArray(b, plan, pad).map(func, dtype=dtype).unchunk()
        elif kind == "stack":
            from bolt_tpu_torch.gpu.stack import StackedArray
            _, func, size, dtype = stage
            b = StackedArray(b, size).map(func, dtype=dtype).unstack()
        elif kind == "filter":
            b = b.filter(stage[1], axis=tuple(range(b.split)))
        elif kind == "swap":
            # the (kaxes, vaxes) the permutation was built from
            # (gpu/array.py :: _do_swap, inverted)
            _, perm, new_split = stage
            split = b.split
            kaxes = [p for p in perm[new_split:] if p < split]
            vaxes = [p - split for p in perm[:new_split] if p >= split]
            b = b._do_swap(kaxes, vaxes)
        else:
            raise ValueError("unknown stream stage %r" % (kind,))
    return b


def _materialize_base(source):
    """Upload the raw source: a callback source slab by slab into one
    device tensor (the pool produces the slabs concurrently, so no whole
    host copy exists), an iterator source assembled on the host first.
    On a pod each rank builds only its own box (:func:`_materialize_box`)."""
    from bolt_tpu_torch.gpu.array import BoltArrayGPU, torch_dtype
    if source.mesh is not None:
        return _materialize_box(source)
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


def _materialize_box(source):
    """The raw pod source as a mesh array, each rank building its own box
    of the key layout: a callback source produces the box's records
    slab by slab (the pool calls ``fn`` with the box's slices), an
    iterator source (re-iterable on a pod) is walked whole by every rank
    and sliced.  Counted at the box's bytes."""
    from bolt_tpu_torch.gpu.array import torch_dtype
    from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
    from bolt_tpu_torch.parallel import sharding
    mesh, shape, split = source.mesh, source.shape, source.split
    spec = sharding.key_spec(mesh, shape, split)
    bx = sharding.box(mesh, spec, shape)
    index = sharding.box_slices(bx)
    if source.kind != "callback":
        host = np.empty(shape, source.dtype)
        for lo, hi, block in source.slabs():
            host[lo:hi] = block
        data = transfer(np.ascontiguousarray(host[index]), source.device)
        return BoltArrayMesh.wrap(data, mesh, shape, split, spec)
    t0 = _clock()
    bshape = sharding.box_shape(bx)
    data = torch.empty(bshape, dtype=torch_dtype(source.dtype),
                       device=source.device)
    r0, r1 = bx[0]

    def fill(rng):
        lo, hi = rng
        idx = (slice(lo, hi),) + index[1:]
        block = np.asarray(source.produce(idx), dtype=source.dtype)
        if block.shape != (hi - lo,) + bshape[1:]:
            raise ValueError(
                "fromcallback callback returned shape %s for index %s "
                "(expected %s)" % (block.shape, idx,
                                   (hi - lo,) + bshape[1:]))
        data[lo - r0:hi - r0].copy_(torch.from_numpy(
            np.ascontiguousarray(block)))

    ranges = [(max(lo, r0), min(hi, r1)) for lo, hi in source.slab_ranges()
              if min(hi, r1) > max(lo, r0)]
    with ThreadPoolExecutor(max_workers=pool_size(source),
                            thread_name_prefix="bolt-stream-upload") as ex:
        list(ex.map(fill, ranges))
    if data.device.type == "cuda":
        torch.cuda.current_stream(data.device).synchronize()
    _engine.record_transfer(data.numel() * data.element_size(),
                            _clock() - t0)
    return BoltArrayMesh.wrap(data, mesh, shape, split, spec)


# ---------------------------------------------------------------------
# the two-phase shuffle: streamed swap resolution
# ---------------------------------------------------------------------

def _stage_token(stage):
    """One stage's fingerprint element: the kind, every callable by its
    bytecode token (``utils.code_token``), every plain value by repr."""
    from bolt_tpu_torch.utils import code_token
    return "/".join(code_token(x) if callable(x) else repr(x)
                    for x in stage)


def _run_fingerprint(source, terminal, ddof, rfunc, specs, codec=None,
                     use_kernel=False):
    """Identity of one logical streamed run for checkpoint matching: the
    source's geometry and slab plan, the stage chain, the terminal (with
    ``ddof``, ``rfunc`` and a group's members), the ingest codec, whether
    ``fused_decode_sum`` decodes it and the device type (the routes'
    partials differ in their last bits), every user callable (stages,
    the filter predicate, ``rfunc``, a callback source's ``produce``) by
    its bytecode token (``utils.code_token``).  An edited pipeline,
    another codec or another route is another run, whose checkpoint is
    ignored, and the port's own version tag keeps a reference
    checkpoint in the same directory from being adopted.  The last
    element is the run's topology: the pod's mesh geometry (so its width)
    on a pod, empty otherwise; a checkpoint of the same run cut at
    another topology is refused (``checkpoint.stream_load``), and each
    rank's shard also records the rank's key box.  Data captured in a
    closure is not part of it: pointing an identical loader at other
    bytes of the same geometry is the caller's contract."""
    from bolt_tpu_torch.utils import code_token
    stages = "|".join(_stage_token(s) for s in source.stages)
    members = "|".join("%s:%s" % (n, d) for n, d in specs) if specs else ""
    return ("bolt-torch-stream-ckpt-v1", str(terminal), str(ddof),
            code_token(rfunc) if rfunc is not None else "",
            "x".join(str(s) for s in source.shape),
            int(source.split), str(source.dtype), int(source.slab),
            str(source.kind),
            code_token(source.produce) if source.produce is not None
            else "", stages, members, str(codec or ""),
            "kernel" if use_kernel else "", source.device.type,
            "pod%r" % (source.mesh.geometry,) if source.mesh is not None
            else "")


def _shuffle_fingerprint(source, pre_stages, perm, new_split, out_block):
    """Identity of one streamed-swap resolution for spill-manifest
    matching: geometry, slab plan, the pre-swap stages (callables by
    bytecode) and the permutation, so a run never adopts buckets cut by
    another pipeline.  Data captured in a closure is not part of it:
    pointing an identical loader at other bytes of the same geometry is
    the caller's contract, as with any resume format."""
    from bolt_tpu_torch.utils import code_token
    stages = "|".join(_stage_token(s) for s in pre_stages)
    return ("bolt-stream-spill-v1",
            "x".join(str(s) for s in source.shape), int(source.split),
            str(source.dtype), int(source.slab), str(source.kind),
            code_token(source.produce) if source.produce is not None
            else "", stages, repr(tuple(perm)), int(new_split),
            int(out_block))


def _resolve_one_swap(source):
    """Resolve the FIRST recorded swap of ``source`` by the two-phase
    shuffle (:mod:`bolt_tpu_torch.parallel.shuffle`): phase 1 streams the
    input slabs through the uploader pool and one re-bucket program each;
    phase 2 copies the permuted slabs into the swapped array (RESIDENT:
    the stages after the swap replayed concretely) or spills buckets of
    them to files and returns a fresh stream over the files carrying the
    stages after the swap (SPILLED).  Bit-identical to the materialised
    swap either way."""
    from bolt_tpu_torch import checkpoint as _ckptlib
    from bolt_tpu_torch.gpu.array import BoltArrayGPU, torch_dtype
    from bolt_tpu_torch.parallel import shuffle as _shuffle

    cut = next(k for k, s in enumerate(source.stages) if s[0] == "swap")
    pre = source.stages[:cut]
    _, perm, new_split = source.stages[cut]
    post = source.stages[cut + 1:]
    base = StreamSource(source.kind, source.produce, source.blocks,
                        source.shape, source.split, source.dtype,
                        source.device, source.slab, pre, ckpt=source.ckpt,
                        codec=source.codec, mesh=source.mesh)
    base._consumed = source._consumed
    st = result_state(base)
    device = source.device
    spill_dir = spill_scope()[0]
    plan = _shuffle.plan_shuffle(st.shape, st.dtype, st.split, perm,
                                 new_split, base.slab, swap_budget(),
                                 spill_dir, source.mesh)
    if not plan.resident and spill_dir is None:
        raise RuntimeError(
            "streamed swap: the re-keyed working set (%.1f MiB) exceeds "
            "the resident budget (%.1f MiB) and no spill directory is "
            "configured — wrap the run in bolt_tpu_torch.stream.spill(dir)"
            " (or raise the budget)"
            % (plan.total_bytes / 2**20, (plan.budget or 0) / 2**20))
    codec_obj = resolve_codec(base)     # lossless or None (swap_stage)
    delta_ok = source.split < len(source.shape)
    mspec = pod = None
    if source.mesh is not None:
        mspec = _pod_plan(base, "swap", codec_obj)
        if not plan.resident:
            # a spilled bucket is one rank's rows, while re-streaming it
            # as a pod slab would split it across the ranks (BLT012)
            raise RuntimeError(
                "streamed swap: the re-keyed working set (%.1f MiB) "
                "exceeds the resident budget (%.1f MiB) and disk "
                "spill is single-process only — on a multi-process "
                "mesh raise the arbiter budget so the buckets stay "
                "resident, or materialise first (toarray) and swap "
                "in memory; analysis.check forecasts this as BLT017"
                % (plan.total_bytes / 2**20, (plan.budget or 0) / 2**20))
        pod = _shuffle.PodShuffle(source.mesh, plan, min(base.slab,
                                                         st.shape[0]))
    fp = _shuffle_fingerprint(base, pre, perm, new_split, plan.out_block)
    # spill resume: slabs whose every bucket landed are skipped (their
    # files are complete: atomic renames, the slab marked after them)
    done = set()
    if not plan.resident and base.kind == "callback":
        done = _ckptlib.spill_manifest(spill_dir, fp)
        if done:
            _engine.record_stream_resume()
            _obs.event("stream.spill_resume", slabs=len(done))
    jobs = None
    if base.kind == "callback":
        jobs = [(g, lo, hi) for g, (lo, hi)
                in enumerate(base.slab_ranges()) if g not in done]
    run_sp = _obs.begin("stream.shuffle", resident=plan.resident,
                        slabs=plan.nslabs, buckets=plan.nbuckets,
                        out_block=plan.out_block)
    t_start = _clock()
    moved = 0
    nslabs = len(done)
    out = None
    try:
        if plan.resident:
            out = torch.empty(plan.out_shape if pod is None else
                              tuple(e - b for b, e in pod.out_box),
                              dtype=torch_dtype(plan.dtype), device=device)
        ing = _Ingest(base, codec_obj, delta_ok, prefetch_depth(),
                      pool_size(base), run_sp, jobs=jobs,
                      prefix="bolt-shuffle", mspec=mspec)
        on_card = ing.on_card
        compute_stream = torch.cuda.current_stream(device) \
            if on_card else None
        window = ing.depth + ing.nwork - 1
        pending = deque()       # events of resident copies in flight

        def _retire():
            while pending and pending[0].query():
                pending.popleft()
                ing.release()

        def _rebucket(parts):
            _chaos.hit("stream.shuffle")
            prog = _shuffle.rebucket_program(plan, pre, codec_obj,
                                             source.dtype,
                                             tuple(parts[0].shape),
                                             delta_ok, device)
            return prog(parts)

        def _spill_bucket(g, bkt, block, row0):
            _chaos.hit("stream.spill")
            ssp = _obs.begin("stream.spill", slab=g, bucket=bkt)
            try:
                nb = _ckptlib.spill_save(spill_dir, fp, g, bkt, block, row0)
            finally:
                _obs.end(ssp)
            _engine.record_spill(nb)

        ing.start()
        if pod is not None:
            _podwatch.pod_enter()
        ready_done = False
        try:
            while True:
                got = ing.next(idle=_retire)
                if got is None:
                    break
                if pod is not None and not ready_done:
                    # every rank confirms its peers alive right before
                    # the first exchange (podwatch.ready_rendezvous)
                    _podwatch.ready_rendezvous()
                    ready_done = True
                _, (slab_parts, _, g, lo, hi) = got
                del got
                parts = _wait_slab(ing, slab_parts, compute_stream)
                del slab_parts
                csp = _obs.begin("stream.compute", slab=g, shuffle=True)
                try:
                    part = _retried(ing, g, "shuffle dispatch",
                                    lambda: _rebucket(parts))
                    if pod is not None:
                        # after the retried local program: every rank
                        # issues the same exchange, slab by slab
                        with _podwatch.guard("shuffle re-bucket",
                                             slab=g):
                            part = pod.exchange(part)
                finally:
                    _obs.end(csp)
                del parts
                moved += part.numel() * part.element_size()
                nslabs += 1
                if plan.resident:
                    _shuffle.concat_program(plan, tuple(part.shape),
                                            device)(out, part, lo)
                    del part
                    if on_card:
                        ev = torch.cuda.Event()
                        ev.record(compute_stream)
                        pending.append(ev)
                        _retire()
                        while len(pending) > window:
                            pending.popleft().synchronize()
                            ing.release()
                    else:
                        ing.release()
                    continue
                for bkt in range(plan.nbuckets):
                    b0 = bkt * plan.out_block
                    block = part[b0:b0 + plan.out_block].cpu().numpy()
                    _retried(ing, g, "spill slab",
                             lambda: _spill_bucket(g, bkt, block, b0))
                del part, block
                _ckptlib.spill_slab_done(spill_dir, fp, g)
                ing.release()
            if on_card:
                compute_stream.synchronize()
        finally:
            if pod is not None:
                _podwatch.pod_exit()
            ing.close()
            pending.clear()
    finally:
        _engine.record_shuffle(moved, _clock() - t_start)
        if run_sp is not None:
            run_sp.set(bytes=moved)
        _obs.end(run_sp)
    if nslabs == 0:
        raise RuntimeError(
            "streamed swap produced no slabs (empty source?) — the "
            "materialised path owns empty-input rules")

    if pod is not None:
        from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
        return _replay_stages(BoltArrayMesh.wrap(
            out, source.mesh, plan.out_shape, new_split, pod.out_spec), post)
    if plan.resident:
        return _replay_stages(BoltArrayGPU(out, new_split, device), post)

    # SPILLED: phase 2 is a fresh callback source over the bucket files,
    # streaming through the same executor as any other source, with the
    # stages after the swap riding it lazily
    out_shape, out_block, j0 = plan.out_shape, plan.out_block, plan.j0
    out_n = out_shape[0]

    def produce(index):
        lo, hi, _ = index[0].indices(out_n)
        chunks = []
        for bkt in range(lo // out_block, -(-hi // out_block)):
            pieces = [_ckptlib.spill_load(spill_dir, fp, g, bkt)
                      for g in range(nslabs)]
            chunks.append(np.concatenate([p[0] for p in pieces], axis=j0))
        full = np.concatenate(chunks, axis=0)
        row0 = (lo // out_block) * out_block
        return full[lo - row0:hi - row0][(slice(None),) + tuple(index[1:])]

    src2 = StreamSource("callback", produce, None, out_shape, new_split,
                        st.dtype, device, out_block, post, ckpt=source.ckpt)
    return BoltArrayGPU._streamed(src2)
