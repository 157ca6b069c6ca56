"""Device working-set estimates of a pipeline (port of the estimates in
``bolt_tpu/analysis/check.py``; the checker itself waits for ROADMAP
A11).

A pipeline's bytes follow its lazy state: a stream holds slabs in a ring
of ``prefetch depth + uploader pool`` slabs (wire bytes when a codec is
armed), a stat group reads its source once, and an in-memory chain or
filter holds its base beside its result.  Nothing here touches the
device or imports the serving layer.
"""

import numpy as np

from bolt_tpu_torch.utils import prod


def _nbytes(t):
    return int(t.numel()) * int(t.element_size())


def _group_bytes(g):
    """Bytes one pass of a stat group reads."""
    if g.kind == "chain":
        return _nbytes(g.base)
    if g.kind == "fpending":
        return _nbytes(g.fpending[0])
    return prod(g.source.shape) * np.dtype(g.source.dtype).itemsize


def _effective_codec(src):
    """The codec a run over ``src`` would resolve (the source's
    ``codec=`` wins over the caller's ``stream.codec()`` scope), without
    the dtype validation ``stream.resolve_codec`` makes: an estimate
    never raises."""
    from bolt_tpu_torch import stream as _stream
    name = src.codec if src.codec is not None else _stream.current_codec()
    if name is None:
        return None
    try:
        return _stream._codec_registry().get(name)
    except ValueError:
        return None


def _stream_slab_bytes(src):
    """One slab's device bytes: the wire representation when a codec is
    armed (the ring holds, and the serving arbiter leases, the encoded
    slab)."""
    itemsize = src.dtype.itemsize
    c = _effective_codec(src)
    if c is not None:
        try:
            itemsize = c.wire_dtype(src.dtype).itemsize
        except ValueError:
            pass          # a refused combination never streams
    return int(src.slab * prod(src.shape[1:]) * itemsize)


def _stream_ring_bytes(src):
    """A streaming plan's peak device footprint: slab bytes times the
    ring bound (prefetch depth + uploader pool), the slabs one run's
    ingest can hold at once."""
    from bolt_tpu_torch import stream as _stream
    return _stream_slab_bytes(src) * (_stream.prefetch_depth()
                                      + _stream.pool_size(src))


def _gpu_array(obj):
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    from bolt_tpu_torch.gpu.chunk import ChunkedArray
    from bolt_tpu_torch.gpu.stack import StackedArray
    arr = obj
    if isinstance(arr, (ChunkedArray, StackedArray)):
        arr = arr._barray
    return arr if isinstance(arr, BoltArrayGPU) else None


def admission_floor_bytes(obj):
    """The least device bytes ``obj``'s pipeline needs at once, which
    admission control (``serve.Server.submit``) compares with the
    serving budget: a stream degrades to one slab in flight (the
    arbiter's starvation valve shallows its ring), so its floor is the
    slab; an in-memory pipeline cannot shrink, so its floor is
    :func:`working_set_bytes`.  ``None`` when nothing can be
    estimated."""
    arr = _gpu_array(obj)
    if arr is None:
        return None
    h = arr._spending
    if h is not None and h.result is None and h.group.kind == "stream":
        return _stream_slab_bytes(h.group.source)
    if arr._stream is not None:
        return _stream_slab_bytes(arr._stream)
    return working_set_bytes(arr)


def working_set_bytes(obj):
    """Estimated peak device bytes ``obj``'s pipeline needs at once:

    * a stream: slab bytes times (prefetch depth + uploader pool);
    * a pending stat: its group's one-pass read (a stream group's ring);
    * a deferred chain, a pending filter or a concrete array: its source
      bytes plus its result bytes (both live while it runs).

    ``None`` for objects with nothing to estimate (local arrays, numpy
    arrays)."""
    arr = _gpu_array(obj)
    if arr is None:
        return None
    h = arr._spending
    if h is not None and h.result is not None:
        return _nbytes(h.result)         # resolved: only the result lives
    if h is not None:
        if h.group.kind == "stream":
            return _stream_ring_bytes(h.group.source)
        return _group_bytes(h.group)
    if arr._stream is not None:
        return _stream_ring_bytes(arr._stream)
    out_bytes = prod(arr._shape) * arr._dtype.itemsize \
        if arr._shape is not None else 0
    if arr._fpending is not None:
        # the survivors are unknown: count the result as the base's
        base = _nbytes(arr._fpending[0])
        return base + (out_bytes or base)
    if arr._chain is not None:
        return _nbytes(arr._chain[0]) + out_bytes
    return out_bytes
