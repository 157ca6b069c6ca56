"""Factory / mode dispatch: the single construction entry point.

Port of ``bolt_tpu/factory.py``.  The registry is ``[('gpu', ConstructGPU),
('local', ConstructLocal)]`` and the context that selects the device
backend is a ``torch.device``.  With no context and no mode the local
NumPy oracle answers; ``mode='gpu'`` with no context means ``cuda:0`` and
raises when CUDA is not available.
"""

from bolt_tpu_torch.gpu.construct import ConstructGPU
from bolt_tpu_torch.local.construct import ConstructLocal

# checked in order; the local backend is the fallback
constructors = [("gpu", ConstructGPU), ("local", ConstructLocal)]


def _lookup(*args, **kwargs):
    """Find the constructor class for the given arguments (reference:
    ``bolt/factory.py`` dispatch helper)."""
    mode = kwargs.get("mode")
    if mode is not None:
        for name, cls in constructors:
            if name == mode:
                return cls
        raise ValueError("unknown mode %r (known: %s)"
                         % (mode, [n for n, _ in constructors]))
    for name, cls in constructors:
        if cls._argcheck(*args, **kwargs):
            return cls
    return ConstructLocal


def array(a, context=None, axis=(0,), mode=None, dtype=None,
          npartitions=None):
    """Create a bolt array from an array-like.  ``mode='gpu'`` (or a
    ``torch.device`` as ``context``) puts ``axis`` as key axes on the
    device; otherwise a local NumPy-backed array is returned."""
    cls = _lookup(context=context, mode=mode)
    if cls is ConstructLocal:
        return ConstructLocal.array(a, dtype=dtype)
    return ConstructGPU.array(a, context=context, axis=axis, dtype=dtype,
                              npartitions=npartitions)


def ones(shape, context=None, axis=(0,), mode=None, dtype=None):
    """Bolt array of ones."""
    cls = _lookup(context=context, mode=mode)
    if cls is ConstructLocal:
        return ConstructLocal.ones(shape, dtype=dtype)
    return ConstructGPU.ones(shape, context=context, axis=axis, dtype=dtype)


def zeros(shape, context=None, axis=(0,), mode=None, dtype=None):
    """Bolt array of zeros."""
    cls = _lookup(context=context, mode=mode)
    if cls is ConstructLocal:
        return ConstructLocal.zeros(shape, dtype=dtype)
    return ConstructGPU.zeros(shape, context=context, axis=axis, dtype=dtype)


def full(shape, value, context=None, axis=(0,), mode=None, dtype=None):
    """Bolt array filled with ``value`` (numpy ``full`` semantics: the
    dtype defaults to the fill value's)."""
    cls = _lookup(context=context, mode=mode)
    if cls is ConstructLocal:
        return ConstructLocal.full(shape, value, dtype=dtype)
    return ConstructGPU.full(shape, value, context=context, axis=axis,
                             dtype=dtype)


def randn(shape, context=None, axis=(0,), mode=None, dtype=None, seed=0):
    """Bolt array of standard normals; ``mode='gpu'`` generates it on the
    device (backends use different RNG streams)."""
    cls = _lookup(context=context, mode=mode)
    if cls is ConstructLocal:
        return ConstructLocal.randn(shape, dtype=dtype, seed=seed)
    return ConstructGPU.randn(shape, context=context, axis=axis, dtype=dtype,
                              seed=seed)


def rand(shape, context=None, axis=(0,), mode=None, dtype=None, seed=0):
    """Bolt array of uniform [0, 1) samples; see :func:`randn`."""
    cls = _lookup(context=context, mode=mode)
    if cls is ConstructLocal:
        return ConstructLocal.rand(shape, dtype=dtype, seed=seed)
    return ConstructGPU.rand(shape, context=context, axis=axis, dtype=dtype,
                             seed=seed)


def fromcallback(fn, shape, context=None, axis=(0,), mode=None, dtype=None,
                 chunks=None, codec=None):
    """Build a bolt array by calling ``fn(index_slices) -> block`` per
    record range (reference: ``bolt_tpu/factory.py :: fromcallback``).
    ``mode='gpu'`` with an explicit ``dtype``: a LAZY stream whose
    reduction terminals run slab by slab through the out-of-core executor
    (``bolt_tpu_torch.stream``; ``chunks`` records a slab, ``codec=`` an
    ingest codec); other consumers materialise it.  Local mode: one call
    for the whole array."""
    cls = _lookup(context=context, mode=mode)
    if cls is ConstructLocal:
        return ConstructLocal.fromcallback(fn, shape, axis=axis, dtype=dtype)
    return ConstructGPU.fromcallback(fn, shape, context=context, axis=axis,
                                     dtype=dtype, chunks=chunks, codec=codec)


def fromiter(blocks, shape, context=None, axis=(0,), mode=None, dtype=None,
             codec=None):
    """Build a bolt array from an ITERABLE of consecutive record blocks
    (key-axes-first layout along the first key axis); ``dtype`` is
    required.  ``mode='gpu'``: a lazy stream like :func:`fromcallback`'s;
    local mode assembles the blocks on the host."""
    cls = _lookup(context=context, mode=mode)
    if cls is ConstructLocal:
        return ConstructLocal.fromiter(blocks, shape, axis=axis, dtype=dtype)
    return ConstructGPU.fromiter(blocks, shape, context=context, axis=axis,
                                 dtype=dtype, codec=codec)


def concatenate(arrays, axis=0, context=None, mode=None):
    """Concatenate bolt arrays; dispatches on the first array's backend
    unless overridden."""
    if isinstance(arrays, (tuple, list)) and len(arrays) and mode is None \
            and context is None:
        from bolt_tpu_torch.gpu.array import BoltArrayGPU
        if isinstance(arrays[0], BoltArrayGPU):
            return ConstructGPU.concatenate(arrays, axis=axis)
        return ConstructLocal.concatenate(arrays, axis=axis)
    cls = _lookup(context=context, mode=mode)
    if cls is ConstructLocal:
        return ConstructLocal.concatenate(arrays, axis=axis)
    return ConstructGPU.concatenate(arrays, axis=axis, context=context)
