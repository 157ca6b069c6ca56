"""Shared argument-normalisation helpers and test utilities.

Reference parity: ``bolt/utils.py`` — symbols ``tupleize``,
``argpack``, ``inshape``, ``slicify``, ``allclose``, ``iterexpand``,
``istransposeable``, ``isreshapeable``.  (Symbol-level citations only: the
reference mount was empty this round — see SURVEY.md §0.)
"""

from numbers import Integral

import numpy as np


def tupleize(arg):
    """Coerce an argument to a tuple.

    Scalars become 1-tuples; lists/ranges/ndarrays become tuples; a 1-tuple
    wrapping a tuple/list (as produced by ``f(*args)`` with ``f((0, 1))``)
    is unwrapped.  ``None`` passes through.

    Reference: ``bolt/utils.py :: tupleize``.
    """
    if arg is None:
        return None
    if isinstance(arg, (tuple, list, range, np.ndarray)):
        if isinstance(arg, tuple) and len(arg) == 1 and isinstance(arg[0], (tuple, list, range, np.ndarray)):
            return tuple(arg[0])
        return tuple(arg)
    return (arg,)


def listify(arg):
    """Like :func:`tupleize` but returns a list.

    Reference: ``bolt/utils.py :: listify``.
    """
    t = tupleize(arg)
    return None if t is None else list(t)


def argpack(args):
    """Normalise ``*args``-style shape/axis arguments.

    Supports both ``f(1, 2, 3)`` and ``f((1, 2, 3))`` calling conventions.

    Reference: ``bolt/utils.py :: argpack``.
    """
    if len(args) == 1 and isinstance(args[0], (tuple, list, range, np.ndarray)):
        return tuple(args[0])
    return tuple(args)


def inshape(shape, axes):
    """Validate that every axis index is within ``range(len(shape))``.

    Reference: ``bolt/utils.py :: inshape``.
    """
    ndim = len(shape)
    for a in tupleize(axes):
        if not isinstance(a, Integral):
            raise ValueError("axis %r is not an integer" % (a,))
        if a < 0 or a >= ndim:
            raise ValueError(
                "axis %d out of bounds for array with %d dimensions" % (a, ndim))


def iterexpand(arg, n):
    """Broadcast a scalar to an ``n``-tuple, or validate an ``n``-sequence.

    Reference: ``bolt/utils.py :: iterexpand``.
    """
    if isinstance(arg, (tuple, list, np.ndarray)):
        t = tuple(arg)
        if len(t) != n:
            raise ValueError(
                "sequence of length %d cannot be broadcast to length %d" % (len(t), n))
        return t
    return (arg,) * n


def slicify(slc, dim):
    """Normalise a single-axis index to a canonical form.

    * ``slice`` → ``slice`` with concrete, in-bounds ``start/stop/step``
    * integer → ``slice(i, i+1, 1)`` (negative values wrapped); the caller is
      responsible for tracking the implied dimension squeeze
    * list / integer ndarray → 1-d ``np.ndarray`` of wrapped, validated indices
    * boolean ndarray of length ``dim`` → ``np.ndarray`` of selected indices

    Reference: ``bolt/utils.py :: slicify``.
    """
    if isinstance(slc, slice):
        start, stop, step = slc.indices(dim)
        if step < 0 and stop < 0:
            # a computed stop of -1 means "past the beginning"; keep it None
            # so downstream indexing doesn't wrap it to dim-1
            stop = None
        return slice(start, stop, step)
    if isinstance(slc, (Integral, np.integer)):
        i = int(slc)
        if i < 0:
            i += dim
        if i < 0 or i >= dim:
            raise IndexError("index %d out of bounds for axis of size %d" % (int(slc), dim))
        return slice(i, i + 1, 1)
    if isinstance(slc, (list, tuple, np.ndarray)):
        arr = np.asarray(slc)
        if arr.dtype == bool:
            if arr.ndim != 1 or arr.shape[0] != dim:
                raise IndexError(
                    "boolean index of shape %s does not match axis of size %d" % (arr.shape, dim))
            return np.nonzero(arr)[0]
        if arr.ndim != 1:
            # the per-axis orthogonal take contract is 1-d index lists
            # (like the bool branch above); a multi-d take would silently
            # shift every later axis
            raise IndexError(
                "per-axis advanced index must be 1-d, got shape %s"
                % (arr.shape,))
        arr = arr.astype(np.int64)
        arr = np.where(arr < 0, arr + dim, arr)
        if arr.size and (arr.min() < 0 or arr.max() >= dim):
            raise IndexError("index out of bounds for axis of size %d" % dim)
        return arr
    raise ValueError("cannot index axis with %r" % (slc,))


def normalize_index(index, shape):
    """Normalise a full ``__getitem__`` index against ``shape`` to
    ``(norm, squeezed)``: one entry per axis, each a canonical ``slice`` or
    a 1-d integer ``np.ndarray`` (advanced), with ``squeezed`` listing the
    axes indexed by scalars (to drop from the result).  Expands a single
    ``Ellipsis``, pads missing axes with full slices, and treats 0-d
    integer arrays (e.g. ``np.argmax`` results) as scalars so a per-axis
    ``take`` never silently shifts later axes.

    Shared by BOTH backends' multiple-advanced-index paths — one
    normalisation, one semantics (reference: the ``_getbasic``/
    ``_getadvanced`` split in ``bolt/spark/array.py``).
    """
    idx = index if isinstance(index, tuple) else (index,)
    ndim = len(shape)
    ell = [n for n, i in enumerate(idx) if i is Ellipsis]
    if len(ell) > 1:
        raise IndexError("an index can only have a single ellipsis ('...')")
    if ell:
        pos = ell[0]
        fill = ndim - (len(idx) - 1)
        if fill < 0:
            raise ValueError("too many indices for %d-d array" % ndim)
        idx = idx[:pos] + (slice(None),) * fill + idx[pos + 1:]
    if len(idx) > ndim:
        raise ValueError("too many indices for %d-d array" % ndim)
    idx = idx + (slice(None),) * (ndim - len(idx))
    squeezed = []
    norm = []
    for ax, (i, dim) in enumerate(zip(idx, shape)):
        if isinstance(i, np.ndarray) and i.ndim == 0 and i.dtype != bool:
            i = int(i)
        if isinstance(i, (int, np.integer)):
            squeezed.append(ax)
        norm.append(slicify(i, dim))
    return norm, squeezed


def istransposeable(new, old):
    """True if ``new`` is a permutation of the axes ``old``.

    Reference: ``bolt/utils.py :: istransposeable``.
    """
    new, old = tupleize(new), tupleize(old)
    return sorted(new) == sorted(old)


def isreshapeable(new, old):
    """True if shape ``new`` has the same number of elements as ``old``.

    Reference: ``bolt/utils.py :: isreshapeable``.
    """
    new, old = tupleize(new), tupleize(old)
    return int(np.prod(new, dtype=np.int64)) == int(np.prod(old, dtype=np.int64))


def allclose(a, b, rtol=1e-5, atol=1e-8):
    """Shape-and-value comparison used throughout the test suite.

    Reference: ``bolt/utils.py :: allclose`` (shape equality + ``np.allclose``).
    """
    a = np.asarray(a)
    b = np.asarray(b)
    return a.shape == b.shape and np.allclose(a, b, rtol=rtol, atol=atol)


def prod(shape):
    """Integer product of a shape tuple (1 for the empty shape)."""
    return int(np.prod(tupleize(shape) or (1,), dtype=np.int64))


def get_kv_axes(shape, axes):
    """Split the axis indices of ``shape`` into (key axes, value axes),
    key axes being those named in ``axes``.

    Reference: ``bolt/spark/utils.py :: get_kv_axes``.
    """
    axes = sorted(tupleize(axes))
    inshape(shape, axes)
    kaxes = tuple(axes)
    vaxes = tuple(i for i in range(len(shape)) if i not in axes)
    return kaxes, vaxes


def get_kv_shape(shape, axes):
    """Split ``shape`` into (key shape, value shape) for the key axes
    ``axes``.

    Reference: ``bolt/spark/utils.py :: get_kv_shape``.
    """
    kaxes, vaxes = get_kv_axes(shape, axes)
    return (tuple(shape[a] for a in kaxes), tuple(shape[a] for a in vaxes))


def chunk_axes(vshape, axis):
    """Normalize a chunk ``axis`` request against a value shape: ``None``
    means every value axis; out-of-range axes raise (shared by both
    backends' ``chunk``; reference: the axis handling of
    ``bolt/spark/chunk.py :: ChunkedArray._chunk``)."""
    nv = len(vshape)
    if axis is None:
        return tuple(range(nv))
    axes = tuple(sorted(tupleize(axis)))
    if len(set(axes)) != len(axes):
        raise ValueError("chunk axes must be unique")
    for a in axes:
        if a < 0 or a >= nv:
            raise ValueError(
                "chunk axis %d out of range for %d value axes" % (a, nv))
    return axes


def chunk_align(vshape, axis, size, padding):
    """Normalize a chunk request to sorted axes WITHOUT breaking the
    pairing between each named axis and its per-axis ``size``/``padding``
    entry: ``chunk(size=(2, 9), axis=(1, 0))`` means size 2 on value axis
    1 and 9 on axis 0, whatever order downstream planning iterates in.
    Returns ``(axes_sorted, size, padding)`` with sequence-valued
    ``size``/``padding`` reordered to match ``axes_sorted``."""
    if axis is None:
        return chunk_axes(vshape, None), size, padding
    axes_given = tuple(tupleize(axis))
    axes = chunk_axes(vshape, axes_given)  # validates + sorts
    order = sorted(range(len(axes_given)), key=lambda i: axes_given[i])

    def reorder(arg):
        if isinstance(arg, (tuple, list, np.ndarray)):
            t = iterexpand(arg, len(axes))
            return tuple(t[i] for i in order)
        return arg

    size = size if isinstance(size, str) else reorder(size)
    padding = None if padding is None else reorder(padding)
    return axes, size, padding


def iter_record_blocks(blocks, shape, dtype):
    """Yield ``(lo, hi, block)`` from an iterable of consecutive record
    blocks (key-axes-first layout, concatenated along the first axis),
    each validated against ``shape`` and cast to ``dtype``; together the
    blocks must cover ``shape`` exactly.  The ONE ``fromiter`` block
    contract, shared by the local backend and the streaming executor so
    their error behavior cannot drift."""
    n = shape[0]
    rest = tuple(shape[1:])
    lo = 0
    for block in iter(blocks):
        block = np.asarray(block, dtype=dtype)
        if block.ndim != len(shape) or block.shape[1:] != rest:
            raise ValueError(
                "fromiter block has shape %s; expected (k,) + %s"
                % (block.shape, rest))
        hi = lo + block.shape[0]
        if hi > n:
            raise ValueError(
                "fromiter blocks overrun the declared shape: %d of %d "
                "records already consumed" % (hi, n))
        yield lo, hi, block
        lo = hi
    if lo != n:
        raise ValueError(
            "fromiter blocks cover only %d of %d declared records"
            % (lo, n))


def check_value_shape(hint, inferred):
    """Validate an explicit ``value_shape`` hint against the inferred
    per-record output shape (shared by every backend's array/chunked/
    stacked map)."""
    if hint is None or inferred is None:
        return
    if tuple(tupleize(hint)) != tuple(inferred):
        raise ValueError("value_shape %s does not match inferred %s"
                         % (tuple(tupleize(hint)), tuple(inferred)))


def assignment_index(norm, shape, squeezed=()):
    """Index tuple that ASSIGNS to the region a ``__getitem__`` with the
    same index would READ — valid for numpy in-place assignment and
    jax's ``.at[...]`` alike, so the value broadcasts against exactly
    the getitem result shape on both backends.

    Scalar-indexed axes (``squeezed``) become bare ints: they drop out
    of the region like numpy assignment (keeping them as length-1 dims
    would reject a value shaped like the getitem result whenever a
    non-1 dim precedes the scalar axis).  When the index is basic, or a
    single advanced entry with no scalars alongside, the zipped and
    orthogonal conventions coincide and the normalized entries pass
    through (cheap basic/single-gather scatter).  Otherwise EVERY
    non-scalar axis opens into an ``np.ix_``-style broadcast mesh: all
    entries are then advanced and adjacent under numpy's rules (scalars
    are 0-d advanced), so region dims follow axis order — the
    orthogonal cross product, matching ``__getitem__``.  Shared by both
    backends' ``set``/``__setitem__`` so the semantics cannot drift."""
    arrays = [s for s in norm if isinstance(s, np.ndarray)]
    if len(arrays) <= 1 and not (arrays and squeezed):
        return tuple(int(s.start) if ax in squeezed else s
                     for ax, s in enumerate(norm))
    meshed = [ax for ax in range(len(norm)) if ax not in squeezed]
    k = len(meshed)
    out = []
    for ax, (s, dim) in enumerate(zip(norm, shape)):
        if ax in squeezed:
            out.append(int(s.start))
            continue
        a = np.arange(dim)[s] if isinstance(s, slice) else s
        pos = meshed.index(ax)
        out.append(a.reshape((1,) * pos + (a.size,) + (1,) * (k - pos - 1)))
    return tuple(out)


def check_q(q):
    """Validate a quantile ``q`` (scalar or 1-d, every value in [0, 1])
    and return it as a float64 ndarray — shared by both backends so the
    contract cannot drift.  NaN is rejected explicitly: on the TPU
    backend q is a traced jit argument, so a NaN that slipped past
    validation would silently produce an all-NaN result instead of this
    error."""
    try:
        qarr = np.asarray(q, dtype=np.float64)
    except (TypeError, ValueError):
        raise ValueError(
            "q must be a scalar or 1-d array of values in [0, 1], got %r"
            % (q,))
    if qarr.ndim > 1:
        raise ValueError("q must be a scalar or 1-d, got %d-d" % qarr.ndim)
    if qarr.size and not (np.all(qarr >= 0.0) and np.all(qarr <= 1.0)):
        raise ValueError("q must be in [0, 1], got %r" % (q,))
    return qarr


def chunk_plan(vshape, itemsize, size, axes, padding=None):
    """Per-value-axis chunk sizes.  A string ``size`` is a per-block
    megabyte budget (the reference's ``size='150'`` default) — the largest
    chunkable axis is halved until the block fits; an int/tuple gives
    explicit chunk sizes for ``axes`` (reference:
    ``bolt/spark/chunk.py :: ChunkedArray._chunk`` plan computation).

    ``padding`` (the halo widths, paired with ``axes``) floors the budget
    halving at ``halo + 1`` per axis, so a wide filter under a tight
    budget gets a slightly-over-budget plan instead of an invalid one
    whose halo exceeds its chunk; explicit int sizes are the user's exact
    request and stay strictly validated downstream."""
    plan = list(vshape)
    floor = [1] * len(vshape)
    if padding is not None:
        for a, p in zip(axes, iterexpand(padding, len(axes))):
            floor[a] = min(int(p) + 1, vshape[a])
    if isinstance(size, str):
        budget = float(size) * 1e6
        while (prod(plan) * itemsize > budget
               and any(plan[a] > floor[a] for a in axes)):
            a = max(axes, key=lambda i: plan[i] - floor[i])
            plan[a] = max(-(-plan[a] // 2), floor[a])
    else:
        sizes = iterexpand(size, len(axes))
        for a, s in zip(axes, sizes):
            if s < 1:
                raise ValueError("chunk size must be >= 1, got %d" % s)
            plan[a] = min(int(s), vshape[a])
    return plan


def chunk_pad(plan, axes, padding, vshape):
    """Per-value-axis halo widths; a halo must be smaller than its chunk
    (reference: ``ChunkedArray._chunk`` padding validation) — except on an
    UNCHUNKED axis (one block spanning the whole axis), where the halo
    only ever clips at the array edges and any width is harmless (a wider-
    than-axis filter radius must still run)."""
    nv = len(vshape)
    pad = [0] * nv
    if padding is not None:
        pads = iterexpand(padding, len(axes))
        for a, p in zip(axes, pads):
            if p < 0 or (p >= plan[a] > 0 and plan[a] < vshape[a]):
                raise ValueError(
                    "padding %d must be smaller than the chunk size %d "
                    "on axis %d — a halo (e.g. a filter's width/sigma "
                    "radius) cannot exceed its block; pass a larger "
                    "size= (chunk budget or explicit per-axis sizes)"
                    % (p, plan[a], a))
            pad[a] = int(p)
    return pad


def code_token(func):
    """A process-stable identity token for a user callable: its name plus
    a digest of its bytecode and constants (nested code objects
    recursed), so two lambdas with different bodies get different tokens
    (``__name__`` calls every lambda ``<lambda>``).  Callables without
    bytecode (ufuncs, builtins, callable objects) fall back to their
    name.  Data captured in a closure is not part of the token
    (reference: ``bolt_tpu/utils.py :: code_token``)."""
    import hashlib
    code = getattr(func, "__code__", None)
    name = getattr(func, "__name__", None) or type(func).__name__
    if code is None:
        return name

    def feed(h, c):
        h.update(c.co_code)
        for const in c.co_consts:
            if hasattr(const, "co_code"):
                feed(h, const)
            else:
                h.update(repr(const).encode())

    h = hashlib.sha1()
    feed(h, code)
    return "%s#%s" % (name, h.hexdigest()[:12])


def chain_retry_step(exc, prev, attempt, allowed, what, knob):
    """The one retry-chaining policy of the streaming executor: chain this
    attempt's ``exc`` to the one before (back to the original failure)
    and either hand it back as the next attempt's ``prev`` (another
    attempt is ``allowed``) or raise: a pointed chained error when
    retries were consumed, the ORIGINAL exception untouched at budget 0
    (reference: ``bolt_tpu/utils.py :: chain_retry_step``)."""
    if prev is not None and exc.__cause__ is None and exc is not prev:
        exc.__cause__ = prev
    if allowed:
        return exc
    if attempt:
        raise RuntimeError(
            "%s failed after %d retries (%s); the final attempt's "
            "error is chained below, each attempt chained to the one "
            "before" % (what, attempt, knob)) from exc
    raise exc
