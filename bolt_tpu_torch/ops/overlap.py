"""Halo-overlap mapping and separable filters over the value axes.

Port of ``bolt_tpu/ops/overlap.py``.  The reference's chunk ``padding``
exists for the Thunder workload of spatial filters over image stacks: the
spatial axes are chunked with a halo so each block sees its neighbours'
boundary rows.  :func:`map_overlap` packages that pattern; :func:`smooth`,
:func:`convolve` and :func:`gaussian` build separable filters on it, and
:func:`median_filter` the joint-window median.

On the gpu mode a floating array is filtered whole: its deferred map chain
is applied and every active axis goes through ONE launch of the window
kernel (``ops/kernels.py :: sepfilter1d``), in the caller's axis order.
On a mesh (``gpu/mesharray.py``) ``shard=`` splits chunked value axes
across mesh axes, as in the reference, and each rank runs the window
kernel on its own block, extended along a split axis by its neighbours'
halos (``parallel/halo.py``) and trimmed after: every output element sees
the values and the taps it sees on one device.
Non-floating inputs, the median and the local mode take the chunked path
(``chunk(padding=...).map(...)``), whose block functions pick numpy or
torch by the block's type.  A kernel that fails raises: nothing retries
on the chunked path.
"""

from functools import lru_cache
from itertools import product as _product

import numpy as np
import torch

from bolt_tpu_torch.utils import chunk_axes, iterexpand, tupleize

# boundary-mode names follow numpy.pad; scipy.ndimage's names are accepted
# as aliases (scipy 'reflect' repeats the edge sample = np 'symmetric';
# scipy 'mirror' excludes it = np 'reflect'; scipy 'nearest' = np 'edge')
_PAD_MODES = ("constant", "reflect", "edge", "symmetric")
_MODE_ALIASES = {"mirror": "reflect", "nearest": "edge"}


def _canon_mode(mode):
    mode = _MODE_ALIASES.get(mode, mode)
    if mode not in _PAD_MODES:
        raise ValueError("mode must be one of %s (or scipy aliases %s), "
                         "got %r" % (_PAD_MODES, tuple(_MODE_ALIASES), mode))
    return mode


def map_overlap(b, func, depth, axis=None, size="150", value_shape=None,
                dtype=None, shard=None):
    """Apply ``func`` to halo-padded blocks of the value axes and
    reassemble: ``b.chunk(size, axis, padding=depth).map(func).unchunk()``.

    ``depth`` is the halo width (scalar, or per-axis paired with ``axis``
    in the order given); ``func`` must preserve the block shape (the halo
    is trimmed after).  Each block sees ``depth`` extra elements from its
    neighbours on the chunked axes, clipped at the array edges, so stencil
    functions compute correct values at interior block boundaries.

    ``shard`` (an array on a mesh only) splits chunked VALUE axes across
    mesh axes, the sequence-parallel regime: a mesh-axis name (applied to
    the first chunked axis) or a ``{value_axis: mesh_axis}`` dict; halos
    then come from the neighbouring ranks.
    """
    return _sharded_chunks(b, depth, axis, size, shard).map(
        func, value_shape=value_shape, dtype=dtype).unchunk()


def _sharded_chunks(b, depth, axis, size, shard):
    """``b.chunk(size, axis, padding=depth)`` with the ``shard=`` request
    applied; a ``ValueError`` off a mesh, as the reference refuses it on
    a mode without a mesh."""
    if shard is not None and getattr(b, "mesh", None) is None:
        raise ValueError("shard= needs an array on a device mesh; "
                         "mode=%r here has no mesh axes" % (b.mode,))
    c = b.chunk(size=size, axis=axis, padding=depth)
    if shard is not None:
        if isinstance(shard, dict):
            for va, name in sorted(shard.items()):
                c = c.shard(name, axis=va)
        else:
            c = c.shard(shard)
    return c


def _odd_widths(width, n):
    """Validate per-axis window widths: odd and >= 1."""
    widths = [int(w) for w in iterexpand(width, n)]
    for w in widths:
        if w < 1 or w % 2 == 0:
            raise ValueError("filter width must be odd and >= 1, got %d" % w)
    return widths


def _halo_pad(x, axes, widths, mode):
    """Pad ``x`` by each window's radius on its axis with boundary
    ``mode``: ``np.pad`` for a numpy block, the kernels' index rule
    (``kernels.halo_pad``) for a tensor."""
    if isinstance(x, np.ndarray):
        pad = [(0, 0)] * x.ndim
        for ax, w in zip(axes, widths):
            pad[ax] = (w // 2, w // 2)
        return np.pad(x, pad, mode=mode)
    from bolt_tpu_torch.ops.kernels import halo_pad
    for ax, w in zip(axes, widths):
        x = halo_pad(x, ax, w // 2, w // 2, mode)
    return x


def _filter1d(x, ax, taps, mode):
    """Correlation of ``x`` with the 1-d ``taps`` along ``ax`` ('same'
    size, boundary per ``mode``): the weighted sum of ``len(taps)``
    shifted slices of the padded block.  A tensor goes through the window
    kernels' plain version (``kernels._filter1d``), whose arithmetic this
    is."""
    if not isinstance(x, np.ndarray):
        from bolt_tpu_torch.ops.kernels import _filter1d as filter_tensor
        return filter_tensor(x, ax, taps, mode)
    w = len(taps)
    length = x.shape[ax]
    xpad = _halo_pad(x, [ax], [w], mode)
    acc = None
    for off in range(w):
        sl = [slice(None)] * x.ndim
        sl[ax] = slice(off, off + length)
        piece = xpad[tuple(sl)] * taps[off]
        acc = piece if acc is None else acc + piece
    return acc


def _as_filtered(blk):
    """A tensor block in the dtype the reference's filter produces: an
    integer or bool block times a Python float is f64 under jnp's x64
    promotion, where torch would give its default f32."""
    if isinstance(blk, np.ndarray) or blk.is_floating_point():
        return blk
    from bolt_tpu_torch.gpu import dtypes
    return blk.to(dtypes.promote(blk.dtype, 1.0))


@lru_cache(maxsize=256)
def _sepfilter_fn(taps_key, axes, mode):
    """Memoised block function for the separable filters: identical
    (taps, axes, mode) return the SAME callable object."""
    def sepfilter(blk):
        out = blk
        for ax, taps in zip(axes, taps_key):
            if len(taps) > 1 or taps[0] != 1.0:  # skip only the identity
                out = _filter1d(_as_filtered(out), ax, taps, mode)
        return out
    return sepfilter


def _separable_filter(b, taps_list, axes, size, mode, shard=None,
                      precision=None):
    """Shared core of :func:`smooth`/:func:`convolve`/:func:`gaussian`:
    a 1-d tap filter per axis.  On the gpu mode a floating array is
    filtered whole by the window kernel (:func:`_whole_array_sepfilter`);
    everything else takes the halo-chunked map."""
    from bolt_tpu_torch._precision import resolve
    pr = resolve(precision)
    mode = _canon_mode(mode)
    depth = tuple(len(t) // 2 for t in taps_list)
    taps_key = tuple(tuple(float(t) for t in taps) for taps in taps_list)
    if getattr(b, "mesh", None) is not None:
        out = _mesh_sepfilter(b, taps_key, tuple(axes), mode, pr, depth,
                              size, shard)
        if out is not None:
            return out
    elif b.mode == "gpu" and shard is None:
        out = _whole_array_sepfilter(b, taps_key, tuple(axes), mode, pr)
        if out is not None:
            return out
    sepfilter = _sepfilter_fn(taps_key, tuple(axes), mode)
    return map_overlap(b, sepfilter, depth, axis=axes, size=size,
                       shard=shard)


def _whole_array_sepfilter(b, taps_key, axes, mode, precision="highest"):
    """Filter every requested axis of the whole array, one window-kernel
    launch per active axis in the caller's order, over the array's data
    with its deferred map chain applied.  ``None`` (the caller takes the
    chunked path) for a non-floating dtype; the identity filter returns a
    new wrapper, never the input itself."""
    from bolt_tpu_torch.ops import kernels
    split = b.split
    active = [(split + a, taps) for a, taps in zip(axes, taps_key)
              if len(taps) > 1 or taps[0] != 1.0]
    if not active:
        return b._clone()
    if not np.issubdtype(np.dtype(b.dtype), np.floating):
        return None
    x = b._mapped()
    for g, taps in active:
        x = kernels.sepfilter1d(x, taps, g, mode=mode, precision=precision)
    return b._wrap(x, split)


def _mesh_sepfilter(b, taps_key, axes, mode, precision, depth, size,
                    shard):
    """The separable filter of a floating array on a mesh: the
    ``shard=`` layout first (``chunk(...).shard(...)``, as the reference
    applies it), then on each rank one window-kernel launch per active
    axis over its block, extended along a split axis by its neighbours'
    halos and trimmed after (``None`` for a non-floating dtype: the
    chunked path).  An axis split over several mesh axes, or whose halo
    is wider than a rank's extent, is gathered first and re-split
    after."""
    from bolt_tpu_torch.gpu.chunk import _halo_extend
    from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
    from bolt_tpu_torch.ops import kernels
    from bolt_tpu_torch.parallel.sharding import spec_names
    split = b.split
    active = [(split + a, taps) for a, taps in zip(axes, taps_key)
              if len(taps) > 1 or taps[0] != 1.0]
    if not np.issubdtype(np.dtype(b.dtype), np.floating):
        return None
    src = _sharded_chunks(b, depth, axes, size, shard)._barray
    mesh, spec = src.mesh, src._spec
    target = spec
    if any(len(spec_names(spec[g])) > 1 or (
            spec[g] is not None and len(taps) // 2 > src._data.shape[g])
           for g, taps in active):
        src = src._whole_records()
    if not active:
        return src._relaid(target) if src._spec != target else \
            BoltArrayMesh(src._local, mesh, src.shape, split, spec)
    with src._scope():
        x = src._local._mapped()
        for g, taps in active:
            r = len(taps) // 2
            name = src._spec[g]
            if name is None or mesh.shape[name] == 1 or r == 0:
                x = kernels.sepfilter1d(x, taps, g, mode=mode,
                                        precision=precision)
                continue
            length = x.shape[g]
            ext, off = _halo_extend(x, g, r, name, mesh)
            x = kernels.sepfilter1d(ext, taps, g, mode=mode,
                                    precision=precision).narrow(
                g, off, length).contiguous()
    out = BoltArrayMesh.wrap(x, mesh, src.shape, split, src._spec)
    return out if out._spec == target else out._relaid(target)


def _filter_axes(b, axis):
    """Value axes for a filtering op, in the caller's order (widths/taps
    bind to the axes as given; the chunk layer re-sorts (axis, depth)
    pairs together)."""
    split = b.split if b.mode == "gpu" else 1
    vshape = b.shape[split:]
    axes = (chunk_axes(vshape, None) if axis is None
            else tuple(tupleize(axis)))
    chunk_axes(vshape, axes)  # validate (range, uniqueness)
    return axes


def smooth(b, width, axis=None, size="150", mode="constant", shard=None,
           precision=None):
    """Separable moving-average (boxcar) filter along value axes.

    ``width``: odd window (scalar or per-``axis``, paired in the order
    given); ``axis``: the value axes to filter (default: all); ``size``:
    chunk plan for the blockwise path; ``mode``: boundary handling at the
    ARRAY edges — ``'constant'`` (zeros), ``'reflect'``, ``'edge'`` or
    ``'symmetric'`` (numpy.pad names; scipy's ``'mirror'``/``'nearest'``
    accepted as aliases).  Floating inputs keep their dtype; integers
    promote as the reference's (f64 for int32).
    """
    axes = _filter_axes(b, axis)
    widths = _odd_widths(width, len(axes))
    taps_list = [[1.0 / w] * w for w in widths]
    return _separable_filter(b, taps_list, axes, size, mode, shard=shard,
                             precision=precision)


def convolve(b, kernel, axis=None, size="150", mode="constant",
             shard=None, precision=None):
    """Separable correlation with explicit 1-d kernels along value axes.

    ``kernel``: a 1-d sequence of odd length, or one such sequence per
    ``axis`` (paired in the order given).  Orientation is correlation
    (the filter is not flipped), matching ``scipy.ndimage``.  Same
    boundary semantics as :func:`smooth`.
    """
    axes = _filter_axes(b, axis)
    kern = list(kernel)
    if kern and np.isscalar(kern[0]):
        taps_list = [[float(t) for t in kern]] * len(axes)
    else:
        if len(kern) != len(axes):
            raise ValueError("expected %d kernels for %d axes, got %d"
                             % (len(axes), len(axes), len(kern)))
        taps_list = [[float(t) for t in k] for k in kern]
    _odd_widths([len(taps) for taps in taps_list], len(taps_list))
    return _separable_filter(b, taps_list, axes, size, mode, shard=shard,
                             precision=precision)


def gaussian(b, sigma, axis=None, size="150", mode="constant", truncate=4.0,
             shard=None, precision=None):
    """Separable Gaussian filter along value axes (``scipy.ndimage.
    gaussian_filter`` tap construction: radius ``truncate * sigma``,
    normalised).  ``sigma``: scalar or per-``axis``."""
    axes = _filter_axes(b, axis)
    sigmas = [float(s) for s in iterexpand(sigma, len(axes))]
    taps_list = []
    for s in sigmas:
        if s < 0:
            raise ValueError("sigma must be >= 0, got %r" % (s,))
        radius = int(truncate * s + 0.5)
        grid = np.arange(-radius, radius + 1, dtype=np.float64)
        taps = np.exp(-0.5 * (grid / s) ** 2) if s > 0 else np.ones(1)
        taps_list.append([float(t) for t in taps / taps.sum()])
    return _separable_filter(b, taps_list, axes, size, mode, shard=shard,
                             precision=precision)


def median_filter(b, width, axis=None, size="150", mode="symmetric",
                  shard=None):
    """Windowed median filter along value axes — the joint (rectangular)
    window over ALL named axes, matching ``scipy.ndimage.median_filter``
    (a median is not separable, so multi-axis requests stack every offset
    in the window product).  ``width``: odd window per axis; the default
    boundary (np ``'symmetric'``) is scipy's default (``'reflect'`` in
    scipy's vocabulary).  Runs on the halo-chunked map on every mode."""
    mode = _canon_mode(mode)
    axes = _filter_axes(b, axis)
    widths = _odd_widths(width, len(axes))
    depth = tuple(w // 2 for w in widths)
    medfilt = _medfilt_fn(tuple(axes), tuple(widths), mode)
    return map_overlap(b, medfilt, depth, axis=axes, size=size, shard=shard)


@lru_cache(maxsize=256)
def _medfilt_fn(axes, widths, mode):
    """Memoised median block function (same rationale as
    :func:`_sepfilter_fn`).  The window product of odd widths is odd, so
    ``torch.median``'s lower median is numpy's median; both propagate
    NaN.  Integer tensor blocks widen first, as jnp's median does."""
    offsets = list(_product(*[range(w) for w in widths]))

    def medfilt(blk):
        xpad = _halo_pad(blk, axes, widths, mode)
        pieces = []
        for off in offsets:
            sl = [slice(None)] * blk.ndim
            for ax, o in zip(axes, off):
                sl[ax] = slice(o, o + blk.shape[ax])
            pieces.append(xpad[tuple(sl)])
        if isinstance(blk, np.ndarray):
            return np.median(np.stack(pieces, axis=0), axis=0)
        from bolt_tpu_torch.gpu import dtypes
        stack = torch.stack(pieces, dim=0)
        return torch.median(stack.to(dtypes.inexact(stack.dtype)),
                            dim=0).values

    return medfilt
