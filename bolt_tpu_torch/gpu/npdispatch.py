"""``__array_function__`` dispatch: the non-ufunc NumPy API on the card.

Port of ``bolt_tpu/tpu/npdispatch.py``, in its order and under its names:
every function of the reference's table is in this one.  ``np.sum(b)``,
``np.stack([b, b])``, ``np.einsum(...)``, ``np.nanmean(b)``,
``np.linalg.inv(b)``, ``np.fft.rfft2(b)`` and the rest run on the card
with NUMPY semantics (``np.sum(b)`` reduces every axis where ``b.sum()``
reduces the key axes) and jnp's result dtypes, and return bolt arrays
with no copy to the host.  Most families build one engine program over
mixed operands (:func:`_device_fused`): a bolt operand applies its
deferred chain inside it, any other operand moves to the card once.

A function outside the table, or a call the reference also sends to the
host (``out=``, ``dtype=``, unsupported modes, host-only operands, a
``func1d`` torch cannot trace), takes the host fallback: every bolt
operand is copied to the host through ``__array__`` (which warns above
``gpu/array.py :: IMPLICIT_GATHER_WARN_BYTES``) and plain numpy answers.
A torch call that fails on the card is an error, never a quiet fallback.
"""

import operator
from collections import Counter

import numpy as np
import torch
from torch.func import vmap

from bolt_tpu_torch import _precision
from bolt_tpu_torch.gpu import array as _garray
from bolt_tpu_torch.gpu import dtypes
from bolt_tpu_torch.gpu.array import (BoltArrayGPU, _cached_jit,
                                      _chain_apply, _chain_blocks,
                                      _chain_rec_bytes, _is_trace_error,
                                      _raise_callable_bug,
                                      _reduce_stat, _traceable,
                                      _warn_fallback, _wide, numpy_dtype)
from bolt_tpu_torch.gpu.dtypes import torch_dtype
from bolt_tpu_torch.gpu.methods import _sortable
from bolt_tpu_torch.utils import check_q, inshape, prod, tupleize

_NV = np._NoValue

_TABLE = {}


class _Fallback(Exception):
    """Raised by a handler that cannot serve the call on the card; the
    dispatcher then takes the host path (copy + plain numpy)."""


def _implements(*np_funcs):
    def deco(handler):
        for f in np_funcs:
            _TABLE[f] = handler
        return handler
    return deco


def _require_default(**pairs):
    """Raise :class:`_Fallback` when any of the given kwargs was set to a
    meaningful value — the card path cannot honour it (``None`` and
    numpy's no-value sentinel both read as "left at default")."""
    for name, (got, default) in pairs.items():
        if got is not default and got is not _NV and got is not None:
            raise _Fallback(name)


def _all_axes(a, axis):
    """numpy's ``axis=None`` means EVERY axis; bolt methods default to the
    key axes — translate explicitly."""
    return tuple(range(a.ndim)) if axis is None else axis


def _keepdims(kd):
    return False if kd in (_NV, None) else bool(kd)


def _is_gpu(x):
    return isinstance(x, BoltArrayGPU)


def _require_gpu(a):
    if not _is_gpu(a):
        raise _Fallback("operand not on the card")
    return a


# ---------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------

@_implements(np.sum)
def _sum(a, axis=None, dtype=None, out=None, keepdims=_NV, initial=_NV,
         where=_NV):
    _require_default(dtype=(dtype, None), out=(out, None),
                     initial=(initial, _NV), where=(where, _NV))
    return a.sum(axis=_all_axes(a, axis), keepdims=_keepdims(keepdims))


@_implements(np.prod)
def _prod(a, axis=None, dtype=None, out=None, keepdims=_NV, initial=_NV,
          where=_NV):
    _require_default(dtype=(dtype, None), out=(out, None),
                     initial=(initial, _NV), where=(where, _NV))
    return a.prod(axis=_all_axes(a, axis), keepdims=_keepdims(keepdims))


@_implements(np.mean)
def _mean(a, axis=None, dtype=None, out=None, keepdims=_NV, where=_NV):
    _require_default(dtype=(dtype, None), out=(out, None), where=(where, _NV))
    return a.mean(axis=_all_axes(a, axis), keepdims=_keepdims(keepdims))


def _ddof(ddof, correction):
    if correction is not _NV:
        if ddof != 0:
            raise ValueError("can't specify both correction and ddof")
        return correction
    return ddof


@_implements(np.var)
def _var(a, axis=None, dtype=None, out=None, ddof=0, keepdims=_NV,
         where=_NV, mean=_NV, correction=_NV):
    _require_default(dtype=(dtype, None), out=(out, None), where=(where, _NV),
                     mean=(mean, _NV))
    return a.var(axis=_all_axes(a, axis), keepdims=_keepdims(keepdims),
                 ddof=_ddof(ddof, correction))


@_implements(np.std)
def _std(a, axis=None, dtype=None, out=None, ddof=0, keepdims=_NV,
         where=_NV, mean=_NV, correction=_NV):
    _require_default(dtype=(dtype, None), out=(out, None), where=(where, _NV),
                     mean=(mean, _NV))
    return a.std(axis=_all_axes(a, axis), keepdims=_keepdims(keepdims),
                 ddof=_ddof(ddof, correction))


def _extremum(name):
    def handler(a, axis=None, out=None, keepdims=_NV, initial=_NV,
                where=_NV):
        _require_default(out=(out, None), initial=(initial, _NV),
                         where=(where, _NV))
        return getattr(a, name)(axis=_all_axes(a, axis),
                                keepdims=_keepdims(keepdims))
    return handler


_TABLE[np.min] = _TABLE[np.amin] = _extremum("min")
_TABLE[np.max] = _TABLE[np.amax] = _extremum("max")


@_implements(np.ptp)
def _ptp(a, axis=None, out=None, keepdims=_NV):
    _require_default(out=(out, None))
    return a.ptp(axis=_all_axes(a, axis), keepdims=_keepdims(keepdims))


def _logical(name):
    def handler(a, axis=None, out=None, keepdims=_NV, where=_NV):
        _require_default(out=(out, None), where=(where, _NV))
        return getattr(a, name)(axis=_all_axes(a, axis),
                                keepdims=_keepdims(keepdims))
    return handler


_TABLE[np.all] = _logical("all")
_TABLE[np.any] = _logical("any")


def _cumulative(name):
    def handler(a, axis=None, dtype=None, out=None):
        _require_default(dtype=(dtype, None), out=(out, None))
        return getattr(a, name)(axis=axis)     # axis=None flattens on both
    return handler


_TABLE[np.cumsum] = _cumulative("cumsum")
_TABLE[np.cumprod] = _cumulative("cumprod")


def _arg(name):
    def handler(a, axis=None, out=None, keepdims=_NV):
        _require_default(out=(out, None))
        return getattr(a, name)(axis=axis, keepdims=_keepdims(keepdims))
    return handler


_TABLE[np.argmax] = _arg("argmax")
_TABLE[np.argmin] = _arg("argmin")


# ---------------------------------------------------------------------
# order statistics
# ---------------------------------------------------------------------

def _quantile_call(a, q, axis, method, keepdims):
    if method not in ("linear", "lower", "higher", "midpoint", "nearest"):
        # numpy's other estimators (inverted_cdf, median_unbiased, ...)
        # are served on the host path
        raise _Fallback("method")
    return a.quantile(q, axis=_all_axes(a, axis), method=method,
                      keepdims=_keepdims(keepdims))


@_implements(np.quantile)
def _quantile(a, q, axis=None, out=None, overwrite_input=False,
              method="linear", keepdims=False, weights=None,
              interpolation=None):
    _require_default(out=(out, None), weights=(weights, None),
                     interpolation=(interpolation, None))
    return _quantile_call(a, q, axis, method, keepdims)


@_implements(np.percentile)
def _percentile(a, q, axis=None, out=None, overwrite_input=False,
                method="linear", keepdims=False, weights=None,
                interpolation=None):
    _require_default(out=(out, None), weights=(weights, None),
                     interpolation=(interpolation, None))
    return _quantile_call(a, np.true_divide(q, 100.0), axis, method,
                          keepdims)


@_implements(np.median)
def _median(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    _require_default(out=(out, None))
    return _quantile_call(a, 0.5, axis, "linear", keepdims)


# ---------------------------------------------------------------------
# sorting / selection / indexing
# ---------------------------------------------------------------------

@_implements(np.sort)
def _sort(a, axis=-1, kind=None, order=None, stable=None):
    _require_default(order=(order, None))
    if stable:
        kind = "stable"
    if axis is None:
        out = a.ravel()
        out.sort(axis=0, kind=kind)
        return out
    out = a._clone()
    out.sort(axis=axis, kind=kind)
    return out


@_implements(np.argsort)
def _argsort(a, axis=-1, kind=None, order=None, stable=None):
    _require_default(order=(order, None))
    return a.argsort(axis=axis, kind="stable" if stable else kind)


@_implements(np.take)
def _take(a, indices, axis=None, out=None, mode="raise"):
    _require_default(out=(out, None))
    return a.take(indices, axis=axis, mode=mode)


@_implements(np.repeat)
def _repeat(a, repeats, axis=None):
    return a.repeat(repeats, axis=axis)


@_implements(np.nonzero)
def _nonzero(a):
    return a.nonzero()


@_implements(np.searchsorted)
def _searchsorted(a, v, side="left", sorter=None):
    return a.searchsorted(v, side=side, sorter=sorter)


@_implements(np.unique)
def _unique(ar, return_index=False, return_inverse=False,
            return_counts=False, axis=None, equal_nan=True, sorted=True):
    if return_index or return_inverse or axis is not None \
            or not equal_nan or not sorted:
        raise _Fallback("unique options")
    from bolt_tpu_torch.ops import unique
    return unique(ar, return_counts=return_counts)


# ---------------------------------------------------------------------
# shaping / elementwise
# ---------------------------------------------------------------------

@_implements(np.transpose)
def _transpose(a, axes=None):
    # bolt's key/value boundary applies: a reversal that crosses it raises
    # the method's ValueError (use swap), never a copy to the host
    return a.transpose() if axes is None else a.transpose(*axes)


@_implements(np.reshape)
def _reshape(a, shape=None, order="C", newshape=None, copy=None):
    _require_default(copy=(copy, None))
    if order != "C":
        raise _Fallback("order")
    if shape is None:
        shape = newshape
    return a.reshape(*tupleize(shape))


@_implements(np.ravel)
def _ravel(a, order="C"):
    return a.ravel(order=order)


@_implements(np.squeeze)
def _squeeze(a, axis=None):
    return a.squeeze(axis=axis)


@_implements(np.swapaxes)
def _swapaxes(a, axis1, axis2):
    return a.swapaxes(axis1, axis2)


@_implements(np.count_nonzero)
def _count_nonzero(a, axis=None, keepdims=False):
    mask = (a != 0) if np.dtype(a.dtype) != np.bool_ else a
    return mask.astype(np.int64).sum(axis=_all_axes(a, axis),
                                     keepdims=_keepdims(keepdims))


@_implements(np.diff)
def _diff(a, n=1, axis=-1, prepend=_NV, append=_NV):
    _require_default(prepend=(prepend, _NV), append=(append, _NV))
    n = operator.index(n)
    if n < 0:
        raise ValueError("order must be non-negative but got %d" % n)
    axis = axis + a.ndim if axis < 0 else axis
    inshape(a.shape, (axis,))
    hi = tuple(slice(1, None) if i == axis else slice(None)
               for i in range(a.ndim))
    lo = tuple(slice(None, -1) if i == axis else slice(None)
               for i in range(a.ndim))
    boolean = np.dtype(a.dtype) == np.bool_
    out = a
    for _ in range(n):
        # numpy's bool diff is XOR (subtract rejects bool)
        out = (out[hi] != out[lo]) if boolean else out[hi] - out[lo]
    return out


@_implements(np.flip)
def _flip(m, axis=None):
    if axis is None:
        axes = tuple(range(m.ndim))
    else:
        axes = tuple(a + m.ndim if a < 0 else a for a in tupleize(axis))
        if len(set(axes)) != len(axes):
            raise ValueError("repeated axis")
        inshape(m.shape, axes)
    return m[tuple(slice(None, None, -1) if i in axes else slice(None)
                   for i in range(m.ndim))]


@_implements(np.moveaxis)
def _moveaxis(a, source, destination):
    src = [s + a.ndim if s < 0 else s for s in tupleize(source)]
    dst = [d + a.ndim if d < 0 else d for d in tupleize(destination)]
    if len(src) != len(dst):
        raise ValueError(
            "`source` and `destination` arguments must have the same "
            "number of elements")
    if len(set(src)) != len(src) or len(set(dst)) != len(dst):
        raise ValueError(
            "repeated axis in `source` or `destination` argument")
    inshape(a.shape, src)
    inshape(a.shape, dst)
    rest = [i for i in range(a.ndim) if i not in src]
    perm = [None] * a.ndim
    for s, d in zip(src, dst):
        perm[d] = s
    it = iter(rest)
    # a move that crosses the key/value boundary raises, like transpose
    return a.transpose(*[next(it) if p is None else p for p in perm])


@_implements(np.clip)
def _clip(a, a_min=_NV, a_max=_NV, out=None, min=_NV, max=_NV, **kw):
    _require_default(out=(out, None))
    if kw:
        raise _Fallback("clip kwargs")
    lo = a_min if a_min is not _NV else (min if min is not _NV else None)
    hi = a_max if a_max is not _NV else (max if max is not _NV else None)
    return a.clip(lo, hi)


@_implements(np.round)
def _round(a, decimals=0, out=None):
    _require_default(out=(out, None))
    return a.round(decimals)


@_implements(np.real)
def _real(val):
    return val.real


@_implements(np.imag)
def _imag(val):
    return val.imag


@_implements(np.diagonal)
def _diagonal(a, offset=0, axis1=0, axis2=1):
    return a.diagonal(offset, axis1, axis2)


@_implements(np.trace)
def _trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    _require_default(out=(out, None))
    return a.trace(offset, axis1, axis2, dtype=dtype)


def _tensor(anchor, x):
    """An operand as a tensor on ``anchor``'s device (a gpu bolt array's
    own tensor, another bolt array or host value copied once)."""
    from bolt_tpu_torch.base import BoltArray
    if isinstance(x, BoltArray) and not _is_gpu(x):
        x = np.asarray(x)
    return anchor._operand(x)


def _concat_many(first, others, axis):
    """Concatenate ``first`` with any number of operands in ONE engine
    program (``np.concatenate`` and ``np.append``): ``axis=None`` ravels
    every operand first, like numpy (the result gets the flat key axis);
    deferred chains on bolt operands run inside the program, host
    operands move to the card once."""
    parts = [first] + list(others)
    if axis is not None:
        axis = int(axis)
        for p in parts:
            if np.ndim(p) != first.ndim:
                raise ValueError("cannot concatenate %d-d with %d-d array"
                                 % (first.ndim, np.ndim(p)))
    new_split = first.split if axis is not None \
        else (1 if first.split else 0)

    def body(*ds):
        if axis is None:
            ds = [d.reshape(-1) for d in ds]
        return torch.cat(_promoted(*ds), 0 if axis is None else axis)

    # on a mesh: every operand laid out as the first with the joined axis
    # whole (axis=None ravels: every operand whole)
    return _device_fused("concat", parts, first, new_split, body, (axis,),
                         axes=WHOLE if axis is None else (axis,),
                         aligned=True)


@_implements(np.concatenate)
def _concatenate(arrays, axis=0, out=None, dtype=None, casting="same_kind"):
    _require_default(out=(out, None), dtype=(dtype, None))
    seq = list(arrays)
    if not seq:
        raise ValueError("need at least one array to concatenate")
    if not _is_gpu(seq[0]):
        raise _Fallback("first operand not on the card")
    return _concat_many(seq[0], seq[1:], axis)


@_implements(np.dot)
def _dot(a, b, out=None):
    _require_default(out=(out, None))
    if not _is_gpu(a):
        raise _Fallback("first operand not on the card")
    return a.dot(b)


@_implements(np.where)
def _where(condition, x=_NV, y=_NV):
    if (x is _NV) != (y is _NV):
        raise ValueError(
            "either both or neither of x and y should be given")
    if x is _NV:
        # the one-argument form is nonzero
        if not _is_gpu(condition):
            raise _Fallback("condition not on the card")
        return condition.nonzero()
    devs = [a for a in (condition, x, y) if _is_gpu(a)]
    if not devs:
        raise _Fallback("no card operand")
    # anchor on the operand with the most key axes; scalars ride in the
    # program, the array operands are box-local on a mesh
    b = max(devs, key=lambda a: a.split)
    scalar = [isinstance(v, (int, float, complex, bool)) for v in (x, y)]
    arrays = [condition] + [v for v, sc in zip((x, y), scalar) if not sc]
    shape = tuple(np.broadcast_shapes(*[np.shape(v) for v in
                                        (condition, x, y)]))
    split = b.split
    # keys survive only when no broadcast axis displaced them
    new_split = split if (len(shape) == b.ndim
                          and shape[:split] == b.shape[:split]) else 0

    def body(c, *rest):
        it = iter(rest)
        vals = [v if sc else next(it) for v, sc in zip((x, y), scalar)]
        return torch.where(c if c.dtype == torch.bool else c != 0, *vals)

    return _device_fused("where", arrays, b, new_split, body,
                         tuple((type(v).__name__, v) if sc else None
                               for v, sc in zip((x, y), scalar)), axes=())


@_implements(np.histogram)
def _histogram(a, bins=10, range=None, density=False, weights=None):
    _require_default(weights=(weights, None))
    if not isinstance(bins, (int, np.integer)):
        raise _Fallback("bin edges")        # array edges: host path
    from bolt_tpu_torch.ops import histogram
    return histogram(a, bins=bins, range=range, density=density)


def _static_bins(bins, d):
    """Per-dimension static int bin counts, or None (array edges take the
    host path)."""
    if isinstance(bins, (int, np.integer)):
        return (int(bins),) * d
    try:
        seq = list(bins)
    except TypeError:
        return None
    if len(seq) != d or not all(isinstance(v, (int, np.integer))
                                for v in seq):
        return None
    return tuple(int(v) for v in seq)


def _static_ranges(range):
    """Per-dimension ``(lo, hi)`` ranges; a per-dimension ``None`` entry
    (numpy-legal: use the data extrema) takes the host fallback."""
    if range is None:
        return None
    out = []
    for r in range:
        if r is None:
            raise _Fallback("per-dimension None range")
        out.append(tuple(float(v) for v in r))
    return tuple(out)


@_implements(np.histogram2d)
def _histogram2d(x, y, bins=10, range=None, density=None, weights=None):
    _require_default(weights=(weights, None))
    # numpy's eager contract: mismatched lengths are its ValueError, and
    # >1-d samples are not silently flattened
    if np.ndim(x) > 1 or np.ndim(y) > 1:
        raise _Fallback("non-1-d histogram2d samples")
    if np.size(x) != np.size(y):
        raise ValueError("x and y must have the same length.")
    bb = _static_bins(bins, 2)
    if bb is None:
        raise _Fallback("bin edges")
    devs = [a for a in (x, y) if _is_gpu(a)]
    if not devs:
        raise _Fallback("no card operand")
    from bolt_tpu_torch.ops.hist import histogramdd
    cols = [_tensor(devs[0], v).reshape(-1) for v in (x, y)]
    from bolt_tpu_torch.gpu import dtypes
    dt = dtypes.promote(cols[0].dtype, cols[1].dtype)
    h, (ex, ey) = histogramdd(torch.stack([c.to(dt) for c in cols], 1), bb,
                              _static_ranges(range), bool(density))
    # numpy returns float64 counts/densities and edges here
    return h.astype(np.float64), ex.astype(np.float64), \
        ey.astype(np.float64)


@_implements(np.histogramdd)
def _histogramdd(sample, bins=10, range=None, density=None, weights=None):
    _require_default(weights=(weights, None))
    _require_gpu(sample)
    if sample.ndim != 2:
        raise _Fallback("non-(N, D) sample")   # sequence-of-arrays form
    bb = _static_bins(bins, sample.shape[1])
    if bb is None:
        raise _Fallback("bin edges")
    from bolt_tpu_torch.ops.hist import histogramdd
    h, edges = histogramdd(_tensor(sample, sample), bb,
                           _static_ranges(range), bool(density))
    return h.astype(np.float64), [e.astype(np.float64) for e in edges]


@_implements(np.bincount)
def _bincount(a, weights=None, minlength=0):
    _require_default(weights=(weights, None))
    if a.ndim != 1:
        # numpy's rejection; ops.bincount flattens
        raise ValueError("object too deep for desired array")
    from bolt_tpu_torch.ops import bincount
    return bincount(a, minlength=minlength)


@_implements(np.split)
def _split_fn(ary, indices_or_sections, axis=0):
    return _do_split(ary, indices_or_sections, axis, strict=True)


@_implements(np.array_split)
def _array_split(ary, indices_or_sections, axis=0):
    return _do_split(ary, indices_or_sections, axis, strict=False)


def _do_split(ary, ios, axis, strict):
    """numpy's split semantics as basic slices through ``__getitem__``."""
    axis = int(axis)
    dim = ary.shape[axis]
    # numpy's own probe: an unsized value is a section count; sized values
    # are index lists whose entries must be true integers
    try:
        nidx = len(ios)
    except TypeError:
        nidx = None
    if nidx is None:
        k = int(ios)
        if k <= 0:
            raise ValueError("number sections must be larger than 0.")
        if strict and dim % k != 0:
            raise ValueError(
                "array split does not result in an equal division")
        base, extra = divmod(dim, k)
        bounds = np.cumsum([0] + [base + 1] * extra + [base] * (k - extra))
    else:
        bounds = [0] + [operator.index(i)
                        for i in np.asarray(ios).ravel().tolist()] + [dim]
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sl = [slice(None)] * ary.ndim
        sl[axis] = slice(int(lo), int(hi))
        out.append(ary[tuple(sl)])
    return out


@_implements(np.shape)
def _shape(a):
    return a.shape


@_implements(np.ndim)
def _ndim(a):
    return a.ndim


@_implements(np.size)
def _size(a, axis=None):
    return a.size if axis is None else a.shape[axis]


# ---------------------------------------------------------------------
# one engine program over mixed operands: the stack family, the layout
# expanders, the contractions and most of the families below
# ---------------------------------------------------------------------

def _device_fused(tag, operands, anchor, new_split, body, extra_key,
                  axes=None, keep=None, whole=(), aligned=False):
    """ONE engine program over ``operands`` computing ``body(*mapped)``:
    a bolt operand applies its deferred chain inside the program (its own
    chain stays intact), any other operand (numpy, a ``torch.Tensor``, a
    local bolt array) moves to ``anchor``'s device once.  ``extra_key``
    must carry every parameter ``body`` closes over: the program is keyed
    on ``(tag, device, new_split, extra_key)`` and each operand's (shape,
    dtype, chain, split), so a repeated call with the same geometry builds
    nothing new.

    ``new_split`` may be a TUPLE for a ``body`` returning that many
    outputs (decomposition-shaped ops): each output takes its own split
    and the call returns a tuple of bolt arrays.

    ``axes``, ``keep``, ``whole`` and ``aligned`` say which axes
    ``body`` touches, for an anchor on a mesh of several ranks
    (:func:`_mesh_fused`); one device ignores them.  A call site names
    its form: an anchor on several ranks refuses ``axes=None``."""
    if _multi(anchor):
        return _mesh_fused(tag, operands, anchor, new_split, body,
                           extra_key, axes, keep, whole, aligned)
    device = anchor.device
    datas, specs = [], []
    for op in operands:
        if _is_gpu(op):
            if op.device != device:
                raise ValueError(
                    "operands live on different devices (%s vs %s); move "
                    "one explicitly first" % (device, op.device))
            base, funcs = op._chain_parts()
            datas.append(base)
            specs.append((funcs, op.split))
        else:
            datas.append(_tensor(anchor, op))
            specs.append(((), None))
    specs = tuple(specs)

    def build():
        # the program closes over the chains and splits only, never a
        # tensor: a cached entry must not pin device memory
        def run(ds):
            return body(*[_chain_apply(f, s, d) if f else d
                          for d, (f, s) in zip(ds, specs)])
        return run

    key = (tag, device, new_split, extra_key,
           tuple((tuple(d.shape), str(d.dtype), f, s)
                 for d, (f, s) in zip(datas, specs)))
    out = _cached_jit(key, build)(datas)
    if isinstance(new_split, tuple):
        return tuple(BoltArrayGPU(o, s, device)
                     for o, s in zip(out, new_split))
    return BoltArrayGPU(out, new_split, device)


# ---------------------------------------------------------------------
# the mesh form (gpu/mesharray.py): one program a rank over the operands'
# boxes, each result laid out by ``key_spec`` of its shape and split (the
# reference's ``_constrain`` on the anchor's mesh)
# ---------------------------------------------------------------------

# ``_device_fused(..., axes=WHOLE)``: every operand gathered whole onto
# every rank (the costly form, which a call site must ask for by name)
WHOLE = "whole"


def _multi(a):
    """True for a bolt array on a mesh of more than one rank."""
    from bolt_tpu_torch.gpu.mesharray import on_mesh
    return on_mesh(a)


def _whole_of(anchor, op):
    """An operand whole on every rank's device: a mesh array gathered
    (one all_to_all), any other moved once."""
    from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
    if isinstance(op, BoltArrayMesh):
        return op._whole_tensor()
    return _tensor(anchor, op)


def _mesh_program(tag, form, anchor, new_split, body, extra_key, datas):
    """``body(*datas)`` as one engine program under the anchor mesh's key
    scope (keyed on the form and the operands' box shapes)."""
    def build():
        def run(ds):
            return body(*ds)
        return run

    key = (tag, form, anchor.device, new_split, extra_key,
           tuple((tuple(d.shape), str(d.dtype)) for d in datas))
    with anchor._scope():
        return _cached_jit(key, build)(datas)


def _mesh_fused(tag, operands, anchor, new_split, body, extra_key, axes,
                keep, whole, aligned):
    """:func:`_device_fused` with an anchor on a mesh of several ranks:
    each rank runs ``body`` once over its operands' boxes, in the form the
    axes it touches allow (every operand on another mesh raises the
    reference's ``different meshes`` error first):

    - ``axes=()``, box-local (an op per element): the anchor keeps its
      layout, an operand of the result's shape meets the anchor's box (a
      mesh array relaid to it, any other sliced), a broadcast one is
      sliced along its axes longer than one, and the operands at indices
      ``whole`` (bins, sample points, a test set) come whole;
    - ``axes`` a tuple: the anchor relaid so those axes are whole on every
      rank (``sharding.whole_spec``: one all_to_all, its transient checked
      by ``hbm_check``), every other operand whole, or (``aligned``, for
      an operand of the anchor's lengths off ``axes``: a concatenation's)
      laid out as the anchor; ``keep`` names, for
      each axis of the result, the anchor axis whose length and layout it
      keeps, or ``None`` for one whole on every rank (default: the
      anchor's axes, the touched ones whole);
    - ``axes=WHOLE`` (which every multi-output body takes): every
      operand whole on every rank, the result whole, each rank keeping
      its box.  A box-local call whose operands do not broadcast into
      the anchor takes this form too.

    ``axes=None`` (no form named) raises ``TypeError``, as does a
    multi-output body with another form: a call site that never chose
    fails on the CPU pods rather than gathering unseen.

    Every result moves to ``key_spec`` of its shape and split; every rank
    returns the same bits.  The shapes are global and known before any
    collective, so a shape error is raised on every rank alike."""
    for op in operands:
        if _is_gpu(op):
            _garray.check_mesh(anchor, op, tag)
    multi = isinstance(new_split, tuple)
    if axes is None or (multi and axes != WHOLE):
        raise TypeError("_device_fused(%r) names no mesh form for its %s: "
                        "pass axes=() (box-local), a tuple of touched axes "
                        "(relaid whole) or WHOLE"
                        % (tag, "outputs" if multi else "operands"))
    nd = anchor.ndim
    if axes == () and not _broadcasts_into(operands, anchor, whole):
        axes = WHOLE
    if axes != WHOLE:
        axes = tuple(sorted({a % nd for a in axes})) if nd else ()
        keep = list(keep) if keep is not None else [
            None if a in axes else a for a in range(nd)]
        src = anchor._whole(axes) if axes else anchor._ready()
        with src._scope():
            mine = src._local._mapped()
        datas = []
        for i, op in enumerate(operands):
            if op is anchor:
                datas.append(mine)
            elif not axes and i not in whole and np.ndim(op):
                datas.append(src._operand_box(op, src.shape, src._spec))
            elif aligned and np.ndim(op) == nd and all(
                    np.shape(op)[a] == src.shape[a]
                    for a in range(nd) if a not in axes):
                datas.append(_aligned_box(anchor, op, src, axes))
            else:
                datas.append(_whole_of(anchor, op))
        t = _mesh_program(tag, ("box", axes, tuple(keep), tuple(whole)),
                          src, new_split, body, extra_key, datas)
        spec = tuple(None if a is None else src._spec[a] for a in keep)
        shape = tuple(int(t.shape[j]) if e is None else src.shape[a]
                      for j, (a, e) in enumerate(zip(keep, spec)))
        return src._result(t, shape, new_split, spec)
    datas = [_whole_of(anchor, op) for op in operands]
    out = _mesh_program(tag, "whole", anchor, new_split, body, extra_key,
                        datas)
    if multi:
        return tuple(anchor._wrap(o, s) for o, s in zip(out, new_split))
    return anchor._wrap(out, new_split)


def _mesh_contract(tag, ops, terms, outl, out_shape, anchor, new_split,
                   body, extra_key):
    """A contraction on a mesh as a fold: the labels the anchor's layout
    shards keep its mesh axes on every operand (a mesh operand relaid to
    them, any other sliced to the anchor's box), each rank contracts its
    boxes, and the partials of the mesh axes that shard a contracted label
    are added in rank order (the same bits on every rank); the output
    keeps the anchor's layout of its labels.  ``terms``/``outl`` are the
    operands' and the output's labels (einsum's); returns None where the
    form does not apply (a repeated label, a broadcast one), and the caller
    takes the whole form."""
    from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
    from bolt_tpu_torch.parallel import multihost, sharding
    if any(len(set(t)) != len(t) or len(t) != np.ndim(o)
           for t, o in zip(terms, ops)):
        return None
    src = anchor._ready()
    aterm = terms[next(i for i, o in enumerate(ops) if o is anchor)]
    entry = {lab: e for lab, e in zip(aterm, src._spec) if e is not None}
    size = dict(zip(aterm, src.shape))
    for o, t in zip(ops, terms):
        if any(lab in entry and n != size[lab]
               for lab, n in zip(t, np.shape(o))):
            return None
    for o in ops:
        if _is_gpu(o):
            _garray.check_mesh(anchor, o, tag)
    span = dict(zip(aterm, src.box))
    datas = []
    for o, t in zip(ops, terms):
        spec = tuple(entry.get(lab) for lab in t)
        if o is anchor:
            with src._scope():
                datas.append(src._local._mapped())
        elif isinstance(o, BoltArrayMesh):
            datas.append((o if o._spec == spec else o._relaid(spec))._data)
        else:
            if not isinstance(o, torch.Tensor):
                o = np.asarray(o)
            datas.append(_tensor(anchor, o[tuple(
                slice(*span[lab]) if lab in entry else slice(None)
                for lab in t)]))
    part = _mesh_program(tag, ("fold", tuple(terms), outl), src, new_split,
                         body, extra_key, datas)
    folded = [entry[lab] for lab in entry if lab not in outl]
    if folded:
        names = tuple(n for e in folded for n in sharding.spec_names(e))
        part = multihost.fold_partials(part, lambda a, b: a + b,
                                       src._mesh.group(names))
    return src._result(part, out_shape, new_split,
                       tuple(entry.get(lab) for lab in outl))


def _aligned_box(anchor, op, src, axes):
    """This rank's part of ``op`` laid out as ``src`` (the anchor with
    ``axes`` whole; ``op`` of its lengths off ``axes``): a mesh array
    relaid to ``src``'s layout, any other sliced to ``src``'s box off
    ``axes``."""
    from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
    if isinstance(op, BoltArrayMesh):
        return (op if op._spec == src._spec else op._relaid(src._spec))._data
    if not isinstance(op, torch.Tensor):
        op = np.asarray(op)
    return _tensor(anchor, op[tuple(
        slice(None) if a in axes else slice(*lim)
        for a, lim in enumerate(src.box))])


def _broadcasts_into(operands, anchor, whole):
    """Whether every operand but those at ``whole`` broadcasts into the
    anchor's shape (the box-local form's result is the anchor's shape)."""
    try:
        return np.broadcast_shapes(*[np.shape(op) for i, op in
                                     enumerate(operands)
                                     if i not in whole]) == anchor.shape
    except ValueError:
        return False


def _tdtype(x):
    """The torch dtype an operand has, or takes once on the card."""
    if _is_gpu(x):
        return torch_dtype(x.dtype)
    if isinstance(x, torch.Tensor):
        return x.dtype
    dt = getattr(x, "dtype", None)
    return torch_dtype(np.dtype(dt) if dt is not None
                       else np.asarray(x).dtype)


def _aval_of(x):
    """A ``meta`` tensor of ``x``'s shape and dtype (the reference's
    ``jax.ShapeDtypeStruct``): shape inference runs the torch function on
    these and reads no data."""
    return torch.empty(np.shape(x), dtype=_tdtype(x), device="meta")


def _eval_shape(fn, *operands):
    """``fn``'s output shape on ``meta`` operands; torch's shape errors
    become numpy's ``ValueError`` (as the reference turns jax's
    ``TypeError``)."""
    try:
        return tuple(fn(*[_aval_of(o) for o in operands]).shape)
    except RuntimeError as e:
        raise ValueError(str(e)) from None


def _promoted(*ds):
    """The tensors ``ds`` cast to jnp's common dtype."""
    dt = ds[0].dtype
    for d in ds[1:]:
        dt = dtypes.promote(dt, d.dtype)
    return [d if d.dtype == dt else d.to(dt) for d in ds]


def _inexact(d):
    """``d`` widened as jnp's ``promote_dtypes_inexact`` widens it."""
    dt = dtypes.inexact(d.dtype)
    return d if d.dtype == dt else d.to(dt)


def _promoted_inexact(*ds):
    """jnp's ``promote_dtypes_inexact`` of several tensors: the common
    dtype, then widened (``f32`` with ``int64`` stays ``f32``)."""
    ds = _promoted(*ds)
    return [_inexact(d) for d in ds]


def _contract(fn, ds, mode):
    """``fn(*ds)`` of a matmul-class torch op on the promoted operands at
    ``mode``'s float32 matmul precision.  An integer contraction on a CUDA
    device (cuBLAS has none) runs in float64 and rounds back: exact while
    every partial sum stays under 2**53."""
    ds = _promoted(*ds)
    dt = ds[0].dtype
    if ds[0].device.type == "cuda" and not (dt.is_floating_point
                                            or dt.is_complex):
        out = fn(*[d.to(torch.float64) for d in ds])
        return torch.round(out).to(dt)
    with _precision.f32_matmul(mode):
        return fn(*ds)


# ---------------------------------------------------------------------
# layout expanders
# ---------------------------------------------------------------------

def _expand_device(a, axes):
    """Shared size-1-axis inserter (``expand_dims`` and the ``atleast_*``
    family): an axis inserted before the last key axis joins the keys, one
    inserted at or past the key/value boundary joins the values."""
    out_ndim = a.ndim + len(axes)
    norm = []
    for ax in axes:
        nx = ax + out_ndim if ax < 0 else ax
        if not 0 <= nx < out_ndim:
            raise np.exceptions.AxisError(ax, out_ndim)
        norm.append(nx)
    if len(set(norm)) != len(norm):
        raise ValueError("repeated axis in `axis` argument")
    ins = set(norm)
    shape, new_split, nxt = [], 0, iter(range(a.ndim))
    for p in range(out_ndim):
        if p in ins:
            shape.append(1)
        else:
            i = next(nxt)
            shape.append(a.shape[i])
            if i == a.split - 1:
                new_split = p + 1
    shape = tuple(shape)
    # each output axis: the source axis it keeps, or None (inserted)
    src = iter(range(a.ndim))
    keep = [None if p in ins else next(src) for p in range(out_ndim)]
    return _device_fused("expand_dims", [a], a, new_split,
                         lambda d: d.reshape(tuple(
                             1 if k is None else d.shape[k] for k in keep)),
                         (shape,), axes=(), keep=keep)


@_implements(np.expand_dims)
def _expand_dims(a, axis):
    _require_gpu(a)
    return _expand_device(a, tupleize(axis))


def _one_atleast(a, n):
    if not _is_gpu(a):
        return getattr(np, "atleast_%dd" % n)(np.asarray(a))
    if a.ndim >= n:
        return a
    # numpy's placement: atleast_2d prepends; atleast_3d gives a 1-d
    # array (1, n, 1) and a 2-d one a trailing axis
    if n == 3 and a.ndim == 2:
        axes = (2,)
    elif n == 3 and a.ndim == 1:
        axes = (0, 2)
    else:
        axes = tuple(range(n - a.ndim))
    return _expand_device(a, axes)


def _atleast(n):
    def handler(*arys):
        res = [_one_atleast(a, n) for a in arys]
        return res[0] if len(res) == 1 else res
    return handler


_TABLE[np.atleast_1d] = _atleast(1)
_TABLE[np.atleast_2d] = _atleast(2)
_TABLE[np.atleast_3d] = _atleast(3)


@_implements(np.broadcast_to)
def _broadcast_to(array, shape, subok=False):
    _require_gpu(array)
    shape = tuple(int(s) for s in tupleize(shape))
    try:
        out = np.broadcast_shapes(tuple(array.shape), shape)
    except ValueError:
        raise ValueError("cannot broadcast shape %s to %s"
                         % (str(tuple(array.shape)), str(shape))) from None
    if out != shape:
        # broadcast_to is one-directional: the target must BE the result
        raise ValueError("cannot broadcast shape %s to %s"
                         % (str(tuple(array.shape)), str(shape)))
    # prepended broadcast axes become leading key axes
    new_split = array.split + (len(shape) - array.ndim) if array.split \
        else 0
    # materialised, as jnp's result is: a stride-0 view would alias.  The
    # prepended axes and the stretched ones of length 1 take the target's
    # length; the others keep the operand's (its box on a mesh)
    off = len(shape) - array.ndim
    keep = [None if j < off or (array.shape[j - off] == 1 and shape[j] != 1)
            else j - off for j in range(len(shape))]
    return _device_fused("broadcast_to", [array], array, new_split,
                         lambda d: d.broadcast_to(tuple(
                             shape[j] if k is None else d.shape[k]
                             for j, k in enumerate(keep))).contiguous(),
                         (shape,), axes=(), keep=keep)


@_implements(np.tile)
def _tile(A, reps):
    _require_gpu(A)
    rep_t = tuple(max(operator.index(r), 0) for r in tupleize(reps))
    # reps longer than ndim prepends axes; they lead, so they join keys
    new_split = A.split + max(0, len(rep_t) - A.ndim) if A.split else 0
    return _device_fused("tile", [A], A, new_split,
                         lambda d: torch.tile(d, rep_t), (rep_t,), axes=WHOLE)


@_implements(np.roll)
def _roll(a, shift, axis=None):
    _require_gpu(a)
    sh_t = tuple(operator.index(s) for s in tupleize(shift))
    if axis is not None:
        ax_t = tuple(operator.index(x) for x in tupleize(axis))
        for x in ax_t:
            if not -a.ndim <= x < a.ndim:
                raise np.exceptions.AxisError(x, a.ndim)
    # an empty shift or axis tuple broadcasts to zero rolls: numpy returns
    # the array unchanged (as a copy)
    if len(sh_t) == 0 or (axis is not None and len(ax_t) == 0):
        return a._clone()
    if axis is None:
        if len(sh_t) != 1:
            raise _Fallback("vector shift with axis=None")
        sh_arg, ax_arg = sh_t[0], ()
    else:
        if len(sh_t) != len(ax_t) and len(sh_t) != 1 and len(ax_t) != 1:
            raise ValueError(
                "'shift' and 'axis' should be scalars or 1D sequences")
        # numpy broadcasts one against the other; rolls of one axis add
        n = max(len(sh_t), len(ax_t))
        sh_arg = sh_t * n if len(sh_t) == 1 else sh_t
        ax_arg = ax_t * n if len(ax_t) == 1 else ax_t
    return _device_fused("roll", [a], a, a.split,
                         lambda d: torch.roll(d, sh_arg, ax_arg),
                         (sh_arg, ax_arg), axes=ax_arg or WHOLE)


@_implements(np.rot90)
def _rot90(m, k=1, axes=(0, 1)):
    _require_gpu(m)
    axes = tuple(axes)
    if len(axes) != 2:
        raise ValueError("len(axes) must be 2.")
    a0 = axes[0] + m.ndim if axes[0] < 0 else axes[0]
    a1 = axes[1] + m.ndim if axes[1] < 0 else axes[1]
    if not (0 <= a0 < m.ndim and 0 <= a1 < m.ndim):
        raise ValueError("Axes=%s out of range for array of ndim=%d."
                         % (str(axes), m.ndim))
    if a0 == a1:
        raise ValueError("Axes must be different.")
    k = operator.index(k) % 4
    split = m.split
    if k % 2 and (a0 < split) != (a1 < split):
        # odd rotations transpose the two axes: the transpose rule, never
        # a silent move between keys and values
        raise ValueError(
            "rot90 may not move axes between keys and values; use swap "
            "(key axes: %s)" % str(tuple(range(split))))
    if k == 0:
        return m._clone()
    return _device_fused("rot90", [m], m, split,
                         lambda d: torch.rot90(d, k, (a0, a1)), (k, a0, a1),
                         axes=(a0, a1))


def _no_padding(pair, size, mode):
    if size == 0 and any(pair):
        raise ValueError("can't extend empty axis using modes other than "
                         "'constant' or 'empty' (mode %r)" % (mode,))


def _pad_constant(d, pairs, cv):
    """numpy's constant padding, one axis after another (so a corner takes
    the later axis's value); ``cv`` is ``(ndim, 2)`` values."""
    for i, (lo, hi) in enumerate(pairs):
        parts = []
        for w, v in ((lo, cv[i][0]), (hi, cv[i][1])):
            shape = list(d.shape)
            shape[i] = w
            parts.append(torch.tensor(v, device=d.device).to(d.dtype)
                         .expand(shape))
        if lo or hi:
            d = torch.cat([parts[0], d, parts[1]], i)
    return d


def _pad_wrap(d, pairs):
    for i, (lo, hi) in enumerate(pairs):
        size = d.shape[i]
        _no_padding((lo, hi), size, "wrap")
        if size == 0 or not (lo or hi):
            continue
        left_repeats, left_rem = divmod(lo, size)
        right_repeats, right_rem = divmod(hi, size)
        parts = []
        if left_rem:
            parts.append(d.narrow(i, size - left_rem, left_rem))
        parts += [d] * (left_repeats + right_repeats + 1)
        if right_rem:
            parts.append(d.narrow(i, 0, right_rem))
        d = torch.cat(parts, i)
    return d


def _pad_reflect(d, pairs, mode, reflect_type):
    """jnp's ``_pad_symmetric_or_reflect``: a pad wider than the axis
    reflects in rounds of at most the axis' size; ``odd`` mirrors each
    round about its current edge."""
    for i, (lo, hi) in enumerate(pairs):
        size = d.shape[i]
        _no_padding((lo, hi), size, mode)
        if size == 0 or not (lo or hi):
            continue
        offset = 1 if (mode == "reflect" and size > 1) else 0
        for padding, before in ((lo, True), (hi, False)):
            edge = d.narrow(i, 0, 1) if before else d.narrow(i, -1, 1)
            while padding > 0:
                cur = min(padding, size - offset)
                padding -= cur
                if before:
                    x = d.narrow(i, offset, cur)
                else:
                    stop = d.shape[i] - (0 if (mode == "symmetric"
                                               or size == 1) else 1)
                    x = d.narrow(i, stop - cur, cur)
                x = torch.flip(x, (i,))
                if reflect_type == "odd":
                    x = 2 * edge - x
                    if size > 1:
                        edge = x.narrow(i, 0, 1) if before \
                            else x.narrow(i, -1, 1)
                d = torch.cat([x, d] if before else [d, x], i)
    return d


def _pad_edge(d, pairs):
    for i, (lo, hi) in enumerate(pairs):
        size = d.shape[i]
        _no_padding((lo, hi), size, "edge")
        if size == 0 or not (lo or hi):
            continue
        parts = []
        for w, edge in ((lo, d.narrow(i, 0, 1)), (hi, d.narrow(i, -1, 1))):
            shape = list(d.shape)
            shape[i] = w
            parts.append(edge.expand(shape))
        d = torch.cat([parts[0], d, parts[1]], i)
    return d


@_implements(np.pad)
def _pad(array, pad_width, mode="constant", **kwargs):
    _require_gpu(array)
    allowed = {"constant": ("constant_values",), "edge": (),
               "reflect": ("reflect_type",), "symmetric": ("reflect_type",),
               "wrap": ()}
    if callable(mode) or mode not in allowed:
        raise _Fallback("mode")           # stat/ramp/callable: host path
    unsupported = set(kwargs) - set(allowed[mode])
    if unsupported:
        raise ValueError("unsupported keyword arguments for mode '%s': %s"
                         % (mode, unsupported))
    pw = np.asarray(pad_width)
    if not np.issubdtype(pw.dtype, np.integer):
        raise TypeError("`pad_width` must be of integral type.")
    try:
        pairs = tuple(tuple(int(v) for v in row)
                      for row in np.broadcast_to(pw, (array.ndim, 2)))
    except ValueError:
        raise ValueError(
            "operands could not be broadcast together with shapes %s (%d, 2)"
            % (str(pw.shape), array.ndim)) from None
    if any(v < 0 for row in pairs for v in row):
        raise ValueError("index can't contain negative values")
    if mode == "constant":
        cv = kwargs.get("constant_values", 0)
        cv_key = tuple(map(tuple, np.broadcast_to(
            np.asarray(cv), (array.ndim, 2)).tolist()))
        kw_key = ("cv", cv_key)

        def body(d):
            return _pad_constant(d, pairs, cv_key)
    elif mode in ("reflect", "symmetric"):
        rt = kwargs.get("reflect_type", "even")
        if rt not in ("even", "odd"):
            raise ValueError("unsupported reflect_type '%s'" % (rt,))
        kw_key = ("rt", rt)

        def body(d):
            return _pad_reflect(d, pairs, mode, rt)
    else:
        kw_key = ()

        def body(d):
            return _pad_wrap(d, pairs) if mode == "wrap" \
                else _pad_edge(d, pairs)
    if array.ndim == 0:
        return array._clone()
    return _device_fused("pad", [array], array, array.split, body,
                         (pairs, mode, kw_key),
                         axes=tuple(i for i, p in enumerate(pairs) if any(p)))


# ---------------------------------------------------------------------
# the stack family
# ---------------------------------------------------------------------

@_implements(np.stack)
def _stack(arrays, axis=0, out=None, dtype=None, casting="same_kind"):
    _require_default(out=(out, None), dtype=(dtype, None))
    if casting != "same_kind":
        raise _Fallback("casting")     # the host path keeps numpy's TypeError
    seq = list(arrays)
    if not seq:
        raise ValueError("need at least one array to stack")
    if not _is_gpu(seq[0]):
        raise _Fallback("first operand not on the card")
    a = seq[0]
    if len({np.shape(s) for s in seq}) != 1:
        raise ValueError("all input arrays must have the same shape")
    out_ndim = a.ndim + 1
    ax = axis + out_ndim if axis < 0 else axis
    if not 0 <= ax < out_ndim:
        raise np.exceptions.AxisError(axis, out_ndim)
    # the new axis joins whichever group it lands in
    new_split = a.split + 1 if ax < a.split else a.split
    # on a mesh each rank stacks its boxes (the new axis whole)
    return _device_fused("stack", seq, a, new_split,
                         lambda *ds: torch.stack(_promoted(*ds), ax), (ax,),
                         axes=(), keep=[j if j < ax else None if j == ax
                                        else j - 1 for j in range(out_ndim)])


def _stack_like(tag, tup, concat_axis, target_shape):
    """vstack/hstack/column_stack/dstack: per-operand reshape (decided
    from the host-known shapes) then ONE concatenate program.
    ``target_shape(shape) -> tuple | None`` (None = pass through)."""
    seq = list(tup)
    if not seq:
        raise ValueError("need at least one array to concatenate")
    if not _is_gpu(seq[0]):
        raise _Fallback("first operand not on the card")
    a = seq[0]
    targets = [target_shape(np.shape(s)) for s in seq]
    eff0 = targets[0] if targets[0] is not None else tuple(a.shape)
    effs = [t if t is not None else np.shape(s)
            for t, s in zip(targets, seq)]
    ax = concat_axis(effs)
    # numpy's cross-operand validation, its ValueError
    for i, e in enumerate(effs[1:], 1):
        if len(e) != len(effs[0]):
            raise ValueError(
                "all the input arrays must have same number of dimensions, "
                "but the array at index 0 has %d dimension(s) and the array "
                "at index %d has %d dimension(s)"
                % (len(effs[0]), i, len(e)))
        for d in range(len(effs[0])):
            if d != ax and e[d] != effs[0][d]:
                raise ValueError(
                    "all the input array dimensions except for the "
                    "concatenation axis must match exactly, but along "
                    "dimension %d, the array at index 0 has size %d and the "
                    "array at index %d has size %d"
                    % (d, effs[0][d], i, e[d]))
    # an anchor reshaped up to 2-d/3-d keys its leading axis; one passed
    # through keeps its own split
    new_split = a.split if targets[0] is None else (
        1 if len(eff0) >= 2 else a.split)
    targets = tuple(targets)

    def body(*ds):
        parts = [d if t is None else d.reshape(t)
                 for d, t in zip(ds, targets)]
        return torch.cat(_promoted(*parts), ax)

    # on a mesh, operands that need no reshape are concatenated as
    # np.concatenate's (laid out as the first, the joined axis whole)
    flat = all(t is None for t in targets)
    return _device_fused(tag, seq, a, new_split, body, (ax, targets),
                         axes=(ax,) if flat else None, aligned=True)


@_implements(np.vstack)
def _vstack(tup, *, dtype=None, casting="same_kind"):
    _require_default(dtype=(dtype, None))
    if casting != "same_kind":
        raise _Fallback("casting")

    def target(sh):
        if len(sh) == 0:
            return (1, 1)
        if len(sh) == 1:
            return (1, sh[0])
        return None

    return _stack_like("vstack", tup, lambda effs: 0, target)


@_implements(np.hstack)
def _hstack(tup, *, dtype=None, casting="same_kind"):
    _require_default(dtype=(dtype, None))
    if casting != "same_kind":
        raise _Fallback("casting")

    def target(sh):
        return (1,) if len(sh) == 0 else None

    # numpy decides the axis from the FIRST array alone
    return _stack_like("hstack", tup,
                       lambda effs: 0 if len(effs[0]) == 1 else 1, target)


@_implements(np.column_stack)
def _column_stack(tup):
    def target(sh):
        if len(sh) == 0:
            return (1, 1)
        if len(sh) == 1:
            return (sh[0], 1)
        return None

    return _stack_like("column_stack", tup, lambda effs: 1, target)


@_implements(np.dstack)
def _dstack(tup):
    def target(sh):
        if len(sh) == 0:
            return (1, 1, 1)
        if len(sh) == 1:
            return (1, sh[0], 1)
        if len(sh) == 2:
            return sh + (1,)
        return None

    return _stack_like("dstack", tup, lambda effs: 2, target)


@_implements(np.append)
def _append(arr, values, axis=None):
    _require_gpu(arr)
    # numpy: axis=None ravels both operands
    return _concat_many(arr, [values], axis)


# ---------------------------------------------------------------------
# contractions (the precision policy of `@` and `dot`: full f32 at
# "highest", TF32 under a "high" or "default" scope; the mode is part of
# the program key)
# ---------------------------------------------------------------------

def _expand_einsum_ellipsis(subs, shapes):
    """Rewrite ``...`` into explicit (upper-case, unused) labels with
    numpy's semantics: per-operand ellipsis dims align RIGHT against the
    widest, and in implicit mode the broadcast labels lead the output.
    Returns an explicit ``in->out`` string."""
    ins, arrow, out = subs.partition("->")
    terms = ins.split(",")
    if len(terms) != len(shapes):
        raise _Fallback("operand count mismatch")
    widths = []
    for t, sh in zip(terms, shapes):
        if "..." in t:
            if t.count("...") > 1:
                raise _Fallback("multiple ellipses in one term")
            k = len(sh) - (len(t) - 3)
            if k < 0:
                raise _Fallback("ellipsis width")   # the host raises exactly
            widths.append(k)
        else:
            widths.append(0)
    bmax = max(widths) if widths else 0
    used = set(subs)
    pool = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in used]
    if len(pool) < bmax:
        raise _Fallback("too many broadcast dims")
    ell = "".join(pool[:bmax])
    new_terms = [t.replace("...", ell[bmax - w:]) if "..." in t else t
                 for t, w in zip(terms, widths)]
    if arrow and "..." not in out and bmax > 0:
        # numpy: an explicit output (even an EMPTY one) must carry '...'
        # when broadcast dims exist; the host path raises its exact error
        raise _Fallback("output missing ellipsis")
    if out:
        new_out = out.replace("...", ell)
    elif arrow:
        new_out = ell                       # explicit empty output
    else:
        cnt = Counter(c for t in new_terms for c in t if c not in ell)
        new_out = ell + "".join(sorted(c for c in cnt if cnt[c] == 1))
    return ",".join(new_terms) + "->" + new_out


# the labels of a contraction written as einsum's (tensordot, inner)
_LABELS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _contraction_anchor(*ops):
    anchor = None
    for o in ops:
        if _is_gpu(o) and (anchor is None or o.split > anchor.split):
            anchor = o
    if anchor is None:
        raise _Fallback("no card operand")
    return anchor


@_implements(np.einsum)
def _einsum(*operands, out=None, optimize=False, **kwargs):
    _require_default(out=(out, None), dtype=(kwargs.pop("dtype", None), None))
    if kwargs.pop("order", "K") not in ("K", "C"):
        raise _Fallback("order")
    if kwargs.pop("casting", "safe") != "safe":
        raise _Fallback("casting")
    if kwargs:
        raise _Fallback("einsum kwargs")
    if not operands or not isinstance(operands[0], str):
        raise _Fallback("interleaved einsum form")
    subs = operands[0].replace(" ", "")
    ops = list(operands[1:])
    if "..." in subs:
        subs = _expand_einsum_ellipsis(subs, [np.shape(o) for o in ops])
    anchor = _contraction_anchor(*ops)
    ins = subs.split("->")[0]
    terms = ins.split(",")
    if len(terms) != len(ops):
        raise _Fallback("operand count mismatch")   # the host raises exactly
    if "->" in subs:
        outl = subs.split("->")[1]
    else:
        cnt = Counter(c for c in ins if c != ",")
        outl = "".join(sorted(c for c in cnt if cnt[c] == 1))
        subs = ins + "->" + outl                     # numpy's implicit output
    out_shape = _eval_shape(lambda *xs: torch.einsum(subs, *_promoted(*xs)),
                            *ops)
    aidx = next(i for i, o in enumerate(ops) if o is anchor)
    term, split = terms[aidx], anchor.split
    # keys survive when the anchor's key labels still lead the output, are
    # not diagonalised within the anchor, and keep their sizes
    new_split = split if (
        len(term) == anchor.ndim
        and len(set(term[:split])) == split
        and outl[:split] == term[:split]
        and out_shape[:split] == tuple(anchor.shape[:split])
    ) else 0
    pr = _precision.resolve()

    def body(*ds):
        return _contract(lambda *xs: torch.einsum(subs, *xs), ds, pr)

    if _multi(anchor):
        out = _mesh_contract("einsum", ops, terms, outl, out_shape, anchor,
                             new_split, body, (subs, pr))
        if out is not None:
            return out
    return _device_fused("einsum", ops, anchor, new_split, body, (subs, pr),
                         axes=WHOLE)


@_implements(np.tensordot)
def _tensordot(a, b, axes=2):
    anchor = _contraction_anchor(a, b)
    try:
        k = operator.index(axes)
        ax_a = tuple(range(np.ndim(a) - k, np.ndim(a)))
        ax_b = tuple(range(k))
    except TypeError:
        axes_a, axes_b = axes
        ax_a = tuple(operator.index(x) for x in tupleize(axes_a))
        ax_b = tuple(operator.index(x) for x in tupleize(axes_b))
    if len(ax_a) != len(ax_b):
        raise ValueError("shape-mismatch for sum")
    dims = ([x % max(np.ndim(a), 1) for x in ax_a],
            [x % max(np.ndim(b), 1) for x in ax_b])

    def td(x, y):
        return torch.tensordot(x, y, dims=dims)

    out_shape = _eval_shape(lambda x, y: td(*_promoted(x, y)), a, b)
    new_split = 0
    if anchor is a:
        pa = tuple(x + a.ndim if x < 0 else x for x in ax_a)
        if all(x >= a.split for x in pa) and \
                out_shape[:a.split] == tuple(a.shape[:a.split]):
            new_split = a.split
    pr = _precision.resolve()

    def body(x, y):
        return _contract(td, (x, y), pr)

    if _multi(anchor):
        la = _LABELS[:np.ndim(a)]
        lb = list(_LABELS[np.ndim(a):np.ndim(a) + np.ndim(b)])
        for i, j in zip(*dims):
            lb[j] = la[i]
        lb = "".join(lb)
        outl = "".join(c for i, c in enumerate(la) if i not in dims[0]) + \
            "".join(c for j, c in enumerate(lb) if j not in dims[1])
        out = _mesh_contract("tensordot", [a, b], [la, lb], outl, out_shape,
                             anchor, new_split, body, (ax_a, ax_b, pr))
        if out is not None:
            return out
    return _device_fused("tensordot", [a, b], anchor, new_split, body,
                         (ax_a, ax_b, pr), axes=WHOLE)


@_implements(np.inner)
def _inner(a, b):
    anchor = _contraction_anchor(a, b)
    out_shape = _eval_shape(lambda x, y: torch.inner(*_promoted(x, y)), a, b)
    new_split = 0
    if anchor is a:
        cap = min(a.split, max(a.ndim - 1, 0))
        if out_shape[:cap] == tuple(a.shape[:cap]):
            new_split = cap
    pr = _precision.resolve()

    def body(x, y):
        return _contract(torch.inner, (x, y), pr)

    if _multi(anchor) and np.ndim(a) and np.ndim(b):
        la = _LABELS[:np.ndim(a)]
        lb = _LABELS[np.ndim(a):np.ndim(a) + np.ndim(b) - 1] + la[-1]
        out = _mesh_contract("inner", [a, b], [la, lb],
                             la[:-1] + lb[:-1], out_shape, anchor,
                             new_split, body, (pr,))
        if out is not None:
            return out
    return _device_fused("inner", [a, b], anchor, new_split, body, (pr,),
                         axes=WHOLE)


@_implements(np.outer)
def _outer(a, b, out=None):
    _require_default(out=(out, None))
    anchor = _contraction_anchor(a, b)
    new_split = 1 if (anchor is a and a.split >= 1) else 0

    def body(x, y):
        x, y = _promoted(x, y)
        return x.reshape(-1, 1) * y.reshape(1, -1)

    return _device_fused("outer", [a, b], anchor, new_split, body, (),
                         axes=WHOLE)


# ---------------------------------------------------------------------
# statistics over samples x features (ops.linalg's blocked Gram programs)
# ---------------------------------------------------------------------

@_implements(np.cov)
def _cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
         aweights=None, *, dtype=None):
    _require_default(y=(y, None), fweights=(fweights, None),
                     aweights=(aweights, None), dtype=(dtype, None))
    _require_gpu(m)
    if m.ndim > 2:
        raise ValueError("m has more than 2 dimensions")
    if m.ndim == 0:
        raise _Fallback("0-d")             # numpy warns and returns nan
    if ddof is not None and ddof != int(ddof):
        raise ValueError("ddof must be integer")
    ddof = (0 if bias else 1) if ddof is None else int(ddof)
    sample_axis = 0 if (m.ndim == 1 or not rowvar) else 1
    if m.shape[sample_axis] - ddof <= 0:
        raise _Fallback("non-positive dof")  # the host path keeps the warning
    from bolt_tpu_torch.ops import cov
    c = cov(m, axis=(sample_axis,), ddof=ddof)
    return c.reshape(()) if m.ndim == 1 else c


@_implements(np.corrcoef)
def _corrcoef(x, y=None, rowvar=True, bias=_NV, ddof=_NV, *, dtype=None):
    # bias/ddof are accepted and ignored, as numpy does
    _require_default(y=(y, None), dtype=(dtype, None))
    _require_gpu(x)
    if x.ndim > 2:
        raise ValueError("m has more than 2 dimensions")
    if x.ndim == 0:
        raise _Fallback("0-d")
    sample_axis = 0 if (x.ndim == 1 or not rowvar) else 1
    if x.shape[sample_axis] < 2:
        raise _Fallback("too few samples")   # the host path keeps the warning
    from bolt_tpu_torch.ops import corrcoef
    r = corrcoef(x, axis=(sample_axis,))
    # numpy clips the real and imaginary parts into [-1, 1] separately
    if np.iscomplexobj(r):
        r = np.clip(r.real, -1, 1) + 1j * np.clip(r.imag, -1, 1)
    else:
        r = np.clip(r, -1, 1)
    return r.reshape(()) if x.ndim == 1 else r


@_implements(np.copy)
def _copy(a, order="K", subok=False):
    if order not in ("K", "C"):
        raise _Fallback("order")
    return a._clone()


# ---------------------------------------------------------------------
# nan-aware reductions, norms and sampling helpers
# ---------------------------------------------------------------------

def _axis_reduced_split(a, axes, keepdims):
    """The reduction split rule of the stat terminals: ``keepdims`` keeps
    every key axis; otherwise reduced key axes drop and the survivors stay
    leading.  ``axes`` must already be normalised to non-negative ints
    (``_all_axes`` output)."""
    if keepdims:
        return a.split
    norm = {ax + a.ndim if ax < 0 else ax
            for ax in (axes if isinstance(axes, (tuple, list, set))
                       else (axes,))}
    return a.split - sum(1 for i in range(a.split) if i in norm)


def _dims(ndim, axes):
    """``axes`` (an int or a sequence, negatives allowed) as a sorted
    tuple of non-negative axes, numpy's errors on a repeat or a miss."""
    out = []
    for ax in tupleize(axes):
        ax = operator.index(ax)
        if not -ndim <= ax < ndim:
            raise np.exceptions.AxisError(ax, ndim)
        out.append(ax % ndim)
    if len(set(out)) != len(out):
        raise ValueError("duplicate value in 'axis'")
    return tuple(sorted(out))


_NAN_FILL = {"nansum": 0, "nanprod": 1, "nanmin": np.inf,
             "nanmax": -np.inf}


def _nansum(x, dims, kd):
    if x.is_complex():
        return torch.where(torch.isnan(x), 0, x).sum(dims, keepdim=kd)
    return torch.nansum(x, dims, keepdim=kd)


def _nan_partial(name, x, dims):
    """The nan reduction ``name`` of the floating tensor ``x`` over
    ``dims`` as a partial that :func:`_nan_fold` joins with another
    block's and :func:`_nan_final` finishes: NaNs take the reduction's
    identity; ``nanmin``/``nanmax`` carry whether a slice is all NaN,
    ``nanmean`` the count of numbers and their sum, ``nanvar``/``nanstd``
    the count, the mean (0 for an all-NaN slice) and the summed squared
    deviations, as jnp's two-pass ``nanvar`` computes them."""
    if name == "nansum":
        return _nansum(x, dims, False)
    nan = torch.isnan(x)
    if name in _NAN_FILL:
        fill = torch.tensor(_NAN_FILL[name], dtype=x.dtype, device=x.device)
        out = _reduce_stat(torch.where(nan, fill, x), name[3:], dims, False,
                           None, numpy_dtype(x.dtype))
        return out if name == "nanprod" else (out, nan.all(dims))
    x = x.to(_wide(dtypes.stat_dtype(name[3:], x.dtype)))
    cnt = (~nan).sum(dims, keepdim=True)
    s = _nansum(x, dims, True)
    rshape = [n for i, n in enumerate(s.shape) if i not in dims]
    if name == "nanmean":
        return cnt.reshape(rshape), s.reshape(rshape)
    mean = s / cnt.clamp(min=1)
    c = torch.where(nan, torch.zeros((), dtype=x.dtype, device=x.device),
                    x - mean)
    del x
    c = (c.real * c.real + c.imag * c.imag) if c.is_complex() else c.mul_(c)
    return cnt.reshape(rshape), mean.reshape(rshape), c.sum(dims)


def _nan_fold(name, a, b):
    """Two blocks' partials of ``name`` as one (``nanvar``/``nanstd`` by
    Chan's pairwise combine, safe where a side counted nothing)."""
    if name == "nansum":
        return a + b
    if name == "nanprod":
        return a * b
    if name in ("nanmin", "nanmax"):
        op = torch.minimum if name == "nanmin" else torch.maximum
        return op(a[0], b[0]), a[1] & b[1]
    if name == "nanmean":
        return a[0] + b[0], a[1] + b[1]
    (na, ma, qa), (nb, mb, qb) = a, b
    n = na + nb
    w = nb.to(qa.dtype) / n.clamp(min=1).to(qa.dtype)
    d = mb - ma
    d2 = d.real * d.real + d.imag * d.imag if d.is_complex() else d * d
    return n, ma + d * w, qa + qb + d2 * (na.to(qa.dtype) * w)


def _nan_final(name, acc, ddof, dtype):
    """The nan reduction ``name`` of torch ``dtype`` data from its folded
    partial: an all-NaN slice of ``nanmin``/``nanmax`` is NaN, and
    ``nanvar``/``nanstd`` are NaN where the count of numbers is at most
    ``ddof``."""
    out_dt = dtypes.stat_dtype(name[3:], dtype)
    if name in ("nanmin", "nanmax"):
        acc = torch.where(acc[1], torch.tensor(np.nan, dtype=acc[0].dtype,
                                               device=acc[0].device), acc[0])
    elif name == "nanmean":
        acc = acc[1] / acc[0]
    elif name in ("nanvar", "nanstd"):
        m2 = acc[2]
        norm = (acc[0] - ddof).to(m2.dtype)
        bad = norm <= 0
        acc = torch.where(bad, torch.tensor(np.nan, dtype=m2.dtype,
                                            device=m2.device),
                          m2) / torch.where(bad, torch.ones_like(norm), norm)
        if name == "nanstd":
            acc = torch.sqrt(acc)
    return acc.to(out_dt)


def _nan_reduce(name, x, dims, kd, ddof):
    """jnp's ``name`` (``nansum`` ... ``nanstd``) of the tensor ``x`` over
    ``dims``: the whole tensor as one block.  Integer and bool data hold
    no NaN: the plain reductions with jnp's dtypes."""
    if not dims:
        # numpy reduces nothing over axis=(); torch reads dim=() as "all"
        x, dims, kd = x.unsqueeze(0), (0,), False
    if not (x.is_floating_point() or x.is_complex()):
        return _reduce_stat(x, name[3:], dims, kd, ddof,
                            numpy_dtype(x.dtype))
    out = _nan_final(name, _nan_partial(name, x, dims), ddof, x.dtype)
    if kd:
        out = out.reshape([1 if i in dims else n
                           for i, n in enumerate(x.shape)])
    return out


def _nan_blocked(name, base, funcs, split, shape, dtype, dims, ddof):
    """The nan reduction ``name`` over ``dims`` (every key axis among
    them) of the chain ``funcs`` over ``base``, folding block partials so
    the mapped tensor is never written.  Its blocks are a quarter of
    ``gpu/array.py :: _BLOCK_BYTES``: a partial holds about three
    block-sized temporaries beside its block (the NaN mask, the centred
    values, their squares), and the pass must stay near one block of
    growth."""
    rec = _chain_rec_bytes(base, split, shape, dtype)
    per = max(1, (_garray._BLOCK_BYTES // 4) // max(1, rec))
    bdims = (0,) + tuple(a - split + 1 for a in dims if a >= split)
    acc = None
    for _, _, recs in _chain_blocks(base, funcs, split, per):
        p = _nan_partial(name, recs, bdims)
        del recs
        acc = p if acc is None else _nan_fold(name, acc, p)
    return _nan_final(name, acc, ddof, torch_dtype(dtype))


def _nan_reduce_common(name, a, axis, dtype, out, keepdims, ddof, kw):
    _require_default(out=(out, None), dtype=(dtype, None),
                     initial=(kw.pop("initial", _NV), _NV),
                     where=(kw.pop("where", _NV), _NV),
                     mean=(kw.pop("mean", _NV), _NV))
    correction = kw.pop("correction", _NV)
    if kw:
        raise _Fallback("%s kwargs" % name)
    if correction is not _NV:
        if ddof != 0:
            raise ValueError("can't specify both correction and ddof")
        ddof = correction
    _require_gpu(a)
    ax = _all_axes(a, axis)
    dims = _dims(a.ndim, ax) if a.ndim else ()
    kd = _keepdims(keepdims)
    new_split = _axis_reduced_split(a, ax, kd)
    oshape = tuple(1 if i in dims else s for i, s in enumerate(a.shape)) \
        if kd else tuple(s for i, s in enumerate(a.shape) if i not in dims)
    if _multi(a):
        return _mesh_nan_reduce(name, a, dims, kd, ddof, new_split, oshape)
    if a.deferred and set(range(a.split)) <= set(dims) and \
            np.issubdtype(a.dtype, np.floating):
        base, funcs = a._chain_parts()
        split, shape, vdt = a.split, a.shape, a.dtype

        def build():
            def run(ds):
                return _nan_blocked(name, ds[0], funcs, split, shape, vdt,
                                    dims, ddof).reshape(oshape)
            return run

        key = (name, a.device, new_split, (dims, kd, ddof, "blocks"),
               ((tuple(base.shape), str(base.dtype), funcs, split),))
        return BoltArrayGPU(_cached_jit(key, build)([base]), new_split,
                            a.device)
    return _device_fused(name, [a], a, new_split,
                         lambda d: _nan_reduce(name, d, dims, kd, ddof),
                         (dims, kd, ddof), axes=WHOLE)


def _mesh_nan_reduce(name, a, dims, kd, ddof, new_split, oshape):
    """A nan reduction on a mesh: of floating data over sharded axes, a
    fold (each rank's :func:`_nan_partial` of its box, the partials of the
    mesh axes that shard ``dims`` joined by :func:`_nan_fold` in rank
    order, then :func:`_nan_final`); else on a layout where ``dims`` are
    whole."""
    from bolt_tpu_torch.parallel import multihost, sharding
    keep = _kept(a.ndim, dims, kd)
    maxes = sharding.shard_axes(a._spec, dims) if dims else ()
    if not maxes or not np.issubdtype(a.dtype, np.inexact):
        return _device_fused(name, [a], a, new_split,
                             lambda d: _nan_reduce(name, d, dims, kd, ddof),
                             (dims, kd, ddof), axes=dims, keep=keep)
    src = a._ready()
    with src._scope():
        part = _nan_partial(name, src._local._mapped(), dims)
    acc = multihost.fold_partials(part, lambda x, y: _nan_fold(name, x, y),
                                  src._mesh.group(maxes))
    out = _nan_final(name, acc, ddof, torch_dtype(a.dtype))
    spec = tuple(None if k is None else src._spec[k] for k in keep)
    if kd:
        out = out.reshape([1 if i in dims else n
                           for i, n in enumerate(src._local.shape)])
    return src._result(out, oshape, new_split, spec)


def _nan_reduction(name):
    # numpy's positional order puts keepdims 5th for the plain reductions
    # but ddof 5th for nanvar/nanstd: the signatures must match or a
    # positional ddof would bind to keepdims
    if name in ("nanvar", "nanstd"):
        def handler(a, axis=None, dtype=None, out=None, ddof=0,
                    keepdims=_NV, **kw):
            return _nan_reduce_common(name, a, axis, dtype, out, keepdims,
                                      ddof, kw)
    else:
        def handler(a, axis=None, dtype=None, out=None, keepdims=_NV,
                    **kw):
            return _nan_reduce_common(name, a, axis, dtype, out, keepdims,
                                      0, kw)
    return handler


for _name in ("nansum", "nanprod", "nanmean", "nanvar", "nanstd",
              "nanmin", "nanmax"):
    _TABLE[getattr(np, _name)] = _nan_reduction(_name)


def _kept(ndim, dims, kd):
    """The source axis each axis of a reduction over ``dims`` keeps (the
    ``keep`` of :func:`_mesh_fused`): ``None`` for a reduced axis kept at
    length one."""
    return [None if i in dims else i for i in range(ndim)] if kd else \
        [i for i in range(ndim) if i not in dims]


def _nanquantile_of(x, q, dims, keepdims, method):
    """jnp's ``nanquantile`` of ``x`` (already float) at the 1-d tensor
    ``q`` over ``dims``: each slice sorted with its NaNs last, the two
    order statistics around ``q * (count - 1)`` of its numbers weighted as
    jnp weighs them; an all-NaN slice gives NaN.  The q axis leads."""
    keep = [i for i in range(x.ndim) if i not in dims]
    kshape = [x.shape[i] for i in keep]
    s = torch.sort(x.permute(keep + list(dims)).reshape(kshape + [-1]),
                   dim=-1).values
    counts = (~torch.isnan(s)).sum(-1).to(q.dtype)
    qt = q.reshape((-1,) + (1,) * len(kshape)) * (counts - 1)
    low, high = torch.floor(qt), torch.ceil(qt)
    hw = qt - low
    lw = 1 - hw
    top = counts - 1
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, top))
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, top))
    sq = s.unsqueeze(0).expand((q.shape[0],) + tuple(s.shape))
    lo = torch.gather(sq, -1, low.long().unsqueeze(-1)).squeeze(-1)
    hi = torch.gather(sq, -1, high.long().unsqueeze(-1)).squeeze(-1)
    if method == "linear":
        out = lo * lw + hi * hw
    elif method == "lower":
        out = lo
    elif method == "higher":
        out = hi
    elif method == "nearest":
        out = torch.where(hw <= 0.5, lo, hi)
    else:
        out = (lo + hi) * 0.5
    if keepdims:
        out = out.reshape((q.shape[0],) + tuple(
            1 if i in dims else x.shape[i] for i in range(x.ndim)))
    return out.to(x.dtype)


def _nanquantile_body(dims, kd, method, scalar_q):
    def body(d, qv):
        xf = d.to(dtypes.promote(d.dtype, torch.float32))
        if xf.is_complex():
            raise ValueError("quantile does not support complex input")
        out = _nanquantile_of(xf, qv.reshape(-1).to(xf.dtype), dims, kd,
                              method)
        return out[0] if scalar_q else out
    return body


@_implements(np.nanmedian)
def _nanmedian(a, axis=None, out=None, overwrite_input=False,
               keepdims=_NV):
    _require_default(out=(out, None))
    _require_gpu(a)
    ax, kd = _all_axes(a, axis), _keepdims(keepdims)
    dims = _dims(a.ndim, ax) if a.ndim else ()
    body = _nanquantile_body(dims, kd, "linear", True)
    return _device_fused("nanmedian", [a, np.asarray(0.5)], a,
                         _axis_reduced_split(a, ax, kd), body, (dims, kd),
                         axes=dims, keep=_kept(a.ndim, dims, kd))


@_implements(np.nanquantile)
def _nanquantile(a, q, axis=None, out=None, overwrite_input=False,
                 method="linear", keepdims=_NV, weights=None,
                 interpolation=None):
    _require_default(out=(out, None), weights=(weights, None),
                     interpolation=(interpolation, None))
    if method not in ("linear", "lower", "higher", "midpoint", "nearest"):
        raise _Fallback("method")
    _require_gpu(a)
    qarr = check_q(q)                  # the shared scalar/1-d contract
    scalar_q = qarr.ndim == 0
    ax, kd = _all_axes(a, axis), _keepdims(keepdims)
    dims = _dims(a.ndim, ax) if a.ndim else ()
    # q is an OPERAND: sweeping many quantiles reuses one program per
    # q-shape.  A vector q prepends a flat KEY axis, the quantile-method
    # convention, ahead of the surviving key axes
    new_split = _axis_reduced_split(a, ax, kd) + (0 if scalar_q else 1)
    return _device_fused("nanquantile", [a, np.asarray(qarr, np.float64)],
                         a, new_split,
                         _nanquantile_body(dims, kd, method, scalar_q),
                         (dims, kd, method), axes=dims,
                         keep=([] if scalar_q else [None])
                         + _kept(a.ndim, dims, kd))


@_implements(np.linalg.norm)
def _linalg_norm(x, ord=None, axis=None, keepdims=False):
    _require_gpu(x)
    ax = None if axis is None else tuple(int(v) for v in tupleize(axis))
    if ax is not None and len(ax) == 1:
        ax = ax[0]
    kd = bool(keepdims)
    reduced = tuple(range(x.ndim)) if ax is None else (
        (ax,) if np.isscalar(ax) else ax)

    def body(d):
        return torch.linalg.norm(_inexact(d), ord=ord, dim=ax, keepdim=kd)

    dims = tuple(sorted(r % x.ndim for r in reduced)) if x.ndim else ()
    return _device_fused("linalg_norm", [x], x,
                         _axis_reduced_split(x, reduced, kd), body,
                         (str(ord), ax, kd), axes=dims,
                         keep=_kept(x.ndim, dims, kd))


@_implements(np.average)
def _average(a, axis=None, weights=None, returned=False, *, keepdims=_NV):
    _require_gpu(a)
    ax = _all_axes(a, axis)
    kd = _keepdims(keepdims)
    if weights is None:
        avg = a.mean(axis=ax, keepdims=kd)
        if not returned:
            return avg
        n = 1
        for i in (range(a.ndim) if axis is None else
                  [axis] if np.isscalar(axis) else axis):
            n *= a.shape[i]
        # numpy returns the sum of weights broadcast to the result shape
        scl = np.broadcast_to(np.asarray(float(n), avg.dtype),
                              avg.shape).copy()
        return avg, scl
    if _is_gpu(weights):
        raise _Fallback("bolt weights")    # the host path handles mixed
    w = np.asarray(weights)
    if w.shape == tuple(a.shape):
        wb = w
    elif w.ndim == 1 and axis is not None and np.isscalar(axis):
        axn = axis + a.ndim if axis < 0 else axis
        if w.shape[0] != a.shape[axn]:
            raise ValueError(
                "Length of weights not compatible with specified axis.")
        shape = [1] * a.ndim
        shape[axn] = w.shape[0]
        wb = w.reshape(shape)
    else:
        raise _Fallback("weights shape")
    scl_full = np.broadcast_to(wb, tuple(a.shape)).sum(
        axis=None if axis is None else ax, keepdims=kd)
    if np.any(scl_full == 0):
        raise ZeroDivisionError("Weights sum to zero, can't be normalized")
    dims = _dims(a.ndim, ax)

    def body(d, wj):
        d, wj = _promoted(d, wj)
        num = (d * wj).sum(dims, keepdim=kd)
        den = wj.expand(d.shape).sum(dims, keepdim=kd)
        dt = dtypes.true_divide(num.dtype, den.dtype)
        return num.to(dt) / den.to(dt)

    avg = _device_fused("average", [a, wb], a,
                        _axis_reduced_split(a, ax, kd), body,
                        (dims, kd, wb.shape), axes=WHOLE)
    if not returned:
        return avg
    scl = np.broadcast_to(np.asarray(scl_full, avg.dtype),
                          avg.shape).copy()
    return avg, scl


@_implements(np.isin)
def _isin(element, test_elements, assume_unique=False, invert=False, *,
          kind=None):
    _require_default(kind=(kind, None))
    _require_gpu(element)
    te = test_elements if (_is_gpu(test_elements)
                           or isinstance(test_elements, torch.Tensor)) \
        else np.asarray(test_elements)

    def body(d, t):
        d, t = _promoted(d, t)
        return torch.isin(d, t.reshape(-1), assume_unique=assume_unique,
                          invert=invert)

    return _device_fused("isin", [element, te], element, element.split,
                         body, (bool(assume_unique), bool(invert)), axes=(),
                         whole=(1,))


@_implements(np.digitize)
def _digitize(x, bins, right=False):
    _require_gpu(x)
    b = np.asarray(bins)
    if b.ndim != 1:
        raise ValueError("object too deep for desired array")
    d = np.diff(b)
    # numpy's rule is NON-strict monotonicity (equal edges are legal)
    if len(b) > 1 and not (np.all(d >= 0) or np.all(d <= 0)):
        raise ValueError(
            "bins must be monotonically increasing or decreasing")
    increasing = len(b) == 0 or b[-1] >= b[0]
    # jnp's sides: searchsorted right of the edges unless ``right``
    side_right = not right

    def body(v, bb):
        v, bb = _promoted(v, bb)
        if not increasing:
            bb = torch.flip(bb, (0,))
        idx = torch.searchsorted(bb.contiguous(), v.contiguous(),
                                 right=side_right, out_int32=True)
        return idx if increasing else bb.shape[0] - idx

    return _device_fused("digitize", [x, b], x, x.split, body,
                         (bool(right), increasing), axes=(), whole=(1,))


@_implements(np.interp)
def _interp(x, xp, fp, left=None, right=None, period=None):
    _require_gpu(x)
    if _is_gpu(xp) or _is_gpu(fp):
        raise _Fallback("bolt sample points")
    xpa, fpa = np.asarray(xp), np.asarray(fp)
    if xpa.ndim != 1 or fpa.ndim != 1:
        raise ValueError("Data points must be 1-D sequences")
    if len(xpa) != len(fpa):
        raise ValueError("fp and xp are not of the same length")
    if len(xpa) == 0:
        raise ValueError("array of sample points is empty")
    if period is not None and period == 0:
        raise ValueError("period must be a non-zero value")

    def body(xx, xq, ff):
        # jnp's _interp: searchsorted and a lerp
        xx, xq = _promoted_inexact(xx, xq)
        ff = _inexact(ff)
        if period is not None:
            per = abs(period)
            xx = torch.remainder(xx, per)
            xq = torch.remainder(xq, per)
            xq, order = torch.sort(xq, stable=True)
            ff = ff[order]
            xq = torch.cat([xq[-1:] - per, xq, xq[:1] + per])
            ff = torch.cat([ff[-1:], ff, ff[:1]])
        i = torch.clamp(torch.searchsorted(xq.contiguous(), xx.contiguous(),
                                           right=True), 1, len(xq) - 1)
        df = ff[i] - ff[i - 1]
        dx = xq[i] - xq[i - 1]
        delta = xx - xq[i - 1]
        eps = np.spacing(np.finfo(numpy_dtype(xq.dtype)).eps)
        dx0 = torch.abs(dx) <= eps
        f = torch.where(dx0, ff[i - 1],
                        ff[i - 1] + (delta / torch.where(
                            dx0, torch.ones_like(dx), dx)) * df)
        if period is None:
            lo = ff[0] if left is None else torch.tensor(
                left, dtype=f.dtype, device=f.device)
            hi = ff[-1] if right is None else torch.tensor(
                right, dtype=f.dtype, device=f.device)
            f = torch.where(xx < xq[0], lo, f)
            f = torch.where(xx > xq[-1], hi, f)
        return f

    return _device_fused("interp", [x, xpa, fpa], x, x.split, body,
                         (left, right, period), axes=(), whole=(1, 2))


def _gradient_axis(d, h, axis):
    """jnp's ``gradient`` along one axis with a scalar spacing ``h``:
    central differences inside, one-sided at the two edges."""
    def sl(start, stop):
        n = d.shape[axis]
        start = start + n if start < 0 else start
        stop = n if stop is None else (stop + n if stop < 0 else stop)
        return d.narrow(axis, start, stop - start)

    upper = (sl(1, 2) - sl(0, 1)) / h
    lower = (sl(-1, None) - sl(-2, -1)) / h
    inner = (sl(2, None) - sl(0, -2)) * 0.5 / h
    return torch.cat([upper, inner, lower], axis)


@_implements(np.gradient)
def _gradient(f, *varargs, axis=None, edge_order=1):
    _require_gpu(f)
    if edge_order != 1:
        raise _Fallback("edge_order")
    if axis is None:
        axes = tuple(range(f.ndim))
    else:
        axes = tuple(a + f.ndim if a < 0 else a for a in tupleize(axis))
        inshape(f.shape, axes)
    if len(varargs) == 0:
        spacing = [1.0] * len(axes)
    elif len(varargs) == 1 and np.ndim(varargs[0]) == 0:
        spacing = [float(varargs[0])] * len(axes)
    elif len(varargs) == len(axes) and all(np.ndim(v) == 0
                                            for v in varargs):
        spacing = [float(v) for v in varargs]
    else:
        raise _Fallback("array spacing")   # coordinate arrays: host path
    for a in axes:
        if f.shape[a] < 2:
            raise ValueError(
                "Shape of array too small to calculate a numerical "
                "gradient, at least 2 elements are required.")
    if len(axes) > 1 and f.deferred:
        # one program per axis below: materialise a deferred chain ONCE so
        # N gradients don't run it N times
        f.cache()
    # jnp promotes the data with the (weakly typed) spacing: integers
    # give the default float
    outs = [_device_fused("gradient", [f], f, f.split,
                          lambda d, _a=a, _h=h: _gradient_axis(
                              d.to(dtypes.promote(d.dtype, _h)), _h, _a),
                          (a, float(h)), axes=(a,))
            for a, h in zip(axes, spacing)]
    return outs[0] if len(outs) == 1 else outs


# ---------------------------------------------------------------------
# flips, integration, nan-aware cumulatives and arg stats
# ---------------------------------------------------------------------

@_implements(np.flipud)
def _flipud(m):
    if m.ndim < 1:
        raise ValueError("Input must be >= 1-d.")
    return _flip(m, 0)


@_implements(np.fliplr)
def _fliplr(m):
    if m.ndim < 2:
        raise ValueError("Input must be >= 2-d.")
    return _flip(m, 1)


def _trapezoid_body(ax, dx):
    # jnp.trapezoid: 0.5 * dx * (y[1:] + y[:-1]) summed along the axis
    def body(d, *xs):
        if xs:
            y, xx = _promoted_inexact(d, xs[0])
            step = torch.diff(xx) if xx.ndim == 1 else \
                torch.movedim(torch.diff(xx, dim=ax), ax, -1)
        else:
            y, step = _inexact(d), dx
        y = torch.movedim(y, ax, -1)
        return 0.5 * (step * (y[..., 1:] + y[..., :-1])).sum(-1)
    return body


def _trapezoid(y, x=None, dx=1.0, axis=-1):
    _require_gpu(y)
    ax = operator.index(axis)
    split = _axis_reduced_split(y, (ax + y.ndim if ax < 0 else ax,), False)
    dims = (ax % y.ndim,) if y.ndim else ()
    if x is None:
        return _device_fused("trapezoid", [y], y, split,
                             _trapezoid_body(ax, float(dx)),
                             (float(dx), ax), axes=dims,
                             keep=_kept(y.ndim, dims, False))
    if _is_gpu(x):
        raise _Fallback("card sample points")
    xa = np.asarray(x)
    # 1-d sample points meet each box whole; others span the array
    return _device_fused("trapezoid_x", [y, xa], y, split,
                         _trapezoid_body(ax, None), (ax, xa.shape),
                         axes=dims if xa.ndim == 1 else WHOLE,
                         keep=_kept(y.ndim, dims, False))


# numpy <2.0 has only trapz, >=2.0 both (trapz deprecated): guard EACH
if hasattr(np, "trapezoid"):
    _TABLE[np.trapezoid] = _trapezoid
if hasattr(np, "trapz"):
    _TABLE[np.trapz] = _trapezoid


def _cross_body(x, y):
    """jnp's ``cross`` over the last axes: a 2-vector has a zero third
    component, and two 2-vectors give the scalar ``a0 b1 - a1 b0``."""
    x, y = _promoted(x, y)
    a0, a1 = x[..., 0], x[..., 1]
    b0, b1 = y[..., 0], y[..., 1]
    if x.shape[-1] == 2 and y.shape[-1] == 2:
        return a0 * b1 - a1 * b0
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    a2 = x[..., 2] if x.shape[-1] == 3 else zero
    b2 = y[..., 2] if y.shape[-1] == 3 else zero
    c0, c1, c2 = torch.broadcast_tensors(a1 * b2 - a2 * b1,
                                         a2 * b0 - a0 * b2, a0 * b1 - a1 * b0)
    return torch.stack([c0, c1, c2], -1)


@_implements(np.cross)
def _cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    anchor = _contraction_anchor(a, b)
    if axis is not None or (axisa, axisb, axisc) != (-1, -1, -1):
        # moved vector axes reshuffle the output layout out from under the
        # leading-keys bookkeeping: host path
        raise _Fallback("non-default cross axes")
    if not (np.ndim(a) and np.ndim(b)) or np.shape(a)[-1] not in (2, 3) \
            or np.shape(b)[-1] not in (2, 3):
        raise _Fallback("cross form")       # numpy raises its own error
    try:
        out_shape = _eval_shape(_cross_body, a, b)
    except ValueError:
        raise _Fallback("cross form") from None
    s = anchor.split
    new_split = s if out_shape[:s] == tuple(anchor.shape[:s]) else 0
    return _device_fused("cross", [a, b], anchor, new_split, _cross_body, (),
                         axes=WHOLE)


@_implements(np.ediff1d)
def _ediff1d(ary, to_end=None, to_begin=None):
    _require_gpu(ary)
    ops = [ary]
    for extra, what in ((to_begin, "to_begin"), (to_end, "to_end")):
        if extra is not None:
            if _is_gpu(extra):
                raise _Fallback("card %s" % what)
            ops.append(np.asarray(extra))
    has_begin, has_end = to_begin is not None, to_end is not None

    def body(d, *extras):
        flat = d.reshape(-1)
        parts = [flat[1:] - flat[:-1]]
        it = iter(extras)
        if has_begin:
            parts.insert(0, next(it).reshape(-1).to(flat.dtype))
        if has_end:
            parts.append(next(it).reshape(-1).to(flat.dtype))
        return torch.cat(parts)

    return _device_fused("ediff1d", ops, ary, min(ary.split, 1), body,
                         (has_begin, has_end), axes=WHOLE)


def _nan_cum(name):
    fill = 0 if name == "nancumsum" else 1
    fn = torch.cumsum if name == "nancumsum" else torch.cumprod

    def handler(a, axis=None, dtype=None, out=None):
        _require_default(out=(out, None), dtype=(dtype, None))
        _require_gpu(a)
        ax = None if axis is None else operator.index(axis)
        if ax is not None and not -a.ndim <= ax < a.ndim:
            raise np.exceptions.AxisError(ax, a.ndim)

        def body(d):
            if d.is_floating_point() or d.is_complex():
                d = torch.where(torch.isnan(d), torch.tensor(
                    fill, dtype=d.dtype, device=d.device), d)
            dt = torch.int64 if d.dtype == torch.bool else d.dtype
            if ax is None:
                return fn(d.reshape(-1), 0, dtype=dt)
            return fn(d, ax, dtype=dt)

        # axis=None flattens: the flat result gets the filter-style flat
        # key axis, cumsum's convention
        new_split = (1 if a.split else 0) if ax is None else a.split
        return _device_fused(name, [a], a, new_split, body, (ax,),
                             axes=WHOLE if ax is None else (ax,))
    return handler


_TABLE[np.nancumsum] = _nan_cum("nancumsum")
_TABLE[np.nancumprod] = _nan_cum("nancumprod")


def _nan_arg(name):
    # an ALL-NaN slice returns jnp's -1 sentinel where numpy raises
    # ValueError: detecting it would force a sync on every call
    fill = -np.inf if name == "nanargmax" else np.inf
    fn = torch.argmax if name == "nanargmax" else torch.argmin

    def handler(a, axis=None, out=None, *, keepdims=_NV):
        _require_default(out=(out, None))
        _require_gpu(a)
        kd = _keepdims(keepdims)
        ax = None if axis is None else operator.index(axis)
        ax_t = tuple(range(a.ndim)) if ax is None else _dims(a.ndim, ax)

        def body(d):
            nan = torch.isnan(d) if d.is_floating_point() else None
            if nan is not None:
                d = torch.where(nan, torch.tensor(fill, dtype=d.dtype,
                                                  device=d.device), d)
            if ax is None:
                out = fn(d.reshape(-1))
                if nan is not None:
                    out = torch.where(nan.all(), -1, out)
                return out.reshape((1,) * d.ndim) if kd else out
            out = fn(d, ax, keepdim=kd)
            if nan is not None:
                out = torch.where(nan.all(ax, keepdim=kd), -1, out)
            return out

        return _device_fused(name, [a], a,
                             _axis_reduced_split(a, ax_t, kd), body,
                             (ax, kd), axes=ax_t, keep=_kept(a.ndim, ax_t, kd))
    return handler


_TABLE[np.nanargmax] = _nan_arg("nanargmax")
_TABLE[np.nanargmin] = _nan_arg("nanargmin")


def _fix_body(d):
    if not d.is_floating_point():
        return d.clone()
    return torch.where(d >= 0, torch.floor(d), torch.ceil(d))


@_implements(np.fix)
def _fix(x, out=None):
    _require_default(out=(out, None))
    _require_gpu(x)
    return _device_fused("fix", [x], x, x.split, _fix_body, (), axes=())


# ---------------------------------------------------------------------
# set operations: the operands reduce to their (small) uniques on the
# card, and the set algebra runs on the host, exactly numpy
# ---------------------------------------------------------------------

def _uniq_small(x):
    if _is_gpu(x):
        from bolt_tpu_torch.ops import unique
        return unique(x)
    return np.unique(np.asarray(x))


@_implements(np.intersect1d)
def _intersect1d(ar1, ar2, assume_unique=False, return_indices=False):
    if return_indices:
        # original positions are lost after the unique reduction
        raise _Fallback("return_indices")
    return np.intersect1d(_uniq_small(ar1), _uniq_small(ar2),
                          assume_unique=True)


@_implements(np.union1d)
def _union1d(ar1, ar2):
    return np.union1d(_uniq_small(ar1), _uniq_small(ar2))


@_implements(np.setdiff1d)
def _setdiff1d(ar1, ar2, assume_unique=False):
    return np.setdiff1d(_uniq_small(ar1), _uniq_small(ar2),
                        assume_unique=True)


@_implements(np.setxor1d)
def _setxor1d(ar1, ar2, assume_unique=False):
    return np.setxor1d(_uniq_small(ar1), _uniq_small(ar2),
                       assume_unique=True)


# ---------------------------------------------------------------------
# complex views and cleanup helpers
# ---------------------------------------------------------------------

@_implements(np.angle)
def _angle(z, deg=False):
    _require_gpu(z)
    deg = bool(deg)

    def body(d):
        if d.is_complex():
            re, im = d.real, d.imag
        else:
            # jnp: a real non-float input computes in the default float
            re = d if d.is_floating_point() else d.to(torch.float64)
            im = torch.zeros_like(re)
        out = torch.atan2(im, re)
        return torch.rad2deg(out) if deg else out

    return _device_fused("angle", [z], z, z.split, body, (deg,), axes=())


@_implements(np.unwrap)
def _unwrap(p, discont=None, axis=-1, *, period=6.283185307179586):
    _require_gpu(p)
    ax = operator.index(axis)
    dc = None if discont is None else float(discont)
    per = float(period)

    def body(d):
        # jnp.unwrap: the jumps folded into [-period/2, period/2) and
        # accumulated along the axis
        if d.is_complex():
            raise ValueError("jnp.unwrap does not support complex inputs.")
        d = d.to(dtypes.promote(d.dtype, per))
        if d.shape[ax] == 0:
            return d
        interval = per / 2
        dd = torch.diff(d, dim=ax)
        ddmod = torch.remainder(dd + interval, per) - interval
        ddmod = torch.where((ddmod == -interval) & (dd > 0),
                            torch.tensor(interval, dtype=d.dtype,
                                         device=d.device), ddmod)
        limit = interval if dc is None else dc
        correct = torch.where(torch.abs(dd) < limit, torch.zeros_like(dd),
                              ddmod - dd)
        return torch.cat([d.narrow(ax, 0, 1),
                          d.narrow(ax, 1, d.shape[ax] - 1)
                          + torch.cumsum(correct, ax)], ax)

    return _device_fused("unwrap", [p], p, p.split, body, (dc, ax, per),
                         axes=(ax,))


def _elementwise(name, fn):
    """A table handler applying ``fn`` to a card operand's tensor."""
    def handler(x):
        _require_gpu(x)
        return _device_fused(name, [x], x, x.split, fn, (), axes=())
    return handler


_TABLE[np.sinc] = _elementwise("sinc", lambda d: torch.sinc(_inexact(d)))
_TABLE[np.i0] = _elementwise("i0", lambda d: torch.i0(_inexact(d)))


@_implements(np.nan_to_num)
def _nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    if not copy:
        raise _Fallback("copy=False")   # in place: the host path decides
    _require_gpu(x)
    args = (float(nan), None if posinf is None else float(posinf),
            None if neginf is None else float(neginf))

    def one(d):
        return torch.nan_to_num(d, nan=args[0], posinf=args[1],
                                neginf=args[2])

    def body(d):
        if d.is_complex():
            return torch.complex(one(d.real), one(d.imag))
        if not d.is_floating_point():
            return d.clone()
        return one(d)

    return _device_fused("nan_to_num", [x], x, x.split, body, args, axes=())


def _inf_sign(name):
    fn = getattr(torch, name)

    def handler(x, out=None):
        _require_default(out=(out, None))
        _require_gpu(x)
        return _device_fused(name, [x], x, x.split, fn, (), axes=())
    return handler


_TABLE[np.isposinf] = _inf_sign("isposinf")
_TABLE[np.isneginf] = _inf_sign("isneginf")


# ---------------------------------------------------------------------
# np.fft: torch.fft (cuFFT on the card), one program per call; key axes
# survive positionally.  jnp's dtypes: integer and bool input widens to
# float first (torch.fft takes no integer), so float32 gives complex64
# and float64 complex128
# ---------------------------------------------------------------------

def _fft1(name):
    fn = getattr(torch.fft, name)

    def handler(a, n=None, axis=-1, norm=None, out=None):
        _require_default(out=(out, None))
        _require_gpu(a)
        nn = None if n is None else operator.index(n)
        ax = operator.index(axis)
        return _device_fused(
            "fft_" + name, [a], a, a.split,
            lambda d: fn(_inexact(d), n=nn, dim=ax, norm=norm),
            (nn, ax, norm), axes=(ax,))
    return handler


def _fftn(name):
    fn = getattr(torch.fft, name)

    def handler(a, s=None, axes=None, norm=None, out=None):
        _require_default(out=(out, None))
        _require_gpu(a)
        st = None if s is None else tuple(operator.index(v)
                                          for v in tupleize(s))
        axt = None if axes is None else tuple(operator.index(v)
                                              for v in tupleize(axes))
        if axt is None and name.endswith("2"):
            axt = (-2, -1)
        # the transform's axes: s without axes names the last len(s)
        touched = axt if axt is not None else WHOLE if st is None \
            else tuple(range(-len(st), 0))
        return _device_fused(
            "fft_" + name, [a], a, a.split,
            lambda d: fn(_inexact(d), s=st, dim=axt, norm=norm),
            (st, axt, norm), axes=touched)
    return handler


for _name in ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft"):
    _TABLE[getattr(np.fft, _name)] = _fft1(_name)
for _name in ("fft2", "ifft2", "fftn", "ifftn", "rfft2", "irfft2",
              "rfftn", "irfftn"):
    _TABLE[getattr(np.fft, _name)] = _fftn(_name)


def _fftshift_fn(name):
    fn = getattr(torch.fft, name)

    def handler(x, axes=None):
        _require_gpu(x)
        axt = None if axes is None else tuple(operator.index(v)
                                              for v in tupleize(axes))
        return _device_fused("fft_" + name, [x], x, x.split,
                             lambda d: fn(d, dim=axt), (axt,),
                             axes=WHOLE if axt is None else axt)
    return handler


_TABLE[np.fft.fftshift] = _fftshift_fn("fftshift")
_TABLE[np.fft.ifftshift] = _fftshift_fn("ifftshift")


@_implements(np.apply_along_axis)
def _apply_along_axis(func1d, axis, arr, *args, **kwargs):
    _require_gpu(arr)
    ax = operator.index(axis)
    ax = ax + arr.ndim if ax < 0 else ax
    if not 0 <= ax < arr.ndim:
        raise np.exceptions.AxisError(axis, arr.ndim)
    try:
        hash((args, tuple(sorted(kwargs.items()))))
        hashable = all(not hasattr(v, "__array__")
                       for v in list(args) + list(kwargs.values()))
    except TypeError:
        hashable = False
    if not hashable:
        raise _Fallback("unhashable func1d extras")
    f = _traceable(func1d)
    nd = arr.ndim

    def one(v):
        return f(v, *args, **kwargs)

    # jnp.apply_along_axis: vmap over the axes after ``ax`` (their
    # outputs trail) and then over those before it
    func = one
    for i in range(1, nd - ax):
        func = vmap(func, in_dims=i, out_dims=-1)
    for i in range(ax):
        func = vmap(func, in_dims=0, out_dims=0)
    try:
        vmap(one)(torch.empty((1, arr.shape[ax]),
                              dtype=torch_dtype(arr.dtype), device="meta"))
    except (RuntimeError, TypeError) as exc:
        if not _is_trace_error(exc):
            _raise_callable_bug("apply_along_axis", func1d, exc,
                                (arr.shape[ax],))
        _warn_fallback("apply_along_axis", func1d, exc)
        raise _Fallback("non-traceable func1d") from None
    # keys before the applied axis survive; the func1d output dims land AT
    # the axis position, displacing everything after it
    new_split = arr.split if ax >= arr.split else ax
    return _device_fused("apply_along_axis", [arr], arr, new_split, func,
                         (f, ax, args, tuple(sorted(kwargs.items()))),
                         axes=WHOLE)


# ---------------------------------------------------------------------
# triangles, diagonals, products, selection
# ---------------------------------------------------------------------

def _tri_fn(name):
    fn = getattr(torch, name)

    def handler(m, k=0):
        _require_gpu(m)
        if m.ndim < 2:
            raise _Fallback("1-d %s" % name)   # numpy promotes to 2-d
        kk = operator.index(k)
        return _device_fused(name, [m], m, m.split,
                             lambda d: fn(d, kk), (kk,), axes=(-2, -1))
    return handler


_TABLE[np.tril] = _tri_fn("tril")
_TABLE[np.triu] = _tri_fn("triu")


@_implements(np.diag)
def _diag(v, k=0):
    _require_gpu(v)
    kk = operator.index(k)
    if v.ndim == 2:
        return v.diagonal(kk)
    if v.ndim != 1:
        raise ValueError("Input must be 1- or 2-d.")
    # building the (n+|k|, n+|k|) matrix: the input axis becomes the row
    # block, so a key axis stays a key axis
    return _device_fused("diag", [v], v, v.split,
                         lambda d: torch.diag(d, kk), (kk,), axes=WHOLE)


@_implements(np.diagflat)
def _diagflat(v, k=0):
    _require_gpu(v)
    kk = operator.index(k)
    return _device_fused("diagflat", [v], v, 1 if v.split else 0,
                         lambda d: torch.diagflat(d, kk), (kk,), axes=WHOLE)


@_implements(np.vander)
def _vander(x, N=None, increasing=False):
    _require_gpu(x)
    if x.ndim != 1:
        raise ValueError("x must be a one-dimensional array or sequence.")
    n = x.shape[0] if N is None else operator.index(N)
    if n < 0:
        raise ValueError("N must be nonnegative")
    inc = bool(increasing)

    def body(d):
        # jnp.vander: powers by an iota of the input's own dtype
        iota = torch.arange(n, device=d.device).to(d.dtype)
        if not inc:
            iota = (n - 1) - iota
        return torch.pow(d[..., None], iota)

    return _device_fused("vander", [x], x, x.split, body, (n, inc), axes=(),
                         keep=[0, None])


def _kron_body(x, y):
    # jnp.kron: the lower-rank operand gains leading axes, then an outer
    # product interleaved axis by axis
    x, y = _promoted(x, y)
    nd = max(x.ndim, y.ndim)
    x = x.reshape((1,) * (nd - x.ndim) + tuple(x.shape))
    y = y.reshape((1,) * (nd - y.ndim) + tuple(y.shape))
    xs = [s for d in x.shape for s in (d, 1)]
    ys = [s for d in y.shape for s in (1, d)]
    out = tuple(a * b for a, b in zip(x.shape, y.shape))
    return (x.reshape(xs) * y.reshape(ys)).reshape(out)


@_implements(np.kron)
def _kron(a, b):
    anchor = _contraction_anchor(a, b)
    new_split = anchor.split if (anchor is a
                                 and np.ndim(b) <= np.ndim(a)) else 0
    return _device_fused("kron", [a, b], anchor, new_split, _kron_body, (),
                         axes=WHOLE)


@_implements(np.select)
def _select(condlist, choicelist, default=0):
    conds, choices = list(condlist), list(choicelist)
    if len(conds) != len(choices):
        raise ValueError(
            "list of cases must be same length as list of conditions")
    if len(conds) == 0:
        raise ValueError("select with an empty condition list is not "
                         "possible")
    anchor = _contraction_anchor(*(conds + choices))
    n = len(conds)
    out_shape = np.broadcast_shapes(*(np.shape(o) for o in conds + choices))
    s = anchor.split
    new_split = s if tuple(out_shape[:s]) == tuple(anchor.shape[:s]) \
        and len(out_shape) == anchor.ndim else 0
    if not np.isscalar(default):
        raise _Fallback("array default")

    def body(*ops):
        # jnp.select: the default joins the promotion as a weak scalar,
        # the FIRST true condition wins
        dt = dtypes.promote(default, ops[n].dtype)
        for c in ops[n + 1:]:
            dt = dtypes.promote(dt, c.dtype)
        out = torch.tensor(default, device=ops[0].device).to(dt)
        for c, v in zip(reversed(ops[:n]), reversed(ops[n:])):
            out = torch.where(c.to(torch.bool), v.to(dt), out)
        return out.expand(out_shape).contiguous()

    # 0 / 0.0 / False compare and hash equal but change the promoted
    # output dtype: the key carries the type too
    return _device_fused("select", conds + choices, anchor, new_split,
                         body, (n, default, type(default).__name__),
                         axes=WHOLE)


@_implements(np.compress)
def _compress(condition, a, axis=None, out=None):
    _require_default(out=(out, None))
    if _is_gpu(condition):
        raise _Fallback("card condition")   # data-dependent size: host path
    _require_gpu(a)
    cond = np.asarray(condition)
    if cond.ndim != 1:
        raise ValueError("condition must be a 1-d array")
    dim = a.size if axis is None else a.shape[
        axis + a.ndim if axis < 0 else axis]
    idx = np.nonzero(cond)[0]
    # numpy allows an OVER-long condition when its extra entries are all
    # False; only a True index past the axis is out of bounds
    if idx.size and idx[-1] >= dim:
        raise IndexError("index %d is out of bounds for axis %d with size "
                         "%d" % (idx[-1], 0 if axis is None else axis, dim))
    return a.take(idx, axis=axis)


@_implements(np.extract)
def _extract(condition, arr):
    if _is_gpu(condition):
        raise _Fallback("card condition")
    _require_gpu(arr)
    idx = np.nonzero(np.asarray(condition).ravel())[0]
    return arr.take(idx)


def _conv_body(op, mode):
    def body(x, y):
        # jnp's _conv: promote to inexact, the shorter operand slides
        # (flipped for convolve, conjugated and the result reversed for a
        # correlate whose second operand is longer)
        x, y = _promoted_inexact(x, y)
        rev = False
        if op == "correlate":
            y = y.conj()
            if x.shape[0] < y.shape[0]:
                x, y, rev = y, x, True
        else:
            if x.shape[0] < y.shape[0]:
                x, y = y, x
            y = torch.flip(y, (0,))
        m = y.shape[0]
        lo, hi = {"valid": (0, 0), "same": (m // 2, m - m // 2 - 1),
                  "full": (m - 1, m - 1)}[mode]
        xp = torch.nn.functional.pad(x, (lo, hi))
        out = torch.nn.functional.conv1d(xp[None, None], y[None, None])[0, 0]
        return torch.flip(out, (0,)) if rev else out
    return body


def _conv1d(name):
    def handler(a, v, mode="full" if name == "convolve" else "valid"):
        anchor = _contraction_anchor(a, v)
        # numpy promotes 0-d operands to 1-d
        if np.ndim(a) == 0 or np.ndim(v) == 0:
            if (_is_gpu(a) and np.ndim(a) == 0) or \
                    (_is_gpu(v) and np.ndim(v) == 0):
                raise _Fallback("0-d card operand")
            a = np.atleast_1d(a) if np.ndim(a) == 0 else a
            v = np.atleast_1d(v) if np.ndim(v) == 0 else v
        if np.ndim(a) != 1 or np.ndim(v) != 1:
            raise ValueError("object too deep for desired array")
        if np.shape(a)[0] == 0 or np.shape(v)[0] == 0:
            raise ValueError("v cannot be empty")
        if mode not in ("full", "same", "valid"):
            raise ValueError(
                "mode must be one of 'full', 'same', or 'valid'")
        new_split = min(anchor.split, 1) if anchor is a else 0
        return _device_fused(name, [a, v], anchor, new_split,
                             _conv_body(name, mode), (mode,), axes=WHOLE)
    return handler


_TABLE[np.convolve] = _conv1d("convolve")
_TABLE[np.correlate] = _conv1d("correlate")


# ---------------------------------------------------------------------
# np.linalg: torch.linalg (cuSOLVER/cuBLAS on the card) in one program a
# call; the leading (key) axes are batch axes, so keys survive as batch
# dims and the (n, n)/(m, n) matrix core is consumed.  jnp answers a
# singular or non-positive matrix with inf/NaN and never raises: the
# ``*_ex`` forms keep that and do not read their error code on the host
# ---------------------------------------------------------------------

# the largest batch of matrices torch.linalg.eigh/eigvalsh is given on a
# CUDA device: cuSOLVER's batched symmetric eigensolver (syevBatched)
# refuses 32768 matrices or more (n = 5 and 16 alike; 16384 works), while
# every other call here takes a (65536, 16, 16) batch
# (tools/linalg_probe.py on the H100)
_SOLVER_BATCH = 16384


def _sliced(fn, x):
    """``fn(x)`` over the leading batch axes of the matrix stack ``x`` in
    slices of at most ``_SOLVER_BATCH`` matrices on a CUDA device; ``fn``
    returns a tensor or a tuple."""
    batch = x.shape[:-2]
    n = prod(batch)
    if x.device.type != "cuda" or n <= _SOLVER_BATCH:
        return fn(x)
    flat = x.reshape((n,) + x.shape[-2:])
    parts = [fn(flat[s:s + _SOLVER_BATCH])
             for s in range(0, n, _SOLVER_BATCH)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p).reshape(batch + p[0].shape[1:])
                     for p in zip(*parts))
    return torch.cat(parts).reshape(batch + parts[0].shape[1:])


# the matrix axes of a batched linalg call; the batch axes lead
_MAT = (-2, -1)


def _batch(a):
    """The batch axes of a matrix stack (a ``keep`` of
    :func:`_mesh_fused` for a result that drops the matrix axes)."""
    return list(range(a.ndim - 2))


def _mat_split(a, consumed=2):
    """Keys surviving a batched matrix op: the leading ``ndim - consumed``
    axes are batch dims; key axes beyond them are consumed by the matrix
    core."""
    return min(a.split, max(a.ndim - consumed, 0))


def _as_float(d):
    """numpy's int → float promotion of a linalg operand (jnp's rule:
    integers below 64 bits give float32)."""
    dt = dtypes.promote(d.dtype, torch.float32)
    return d if d.dtype == dt else d.to(dt)


def _float_body(fn):
    """Wrap a torch.linalg call with numpy's int → float promotion."""
    def body(d, *rest):
        return fn(_as_float(d), *rest)
    return body


def _two_d(a):
    if a.ndim < 2:
        raise np.linalg.LinAlgError(
            "%d-dimensional array given. Array must be at least "
            "two-dimensional" % a.ndim)


def _square_check(a):
    _two_d(a)
    if a.shape[-1] != a.shape[-2]:
        raise np.linalg.LinAlgError(
            "Last 2 dimensions of the array must be square")


def _linalg_result(name, outs):
    """numpy ≥1.25 returns namedtuples (``EighResult`` etc., attribute
    access included); mirror that when the (private but stable) types are
    importable, else a plain tuple."""
    try:
        from numpy.linalg import _linalg
        return getattr(_linalg, name)(*outs)
    except (ImportError, AttributeError):
        return tuple(outs)


def _inv(d):
    return torch.linalg.inv_ex(d).inverse


@_implements(np.linalg.inv)
def _linalg_inv(a):
    _require_gpu(a)
    _square_check(a)
    return _device_fused("linalg_inv", [a], a, _mat_split(a),
                         _float_body(_inv), (), axes=_MAT)


def _svd(d, full_matrices=False, hermitian=False):
    """``(u, s, vh)`` of ``d``; ``hermitian`` through ``eigh`` as jnp's
    ``svd(hermitian=True)``: singular values ``|w|`` in descending order,
    ``vh`` carrying the eigenvalues' signs."""
    if not hermitian:
        return tuple(torch.linalg.svd(d, full_matrices=full_matrices))
    w, v = _eigh(d)
    s, order = torch.sort(w.abs(), dim=-1, descending=True)
    u = torch.take_along_dim(v, order[..., None, :], -1)
    sgn = torch.sign(torch.take_along_dim(w, order, -1)).to(u.dtype)
    return u, s, (u * sgn[..., None, :]).mH


def _svdvals(d, hermitian=False):
    if hermitian:
        return torch.sort(_eigvalsh(d).abs(), dim=-1, descending=True).values
    return torch.linalg.svdvals(d)


def _pinv(d, rc, hermitian):
    # jnp.linalg.pinv: singular values at or under rtol * s_max dropped
    m, n = d.shape[-2:]
    if m == 0 or n == 0:
        return d.new_empty(d.shape[:-2] + (n, m))
    rtol = 10.0 * max(m, n) * torch.finfo(d.dtype).eps if rc is None else rc
    u, s, vh = _svd(d.conj(), full_matrices=False, hermitian=hermitian)
    cutoff = rtol * s[..., 0:1]
    s = torch.where(s > cutoff, s, torch.tensor(np.inf, dtype=s.dtype,
                                                device=s.device)).to(u.dtype)
    with _precision.f32_matmul("highest"):
        return torch.matmul(vh.mT, u.mT / s[..., None])


@_implements(np.linalg.pinv)
def _linalg_pinv(a, rcond=None, hermitian=False, *, rtol=_NV):
    _require_gpu(a)
    _two_d(a)
    if rtol is not _NV and rtol is not None:
        if rcond is not None:
            raise ValueError("cannot pass both rcond and rtol")
        rcond = rtol
    rc = None if rcond is None else float(rcond)
    herm = bool(hermitian)
    return _device_fused("linalg_pinv", [a], a, _mat_split(a),
                         _float_body(lambda d: _pinv(d, rc, herm)),
                         (rc, herm), axes=_MAT)


@_implements(np.linalg.det)
def _linalg_det(a):
    _require_gpu(a)
    _square_check(a)
    return _device_fused("linalg_det", [a], a, _mat_split(a),
                         _float_body(torch.linalg.det), (), axes=_MAT,
                         keep=_batch(a))


@_implements(np.linalg.slogdet)
def _linalg_slogdet(a):
    _require_gpu(a)
    _square_check(a)
    s = _mat_split(a)
    return _linalg_result("SlogdetResult", _device_fused(
        "linalg_slogdet", [a], a, (s, s),
        _float_body(lambda d: tuple(torch.linalg.slogdet(d))), (), axes=WHOLE))


def _cholesky(d, upper):
    # jnp fills the lower triangle of the factor of a matrix that is not
    # positive definite with NaN; torch leaves it half computed: mask it
    # by the error code, on the card
    low, info = torch.linalg.cholesky_ex(d)
    low = torch.where((info == 0)[..., None, None], low,
                      torch.full_like(low, np.nan).tril())
    return low.mH if upper else low


@_implements(np.linalg.cholesky)
def _linalg_cholesky(a, *, upper=False):
    _require_gpu(a)
    _square_check(a)
    up = bool(upper)
    return _device_fused("linalg_cholesky", [a], a, _mat_split(a),
                         _float_body(lambda d: _cholesky(d, up)), (up,),
                         axes=_MAT)


def _uplo_sym(d, UPLO):
    """Mirror the named triangle: numpy reads ONLY it."""
    tri = torch.tril(d) if UPLO == "L" else torch.triu(d)
    other = tri.mH
    diag = torch.diagonal(d.real if d.is_complex() else d, 0, -2, -1)
    return tri + other - torch.diag_embed(diag).to(d.dtype)


def _check_uplo(UPLO):
    if UPLO not in ("L", "U"):
        raise ValueError("UPLO argument must be 'L' or 'U'")


def _eigh(d):
    # torch.linalg.eigh has no _ex form: it reads its error code on the
    # host, one sync a call
    return _sliced(lambda x: tuple(torch.linalg.eigh(x)), d)


def _eigvalsh(d):
    return _sliced(torch.linalg.eigvalsh, d)


@_implements(np.linalg.eigh)
def _linalg_eigh(a, UPLO="L"):
    _require_gpu(a)
    _square_check(a)
    _check_uplo(UPLO)
    s = _mat_split(a)
    return _linalg_result("EighResult", _device_fused(
        "linalg_eigh", [a], a, (s, s),
        _float_body(lambda d: _eigh(_uplo_sym(d, UPLO))), (UPLO,), axes=WHOLE))


@_implements(np.linalg.eigvalsh)
def _linalg_eigvalsh(a, UPLO="L"):
    _require_gpu(a)
    _square_check(a)
    _check_uplo(UPLO)
    # its own single-output program: no eigenvectors computed to be
    # discarded
    return _device_fused(
        "linalg_eigvalsh", [a], a, _mat_split(a),
        _float_body(lambda d: _eigvalsh(_uplo_sym(d, UPLO))), (UPLO,),
        axes=_MAT, keep=_batch(a) + [None])


@_implements(np.linalg.svd)
def _linalg_svd(a, full_matrices=True, compute_uv=True, hermitian=False):
    _require_gpu(a)
    _two_d(a)
    s = _mat_split(a)
    fm, herm = bool(full_matrices), bool(hermitian)
    if compute_uv:
        return _linalg_result("SVDResult", _device_fused(
            "linalg_svd", [a], a, (s, s, s),
            _float_body(lambda d: _svd(d, fm, herm)), (fm, herm), axes=WHOLE))
    return _device_fused("linalg_svdvals", [a], a, s,
                         _float_body(lambda d: _svdvals(d, herm)),
                         ("no_uv", herm), axes=_MAT, keep=_batch(a) + [None])


if hasattr(np.linalg, "svdvals"):
    @_implements(np.linalg.svdvals)
    def _linalg_svdvals(x, /):
        return _linalg_svd(x, compute_uv=False)


def _qr(d, mode):
    """``(q, r)`` of ``d`` in numpy's ``reduced``/``complete`` mode:
    ``torch.geqrf``'s Householder reflectors (batched on the card) and
    their product formed by one batched rank-1 update per reflector, as
    LAPACK's unblocked ``org2r`` forms it.  ``torch.linalg.qr`` forms Q
    one matrix at a time on a CUDA device (0.9-1.3 s for 32768 16 x 16
    matrices on the H100, ``tools/linalg_probe.py``)."""
    a, tau = torch.geqrf(d)
    m, n = d.shape[-2:]
    k = min(m, n)
    cols = m if mode == "complete" else k
    r = a[..., :cols, :].triu()
    q = torch.eye(m, cols, dtype=d.dtype, device=d.device).expand(
        d.shape[:-2] + (m, cols))
    row = torch.arange(m, device=d.device)
    for i in reversed(range(k)):
        # H_i = I - tau_i v v^H, v the i-th reflector with a unit head
        v = torch.where(row < i, 0, torch.where(row == i, 1, a[..., i]))
        v = v.to(d.dtype).unsqueeze(-1)
        q = q - (tau[..., i, None, None] * v) @ (v.mH @ q)
    return q, r


@_implements(np.linalg.qr)
def _linalg_qr(a, mode="reduced"):
    _require_gpu(a)
    _two_d(a)
    if mode not in ("reduced", "complete", "r"):
        raise _Fallback("qr mode")          # 'raw': host path
    s = _mat_split(a)
    if mode == "r":
        return _device_fused(
            "linalg_qr_r", [a], a, s,
            _float_body(lambda d: torch.linalg.qr(d, mode="r").R), (),
            axes=_MAT)
    return _linalg_result("QRResult", _device_fused(
        "linalg_qr", [a], a, (s, s),
        _float_body(lambda d: _qr(d, mode)), (mode,), axes=WHOLE))


def _solve(x, y):
    """numpy 2's ``solve``: ``y`` is a vector only when 1-d, else a stack
    of matrices broadcast against ``x``'s batch (``solve_ex``: a singular
    system gives inf/NaN, read by no one on the host)."""
    x, y = _promoted(_as_float(x), y)
    vec = y.ndim == 1
    if vec:
        y = y[:, None]
    batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    x = x.expand(batch + x.shape[-2:])
    y = y.expand(batch + y.shape[-2:])
    out = torch.linalg.solve_ex(x, y).result
    return out[..., 0] if vec else out


@_implements(np.linalg.solve)
def _linalg_solve(a, b):
    anchor = _contraction_anchor(a, b)
    if np.ndim(a) < 2 or np.shape(a)[-1] != np.shape(a)[-2]:
        raise np.linalg.LinAlgError(
            "Last 2 dimensions of the array must be square")
    bshape = np.shape(b)
    if not bshape or bshape[-1 if len(bshape) == 1 else -2] != \
            np.shape(a)[-1]:
        raise ValueError("solve: Input operand 1 has a mismatch in its "
                         "core dimension 0")
    # a broadcast rhs with MORE leading dims prepends batch axes that
    # displace a's keys: re-key to 0 there instead of mislabeling
    new_split = _mat_split(a) if (anchor is a
                                  and np.ndim(b) <= np.ndim(a)) else 0
    return _device_fused("linalg_solve", [a, b], anchor, new_split,
                         _solve, (), axes=WHOLE)


def _matrix_power(d, n):
    # jnp.linalg.matrix_power: square-and-multiply, a negative power of
    # the inverse
    if n == 0:
        eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
        return eye.expand(d.shape).clone()
    if n < 0:
        d, n = _inv(d), -n
    z = result = None
    with _precision.f32_matmul("highest"):
        while n > 0:
            z = d if z is None else z @ z
            n, bit = divmod(n, 2)
            if bit:
                result = z if result is None else result @ z
    return result


@_implements(np.linalg.matrix_power)
def _linalg_matrix_power(a, n):
    _require_gpu(a)
    _square_check(a)
    n = operator.index(n)
    return _device_fused("linalg_matrix_power", [a], a, _mat_split(a),
                         _float_body(lambda d: _matrix_power(d, n)), (n,),
                         axes=_MAT)


@_implements(np.linalg.matrix_rank)
def _linalg_matrix_rank(A, tol=None, hermitian=False, *, rtol=_NV):
    _require_gpu(A)
    if A.ndim < 2:
        # numpy: the rank of a vector is whether ANY entry is nonzero, a
        # one-scalar reduction fetched
        nz = (A != 0).any(axis=tuple(range(A.ndim)))
        return np.intp(bool(nz.totorch()))
    if rtol is not _NV and rtol is not None and tol is not None:
        raise ValueError("cannot pass both tol and rtol")
    abs_tol = None if tol is None else float(tol)
    rel_tol = float(rtol) if (rtol is not _NV and rtol is not None) \
        else None
    nmax = max(A.shape[-2:])
    herm = bool(hermitian)

    def body(d):
        # numpy's thresholds: tol is ABSOLUTE; rtol (and the default
        # max(m, n) * eps) scale by the largest singular value
        s = _svdvals(d, herm)
        if abs_tol is not None:
            thresh = torch.tensor(abs_tol, dtype=s.dtype, device=s.device)
        else:
            rel = rel_tol if rel_tol is not None \
                else nmax * torch.finfo(s.dtype).eps
            thresh = s.amax(-1, keepdim=True) * rel
        return (s > thresh).sum(-1)

    return _device_fused("linalg_matrix_rank", [A], A, _mat_split(A),
                         _float_body(body), (abs_tol, rel_tol, herm),
                         axes=_MAT, keep=_batch(A))


@_implements(np.linalg.lstsq)
def _linalg_lstsq(a, b, rcond=None):
    anchor = _contraction_anchor(a, b)
    if np.ndim(a) != 2:
        raise _Fallback("batched lstsq")    # numpy rejects; the host raises
    # eager: numpy's empty-residual convention branches on the rank, one
    # scalar read; the outputs are solution-sized
    xa, xb = _promoted(_inexact(_tensor(anchor, a)),
                       _inexact(_tensor(anchor, b)))
    xa = _as_float(xa)
    xb = xb.to(xa.dtype)
    if xa.shape[0] != xb.shape[0]:
        raise ValueError("Leading dimensions of input arrays must match")
    vec = xb.ndim == 1
    if vec:
        xb = xb[:, None]
    m, n = xa.shape
    rc = float(torch.finfo(xa.dtype).eps) * max(m, n) if rcond is None \
        else (float(torch.finfo(xa.dtype).eps) if rcond < 0 else rcond)
    # jnp's lstsq: through the SVD, singular values under rcond * s_max
    # dropped
    u, s, vt = torch.linalg.svd(xa, full_matrices=False)
    mask = (s > 0) & (s >= rc * s[0])
    rank = int(mask.sum())
    safe = torch.where(mask, s, torch.ones_like(s)).to(xa.dtype)
    s_inv = torch.where(mask, 1 / safe, torch.zeros_like(safe))[:, None]
    with _precision.f32_matmul("highest"):
        x = vt.mH @ (s_inv * (u.mH @ xb))
        if rank < n or m <= n:
            res = xa.new_empty((0,), dtype=s.dtype)
        else:
            res = torch.linalg.norm(xb - xa @ x, dim=0) ** 2
    if vec:
        x = x[:, 0]
    # numpy returns the rank as a plain int scalar
    return anchor._wrap(x, 0), anchor._wrap(res, 0), rank, \
        anchor._wrap(s, 0)


# ---------------------------------------------------------------------
# the tail: selection and partition, lexsort, grid, block and broadcast
# constructors, insert/delete/resize, the last np.linalg utilities, and
# the nonsymmetric-eig policy
# ---------------------------------------------------------------------

def _gather_fill(dtype):
    """jnp's fill value of an out-of-bounds gather: NaN for inexact
    types, the most negative value for signed integers, the largest for
    unsigned ones, True for bools."""
    if dtype.is_floating_point or dtype.is_complex:
        return np.nan
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@_implements(np.take_along_axis)
def _take_along_axis(arr, indices, axis=None):
    _require_gpu(arr)
    if axis is None:
        if np.ndim(indices) != 1:
            raise ValueError(
                "when axis=None, `indices` must have a single dimension.")
        arr, ax = arr.ravel(), 0
    else:
        ax = operator.index(axis)
        if ax < 0:
            ax += arr.ndim
        if not 0 <= ax < arr.ndim:
            raise np.exceptions.AxisError(axis, arr.ndim)
        if np.ndim(indices) != arr.ndim:
            raise ValueError(
                "`indices` and `arr` must have the same number of "
                "dimensions")
    n_ax = arr.shape[ax]
    checked = not _is_gpu(indices)
    if checked:
        # host-visible indices validate numpy's bounds eagerly; card ones
        # are exempt (checking them would be a copy to the host) and an
        # out-of-bounds one reads jnp's fill value
        host_idx = np.asarray(indices)
        if host_idx.size and ((host_idx < -n_ax) | (host_idx >= n_ax)).any():
            raise IndexError(
                "index out of bounds for axis %d with size %d" % (ax, n_ax))

    def body(d, idx):
        idx = idx.long()
        # negative indices wrap once; any index reads inside the axis
        safe = idx.remainder(max(n_ax, 1))
        shape = list(torch.broadcast_shapes(
            tuple(s for i, s in enumerate(d.shape) if i != ax),
            tuple(s for i, s in enumerate(safe.shape) if i != ax)))
        d = d.expand(shape[:ax] + [d.shape[ax]] + shape[ax:])
        safe = safe.expand(shape[:ax] + [safe.shape[ax]] + shape[ax:])
        out = torch.gather(d, ax, safe)
        if checked:
            return out
        ok = ((idx >= -n_ax) & (idx < n_ax)).expand(safe.shape)
        return torch.where(ok, out, torch.tensor(
            _gather_fill(out.dtype), device=out.device).to(out.dtype))

    return _device_fused("take_along_axis", [arr, indices], arr, arr.split,
                         body, (ax, checked), axes=WHOLE)


@_implements(np.put_along_axis)
def _put_along_axis(arr, indices, values, axis):
    if _is_gpu(arr):
        # the host fallback would mutate a copied array and discard it:
        # reject loudly instead
        raise TypeError(
            "put_along_axis mutates its target in place; card bolt arrays "
            "are immutable — use b.set(...) or build the result "
            "functionally")
    raise _Fallback("target is a host array")


def _partition_common(a, kth, axis, kind, order):
    _require_default(order=(order, None))
    _require_gpu(a)
    if kind != "introselect":
        raise ValueError("unknown kind %r" % (kind,))
    if not isinstance(kth, (int, np.integer)):
        raise _Fallback("sequence kth")
    if axis is None:
        a, ax = a.ravel(), 0
    else:
        ax = operator.index(axis)
        if ax < 0:
            ax += a.ndim
        if not 0 <= ax < a.ndim:
            raise np.exceptions.AxisError(axis, a.ndim)
    n = a.shape[ax]
    k = int(kth)
    if not -n <= k < n:
        raise ValueError("kth(=%d) out of bounds (%d)" % (k, n))
    return a, (k + n if k < 0 else k), ax


# partition's order inside each side is unspecified: a sorted axis is a
# partition at every kth (numpy's invariants), one sort a call


@_implements(np.partition)
def _partition(a, kth, axis=-1, kind="introselect", order=None):
    a, k, ax = _partition_common(a, kth, axis, kind, order)
    return _device_fused(
        "partition", [a], a, a.split,
        lambda d: torch.sort(d, dim=ax, stable=True).values, (k, ax),
        axes=(ax,))


@_implements(np.argpartition)
def _argpartition(a, kth, axis=-1, kind="introselect", order=None):
    a, k, ax = _partition_common(a, kth, axis, kind, order)
    return _device_fused(
        "argpartition", [a], a, a.split,
        lambda d: torch.argsort(_sortable(d), dim=ax, stable=True), (k, ax),
        axes=(ax,))


def _lexsort_body(axis):
    def body(*keys):
        # stable sorts from the least significant key (the first) to the
        # primary one (the last)
        idx = None
        for k in keys:
            k = _sortable(k)
            if idx is not None:
                k = torch.take_along_dim(k, idx, axis)
            order = torch.argsort(k, dim=axis, stable=True)
            idx = order if idx is None else torch.take_along_dim(idx, order,
                                                                 axis)
        return idx
    return body


@_implements(np.lexsort)
def _lexsort(keys, axis=-1):
    if _is_gpu(keys):
        # a single ≥2-d array: numpy treats the rows along axis 0 as the
        # key sequence (the last row primary)
        if keys.ndim == 0:
            raise _Fallback("0-d lexsort")
        if keys.ndim == 1:
            return keys.argsort(axis=axis, kind="stable")
        return _device_fused(
            "lexsort", [keys], keys, max(keys.split - 1, 0),
            lambda d: _lexsort_body(axis)(*d.unbind(0)), (axis,), axes=WHOLE)
    seq = list(keys)
    anchor = next((k for k in seq if _is_gpu(k)), None)
    if anchor is None:
        raise _Fallback("no card operand")
    if len({np.shape(k) for k in seq}) != 1:
        raise ValueError("all keys need to be the same shape")
    return _device_fused("lexsort", seq, anchor, anchor.split,
                         _lexsort_body(axis), (axis,), axes=WHOLE)


@_implements(np.meshgrid)
def _meshgrid(*xi, copy=True, sparse=False, indexing="xy"):
    if indexing not in ("xy", "ij"):
        raise ValueError("Valid values for `indexing` are 'xy' and 'ij'.")
    anchor = next((x for x in xi if _is_gpu(x)), None)
    if anchor is None:
        raise _Fallback("no card operand")
    if any(np.ndim(x) > 1 for x in xi):
        raise _Fallback("meshgrid over >1-d operands")
    k = len(xi)
    sparse = bool(sparse)
    if not sparse:
        from bolt_tpu_torch.gpu.array import hbm_check
        grid = prod([int(np.size(x)) for x in xi])
        item = sum(np.dtype(getattr(x, "dtype", np.float64)).itemsize
                   for x in xi)
        hbm_check("meshgrid", grid * item,
                  "%d dense grids of %d elements" % (k, grid), anchor.device)

    def body(*ds):
        # each input along its own axis (the first two swapped for 'xy'),
        # every output keeping its input's dtype
        shape = [d.numel() for d in ds]
        order = list(range(k))
        if indexing == "xy" and k > 1:
            order[0], order[1] = 1, 0
            shape[0], shape[1] = shape[1], shape[0]
        outs = []
        for i, d in enumerate(ds):
            s = [1] * k
            s[order[i]] = -1
            g = d.reshape(s)
            outs.append(g if sparse else g.expand(shape).contiguous())
        return tuple(outs)

    return list(_device_fused("meshgrid", list(xi), anchor, (0,) * k, body,
                              (sparse, indexing), axes=WHOLE))


def _block_depth(node):
    """The list nesting of a ``np.block`` spec, which must be uniform."""
    if not isinstance(node, list):
        return 0
    if not node:
        raise ValueError("Lists cannot be empty")
    depths = {_block_depth(c) for c in node}
    if len(depths) != 1:
        raise ValueError("List depths are mismatched")
    return 1 + depths.pop()


@_implements(np.block)
def _block(arrays):
    leaves = []

    def collect(node):
        if isinstance(node, list):
            return [collect(c) for c in node]
        leaves.append(node)
        return len(leaves) - 1

    spec = collect(arrays)
    anchor = next((x for x in leaves if _is_gpu(x)), None)
    if anchor is None:
        raise _Fallback("no card operand")
    depth = _block_depth(arrays)

    def body(*ds):
        # numpy's block: every leaf raised to the result's rank, the
        # innermost lists joined along the last axis, each outer level one
        # axis further left
        ds = _promoted(*ds)
        nd = max([depth] + [d.ndim for d in ds])

        def rec(node, level):
            if isinstance(node, list):
                return torch.cat([rec(c, level + 1) for c in node],
                                 -(depth - level))
            d = ds[node]
            return d.reshape((1,) * (nd - d.ndim) + tuple(d.shape))

        return rec(spec, 0)

    out_shape = _eval_shape(body, *leaves)
    new_split = min(anchor.split, len(out_shape))
    return _device_fused("block", leaves, anchor, new_split, body,
                         (repr(spec),), axes=WHOLE)


@_implements(np.broadcast_arrays)
def _broadcast_arrays(*args, subok=False):
    anchor = next((x for x in args if _is_gpu(x)), None)
    if anchor is None:
        raise _Fallback("no card operand")
    out_shape = np.broadcast_shapes(*[np.shape(a) for a in args])
    # an operand already at the full shape keeps its keys; broadcast ones
    # gain leading or stretched axes with no key meaning
    splits = tuple(a.split if _is_gpu(a) and a.shape == out_shape else 0
                   for a in args)
    return tuple(_device_fused(
        "broadcast_arrays", list(args), anchor, splits,
        lambda *ds: tuple(t.contiguous()
                          for t in torch.broadcast_tensors(*ds)), (),
        axes=WHOLE))


def _static_obj_key(obj):
    """Hashable key for a static insert/delete selector."""
    if isinstance(obj, slice):
        return ("slice", obj.start, obj.stop, obj.step)
    if isinstance(obj, (int, np.integer)):
        return ("int", int(obj))
    return ("arr", tuple(np.asarray(obj).ravel().tolist()),
            np.asarray(obj).shape, str(np.asarray(obj).dtype))


def _axis_of(arr, axis):
    """``(arr, axis)`` of an insert/delete: ``None`` ravels."""
    if axis is None:
        return arr.ravel(), 0
    ax = operator.index(axis)
    if ax < 0:
        ax += arr.ndim
    if not 0 <= ax < arr.ndim:
        raise np.exceptions.AxisError(axis, arr.ndim)
    return arr, ax


@_implements(np.delete)
def _delete(arr, obj, axis=None):
    _require_gpu(arr)
    if _is_gpu(obj):
        raise _Fallback("card selector")   # the result's size is static
    arr, ax = _axis_of(arr, axis)
    n = arr.shape[ax]
    if isinstance(obj, (int, np.integer)):
        if not -n <= obj < n:
            raise IndexError("index %d is out of bounds for axis %d with "
                             "size %d" % (obj, ax, n))
        keep = np.ones(n, bool)
        keep[obj] = False
    elif isinstance(obj, slice):
        keep = np.ones(n, bool)
        keep[obj] = False
    else:
        sel = np.asarray(obj)
        if sel.dtype == bool:
            if sel.shape != (n,):
                raise ValueError(
                    "boolean array argument obj to delete must be one "
                    "dimensional and match the axis length of %d" % n)
            keep = ~sel
        elif sel.size == 0 or np.issubdtype(sel.dtype, np.integer):
            keep = np.ones(n, bool)
            keep[sel.astype(np.intp)] = False   # numpy's IndexError
        else:
            raise IndexError("arrays used as indices must be of integer "
                             "(or boolean) type")
    kept = tuple(np.nonzero(keep)[0].tolist())

    def body(d):
        return torch.index_select(d, ax, torch.as_tensor(
            kept, dtype=torch.int64, device=d.device))

    return _device_fused("delete", [arr], arr, arr.split, body,
                         (ax, _static_obj_key(obj)), axes=(ax,))


@_implements(np.insert)
def _insert(arr, obj, values, axis=None):
    _require_gpu(arr)
    if _is_gpu(obj):
        raise _Fallback("card selector")
    arr, ax = _axis_of(arr, axis)
    n = arr.shape[ax]
    if isinstance(obj, slice):
        indices = np.arange(*obj.indices(n))
    else:
        indices = np.asarray(obj)
    if indices.ndim > 1:
        raise ValueError("index array argument obj to insert must be one "
                         "dimensional or scalar")
    if indices.size == 0 and not isinstance(obj, np.ndarray):
        indices = indices.astype(np.intp)
    if not np.issubdtype(indices.dtype, np.integer):
        raise IndexError("arrays used as indices must be of integer (or "
                         "boolean) type")
    bad = (indices < -n) | (indices > n)    # insert allows the end slot
    if np.any(bad):
        raise IndexError("index %s is out of bounds for axis %d with size "
                         "%d" % (indices[bad][:1] if indices.ndim
                                 else indices, ax, n))
    scalar = indices.ndim == 0
    nd = arr.ndim

    def body(d, v):
        # jnp.insert: the values take the array's dtype and rank; a scalar
        # index inserts the values' first axis at ``ax``; positions are
        # worked out on the host from the static selector
        v = v.to(d.dtype)
        v = v.reshape((1,) * (nd - v.ndim) + tuple(v.shape))
        idx = indices
        if idx.size == 1:
            if scalar:
                v = torch.movedim(v, 0, ax)
            idx = np.full(v.shape[ax], idx.ravel()[0])
        n_insert = np.broadcast_shapes(idx.shape, (v.shape[ax],))[0]
        idx = np.broadcast_to(np.where(idx < 0, idx + n, idx), (n_insert,))
        order = np.argsort(idx, kind="stable")
        vind = idx.astype(np.int64).copy()
        vind[order] += np.arange(n_insert)
        mask = np.ones(n + n_insert, bool)
        mask[vind] = False
        shape = list(d.shape)
        shape[ax] = n_insert
        out_shape = list(d.shape)
        out_shape[ax] += n_insert
        out = torch.zeros(out_shape, dtype=d.dtype, device=d.device)
        out.index_copy_(ax, torch.as_tensor(vind, device=d.device),
                        v.expand(shape).contiguous())
        out.index_copy_(ax, torch.as_tensor(np.nonzero(mask)[0],
                                            device=d.device), d)
        return out

    return _device_fused("insert", [arr, values], arr, arr.split, body,
                         (ax, _static_obj_key(indices), scalar), axes=WHOLE)


@_implements(np.resize)
def _resize(a, new_shape):
    _require_gpu(a)
    shp = tuple(operator.index(s) for s in (
        new_shape if isinstance(new_shape, (tuple, list)) else (new_shape,)))
    if any(s < 0 for s in shp):
        raise ValueError("all elements of `new_shape` must be non-negative")
    size = prod(shp)

    def body(d):
        # jnp.resize: the flat data repeated to fill, zeros when empty
        flat = d.reshape(-1)
        if flat.numel() == 0 or size == 0:
            return torch.zeros(shp, dtype=d.dtype, device=d.device)
        reps = -(-size // flat.numel())
        return flat.repeat(reps)[:size].reshape(shp)

    return _device_fused("resize", [a], a, min(a.split, len(shp)), body,
                         (shp,), axes=WHOLE)


def _cond(d, p):
    # jnp.linalg.cond: the singular value ratio for p in (None, 2, -2),
    # else norm(x, p) * norm(inv(x), p); a NaN from a singular matrix
    # reads inf
    if p is None or p == 2:
        s = _svdvals(d)
        return s[..., 0] / s[..., -1]
    if p == -2:
        s = _svdvals(d)
        r = s[..., -1] / s[..., 0]
    else:
        if d.shape[-1] != d.shape[-2]:
            raise np.linalg.LinAlgError(
                "Last 2 dimensions of the array must be square")
        r = torch.linalg.norm(d, ord=p, dim=(-2, -1)) * torch.linalg.norm(
            _inv(d), ord=p, dim=(-2, -1))
    return torch.where(torch.isnan(r) & ~torch.isnan(d).any(-1).any(-1),
                       torch.tensor(np.inf, dtype=r.dtype, device=r.device),
                       r)


@_implements(np.linalg.cond)
def _linalg_cond(x, p=None):
    _require_gpu(x)
    _two_d(x)
    if p not in (None, 2, -2) and x.shape[-1] != x.shape[-2]:
        raise np.linalg.LinAlgError(
            "Last 2 dimensions of the array must be square")
    return _device_fused("linalg_cond", [x], x, _mat_split(x),
                         _float_body(lambda d: _cond(d, p)), (str(p),),
                         axes=_MAT, keep=_batch(x))


@_implements(np.linalg.multi_dot)
def _linalg_multi_dot(arrays, *, out=None):
    _require_default(out=(out, None))
    seq = list(arrays)
    if len(seq) < 2:
        raise ValueError("Expecting at least two arrays.")
    if not any(_is_gpu(a) for a in seq):
        raise _Fallback("no card operand")
    anchor = next(a for a in seq if _is_gpu(a))
    # result ndim: 2 minus one per 1-d end operand; rows come from the
    # FIRST operand, so its keys survive iff it is 2-d and on the card (a
    # 1-d first operand is contracted away)
    out_ndim = 2 - (np.ndim(seq[0]) == 1) - (np.ndim(seq[-1]) == 1)
    first_rows_survive = _is_gpu(seq[0]) and np.ndim(seq[0]) == 2 \
        and out_ndim >= 1
    new_split = min(seq[0].split, 1) if first_rows_survive else 0
    pr = _precision.resolve()
    # integer chains compute in float and round back to the integer dtype
    # numpy answers with, instead of leaking a float result
    rt = dtypes.promote(*[_tdtype(o) for o in seq[:2]])
    for o in seq[2:]:
        rt = dtypes.promote(rt, _tdtype(o))
    target = rt if not (rt.is_floating_point or rt.is_complex) else None
    _eval_shape(lambda *xs: torch.linalg.multi_dot(
        [_as_float(x).to(torch.float64) for x in xs]), *seq)

    def body(*ds):
        ds = _promoted(*[_as_float(d) for d in ds])
        with _precision.f32_matmul(pr):
            out = torch.linalg.multi_dot(ds)
        return out if target is None else torch.round(out).to(target)

    return _device_fused("multi_dot", seq, anchor, new_split, body,
                         (pr, str(target)), axes=WHOLE)


@_implements(np.linalg.tensorsolve)
def _linalg_tensorsolve(a, b, axes=None):
    anchor = a if _is_gpu(a) else b
    _require_gpu(anchor)
    axs = None if axes is None else tuple(operator.index(x) for x in axes)
    # numpy's solve promotes through common_type: integers give float64,
    # floats keep their width
    probe = [np.empty(0, np.int64 if np.dtype(numpy_dtype(_tdtype(x)))
                      == np.bool_ else numpy_dtype(_tdtype(x)))
             for x in (a, b)]
    target = torch_dtype(np.common_type(*probe))
    a_nd = np.ndim(a)
    b_shape = tuple(np.shape(b))
    a_shape = list(np.shape(a))
    if axs is not None:
        rest = [i for i in range(a_nd) if i not in
                [x % a_nd for x in axs]]
        a_shape = [a_shape[i] for i in rest] + [a_shape[x % a_nd]
                                                for x in axs]
    out_shape = tuple(a_shape[len(b_shape):])
    if tuple(a_shape[:len(b_shape)]) != b_shape or \
            prod(b_shape) != prod(out_shape):
        raise np.linalg.LinAlgError(
            "tensorsolve: a.shape %s does not match b.shape %s"
            % (tuple(np.shape(a)), b_shape))

    def body(da, db):
        if axs is not None:
            da = torch.movedim(da, [x % a_nd for x in axs],
                               [a_nd - len(axs) + i
                                for i in range(len(axs))])
        da, db = _promoted(_as_float(da), _as_float(db))
        out = _solve(da.reshape(db.numel(), prod(out_shape)),
                     db.reshape(-1)).reshape(out_shape)
        return out if out.dtype == target else out.to(target)

    return _device_fused("tensorsolve", [a, b], anchor, 0, body,
                         (axs, str(target)), axes=WHOLE)


@_implements(np.linalg.tensorinv)
def _linalg_tensorinv(a, ind=2):
    _require_gpu(a)
    ind = operator.index(ind)
    if ind <= 0:
        raise ValueError("Invalid ind argument.")
    head, tail = tuple(a.shape[:ind]), tuple(a.shape[ind:])
    if prod(head) != prod(tail):
        raise np.linalg.LinAlgError(
            "tensorinv: the product of the first %d dimensions must equal "
            "that of the rest" % ind)

    def body(d):
        return _inv(d.reshape(prod(head), prod(tail))).reshape(tail + head)

    return _device_fused("tensorinv", [a], a, 0, _float_body(body), (ind,),
                         axes=WHOLE)


@_implements(np.linalg.eig, np.linalg.eigvals)
def _linalg_eig_policy(a, *args, **kwargs):
    if _is_gpu(a):
        # the reference serves no nonsymmetric eigendecomposition on its
        # device, and the port adds no feature the reference lacks: an
        # explicit policy, not a silent copy to the host
        raise NotImplementedError(
            "np.linalg.eig/eigvals of a card bolt array: no nonsymmetric "
            "eigendecomposition is served on the device. Use "
            "np.linalg.eigh/eigvalsh for symmetric/Hermitian matrices, or "
            "make the host transfer explicit with b.tolocal() first.")
    raise _Fallback("host operand")


# np.fft.fftfreq / rfftfreq take no array argument (n is an int), so they
# are NOT __array_function__-dispatchable.  With a card scalar ``d`` they
# are served COMPOSITIONALLY: numpy builds ``arange(n) * (1/(n*d))``,
# whose ufunc steps route through ``__array_ufunc__`` and the
# broadcasting ``_elementwise``, so the result is a card bolt array with
# no host math (tests/test_torch_npdispatch_tail.py::test_tail9_fftfreq).


# ---------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------

def _to_host(x):
    return np.asarray(x) if _is_gpu(x) else x


def dispatch(func, types, args, kwargs):
    """Serve ``func`` from the table, else fall back to the host: copy
    every bolt operand (``__array__`` warns above the size threshold) and
    run plain numpy — numpy-correct always, on the card where the table
    covers it.  Per NEP-18 an operand type this package does not know
    (another library's duck array) gets ``NotImplemented``, so ITS
    ``__array_function__`` is consulted instead."""
    from bolt_tpu_torch.base import BoltArray
    for t in types:
        if not issubclass(t, (BoltArray, np.ndarray, torch.Tensor)):
            return NotImplemented
    handler = _TABLE.get(func)
    if handler is not None:
        try:
            return handler(*args, **kwargs)
        except _Fallback:
            pass
    host_args = tuple(
        tuple(_to_host(x) for x in a) if isinstance(a, (tuple, list))
        else _to_host(a) for a in args)
    host_kwargs = {k: _to_host(v) for k, v in kwargs.items()}
    return func(*host_args, **host_kwargs)
