"""``__array_function__`` dispatch: the non-ufunc NumPy API on the card.

Port of ``bolt_tpu/tpu/npdispatch.py`` (its dispatcher, the core table
and the families that route into the ops library).  ``np.sum(b)``,
``np.sort(b)``, ``np.histogram(b)``, ``np.cov(b)`` and the rest of the
table run the bolt methods with NUMPY semantics (``np.sum(b)`` reduces
every axis where ``b.sum()`` reduces the key axes) and return bolt
arrays, with no copy to the host.  A function outside the table, or a
call with keywords the card path cannot honour (``out=``, ``dtype=``,
array bin edges), takes the host fallback: every bolt operand is copied
to the host through ``__array__`` (which warns above
``gpu/array.py :: IMPLICIT_GATHER_WARN_BYTES``) and plain numpy answers.
The reference's stacking, einsum, nan-family, ``np.linalg``, ``np.fft``
and tail entries are not in this table yet: they take the host fallback.
"""

import operator

import numpy as np
import torch

from bolt_tpu_torch.utils import inshape, tupleize

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
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
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


@_implements(np.concatenate)
def _concatenate(arrays, axis=0, out=None, dtype=None, casting="same_kind"):
    _require_default(out=(out, None), dtype=(dtype, None))
    seq = list(arrays)
    if not seq:
        raise ValueError("need at least one array to concatenate")
    first = seq[0]
    if not _is_gpu(first):
        raise _Fallback("first operand not on the card")
    parts = [_tensor(first, x) for x in seq]
    if axis is None:
        parts = [p.reshape(-1) for p in parts]
        new_split = 1 if first.split else 0
    else:
        axis = int(axis)
        for p in parts:
            if p.ndim != first.ndim:
                raise ValueError("cannot concatenate %d-d with %d-d array"
                                 % (first.ndim, p.ndim))
        new_split = first.split
    from bolt_tpu_torch.gpu import dtypes
    dt = parts[0].dtype
    for p in parts[1:]:
        dt = dtypes.promote(dt, p.dtype)
    out = torch.cat([p.to(dt) for p in parts],
                    dim=0 if axis is None else axis)
    return first._wrap(out, new_split)


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
    # anchor on the operand with the most key axes
    b = max(devs, key=lambda a: a.split)
    c = _tensor(b, condition)
    xs = [v if isinstance(v, (int, float, complex, bool)) else _tensor(b, v)
          for v in (x, y)]
    out = torch.where(c if c.dtype == torch.bool else c != 0, *xs)
    split = b.split
    # keys survive only when no broadcast axis displaced them
    shape = tuple(out.shape)
    new_split = split if (len(shape) == b.ndim
                          and shape[:split] == b.shape[:split]) else 0
    return b._wrap(out, new_split)


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
    h, edges = histogramdd(sample.totorch(), bb, _static_ranges(range),
                           bool(density))
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
