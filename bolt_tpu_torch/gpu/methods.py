"""The ndarray method surface of the gpu mode: quantiles, arg-reductions,
sorts, cumulative ops, gathers, products and the functional update.

Port of the methods ``bolt_tpu/tpu/array.py`` defines beside its
terminals (``quantile``, ``argmax``, ``argsort``, ``sort``, ``cumsum``,
``take``, ``repeat``, ``diagonal``, ``trace``, ``nonzero``,
``searchsorted``, ``set``, ``item``, ``_matmul``/``dot`` and the ufunc
methods of ``_ufunc_method``).  :class:`ArrayMethods` is a mixin of
:class:`~bolt_tpu_torch.gpu.array.BoltArrayGPU`: each method applies a
deferred chain once (``_mapped``), runs torch ops on the result and wraps
it with the reference's split rule.  The reference's slabbed
``_argsort_chunked`` has no counterpart (one card sorts in place of the
slabs); its up-front demand checks do (``gpu/array.py :: hbm_check``:
cumulative ops, ``argsort``, ``sort``).

``quantile`` sorts the reduced axes with ``torch.sort`` and interpolates
as ``jnp.quantile`` does (``torch.quantile`` refuses inputs above 2**24
elements; config 1's key-axis median has 1.6e8).
"""

from numbers import Integral

import numpy as np
import torch

from bolt_tpu_torch import _precision
from bolt_tpu_torch.gpu import dtypes, ufuncs
from bolt_tpu_torch.gpu.dtypes import torch_dtype
from bolt_tpu_torch.utils import prod, tupleize

QUANTILE_METHODS = ("linear", "lower", "higher", "midpoint", "nearest")

def _hbm_check(op, need_bytes, model, device):
    # gpu/array.py imports this module: its hbm_check is read at the call
    from bolt_tpu_torch.gpu.array import hbm_check
    hbm_check(op, need_bytes, model, device)


def _check_sort_kind(kind):
    """numpy's sort kinds (its wording for the rejection).  Every kind
    sorts stably here, which is numpy's tie order for ``stable``."""
    if kind not in (None, "quicksort", "heapsort", "mergesort", "stable"):
        raise ValueError("sort kind must be one of 'quick', 'heap', "
                         "or 'stable' (got %r)" % (kind,))


def _sortable(x):
    """``x`` in a dtype torch sorts, flips and gathers on every device,
    with the same order: bools as bytes, the unsigned integers torch
    leaves out in their ordered carriers (``gpu/dtypes.py :: carry``);
    :func:`_unsortable` takes sorted values back."""
    return dtypes.carry(x, ordered=True)


def _unsortable(s, dtype):
    """Values taken from :func:`_sortable`'s tensor, back in ``dtype``."""
    return dtypes.uncarry(s, dtype, ordered=True)


def _argsort(x, dim):
    """The stable ascending order of ``x`` along ``dim``; complex numbers
    in numpy's order, by the real part and ties by the imaginary part
    (two stable sorts: torch sorts no complex tensor)."""
    if not x.is_complex():
        return torch.argsort(_sortable(x), dim=dim, stable=True)
    i = torch.argsort(x.imag, dim=dim, stable=True)
    j = torch.argsort(torch.take_along_dim(x.real, i, dim), dim=dim,
                      stable=True)
    return torch.take_along_dim(i, j, dim)


def _dot(a, b):
    """``numpy.dot``: the sum product over ``a``'s last axis and ``b``'s
    second-to-last (its only axis when 1-d)."""
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.ndim - 1],
                                       [max(b.ndim - 2, 0)]))


def quantile_of(x, qarr, axes, keepdims, method):
    """``jnp.quantile(x, q, axis=axes, keepdims=keepdims, method=...)``
    of the tensor ``x`` with a 1-d ``qarr``: the reduced axes moved last
    and sorted, the two order statistics around ``q * (n - 1)`` weighted
    as jnp weighs them, NaN wherever a reduced slice holds one.  The q
    axis leads the result."""
    if method not in QUANTILE_METHODS:
        raise ValueError("method can only be %s, got %r"
                         % (", ".join(QUANTILE_METHODS), method))
    cdt = dtypes.promote(x.dtype, torch.float32)
    if cdt.is_complex:
        raise ValueError("quantile does not support complex input")
    keep = [a for a in range(x.ndim) if a not in axes]
    kshape = [x.shape[a] for a in keep]
    s = torch.sort(x.to(cdt).permute(keep + list(axes)).reshape(
        kshape + [-1]), dim=-1).values
    n = s.shape[-1]
    qt = torch.as_tensor(qarr, dtype=cdt, device=x.device) * (n - 1)
    low, high = torch.floor(qt), torch.ceil(qt)
    hw = qt - low
    lw = 1 - hw
    low = low.clamp(0, n - 1).to(torch.int64)
    high = high.clamp(0, n - 1).to(torch.int64)
    lo = s[..., low].movedim(-1, 0)
    hi = s[..., high].movedim(-1, 0)
    w = (len(qarr),) + (1,) * len(kshape)
    if method == "linear":
        out = lo * lw.reshape(w) + hi * hw.reshape(w)
    elif method == "lower":
        out = lo
    elif method == "higher":
        out = hi
    elif method == "nearest":
        out = torch.where((hw <= 0.5).reshape(w), lo, hi)
    else:
        out = (lo + hi) * 0.5
    # torch sorts NaN last: a slice holding one gives NaN
    out = torch.where(torch.isnan(s[..., -1]), float("nan"), out)
    if keepdims:
        out = out.reshape((len(qarr),) + tuple(
            1 if a in axes else x.shape[a] for a in range(x.ndim)))
    return out


class ArrayMethods:
    """The ndarray methods of :class:`BoltArrayGPU` (see the module
    docstring)."""

    def _one_axis(self, axis):
        """Normalise a single int axis (negative wrap, range check);
        ``TypeError`` for a non-integer, as ndarray's methods raise."""
        if not isinstance(axis, Integral):
            raise TypeError("axis %r is not an integer" % (axis,))
        axis = int(axis)
        if axis < 0:
            axis += self.ndim
        if not 0 <= axis < self.ndim:
            raise ValueError("axis %d is out of bounds for array of "
                             "dimension %d" % (axis, self.ndim))
        return axis

    # ------------------------------------------------------------------
    # reductions beside the stat terminals
    # ------------------------------------------------------------------

    def quantile(self, q, axis=None, keepdims=False, method="linear"):
        """The ``q``-th quantile over ``axis`` (default: the key axes).
        ``q`` is a scalar or a 1-d array in [0, 1]; a 1-d ``q`` prepends a
        q axis, a flat KEY axis, as in the reference (the remaining key
        axes stay leading).  f32 or wider: an integer or f16 input
        computes in f32, as jnp does."""
        from bolt_tpu_torch.utils import check_q
        qarr = check_q(q)
        vector = qarr.ndim == 1
        from bolt_tpu_torch.gpu.array import stat_axes, stat_split
        axes = stat_axes(self.shape, self._split, axis)
        new_split = stat_split(self._split, axes, keepdims) + (1 if vector
                                                              else 0)
        out = quantile_of(self._mapped(), qarr.reshape(-1), axes, keepdims,
                          method)
        return self._wrap(out if vector else out[0], new_split)

    def median(self, axis=None, keepdims=False):
        """Median over ``axis`` (default: the key axes)."""
        return self.quantile(0.5, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        """Index of the maximum along one axis (``None``: into the
        flattened array); ties take the first occurrence and a NaN wins,
        as in numpy."""
        return self._arg_stat(torch.argmax, axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        """Index of the minimum along one axis (see :meth:`argmax`)."""
        return self._arg_stat(torch.argmin, axis, keepdims)

    def _arg_stat(self, fn, axis, keepdims):
        if axis is not None:
            axis = self._one_axis(axis)
        x = _sortable(self._mapped())
        if x.is_complex():
            raise TypeError("%s of a complex array is not supported (the "
                            "reference refuses it too); np.argsort takes "
                            "numpy's order" % fn.__name__)
        if axis is None:
            out = fn(x.reshape(-1))
            if keepdims:
                out = out.reshape((1,) * x.ndim)
            return self._wrap(out, 0)
        split = self._split
        new_split = split - (1 if axis < split and not keepdims else 0)
        return self._wrap(fn(x, dim=axis, keepdim=keepdims), new_split)

    def cumsum(self, axis=None):
        """Cumulative sum along one axis; ``None`` is the cumsum of the
        flattened array, keyed by one flat key axis (``filter``'s
        convention).  jnp's dtypes: integers keep theirs, bool counts in
        int64."""
        return self._cum(torch.cumsum, axis)

    def cumprod(self, axis=None):
        """Cumulative product (see :meth:`cumsum`)."""
        return self._cum(torch.cumprod, axis)

    def _cum(self, fn, axis):
        split = self._split
        if axis is not None:
            axis = self._one_axis(axis)
        # memory model: input + full-size output (bool counts in int64)
        out_item = 8 if self.dtype == np.bool_ else self.dtype.itemsize
        _hbm_check(fn.__name__, self.size * (self.dtype.itemsize + out_item),
                   "input + full-size output", self.device)
        x = self._mapped()
        dt = torch.int64 if x.dtype == torch.bool else x.dtype
        # an unsigned dtype torch leaves out scans in its carrier, which
        # wraps alike
        c, cdt = dtypes.carry(x), dtypes.carrier(dt)
        if axis is None:
            out, split = fn(c.reshape(-1), dim=0, dtype=cdt), 1 if split else 0
        else:
            out = fn(c, dim=axis, dtype=cdt)
        return self._wrap(dtypes.uncarry(out, dt), split)

    # ------------------------------------------------------------------
    # sorts and gathers
    # ------------------------------------------------------------------

    def argsort(self, axis=-1, kind=None):
        """Indices that sort along ``axis`` (default: the last; ``None``
        flattens, keyed by one flat key axis).  Stable under every
        ``kind``, so ties keep numpy's ``stable`` order."""
        _check_sort_kind(kind)
        split = self._split
        if axis is not None:
            axis = self._one_axis(axis)
        # memory model: input + index output + the sort's scratch of both
        in_bytes = self.size * self.dtype.itemsize
        _hbm_check("argsort", 2 * (in_bytes + self.size * 8),
                   "input + index output + sort scratch of both",
                   self.device)
        x = self._mapped()
        if axis is None:
            return self._wrap(_argsort(x.reshape(-1), 0), 1 if split else 0)
        return self._wrap(_argsort(x, axis), split)

    def sort(self, axis=-1, kind=None):
        """Sort along ``axis`` in place and return ``None``, ndarray's
        convention: this wrapper rebinds to the sorted tensor (other
        wrappers of the old data keep it)."""
        _check_sort_kind(kind)
        axis = self._one_axis(axis)
        # memory model: input + sorted output + sort scratch
        _hbm_check("sort", 3 * self.size * self.dtype.itemsize,
                   "input + sorted output + sort scratch", self.device)
        x = self._mapped()
        if x.is_complex():
            out = torch.take_along_dim(x, _argsort(x, axis), axis)
        else:
            out = _unsortable(torch.sort(_sortable(x), dim=axis,
                                         stable=True).values, x.dtype)
        self._adopt_materialised(out)
        self._stat_group = None
        return None

    def take(self, indices, axis=None, mode="raise"):
        """Elements by index (``ndarray.take``): ``axis=None`` indexes the
        flattened array (keyed by one flat key axis), an int axis gathers
        along it.  ``mode``: ``raise`` (negative indices wrap once, any
        other out of bounds raises ``IndexError``), ``wrap``, ``clip``.
        Index dtypes follow numpy: float arrays are refused, float
        sequences truncate, bools are 0/1."""
        if mode not in ("raise", "wrap", "clip"):
            raise ValueError("mode must be 'raise', 'wrap' or 'clip', "
                             "got %r" % (mode,))
        arraylike = isinstance(indices, np.ndarray) or (
            hasattr(indices, "__array__")
            and not isinstance(indices, (list, tuple)))
        idx = np.asarray(indices)
        if idx.dtype == bool:
            idx = idx.astype(np.intp)
        elif not np.issubdtype(idx.dtype, np.integer):
            if arraylike:
                raise TypeError("Cannot cast take indices from %s to "
                                "integer" % (idx.dtype,))
            idx = np.trunc(idx).astype(np.intp)
        if axis is not None:
            axis = self._one_axis(axis)
        dim = prod(self.shape) if axis is None else self.shape[axis]
        if mode == "wrap":
            wrapped = idx % dim
        elif mode == "clip":
            wrapped = np.clip(idx, 0, dim - 1)
        else:
            wrapped = np.where(idx < 0, idx + dim, idx)
            if idx.size and (wrapped.min() < 0 or wrapped.max() >= dim):
                raise IndexError("take index out of bounds for size %d"
                                 % dim)
        split = self._split
        x = self._mapped()
        ids = torch.as_tensor(wrapped.astype(np.int64), device=x.device)
        if axis is None:
            return self._wrap(x.reshape(-1)[ids],
                              1 if split and idx.ndim else 0)
        out = torch.index_select(x, axis, ids.reshape(-1)).reshape(
            tuple(x.shape[:axis]) + idx.shape + tuple(x.shape[axis + 1:]))
        new_split = split if axis >= split or idx.ndim == 1 \
            else split + idx.ndim - 1
        return self._wrap(out, new_split)

    def ravel(self, order="C"):
        """Flatten to 1-d, keyed by one flat key axis (a key-less array
        stays key-less).  ``F`` flattens column-major; ``A``/``K`` follow
        the logical C order."""
        if order not in ("C", "F", "A", "K"):
            raise ValueError("order must be one of 'C', 'F', 'A', or 'K' "
                             "(got %r)" % (order,))
        x = self._mapped()
        if order == "F":
            x = x.permute(tuple(reversed(range(x.ndim))))
        return self._wrap(x.reshape(-1), 1 if self._split else 0)

    def flatten(self, order="C"):
        """A flattened copy: :meth:`ravel`."""
        return self.ravel(order=order)

    def repeat(self, repeats, axis=None):
        """Repeat elements (``ndarray.repeat``: ``axis=None`` flattens
        first; ``repeats`` a scalar or a 1-d array of the axis' length;
        floats truncate)."""
        rep = np.asarray(repeats)
        if rep.ndim > 1:
            raise ValueError("object too deep for desired array")
        if rep.dtype == bool or not np.issubdtype(rep.dtype, np.integer):
            rep = np.trunc(rep).astype(np.int64)
        if rep.size and rep.min() < 0:
            raise ValueError("negative dimensions are not allowed")
        if axis is not None:
            axis = self._one_axis(axis)
        dim = prod(self.shape) if axis is None else self.shape[axis]
        if rep.ndim == 1 and rep.size not in (1, dim):
            raise ValueError("operands could not be broadcast together "
                             "with shape (%d,) (%d,)" % (dim, rep.size))
        x = self._mapped()
        if rep.ndim == 1 and rep.size == dim:
            r = torch.as_tensor(rep.astype(np.int64), device=x.device)
        else:
            r = int(rep.reshape(-1)[0])
        split = self._split
        if axis is None:
            return self._wrap(torch.repeat_interleave(x.reshape(-1), r),
                              1 if split else 0)
        return self._wrap(torch.repeat_interleave(x, r, dim=axis), split)

    def _diag_axes(self, axis1, axis2):
        axis1, axis2 = self._one_axis(axis1), self._one_axis(axis2)
        if axis1 == axis2:
            raise ValueError("axis1 and axis2 cannot be the same")
        return axis1, axis2

    def _diag_split(self, axis1, axis2):
        return self._split - sum(1 for a in (axis1, axis2)
                                 if a < self._split)

    def diagonal(self, offset=0, axis1=0, axis2=1):
        """The diagonals of the (``axis1``, ``axis2``) planes, as the last
        (value) axis; the remaining key axes stay leading."""
        axis1, axis2 = self._diag_axes(axis1, axis2)
        out = torch.diagonal(self._mapped(), int(offset), axis1, axis2)
        return self._wrap(out.contiguous(), self._diag_split(axis1, axis2))

    def trace(self, offset=0, axis1=0, axis2=1, dtype=None):
        """Sum of the (``axis1``, ``axis2``) diagonals, in the dtype
        numpy's ``ndarray.trace`` gives (int8 and bool count in int64)."""
        axis1, axis2 = self._diag_axes(axis1, axis2)
        target = torch_dtype(np.empty((1, 1), dtype=self.dtype).trace(
            dtype=dtype).dtype)
        d = torch.diagonal(self._mapped(), int(offset), axis1, axis2)
        return self._wrap(d.to(target).sum(dim=-1, dtype=target),
                          self._diag_split(axis1, axis2))

    def nonzero(self):
        """Indices of the non-zero elements: a tuple of host int64 arrays,
        one per axis (ndarray's return)."""
        from bolt_tpu_torch.gpu.array import _download
        return tuple(_download(i) for i in torch.nonzero(
            self._mapped(), as_tuple=True))

    def searchsorted(self, v, side="left", sorter=None):
        """Insertion points that keep this sorted 1-d array sorted, as
        host indices: a numpy int for a scalar ``v``, an int64 array of
        ``v``'s shape otherwise."""
        if self.ndim != 1:
            raise ValueError("object too deep for desired array")
        if side not in ("left", "right"):
            raise ValueError("'%s' is an invalid value for keyword 'side'"
                             % (side,))
        if sorter is not None:
            sorter = np.asarray(sorter)
            if not np.issubdtype(sorter.dtype, np.integer):
                raise TypeError("sorter must only contain integers")
            if sorter.shape != self.shape:
                raise ValueError("sorter.size must equal a.size")
        from bolt_tpu_torch.gpu.array import BoltArrayGPU
        vt = self._operand(v) if isinstance(v, BoltArrayGPU) else \
            torch.as_tensor(np.asarray(v), device=self.device)
        x = self._mapped()
        if sorter is not None:
            x = x[torch.as_tensor(sorter.astype(np.int64), device=x.device)]
        cd = dtypes.promote(x.dtype, vt.dtype)
        out = torch.searchsorted(x.to(cd), vt.to(cd).reshape(-1),
                                 right=side == "right")
        out = out.reshape(vt.shape).cpu().numpy().astype(np.int64)
        return out[()] if vt.ndim == 0 else out

    # ------------------------------------------------------------------
    # the functional update and element reads
    # ------------------------------------------------------------------

    def set(self, index, value):
        """Functional indexed update: a NEW array equal to this one with
        ``self[index] = value``, the region ``__getitem__`` with the same
        index reads (two or more advanced indices apply orthogonally);
        ``value`` broadcasts against it and casts to this dtype (numpy's
        assignment).  Device tensors are not assigned in place."""
        from bolt_tpu_torch.utils import assignment_index, normalize_index
        norm, squeezed = normalize_index(index, self.shape)
        idx = assignment_index(norm, self.shape, squeezed)
        if any(isinstance(s, slice) and s.step < 0 for s in idx):
            # torch slices take no negative step: open every axis into
            # an orthogonal mesh of index vectors (the region numpy
            # assigns to is the same)
            axes = [ax for ax, s in enumerate(idx) if not isinstance(s, int)]
            vecs = [np.ascontiguousarray(np.arange(self.shape[ax])[idx[ax]])
                    if isinstance(idx[ax], slice) else idx[ax].reshape(-1)
                    for ax in axes]
            idx = list(idx)
            for pos, (ax, vec) in enumerate(zip(axes, vecs)):
                idx[ax] = vec.reshape((1,) * pos + (vec.size,)
                                      + (1,) * (len(axes) - pos - 1))
        from bolt_tpu_torch.gpu.array import BoltArrayGPU
        if isinstance(value, BoltArrayGPU):
            val = self._operand(value)
        else:
            val = torch.as_tensor(np.asarray(value), device=self.device)
        region = self.ndim - len(squeezed)
        while val.ndim > region and val.shape[0] == 1:
            val = val.reshape(val.shape[1:])
        x = self._mapped()
        out = x.clone()
        tidx = tuple(torch.as_tensor(s, dtype=torch.int64, device=x.device)
                     if isinstance(s, np.ndarray) else s for s in idx)
        try:
            out[tidx] = val.to(out.dtype)
        except RuntimeError as exc:
            raise ValueError("could not broadcast the value into the "
                             "region: %s" % exc) from None
        return self._wrap(out, self._split)

    def __setitem__(self, index, value):
        raise TypeError(
            "'%s' does not support item assignment: device arrays are "
            "immutable.  Use b = b.set(index, value) for a functional "
            "update with the same indexing semantics (the local backend "
            "offers the same method)" % type(self).__name__)

    def item(self, *args):
        """One element as a Python scalar (ndarray's forms: no argument
        for a size-1 array, a flat index, or one index per axis;
        negatives wrap).  Only that element is copied to the host."""
        if len(args) == 1 and isinstance(args[0], tuple):
            args = args[0]
        if not all(isinstance(a, Integral) for a in args):
            raise TypeError("item() takes integer arguments")
        shape = self.shape
        if not args:
            if prod(shape) != 1:
                raise ValueError("can only convert an array of size 1 to "
                                 "a Python scalar")
            multi = (0,) * len(shape)
        elif len(args) == 1:
            flat, size = int(args[0]), prod(shape)
            if flat < 0:
                flat += size
            if not 0 <= flat < size:
                raise IndexError("index %d is out of bounds for size %d"
                                 % (int(args[0]), size))
            multi = tuple(int(i) for i in np.unravel_index(flat, shape))
        else:
            if len(args) != len(shape):
                raise ValueError("incorrect number of indices for array")
            multi = []
            for a, dim in zip(args, shape):
                i = int(a) + (dim if int(a) < 0 else 0)
                if not 0 <= i < dim:
                    raise IndexError("index %d is out of bounds for axis "
                                     "of size %d" % (int(a), dim))
                multi.append(i)
            multi = tuple(multi)
        return self._mapped()[multi].item()

    def tolist(self):
        """Nested Python lists of the whole array (a full copy to the
        host, like :meth:`toarray`)."""
        return self.toarray().tolist()

    # ------------------------------------------------------------------
    # products
    # ------------------------------------------------------------------

    def _matmul(self, other, reverse=False, dot=False, precision=None):
        """``@`` (or ``numpy.dot`` with ``dot``) batched over the key axes
        with ``torch.matmul``.  f32 runs at full precision unless the
        precision mode (``precision=``, else the scope) asks for the
        faster TF32 (``high``) or bf16 (``default``) pass.  Keys survive
        while they still lead the output; a contraction mismatch raises
        numpy's ``ValueError``."""
        mode = _precision.resolve(precision)
        odata = self._operand(other)
        x = self._data
        a, b = (odata, x) if reverse else (x, odata)
        cdt = dtypes.promote(a.dtype, b.dtype)
        fn = _dot if dot else torch.matmul
        try:
            shape = tuple(fn(torch.empty(a.shape, dtype=cdt, device="meta"),
                             torch.empty(b.shape, dtype=cdt,
                                         device="meta")).shape)
        except RuntimeError as exc:
            raise ValueError(str(exc)) from None
        with _precision.f32_matmul(mode):
            out = fn(a.to(cdt), b.to(cdt))
        cap = self.ndim - (2 if reverse else 1)
        new_split = min(self._split, max(cap, 0))
        if odata.ndim > self.ndim or shape[:new_split] != \
                tuple(self.shape[:new_split]):
            new_split = 0
        return self._wrap(out, new_split)

    def dot(self, other, *, precision=None):
        """``numpy.dot``: the matrix product for 2-d, the inner product
        for 1-d, and for higher ranks the sum product over this array's
        last axis and ``other``'s second-to-last.  ``precision`` as for
        ``@`` (keyword-only: ndarray.dot's second positional is ``out``,
        which this backend does not take)."""
        return self._matmul(other, dot=True, precision=precision)


def _reduce_axes(arr, axis):
    if axis is None:
        return tuple(range(arr.ndim))
    axes = tuple(sorted(arr._one_axis(a) for a in tupleize(axis)))
    if len(set(axes)) != len(axes):
        raise ValueError("duplicate value in 'axis'")
    return axes


def ufunc_method(arr, ufunc, method, inputs, kwargs):
    """The binary ufunc methods on the gpu array ``arr`` (reference:
    ``BoltArrayTPU._ufunc_method``): ``np.add.reduce(b)``,
    ``np.multiply.accumulate(b)``, ``np.subtract.outer(b, w)``,
    ``np.add.reduceat(b, idx)``, each on the device.  ``out=``, a masking
    ``where=``, a ufunc with no torch twin and a ``reduce``/``reduceat``
    whose fold order does not match numpy's (``UFUNC_FOLD_SAFE``) return
    NotImplemented, so numpy raises ``TypeError``."""
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    name = ufunc.__name__
    if ufunc.nin != 2 or ufunc.nout != 1 or not ufuncs.has(name, 2):
        return NotImplemented
    kwargs = dict(kwargs)
    if kwargs.pop("out", None) is not None:
        return NotImplemented
    where = kwargs.pop("where", True)
    if where is not True and not (np.ndim(where) == 0
                                  and bool(np.asarray(where))):
        return NotImplemented
    dtype = kwargs.pop("dtype", None)
    dt = None if dtype is None else torch_dtype(dtype)

    if method == "reduce":
        axis = kwargs.pop("axis", 0)
        keepdims = kwargs.pop("keepdims", False)
        initial = kwargs.pop("initial", None)
        if kwargs or len(inputs) != 1 or inputs[0] is not arr \
                or name not in ufuncs.UFUNC_FOLD_SAFE:
            return NotImplemented
        if initial is not None and not isinstance(initial, (int, float,
                                                            complex)):
            if np.ndim(initial) != 0:
                return NotImplemented
            initial = np.asarray(initial).item()
        axes = _reduce_axes(arr, axis)
        if len(axes) > 1:
            # numpy itself refuses a multi-axis reduce of an op that is
            # not reorderable (its exact ValueError)
            ufunc.reduce(np.zeros((1,) * arr.ndim, arr.dtype), axis=axes)
        split = arr.split
        if name == "bitwise_xor" and any(a < split for a in axes):
            # the reference refuses an xor over the key axes (XLA has no
            # cross-device xor combine): the same answer here
            return NotImplemented
        new_split = split if (keepdims or not axes) else \
            split - sum(1 for a in axes if a < split)
        return arr._wrap(ufuncs.ufunc_reduce(
            ufunc, arr._mapped(), axes, dt, keepdims, initial), new_split)

    if method == "accumulate":
        axis = kwargs.pop("axis", 0)
        if kwargs or len(inputs) != 1 or inputs[0] is not arr:
            return NotImplemented
        if axis is None:
            raise ValueError("accumulate does not allow multiple axes")
        return arr._wrap(ufuncs.ufunc_accumulate(
            ufunc, arr._mapped(), arr._one_axis(axis), dt), arr.split)

    if method == "outer":
        if kwargs or len(inputs) != 2:
            return NotImplemented
        a, b = (x._mapped() if isinstance(x, BoltArrayGPU)
                else arr._operand(x) for x in inputs)
        new_split = inputs[0].split if isinstance(inputs[0], BoltArrayGPU) \
            else 0
        return arr._wrap(ufuncs.ufunc_outer(ufunc, a, b, dt), new_split)

    if method == "reduceat":
        axis = kwargs.pop("axis", 0)
        if kwargs or len(inputs) != 2 or inputs[0] is not arr \
                or name not in ufuncs.UFUNC_FOLD_SAFE:
            return NotImplemented
        if axis is None:
            raise ValueError("reduceat does not allow multiple axes")
        axis = arr._one_axis(axis)
        indices = inputs[1]
        if isinstance(indices, BoltArrayGPU):
            idx = indices.toarray()
        else:
            idx = np.asarray(indices)
            n_ax = arr.shape[axis]
            bad = (idx < 0) | (idx >= n_ax)
            if idx.size and bad.any():
                raise IndexError("index %d out-of-bounds in %s.reduceat "
                                 "[0, %d)" % (int(idx[bad][0]), name, n_ax))
        if idx.ndim != 1:
            return NotImplemented
        return arr._wrap(ufuncs.ufunc_reduceat(
            ufunc, arr._mapped(), idx, axis, dt), arr.split)
    return NotImplemented
