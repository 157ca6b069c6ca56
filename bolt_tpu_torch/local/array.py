"""The ``mode='local'`` backend: a ``numpy.ndarray`` subclass.

This is the semantic oracle — every device-backend parity test compares against
this implementation (reference: ``bolt/local/array.py :: BoltArrayLocal``;
symbol-level citation, see SURVEY.md §0).
"""

from itertools import product as _product

import numpy as np

from bolt_tpu_torch.base import BoltArray
from bolt_tpu_torch.utils import inshape, prod, tupleize

# the statistic names the fluent ``stats("sum", ...)`` form accepts (the
# reference keeps them beside its fused multi-stat, ``multistat.py:78``)
LAZY_NAMES = ("sum", "mean", "var", "std", "min", "max", "prod", "all",
              "any", "ptp")


class BoltArrayLocal(np.ndarray, BoltArray):
    """NumPy-backed bolt array.

    Being an ``ndarray`` subclass, it inherits the full NumPy operator and
    reduction surface (``+``, ``mean(axis=...)``, ``T``, slicing, …); the
    bolt-specific functional operators (``map``/``filter``/``reduce``) treat
    the ``axis`` argument as the key-axis set, exactly like the distributed
    backend (reference: ``bolt/local/array.py`` — ``__new__`` view-cast,
    functional ops via key-axes-to-front reshape).
    """

    _mode = "local"

    def __new__(cls, array):
        return np.asarray(array).view(cls)

    @property
    def mode(self):
        return self._mode

    @property
    def _constructor(self):
        from bolt_tpu_torch.local.construct import ConstructLocal
        return ConstructLocal

    # ------------------------------------------------------------------
    # internal: move key axes to the front and flatten them
    # ------------------------------------------------------------------

    def _kv_reshape(self, axis):
        """Return ``(flat, key_shape, value_shape)`` where ``flat`` has shape
        ``(prod(key_shape), *value_shape)`` with key axes moved to the front.

        Reference: the reshape idiom inside
        ``bolt/local/array.py :: BoltArrayLocal.map``.
        """
        axes = sorted(tupleize(axis))
        inshape(self.shape, axes)
        rest = [i for i in range(self.ndim) if i not in axes]
        key_shape = tuple(self.shape[a] for a in axes)
        value_shape = tuple(self.shape[i] for i in rest)
        moved = np.transpose(np.asarray(self), axes + rest)
        flat = moved.reshape((prod(key_shape),) + value_shape)
        return flat, key_shape, value_shape

    # ------------------------------------------------------------------
    # functional operators
    # ------------------------------------------------------------------

    def map(self, func, axis=(0,), value_shape=None, dtype=None, with_keys=False):
        """Apply ``func`` to the value block at every key tuple.

        ``value_shape``/``dtype`` are accepted for cross-backend signature
        parity but are inferred from the results here.

        Reference: ``bolt/local/array.py :: BoltArrayLocal.map``.
        """
        flat, key_shape, _ = self._kv_reshape(axis)
        if with_keys:
            keys = _product(*[range(k) for k in key_shape])
            items = [func((k, v)) for k, v in zip(keys, flat)]
        else:
            items = [func(v) for v in flat]
        out = np.asarray(items)
        if dtype is not None:
            out = out.astype(dtype)
        return BoltArrayLocal(out.reshape(key_shape + out.shape[1:]))

    def filter(self, func, axis=(0,), sort=False):
        """Keep value blocks for which ``func`` is truthy; survivors are
        re-keyed to a flat ``(n,)`` key axis.

        Reference: ``bolt/local/array.py :: BoltArrayLocal.filter``.
        """
        flat, _, value_shape = self._kv_reshape(axis)
        items = [v for v in flat if func(v)]
        out = np.asarray(items)
        if len(items) == 0:
            out = out.reshape((0,) + value_shape)
        return BoltArrayLocal(out)

    def reduce(self, func, axis=(0,), keepdims=False):
        """Fixed-order pairwise tree combine of all value blocks with
        ``func`` — the SAME combine order as the distributed backend's
        compiled tree, so f32 ``reduce(add)`` is bit-exact across backends
        and non-associative reducers cannot silently diverge (the reference
        local backend uses a sequential left fold, but its Spark twin's
        ``rdd.treeReduce`` order is unspecified anyway — matching orders
        across OUR backends is the stronger contract; SURVEY §7 hard
        part 2).

        Reference: ``bolt/local/array.py :: BoltArrayLocal.reduce``.
        """
        flat, key_shape, value_shape = self._kv_reshape(axis)
        if flat.shape[0] == 0:
            raise TypeError("reduce of an empty array with no initial value")
        x = flat
        while x.shape[0] > 1:
            half = x.shape[0] // 2
            combined = np.asarray(
                [func(a, b) for a, b in zip(x[:half], x[half:2 * half])])
            rem = x[2 * half:]
            x = np.concatenate([combined, rem], axis=0) if rem.shape[0] \
                else combined
        out = np.asarray(x[0])
        if out.shape != value_shape:
            raise ValueError(
                "reduce produced shape %s, expected value shape %s"
                % (out.shape, value_shape))
        if keepdims:
            out = out.reshape((1,) * len(key_shape) + value_shape)
        return BoltArrayLocal(out)

    def stats(self, *requested, axis=None, accumulate=None, **kwargs):
        """Moment statistics over key axes, returned as a
        :class:`~bolt_tpu_torch.statcounter.StatCounter` — the same contract the
        device backend serves via its shard_map Welford combine (reference:
        ``BoltArraySpark.stats`` via ``rdd.aggregate(StatCounter)``).

        ``axis=None`` means the leading axis, this backend's default key
        axis.

        The FLUENT form ``stats("sum", "var", "min", ...)`` mirrors the
        device backend's fused multi-stat (an ordered ``{name: array}``
        dict, any of sum/mean/var/std/min/max/prod/all/any/ptp) — here
        it is one NumPy pass per name, the semantic oracle the fused
        programs are parity-tested against.  ``accumulate`` is accepted
        for signature parity; the oracle always computes exactly."""
        if requested and all(isinstance(r, str) for r in requested):
            from collections import OrderedDict
            for n in requested:
                if n not in LAZY_NAMES:
                    raise ValueError(
                        "unknown statistic %r; choose from %s"
                        % (n, ", ".join(LAZY_NAMES)))
            axes = (0,) if axis is None else tuple(sorted(tupleize(axis)))
            x = np.asarray(self)
            out = OrderedDict()
            for n in requested:
                out[n] = BoltArrayLocal(getattr(np, n)(x, axis=axes))
            return out
        from bolt_tpu_torch.statcounter import StatCounter
        if requested:
            # legacy positional form: stats(requested_tuple[, axis])
            if len(requested) > 2:
                raise TypeError("stats() takes at most 2 positional "
                                "arguments (requested, axis)")
            kwargs.setdefault("requested", requested[0])
            if len(requested) == 2:
                if axis is not None:
                    raise TypeError("stats() got axis twice")
                axis = requested[1]
        requested = kwargs.pop("requested",
                               ("mean", "var", "std", "min", "max"))
        if kwargs:
            raise TypeError("unexpected keyword arguments %r"
                            % sorted(kwargs))
        axes = (0,) if axis is None else tuple(sorted(tupleize(axis)))
        inshape(self.shape, axes)
        x = np.asarray(self)
        n = prod(tuple(self.shape[a] for a in axes))
        mu = x.mean(axis=axes, keepdims=True)
        m2 = ((x - mu) ** 2).sum(axis=axes)
        return StatCounter.from_moments(
            n, np.squeeze(mu, axis=axes), m2,
            minValue=x.min(axis=axes), maxValue=x.max(axis=axes),
            stats=requested)

    def ptp(self, axis=None, keepdims=False):
        """Peak-to-peak (max − min).  numpy ≥2 removed the ndarray method
        in favour of ``np.ptp``; this restores it with ndarray reduction
        conventions (``axis=None`` reduces everything), matching this
        backend's inherited mean/sum family."""
        return BoltArrayLocal(np.ptp(np.asarray(self), axis=axis,
                                     keepdims=keepdims))

    def quantile(self, q, axis=(0,), keepdims=False, method="linear"):
        """The ``q``-th quantile over ``axis`` (default: the leading axis,
        this backend's default key axis; ``None`` means the same, matching
        ``stats``).  ``q``: a scalar, or a 1-d array that prepends a q
        axis like ``np.quantile`` — matching the distributed backend;
        superset of the reference."""
        from bolt_tpu_torch.utils import check_q
        qarr = check_q(q)
        axes = (0,) if axis is None else tuple(sorted(tupleize(axis)))
        inshape(self.shape, axes)
        return BoltArrayLocal(np.quantile(
            np.asarray(self), qarr if qarr.ndim else float(q), axis=axes,
            keepdims=keepdims, method=method))

    def median(self, axis=(0,), keepdims=False):
        """Median over ``axis`` (default: the leading axis)."""
        return self.quantile(0.5, axis=axis, keepdims=keepdims)

    # ------------------------------------------------------------------
    # chunked / stacked views (superset of the reference, which has them
    # only on the distributed backend — ``bolt/spark/chunk.py`` /
    # ``bolt/spark/stack.py``; here the same contract runs on NumPy so
    # mode-agnostic user code needs no SparkContext/mesh)
    # ------------------------------------------------------------------

    def chunk(self, size="150", axis=None, padding=None, key_axis=(0,)):
        """Decompose the value axes into chunks; returns a
        :class:`~bolt_tpu_torch.local.chunk.LocalChunkedArray`.

        ``key_axis`` names this array's key axes (the distributed backend
        carries its split intrinsically; this backend, like its ``map``,
        takes the key-axis set per call) — they are moved to the front, and
        ``axis``/``size``/``padding`` address the remaining value axes
        exactly as on the device backend."""
        from bolt_tpu_torch.local.chunk import LocalChunkedArray
        flat, key_shape, value_shape = self._kv_reshape(key_axis)
        data = flat.reshape(key_shape + value_shape)
        return LocalChunkedArray.chunk(data, len(key_shape), size=size,
                                       axis=axis, padding=padding)

    def stacked(self, size=1000, key_axis=(0,)):
        """Batch flat key records into blocks; returns a
        :class:`~bolt_tpu_torch.local.stack.LocalStackedArray` (same contract as
        the device backend's compatibility view)."""
        from bolt_tpu_torch.local.stack import LocalStackedArray
        flat, key_shape, value_shape = self._kv_reshape(key_axis)
        data = flat.reshape(key_shape + value_shape)
        return LocalStackedArray(data, len(key_shape), size)

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------

    @staticmethod
    def _mixes_advanced(index):
        """True when ``index`` (a tuple) mixes advanced entries in a way
        where numpy's zipped convention diverges from this framework's
        orthogonal one: two or more advanced (list/ndarray) indices, or
        one advanced index with a scalar alongside (a scalar counts as a
        0-d advanced index to numpy, whose "separated advanced indices
        move to the front" rule would then diverge).  Shared by
        ``__getitem__`` and ``__setitem__`` so read and write semantics
        cannot desynchronize."""
        nadv = sum(1 for i in index
                   if isinstance(i, (list, np.ndarray))
                   and not (isinstance(i, np.ndarray) and i.ndim == 0))
        nscalar = sum(1 for i in index
                      if isinstance(i, (int, np.integer))
                      or (isinstance(i, np.ndarray) and i.ndim == 0
                          and i.dtype != bool))
        return nadv >= 2 or bool(nadv and nscalar)

    def __getitem__(self, index):
        """ndarray indexing, EXCEPT that two or more advanced (list /
        ndarray / boolean) indices apply orthogonally per axis (``np.ix_``
        semantics) — matching the distributed backend and the reconstructed
        reference's per-axis ``_getadvanced`` (``bolt/spark/array.py``),
        instead of numpy's zipped point-selection.  ``b[[0, 1], :, [0, 2]]``
        therefore returns the same shape on both backends (VERDICT r1
        weak-3).  Single advanced indices are identical under both
        conventions and delegate to numpy."""
        if not isinstance(index, tuple):
            # a lone index can never mix advanced entries: ndarray fast path
            return super().__getitem__(index)
        if not self._mixes_advanced(index):
            return super().__getitem__(index)
        from bolt_tpu_torch.utils import normalize_index
        norm, squeezed = normalize_index(index, self.shape)
        out = np.asarray(self)[tuple(
            s if isinstance(s, slice) else slice(None) for s in norm)]
        for ax, s in enumerate(norm):
            if isinstance(s, np.ndarray):
                out = np.take(out, s, axis=ax)
        if squeezed:
            out = out.reshape(tuple(
                s for i, s in enumerate(out.shape) if i not in squeezed))
        return BoltArrayLocal(out)

    # ------------------------------------------------------------------
    # mutation (the distributed backend's device arrays are immutable;
    # ``set`` is the functional update both backends share, and this
    # backend's inherited in-place ``__setitem__`` is overridden only to
    # keep ≥2 advanced indices orthogonal, matching ``__getitem__``)
    # ------------------------------------------------------------------

    def set(self, index, value):
        """Functional indexed update: a NEW array equal to this one with
        ``self[index] = value`` applied — same indexing semantics as
        ``__getitem__`` (two or more advanced indices apply
        orthogonally); ``value`` broadcasts against the selected region
        and casts to this dtype (numpy assignment semantics).  Mirrors
        the distributed backend's method, where device arrays cannot be
        assigned in place."""
        from bolt_tpu_torch.utils import assignment_index, normalize_index
        norm, squeezed = normalize_index(index, self.shape)
        out = np.array(self)
        out[assignment_index(norm, self.shape, squeezed)] = value
        return BoltArrayLocal(out)

    def __setitem__(self, index, value):
        """ndarray in-place assignment, EXCEPT that multiple-advanced
        (and scalar-plus-advanced) indices assign to the region
        ``__getitem__`` with the same index would read — the ORTHOGONAL
        per-axis cross product, dims in axis order — matching this
        backend's ``__getitem__`` and both backends' ``set`` (same
        rerouting condition as ``__getitem__``)."""
        if isinstance(index, tuple) and self._mixes_advanced(index):
            from bolt_tpu_torch.utils import assignment_index, normalize_index
            norm, squeezed = normalize_index(index, self.shape)
            index = assignment_index(norm, self.shape, squeezed)
        return super().__setitem__(index, value)

    # ------------------------------------------------------------------
    # conversions
    # ------------------------------------------------------------------

    def first(self):
        """The value block at the first key (axis-0 record).

        Reference: ``bolt/local/array.py :: BoltArrayLocal.first``.
        """
        return np.asarray(self)[0]

    def concatenate(self, arry, axis=0):
        """Concatenate with another array along ``axis``.

        Reference: ``bolt/local/array.py :: BoltArrayLocal.concatenate``.
        """
        if isinstance(arry, BoltArray):
            arry = arry.toarray()
        return BoltArrayLocal(np.concatenate((np.asarray(self), np.asarray(arry)), axis))

    def toarray(self, out=None):
        if out is not None:
            BoltArray._check_out(out, self.shape, self.dtype)
            out[...] = np.asarray(self)
            return out
        return np.asarray(self)

    def iter_shards(self):
        """Single-shard analog of the distributed backend's
        :meth:`~bolt_tpu_torch.gpu.array.BoltArrayGPU.iter_shards`: one
        ``(index, block)`` covering the whole array, so shard-walking
        code is mode-agnostic.  The block is a COPY, like the device
        backend's host fetches — mutating it never aliases the array."""
        yield (tuple(slice(0, d) for d in self.shape),
               np.array(np.asarray(self)))

    def tolocal(self):
        return self

    def totorch(self, context=None, axis=(0,)):
        """Distribute over ``context`` and unwrap to the device
        ``torch.Tensor`` (reference: ``bolt/local/array.py ::
        BoltArrayLocal.tordd(sc, axis)`` — distribute, then unwrap to the
        engine-native records)."""
        return self.togpu(context=context, axis=axis).totorch()

    def __repr__(self):
        return BoltArray.__repr__(self)
