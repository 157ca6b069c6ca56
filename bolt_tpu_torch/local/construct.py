"""Constructors for the ``mode='local'`` backend.

Reference: ``bolt/local/construct.py :: ConstructLocal`` (symbol-level
citation, see SURVEY.md §0).
"""

import numpy as np

from bolt_tpu_torch.local.array import BoltArrayLocal


class ConstructLocal:
    """Thin NumPy wrappers returning :class:`BoltArrayLocal`."""

    @staticmethod
    def _argcheck(*args, **kwargs):
        """The local backend is the dispatch fallback; it claims a call only
        when asked for by name (reference: ``bolt/local/construct.py ::
        ConstructLocal._argcheck``)."""
        return kwargs.get("mode") == "local"

    @staticmethod
    def array(a, dtype=None):
        return BoltArrayLocal(np.asarray(a, dtype=dtype))

    @staticmethod
    def ones(shape, dtype=None):
        return BoltArrayLocal(np.ones(shape, dtype=dtype))

    @staticmethod
    def zeros(shape, dtype=None):
        return BoltArrayLocal(np.zeros(shape, dtype=dtype))

    @staticmethod
    def full(shape, value, dtype=None):
        return BoltArrayLocal(np.full(shape, value, dtype=dtype))

    @staticmethod
    def _float_dtype(dtype):
        if dtype is not None and not np.issubdtype(np.dtype(dtype),
                                                   np.floating):
            # same contract as the device backend: truncating uniform [0, 1)
            # to int would silently return zeros
            raise ValueError("random constructors require a float dtype, "
                             "got %s" % np.dtype(dtype))
        return dtype

    @staticmethod
    def fromcallback(fn, shape, axis=(0,), dtype=None):
        """Local analog of the sharded loader: one callback call covering
        the whole array (a single 'shard').  ``axis`` gets the same
        key-axes-first treatment as the device backend, so a loader written
        against one backend serves the other unchanged."""
        from bolt_tpu_torch.utils import inshape, tupleize
        shape = tuple(shape)
        axes = sorted(tupleize(axis))
        inshape(shape, axes)
        rest = [i for i in range(len(shape)) if i not in axes]
        shape = tuple(shape[i] for i in axes + rest)
        block = np.asarray(fn(tuple(slice(0, n) for n in shape)),
                           dtype=dtype)
        if block.shape != shape:
            raise ValueError("fromcallback callback returned shape %s "
                             "(expected %s)" % (block.shape, shape))
        return BoltArrayLocal(block)

    @staticmethod
    def fromiter(blocks, shape, axis=(0,), dtype=None):
        """Local analog of the streaming iterator constructor: blocks
        (key-axes-first layout, concatenated along the first key axis)
        are assembled into one host array.  ``dtype`` is required, like
        the device backend (and ``np.fromiter``)."""
        if dtype is None:
            raise ValueError(
                "fromiter requires an explicit dtype (blocks are consumed "
                "lazily, so the element type cannot be inferred up front)")
        from bolt_tpu_torch.utils import inshape, iter_record_blocks, tupleize
        shape = tuple(shape)
        axes = sorted(tupleize(axis))
        inshape(shape, axes)
        rest = [i for i in range(len(shape)) if i not in axes]
        shape = tuple(shape[i] for i in axes + rest)
        out = np.empty(shape, dtype=dtype)
        for lo, hi, block in iter_record_blocks(blocks, shape, dtype):
            out[lo:hi] = block
        return BoltArrayLocal(out)

    @staticmethod
    def randn(shape, dtype=None, seed=0):
        """Standard-normal array (extension beyond the reference factory;
        RNG streams differ between backends by construction)."""
        dtype = ConstructLocal._float_dtype(dtype)
        # same seed normalization as the device backend: any Python int works
        x = np.random.default_rng(seed % (1 << 32)).standard_normal(shape)
        return BoltArrayLocal(x.astype(dtype) if dtype is not None else x)

    @staticmethod
    def rand(shape, dtype=None, seed=0):
        """Uniform [0, 1) array (extension beyond the reference factory)."""
        dtype = ConstructLocal._float_dtype(dtype)
        x = np.random.default_rng(seed % (1 << 32)).random(shape)
        return BoltArrayLocal(x.astype(dtype) if dtype is not None else x)

    @staticmethod
    def concatenate(arrays, axis=0):
        if not isinstance(arrays, (tuple, list)) or len(arrays) == 0:
            raise ValueError("concatenate requires a non-empty tuple of arrays")
        return BoltArrayLocal(np.concatenate([np.asarray(a) for a in arrays], axis))
