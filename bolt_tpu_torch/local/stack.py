"""Local-backend stacking: the NumPy oracle for the stacked semantics.

The reference's ``StackedArray`` exists only on the distributed backend
(``bolt/spark/stack.py``; symbol-level citation, SURVEY.md §0).  This view
closes the asymmetry the same way :mod:`bolt_tpu_torch.local.chunk` does for
chunking: the same block-wise ``map`` contract (``func`` sees
``(n, *value_shape)`` and must preserve ``n``) on plain NumPy.
"""

import numpy as np

from bolt_tpu_torch.utils import check_value_shape, prod


class LocalStackedArray:
    """A block-batched view over a NumPy array whose leading ``split`` axes
    are keys.  Mirrors the reference package's ``StackedArray`` (``bolt_tpu/tpu/stack.py``)."""

    def __init__(self, data, split, size):
        if int(size) < 1:
            raise ValueError("stack size must be >= 1, got %r" % (size,))
        self._data = np.asarray(data)
        self._split = int(split)
        self._size = int(size)

    @property
    def shape(self):
        return self._data.shape

    @property
    def split(self):
        return self._split

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def mode(self):
        return "local"

    @property
    def size(self):
        return self._size

    @property
    def nblocks(self):
        n = prod(self.shape[:self._split])
        return -(-n // self._size)

    def map(self, func, value_shape=None, dtype=None):
        """Apply ``func`` block-wise; record counts must be preserved so
        ``unstack`` can restore the key axes."""
        kshape = self.shape[:self._split]
        vshape = self.shape[self._split:]
        n = prod(kshape)
        flat = self._data.reshape((n,) + vshape)
        outs = []
        for i in range(0, n, self._size):
            blk = flat[i:i + self._size]
            out = np.asarray(func(blk))
            if out.ndim < 1 or out.shape[0] != blk.shape[0]:
                raise ValueError(
                    "stacked map must preserve the record count: block of "
                    "%d records -> %s"
                    % (blk.shape[0],
                       out.shape[0] if out.ndim >= 1 else "none"))
            outs.append(out)
        if outs:
            out = np.concatenate(outs, axis=0)
        else:
            # zero records: infer the output value shape func WOULD produce
            # (warnings silenced — an all-zeros probe block may divide/log)
            with np.errstate(all="ignore"):
                probe = np.asarray(func(np.zeros((self._size,) + vshape,
                                                 self._data.dtype)))
            out = np.zeros((0,) + probe.shape[1:], probe.dtype)
        check_value_shape(value_shape, tuple(out.shape[1:]))
        if dtype is not None:
            out = out.astype(dtype)
        return LocalStackedArray(out.reshape(kshape + out.shape[1:]),
                                 self._split, self._size)

    def unstack(self):
        """Back to a :class:`~bolt_tpu_torch.local.array.BoltArrayLocal`."""
        from bolt_tpu_torch.local.array import BoltArrayLocal
        return BoltArrayLocal(self._data)

    def __repr__(self):
        s = "StackedArray\n"
        s += "mode: local\n"
        s += "shape: %s\n" % str(self.shape)
        s += "split: %d\n" % self.split
        s += "size: %d\n" % self._size
        s += "nblocks: %d\n" % self.nblocks
        return s
