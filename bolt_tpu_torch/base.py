"""Abstract cross-backend array contract.

Reference parity: ``bolt/base.py :: BoltArray`` — the contract both backends
implement (``mode``, ``shape``, ``dtype``, ``map/filter/reduce``,
``toarray``, conversions, ``__repr__``).  Citations are symbol-level; see
SURVEY.md §0.
"""

from abc import ABCMeta, abstractmethod


class HostFallbackWarning(UserWarning):
    """A ``mode='gpu'`` functional op received a callable that
    ``torch.func.vmap`` cannot batch (data-dependent control flow,
    ``.item()``, numpy coercion of a tensor) and is rerouting through the
    local (NumPy) oracle — a full device→host→device round-trip.
    Semantics are preserved but throughput drops by orders of magnitude
    on the card; rewrite the callable with torch tensor operations to stay
    on device.  Filter or ``error`` this category to locate (or forbid)
    fallback sites."""


class HBMPressureWarning(UserWarning):
    """An operation's estimated device-memory demand exceeds the ASSUMED
    card memory (the card did not report its capacity, so an 80 GB H100
    is assumed).  The op may still fit; set ``BOLT_HBM_BYTES`` (or
    ``bolt_tpu_torch.gpu.array._HBM_LIMIT_OVERRIDE``) to the card's
    memory size to make this an up-front ``MemoryError`` instead of a
    CUDA out-of-memory error mid-program."""


class BoltArray(metaclass=ABCMeta):
    """An n-dimensional array whose axes split into *key axes* (the
    distributed / parallel domain) and *value axes* (the local block each
    unit of parallelism holds).

    Backends:

    * ``mode='local'`` — :class:`bolt_tpu_torch.local.array.BoltArrayLocal`, a
      ``numpy.ndarray`` subclass; the semantic oracle.
    * ``mode='gpu'`` — :class:`bolt_tpu_torch.gpu.array.BoltArrayGPU`, a
      ``torch.Tensor`` on one ``torch.device``, key axes leading.
    """

    _mode = None

    @property
    def mode(self):
        """Backend identifier: ``'local'`` or ``'gpu'``."""
        return self._mode

    @property
    @abstractmethod
    def shape(self):
        """Full logical shape, key axes leading."""

    @property
    @abstractmethod
    def dtype(self):
        """Element dtype."""

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        n = 1
        for s in self.shape:
            n *= int(s)
        return n

    @property
    @abstractmethod
    def _constructor(self):
        """The construction class for this backend (``ConstructLocal`` /
        ``ConstructGPU``)."""

    # ------------------------------------------------------------------
    # functional operators (reference: ``bolt/base.py`` abstract methods)
    # ------------------------------------------------------------------

    @abstractmethod
    def map(self, func, axis=(0,), value_shape=None, dtype=None, with_keys=False):
        """Apply ``func`` to the value block at every key."""

    @abstractmethod
    def filter(self, func, axis=(0,), sort=False):
        """Keep the records whose value block satisfies ``func``; the
        surviving records are re-keyed to a flat ``(n,)`` key space."""

    @abstractmethod
    def reduce(self, func, axis=(0,), keepdims=False):
        """Combine all value blocks pairwise with the associative binary
        ``func``."""

    # ------------------------------------------------------------------
    # conversions
    # ------------------------------------------------------------------

    @abstractmethod
    def toarray(self, out=None):
        """Materialise as a host ``numpy.ndarray`` in key order; with
        ``out=`` (a writable shape/dtype-matched array, e.g. a memmap)
        the gather writes into the caller's buffer instead of
        allocating."""

    @abstractmethod
    def iter_shards(self):
        """Yield ``(index, block)`` host copies per locally-addressable
        shard — the assembly-free collect (one whole-array block on the
        local backend)."""

    @abstractmethod
    def tolocal(self):
        """Convert to the ``mode='local'`` backend."""

    @staticmethod
    def _check_out(out, shape, dtype):
        """Shared ``out=`` validation for :meth:`toarray` — one
        implementation so the backends' messages cannot drift."""
        import numpy as np
        if tuple(out.shape) != tuple(shape):
            raise ValueError("out has shape %s, expected %s"
                             % (tuple(out.shape), tuple(shape)))
        if np.dtype(out.dtype) != np.dtype(dtype):
            raise ValueError(
                "out has dtype %s, expected %s (toarray does not cast)"
                % (out.dtype, np.dtype(dtype)))
        return out

    def togpu(self, context=None, axis=(0,)):
        """Convert to the ``mode='gpu'`` backend, with ``axis`` as key axes
        on the ``torch.device`` ``context`` (``None`` means ``cuda:0``).

        Replaces the reference's ``tospark(sc, axis)`` in the same structural
        slot (reference: ``bolt/local/array.py :: BoltArrayLocal.tospark``).
        """
        from bolt_tpu_torch.gpu.construct import ConstructGPU
        return ConstructGPU.array(self.toarray(), context=context, axis=axis)

    def __repr__(self):
        s = "BoltArray\n"
        s += "mode: %s\n" % self.mode
        s += "shape: %s\n" % str(tuple(self.shape))
        return s
