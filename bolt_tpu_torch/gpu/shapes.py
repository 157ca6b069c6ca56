"""Axis-group-local shape views.

Reference: ``bolt/spark/shapes.py`` — ``Shapes`` (abstract), ``Keys``,
``Values``: shape/reshape/transpose restricted to one axis group, never
crossing the key/value boundary and never shuffling data (symbol-level
citation, SURVEY.md §0).
"""

from bolt_tpu_torch.utils import argpack, isreshapeable, istransposeable


class Shapes:
    """Base for the ``Keys``/``Values`` views over a
    :class:`~bolt_tpu_torch.gpu.array.BoltArrayGPU`."""

    def __init__(self, barray):
        self._barray = barray

    @property
    def shape(self):
        raise NotImplementedError

    def reshape(self, *shape):
        raise NotImplementedError

    def transpose(self, *axes):
        raise NotImplementedError

    def _check_reshape(self, shape):
        if not isreshapeable(shape, self.shape):
            raise ValueError("cannot reshape %s to %s"
                             % (str(self.shape), str(shape)))

    def _check_transpose(self, axes):
        if not istransposeable(axes, range(len(self.shape))):
            raise ValueError("axes %s is not a permutation of %s axes"
                             % (str(axes), len(self.shape)))

    def __repr__(self):
        return "%s: %s" % (type(self).__name__.lower(), str(self.shape))


class Keys(Shapes):
    """View over the key axes (reference: ``bolt/spark/shapes.py :: Keys``).
    Reshaping keys remaps key tuples without touching any value block."""

    @property
    def shape(self):
        b = self._barray
        return b.shape[:b.split]

    def reshape(self, *shape):
        shape = argpack(shape)
        self._check_reshape(shape)
        b = self._barray
        # the view states the boundary explicitly: every new axis is a key
        return b._reshape_with_split(tuple(shape) + b.shape[b.split:],
                                     len(shape))

    def transpose(self, *axes):
        axes = argpack(axes)
        if len(axes) == 0:
            axes = tuple(reversed(range(len(self.shape))))
        self._check_transpose(axes)
        b = self._barray
        perm = tuple(axes) + tuple(range(b.split, b.ndim))
        return b.transpose(*perm)


class Values(Shapes):
    """View over the value axes (reference: ``bolt/spark/shapes.py ::
    Values``).  Reshaping values reshapes every block in place."""

    @property
    def shape(self):
        b = self._barray
        return b.shape[b.split:]

    def reshape(self, *shape):
        shape = argpack(shape)
        self._check_reshape(shape)
        b = self._barray
        # the view states the boundary explicitly: the split is unchanged
        return b._reshape_with_split(b.shape[:b.split] + tuple(shape),
                                     b.split)

    def transpose(self, *axes):
        axes = argpack(axes)
        if len(axes) == 0:
            axes = tuple(reversed(range(len(self.shape))))
        self._check_transpose(axes)
        b = self._barray
        perm = tuple(range(b.split)) + tuple(b.split + a for a in axes)
        return b.transpose(*perm)
