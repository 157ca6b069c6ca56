"""Carry state across from the reference package.

The caller reads the reference side (``b.toarray()``, ``b.split`` of a
``bolt_tpu`` array, or its numpy moments) and hands plain numpy arrays
here; nothing in this module imports jax or the reference package.
"""

import numpy as np
import torch

from bolt_tpu_torch.gpu.construct import ConstructGPU, resolve_device


def from_reference(values, split, context=None):
    """A :class:`~bolt_tpu_torch.gpu.array.BoltArrayGPU` with the keys and
    values of a reference array: ``values`` is its ``toarray()`` (key axes
    leading) and ``split`` its key-axis count."""
    return ConstructGPU.array(np.asarray(values), context=context,
                              axis=tuple(range(int(split))))


def moments_from_reference(mu, m2, mn, mx, device=None):
    """Numpy moment arrays ``(mu, m2, min, max)`` as tensors on ``device``
    (``None`` means ``cuda:0``, as for ``mode='gpu'``)."""
    device = resolve_device(device)
    return tuple(torch.from_numpy(np.array(a, order="C")).to(device)
                 for a in (mu, m2, mn, mx))
