"""Carry state across from the reference package.

The caller reads the reference side (``b.toarray()``, ``b.split`` of a
``bolt_tpu`` array, its numpy moments, a mesh's shape and axis names, the
slices each of its devices holds) and hands plain numpy arrays, tuples
and slices here; nothing in this module imports jax or the reference
package.
"""

import numpy as np
import torch

from bolt_tpu_torch.gpu.construct import ConstructGPU, resolve_device


def from_reference(values, split, context=None):
    """A :class:`~bolt_tpu_torch.gpu.array.BoltArrayGPU` with the keys and
    values of a reference array: ``values`` is its ``toarray()`` (key axes
    leading) and ``split`` its key-axis count.  With a mesh as
    ``context`` each rank places only its own box of ``values``."""
    return ConstructGPU.array(np.asarray(values), context=context,
                              axis=tuple(range(int(split))))


def moments_from_reference(mu, m2, mn, mx, device=None):
    """Numpy moment arrays ``(mu, m2, min, max)`` as tensors on ``device``
    (``None`` means ``cuda:0``, as for ``mode='gpu'``)."""
    device = resolve_device(device)
    return tuple(torch.from_numpy(np.array(a, order="C")).to(device)
                 for a in (mu, m2, mn, mx))


def mesh_from_reference(shape, axis_names):
    """The unbound port mesh layout of a reference mesh of ``shape``
    (its ``mesh.devices.shape``) and ``axis_names``: enough for
    ``key_spec``/``combined_spec`` and each rank's box."""
    from bolt_tpu_torch.parallel.mesh import layout
    return layout(tuple(int(s) for s in shape), tuple(axis_names))


def boxes_from_reference(indices, shape):
    """``{mesh coordinates: box}`` from the reference's placement:
    ``indices`` maps each device's coordinate tuple in the mesh's device
    grid to the tuple of slices it holds (the reference's
    ``sharding.devices_indices_map(shape)`` read through
    ``np.ndenumerate(mesh.devices)``).  A box is one ``(start, stop)`` an
    axis, as the port's ``parallel.sharding.box`` gives a rank's — so the
    two layouts compare one for one, by coordinate."""
    return {tuple(int(c) for c in coords):
            tuple(tuple(sl.indices(int(n))[:2]) for sl, n in zip(idx, shape))
            for coords, idx in indices.items()}
