"""Explicit halo exchange between neighbouring ranks of a mesh axis.

Port of ``bolt_tpu/parallel/halo.py``.  The reference's chunk
``padding`` ships overlapping blocks through the Spark shuffle; when a
value axis is split across the mesh, each shard needs its neighbours'
edge slices before a windowed or stencil computation.  The reference
runs this inside ``shard_map`` with ``lax.ppermute``; here every rank
calls :func:`exchange_halo` on its own block, and the edges travel by
``multihost.ppermute`` (``batch_isend_irecv``) along the named mesh axis.
"""

import torch

from bolt_tpu_torch.parallel import multihost


def exchange_halo(local, pad, axis, axis_name, mode="zero", mesh=None):
    """Extend this rank's block ``local`` along ``axis`` with ``pad``
    elements from the previous and next rank on the mesh axis
    ``axis_name`` of ``mesh`` (default: the pod's
    :func:`~bolt_tpu_torch.parallel.mesh.default_mesh`).  Every rank of
    the mesh calls it together.

    ``mode='zero'`` fills the outer boundary of the first and last rank
    with zeros; ``mode='wrap'`` exchanges cyclically.  Returns a tensor
    whose ``axis`` is ``2*pad`` longer than ``local``'s."""
    if pad <= 0:
        return local
    if pad > local.shape[axis]:
        # a halo wider than the shard would need data from beyond the
        # immediate neighbour
        raise ValueError(
            "halo pad %d exceeds the per-shard extent %d on axis %d"
            % (pad, local.shape[axis], axis))
    if mode not in ("zero", "wrap"):
        raise ValueError("mode must be 'zero' or 'wrap', got %r" % (mode,))
    if mesh is None:
        from bolt_tpu_torch.parallel.mesh import default_mesh
        mesh = default_mesh()
    n = mesh.shape[axis_name]
    ranks = mesh.group_ranks((axis_name,))
    idx = mesh.coords()[axis_name]
    length = local.shape[axis]
    # my right edge goes to my right neighbour (becomes its left halo)
    right_edge = local.narrow(axis, length - pad, pad)
    left_halo = multihost.ppermute(
        right_edge, ranks, [(i, (i + 1) % n) for i in range(n)])
    # my left edge goes to my left neighbour (becomes its right halo)
    left_edge = local.narrow(axis, 0, pad)
    right_halo = multihost.ppermute(
        left_edge, ranks, [(i, (i - 1) % n) for i in range(n)])
    if mode == "zero":
        if idx == 0:
            left_halo = torch.zeros_like(left_halo)
        if idx == n - 1:
            right_halo = torch.zeros_like(right_halo)
    return torch.cat([left_halo, local, right_halo], dim=axis)
