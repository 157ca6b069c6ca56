"""One-pass statistics for the gpu backend: ``stats()``.

Port of ``bolt_tpu/tpu/stats.py :: welford``.  The reference computes
per-shard moments inside a ``shard_map`` (``_shard_moments``, which calls
the Pallas ``fused_welford``) and Chan-combines them across the mesh with
``psum``/``pmax``/``pmin``.  On one card there is nothing to combine
across devices: the moments of the whole array come from ONE call of the
CUDA ``fused_welford`` kernel when the reduced axes lead, and from the
two-pass torch body otherwise, as one engine program (family
``"welford"``).  On a mesh (``gpu/mesharray.py``) each rank computes the
moments of its box the same way, and the ``(n, mean, M2, min, max)``
partials of the ranks that split the reduced axes are gathered and
Chan-combined in rank order (:func:`_mesh_moments`, through the mesh's
one fold, ``gpu/multistat.py :: mesh_fold``); mesh axes that
split no reduced axis hold replicas and are never combined over.
"""

from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.gpu import dtypes
from bolt_tpu_torch.statcounter import StatCounter
from bolt_tpu_torch.utils import inshape, prod, tupleize


def _cached_jit(key, builder):
    """Keyed program dispatch through the engine (patched per module by
    ``bolt_tpu_torch.profile.instrument``)."""
    return _engine.get(key, builder)


def _kernel_gate(axes, ndim, dtype):
    """True when ``fused_welford`` computes the moments: the reduced axes
    are the leading ones (not all of them) and the dtype is floating."""
    return (axes == tuple(range(len(axes))) and len(axes) < ndim
            and dtype.is_floating_point)


def _moments(x, axes):
    """``(mu, m2, min, max)`` over ``axes`` of the tensor ``x``.  Leading
    axes view ``x`` as ``(prod(leading), *rest)`` for one kernel call —
    the same algebra as the reference's Chan combine of the remaining
    leading axes (``stats.py:51-62``), done by the kernel's own row
    combine.  Other geometries take the two-pass body, in the reference's
    (jnp's) mean dtype: f32 for int32, f64 for int64."""
    if _kernel_gate(axes, x.ndim, x.dtype):
        from bolt_tpu_torch.ops.kernels import fused_welford
        lead = prod(tuple(x.shape[:len(axes)]))
        r = fused_welford(x.reshape((lead,) + tuple(x.shape[len(axes):])))
        if r is not None:
            return r
    xf = x.to(dtypes.inexact(x.dtype))
    mu = xf.mean(dim=axes)
    m2 = ((xf - xf.mean(dim=axes, keepdim=True)) ** 2).sum(dim=axes)
    c = dtypes.carry(x, ordered=True)    # an unsigned dtype torch leaves out
    return (mu, m2, dtypes.uncarry(c.amin(dim=axes), x.dtype, ordered=True),
            dtypes.uncarry(c.amax(dim=axes), x.dtype, ordered=True))


def welford(barray, requested=("mean", "var", "std", "min", "max"),
            axis=None):
    """Count/mean/var/std/min/max over any axes, returned as a
    :class:`~bolt_tpu_torch.statcounter.StatCounter` holding value-shaped
    moments.  ``axis=None`` reduces over all key axes (the reference's
    ``stats()``); any subset of key and value axes is allowed, and the
    remaining axes stay as leading dimensions of each moment."""
    if axis is None:
        axes = tuple(range(barray.split))
    else:
        axes = tuple(sorted(tupleize(axis)))
        inshape(barray.shape, axes)
    if len(axes) == 0:
        raise ValueError("at least one axis is required")
    n_total = prod(tuple(barray.shape[a] for a in axes))
    _engine.strict_guard(barray, "stats()")
    if getattr(barray, "_mesh", None) is not None:
        mu, m2, mn, mx = _mesh_moments(barray, axes)
        return StatCounter.from_moments(n_total, mu, m2, minValue=mn,
                                        maxValue=mx, stats=requested)
    x = barray._data
    fn = _cached_jit(("welford", tuple(x.shape), str(x.dtype), axes,
                      x.device), lambda: lambda data: _moments(data, axes))
    mu, m2, mn, mx = (t.detach().cpu().numpy() for t in fn(x))
    return StatCounter.from_moments(n_total, mu, m2, minValue=mn,
                                    maxValue=mx, stats=requested)


def _mesh_moments(barray, axes):
    """Host ``(mu, m2, min, max)`` over ``axes`` of the mesh array
    ``barray``: each rank's :func:`_moments` of its box (one
    ``fused_welford`` launch when the axes lead), folded in rank order
    over the mesh axes that shard ``axes``, then the kept axes gathered
    where the mesh splits them.  Every rank returns the same bits."""
    import torch
    from bolt_tpu_torch.gpu import multistat
    from bolt_tpu_torch.gpu.array import _download
    from bolt_tpu_torch.gpu.mesharray import topology_key
    from bolt_tpu_torch.parallel import sharding
    mesh, spec, shape = barray._mesh, barray._spec, barray.shape
    loc = barray.local
    with _engine.topology(topology_key(mesh)):
        x = loc._data
        fn = _cached_jit(("welford", tuple(x.shape), str(x.dtype), axes,
                          x.device), lambda: lambda data: _moments(data, axes))
        mu, m2, mn, mx = fn(x)
    maxes = sharding.shard_axes(spec, axes)
    if maxes:
        n = torch.tensor(prod(tuple(x.shape[a] for a in axes)),
                         dtype=torch.int64, device=mu.device)
        (_, mu, m2), mn, mx = multistat.mesh_fold(
            ("moments", "min", "max"), ((n, mu, m2), mn, mx),
            mesh.group(maxes))
    kept = tuple(a for a in range(len(shape)) if a not in axes)
    kspec = tuple(spec[a] for a in kept)
    kshape = tuple(shape[a] for a in kept)
    return tuple(sharding.gather(t, mesh, kshape, kspec, _download)[0]
                 for t in (mu, m2, mn, mx))
