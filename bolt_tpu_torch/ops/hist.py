"""Whole-array histograms on one card.

Port of ``bolt_tpu/ops/hist.py``: ``numpy.histogram`` semantics over all
elements of a bolt array, with ``jnp.histogram``'s edges (the same
``linspace`` in the data's float dtype, the ``lo == hi`` widening) and its
counting rule (``searchsorted`` on the right, the last bin closed on the
right, values outside the range and NaN dropped).  A deferred chain is
read block by block; counts come back as int64 and ``density`` is
computed on the host.  :func:`histogramdd` serves ``np.histogram2d`` and
``np.histogramdd`` (``gpu/npdispatch.py``).
"""

import numpy as np
import torch

from bolt_tpu_torch.utils import prod


def _inexact(dtype):
    """jnp's ``to_inexact_dtype`` under x64: integers and bool histogram
    in f64, floats in their own dtype."""
    return dtype if (dtype.is_floating_point or dtype.is_complex) \
        else torch.float64


def bin_edges(lo, hi, bins, dtype):
    """``jnp.histogram_bin_edges`` of an integer ``bins`` over ``(lo,
    hi)``: the bounds cast to ``dtype``, widened by 0.5 each way when
    equal there, then ``jnp.linspace``'s ``start * (1 - t) + stop * t``
    with ``t = i / bins``, all in ``dtype`` (on the host, a tiny tensor)."""
    rng = torch.tensor([lo, hi], dtype=torch.float64).to(dtype)
    if rng[0] == rng[1]:
        rng = rng + torch.tensor([-0.5, 0.5], dtype=dtype)
    start, stop = rng[0], rng[1]
    t = torch.arange(bins, dtype=dtype) / bins
    return torch.cat([start * (1 - t) + stop * t, stop[None]])


def _counts(x, edges):
    """Per-bin int64 counts of the flat values ``x`` against ``edges``:
    the bin right of each value's right-side insertion point, the last
    edge counted in the last bin, index 0 (below) and ``bins + 1`` (above,
    NaN) dropped."""
    bins = edges.shape[0] - 1
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    return torch.bincount(idx, minlength=bins + 2)[1:bins + 1]


def _flat_blocks(base, funcs, split, shape, dtype):
    """The flattened values of the chain ``funcs`` over ``base`` (mapped
    values of ``shape`` and numpy ``dtype``), block by block of about
    ``_BLOCK_BYTES``; no chain: the base itself."""
    from bolt_tpu_torch.gpu.array import (_block_records, _chain_blocks,
                                          _chain_rec_bytes)
    if not funcs:
        yield base.reshape(-1)
        return
    per = _block_records(_chain_rec_bytes(base, split, shape, dtype))
    for _, _, recs in _chain_blocks(base, funcs, split, per):
        yield recs.reshape(-1)


def histogram(b, bins=10, range=None, density=False):
    """``numpy.histogram`` over ALL elements of a bolt array (flattened,
    like numpy), as ``jnp.histogram`` bins them: returns ``(counts,
    edges)`` as host ndarrays (reference: ``bolt_tpu.ops.histogram``).

    ``bins`` is an int; ``range=None`` takes ``(min, max)`` of the data
    (one sync of two scalars).  A deferred map chain is applied block by
    block, twice when the range comes from the data."""
    bins = int(bins)
    if bins < 1:
        raise ValueError("bins must be >= 1, got %d" % bins)
    if range is not None:
        lo, hi = float(range[0]), float(range[1])
        if not (np.isfinite(lo) and np.isfinite(hi)):
            raise ValueError(
                "supplied range of [%s, %s] is not finite" % (lo, hi))
        if lo > hi:
            raise ValueError("range must satisfy min <= max, got %r"
                             % (range,))
        if lo == hi:
            # numpy expands an empty range by +-0.5 (constant-data case)
            lo, hi = lo - 0.5, hi + 0.5
    if b.mode == "local":
        return np.histogram(np.asarray(b), bins=bins, range=range,
                            density=density)

    from bolt_tpu_torch.gpu.array import _cached_jit
    from bolt_tpu_torch.gpu.dtypes import torch_dtype
    from bolt_tpu_torch.gpu.mesharray import on_mesh
    dtype = _inexact(torch_dtype(b.dtype))
    if on_mesh(b):
        counts, edges = _mesh_histogram(b, bins, None if range is None
                                        else (lo, hi), dtype)
        if density:
            counts = counts / np.diff(edges) / counts.sum()
        return counts, edges
    base, funcs = b._chain_parts()
    split, shape, vdtype = b.split, tuple(b.shape), b.dtype
    bounds = None if range is None else (lo, hi)

    def build():
        def run(data):
            if bounds is None:
                lo_hi = None
                for x in _flat_blocks(data, funcs, split, shape, vdtype):
                    part = torch.stack(torch.aminmax(x.to(dtype)))
                    lo_hi = part if lo_hi is None else torch.stack(
                        [torch.minimum(lo_hi[0], part[0]),
                         torch.maximum(lo_hi[1], part[1])])
                lo_, hi_ = lo_hi.tolist()          # the one sync
            else:
                lo_, hi_ = bounds
            edges = bin_edges(lo_, hi_, bins, dtype)
            dev_edges = edges.to(data.device)
            counts = None
            for x in _flat_blocks(data, funcs, split, shape, vdtype):
                c = _counts(x.to(dtype), dev_edges)
                counts = c if counts is None else counts + c
            return counts.to("cpu").numpy(), edges.numpy()
        return run

    counts, edges = _cached_jit(
        ("histogram", funcs, tuple(base.shape), str(base.dtype), split,
         bins, bounds, b.device), build)(base)
    counts = counts.astype(np.int64)
    if density:
        counts = counts / np.diff(edges) / counts.sum()
    return counts, edges


def _mesh_histogram(b, bins, bounds, dtype):
    """:func:`histogram` on a mesh of more than one rank: the range is
    the min/max fold over the ranks holding distinct boxes, then each
    rank counts its own box and the counts add in rank order (int64)."""
    from bolt_tpu_torch.parallel import multihost, sharding
    loc = b.local
    maxes = sharding.shard_axes(b._spec, range(b.ndim))
    group = b._mesh.group(maxes) if maxes else None
    base, funcs = loc._chain_parts()
    split, shape, vdtype = loc.split, tuple(loc.shape), loc.dtype
    with b._scope():
        if bounds is None:
            lo_hi = torch.tensor([float("inf"), -float("inf")], dtype=dtype,
                                 device=base.device)
            for x in _flat_blocks(base, funcs, split, shape, vdtype):
                part = torch.stack(torch.aminmax(x.to(dtype)))
                lo_hi = torch.stack([torch.minimum(lo_hi[0], part[0]),
                                     torch.maximum(lo_hi[1], part[1])])
            lo_hi = multihost.fold_partials(lo_hi, lambda p, q: torch.stack(
                [torch.minimum(p[0], q[0]), torch.maximum(p[1], q[1])]),
                group)
            bounds = lo_hi.tolist()
        edges = bin_edges(bounds[0], bounds[1], bins, dtype)
        dev_edges = edges.to(base.device)
        counts = torch.zeros(bins, dtype=torch.int64, device=base.device)
        for x in _flat_blocks(base, funcs, split, shape, vdtype):
            counts = counts + _counts(x.to(dtype), dev_edges).to(torch.int64)
        counts = multihost.fold_partials(counts, torch.add, group)
    return counts.to("cpu").numpy().astype(np.int64), edges.numpy()


def histogramdd(sample, bins, ranges, density):
    """``jnp.histogramdd`` of the ``(N, D)`` tensor ``sample`` with static
    int ``bins`` per dimension and ``ranges`` (``None`` or a ``(lo, hi)``
    pair per dimension): returns the ``bins``-shaped host counts (int64,
    or ``density`` in the sample's float dtype) and the host edges of each
    dimension.  Data-derived ranges cost one sync."""
    dtype = _inexact(sample.dtype)
    x = sample.to(dtype)
    d = x.shape[1]
    if ranges is None:
        if x.shape[0]:
            mn, mx = torch.aminmax(x, dim=0)
            lims = torch.stack([mn, mx], 1).tolist()     # the one sync
        else:
            lims = [(0.0, 0.0)] * d
    else:
        lims = [tuple(r) for r in ranges]
    edges = [bin_edges(lims[i][0], lims[i][1], bins[i], dtype)
             for i in range(d)]
    flat = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for i in range(d):
        e = edges[i].to(x.device)
        col = x[:, i].contiguous()
        idx = torch.searchsorted(e, col, right=True)
        idx = torch.where(col == e[-1], idx - 1, idx)
        flat = flat * (bins[i] + 2) + idx
    full = tuple(n + 2 for n in bins)
    hist = torch.bincount(flat, minlength=prod(full)).reshape(full)
    hist = hist[(slice(1, -1),) * d].to("cpu").numpy()
    edges = [e.numpy() for e in edges]
    if density:
        hist = hist.astype(edges[0].dtype)
        hist = hist / hist.sum()
        for norm in np.ix_(*[np.diff(e) for e in edges]):
            hist = hist / norm
    return hist, edges
