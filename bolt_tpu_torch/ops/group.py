"""Segmented (grouped) reductions over the key axis, ``topk``, ``unique``
and ``bincount``, on one card.

Port of ``bolt_tpu/ops/group.py``.  ``segment_reduce`` is the
``reduceByKey`` analog: a scatter combine (``index_add_`` /
``scatter_reduce_``) or, for sum/mean of floating data, one matmul of a
one-hot label matrix against the records.  ``topk`` keeps ``lax.top_k``'s
order (ties to the lower index, NaN largest) through a stable argsort of
the index-reversed array, and ``unique`` numpy's (all NaNs collapse into
one entry) through a sort and a first-occurrence mask, not
``torch.topk``/``torch.unique``.  A deferred map chain is applied block by
block where the op folds blocks (``segment_reduce``), else once.
"""

from numbers import Integral

import numpy as np
import torch

from bolt_tpu_torch import _precision
from bolt_tpu_torch.gpu.methods import _sortable, _unsortable
from bolt_tpu_torch.utils import prod

_OPS = ("sum", "mean", "max", "min")

# the auto gate's rates on an NVIDIA H100 80GB HBM3 at 700.00 W, measured
# by chip_smoke.py phase 9 at (8192, 1024, 64) f32 into 256 segments: the
# one-hot matmul's effective rate per precision mode (1.63, 1.70 and 6.06
# ms for its 275 GFLOP) and the scatter combine's (3.68 ms for 2.15 GB);
# the one-hot's own traffic at the data sheet's 3.35 TB/s
_MATMUL_RATE = {"default": 1.69e14, "high": 1.62e14, "highest": 4.54e13}
_ONEHOT_BYTES_PER_S = 3.35e12
_SCATTER_BYTES_PER_S = 5.84e11


def _label_minmax(labels):
    """``(min, max)`` of a labels tensor as Python ints: ONE host sync of
    two scalars (the labels themselves never leave the device)."""
    mn, mx = torch.stack(torch.aminmax(labels)).tolist()
    return int(mn), int(mx)


def _is_int(t):
    return not (t.dtype.is_floating_point or t.dtype.is_complex
                or t.dtype == torch.bool)


def _labels(b, labels):
    """The labels of ``b`` as a tensor on its device, or a host array: on
    a gpu array a bolt gpu array or a tensor of labels stays on the card
    (another device is refused, as a binary operand's); anything else
    goes through numpy."""
    from bolt_tpu_torch.gpu.array import BoltArrayGPU, check_mesh
    from bolt_tpu_torch.gpu.mesharray import on_mesh
    if b.mode == "gpu" and on_mesh(b):
        # each rank takes its slice of the whole label vector
        if isinstance(labels, BoltArrayGPU):
            check_mesh(b, labels, "segment_reduce labels")
            return labels.toarray()
        if isinstance(labels, torch.Tensor):
            return labels.cpu().numpy()
        return np.asarray(labels)
    if b.mode == "gpu":
        if isinstance(labels, BoltArrayGPU):
            labels = labels.totorch()
        if isinstance(labels, torch.Tensor):
            # the data's own device: a context of "cuda" holds cuda:0
            if labels.device != b._chain_parts()[0].device:
                raise ValueError(
                    "segment_reduce labels live on different devices (%s "
                    "vs %s); move one explicitly first"
                    % (labels.device, b.device))
            return labels
    return np.asarray(labels)


def segment_reduce(b, labels, num_segments=None, op="sum", method=None,
                   precision=None):
    """Reduce the records of ``b`` (leading key axis) into groups given by
    ``labels`` (reference: ``bolt_tpu.ops.segment_reduce``): record ``i``
    joins group ``labels[i]`` and group ``g``'s result is the
    ``op``-combine of its records.

    ``labels``: 1-d integers of length ``b.shape[0]``.  A host sequence /
    ndarray goes to the card once; a tensor or a gpu bolt array stays
    there, and its range check is one sync of two scalars.
    ``num_segments`` defaults to ``labels.max() + 1``; empty groups give
    0 for sum/mean and the dtype's identity for max/min.  ``op='mean'`` of
    integers promotes through f64.  Returns a bolt array of
    ``(num_segments, *value_shape)`` with ``split=1``.

    ``method``: ``None``/``"auto"`` picks by the cost model below;
    ``"scatter"`` forces the scatter combine; ``"matmul"`` the one-hot
    form ``onehot(labels) @ X`` (sum/mean of floating data only; the
    one-hot has the data's own dtype).  A non-finite record would poison
    whole value columns through ``0 x NaN``, so a non-finite matmul result
    (one host read) recomputes with the scatter combine: numpy's
    semantics always.  ``precision=None`` resolves through the scoped
    policy, pinned at ``"highest"``."""
    if op not in _OPS:
        raise ValueError("op must be one of %s, got %r" % (_OPS, op))
    if method not in (None, "auto", "scatter", "matmul"):
        raise ValueError("method must be 'auto', 'scatter' or 'matmul', "
                         "got %r" % (method,))
    float_in = np.issubdtype(np.dtype(b.dtype), np.floating) or (
        op == "mean" and np.issubdtype(np.dtype(b.dtype), np.integer))
    if method == "matmul" and (op not in ("sum", "mean") or not float_in):
        raise ValueError(
            "method='matmul' serves sum/mean of real floating (or "
            "int-mean) data only, got op=%r dtype=%s" % (op, b.dtype))
    pr = _precision.resolve(precision)
    labels = _labels(b, labels)
    on_card = isinstance(labels, torch.Tensor)
    integral = _is_int(labels) if on_card else np.issubdtype(
        np.dtype(labels.dtype), np.integer)
    if labels.ndim != 1 or not integral:
        raise ValueError("labels must be 1-d integers, got shape %s dtype %s"
                         % (tuple(labels.shape), labels.dtype))
    n = b.shape[0]
    if labels.shape[0] != n:
        raise ValueError("labels length %d != leading axis %d"
                         % (labels.shape[0], n))
    size = int(labels.shape[0])
    if on_card:
        lmin, lmax = _label_minmax(labels) if size else (0, -1)
    else:
        lmin = int(labels.min()) if size else 0
        lmax = int(labels.max()) if size else -1
    if size and lmin < 0:
        raise ValueError("labels must be non-negative")
    if num_segments is None:
        num_segments = lmax + 1 if size else 0
    num_segments = int(num_segments)
    if size and lmax >= num_segments:
        raise ValueError("label %d out of range for num_segments=%d"
                         % (lmax, num_segments))

    if b.mode == "local":
        return _local_segment(b, labels, num_segments, op)

    from bolt_tpu_torch.gpu.array import BoltArrayGPU, _cached_jit, hbm_check
    from bolt_tpu_torch.gpu.mesharray import on_mesh
    if on_mesh(b):
        return _mesh_segment(b, labels, num_segments, op, method, precision)
    base, funcs = b._chain_parts()
    split = b.split
    # cost gate for the one-hot form: ~2 * nseg * size flops at the
    # matmul's rate for the precision mode, plus the one-hot's own HBM
    # traffic, against the scatter's bytes at its measured rate.  Only
    # sum/mean of real floating data qualify, and the one-hot is capped
    # at the data's own size
    item = np.dtype(b.dtype).itemsize
    oh_bytes = float(num_segments) * n * item
    data_bytes = float(b.size) * item
    est_matmul = (2.0 * num_segments * b.size / _MATMUL_RATE[pr]
                  + oh_bytes / _ONEHOT_BYTES_PER_S)
    est_scatter = data_bytes / _SCATTER_BYTES_PER_S
    use_matmul = (method == "matmul" or (
        method in (None, "auto") and op in ("sum", "mean") and float_in
        and num_segments > 0 and oh_bytes <= data_bytes
        and est_matmul < est_scatter)) and n > 0
    if method == "matmul" and n > 0:
        # the forced one-hot form: input + one-hot + output (the auto
        # gate already caps the one-hot at the data's own size)
        hbm_check("segment_reduce matmul",
                  int(data_bytes + oh_bytes
                      + num_segments * (b.size // max(n, 1)) * item),
                  "input + one-hot + output", b.device)
    shape = tuple(b.shape)
    dtype = b.dtype

    def build():
        def run(data, lab):
            return _segment_program(data, funcs, split, lab, num_segments,
                                    op, use_matmul, pr, shape, dtype)
        return run

    # labels are an argument of the program: distinct label vectors reuse
    # one program (never key on label content)
    fn = _cached_jit(("segreduce", op, funcs, tuple(base.shape),
                      str(base.dtype), split, num_segments, b.device,
                      use_matmul, pr if use_matmul else None), build)
    lab = labels if on_card else torch.from_numpy(
        labels.astype(np.int64)).to(b.device)
    return BoltArrayGPU(fn(base, lab), 1, b.device)


_FOLD = {"sum": torch.add, "mean": torch.add, "max": torch.maximum,
         "min": torch.minimum}


def _mesh_segment(b, labels, num_segments, op, method, precision):
    """:func:`segment_reduce` on a mesh of more than one rank: each rank
    reduces its own records with its slice of the labels (a mean as
    sums), the partials of the mesh axes that split the records fold in
    rank order, and a mean divides by the global counts."""
    from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
    from bolt_tpu_torch.parallel import multihost, sharding
    bx = b.box
    lo, hi = bx[0]
    lab = np.asarray(labels)[lo:hi].astype(np.int64)
    loc = b.local
    float_in = np.issubdtype(np.dtype(b.dtype), np.floating) or \
        np.issubdtype(np.dtype(b.dtype), np.complexfloating)
    with b._scope():
        if op == "mean" and not float_in:
            loc = loc.astype(np.float64)
        part = segment_reduce(
            loc, torch.from_numpy(lab).to(loc.device), num_segments,
            "sum" if op == "mean" else op, method, precision)._data
        maxes = sharding.shard_axes(b._spec, [0])
        if maxes:
            part = multihost.fold_partials(part, _FOLD[op],
                                           b._mesh.group(maxes))
        if op == "mean":
            cnt = torch.from_numpy(np.bincount(
                np.asarray(labels).astype(np.int64),
                minlength=num_segments)).to(part.device, part.dtype)
            part = part / torch.clamp(cnt, min=1).reshape(
                (-1,) + (1,) * (part.ndim - 1))
    shape = (num_segments,) + tuple(b.shape[1:])
    spec = (None,) + tuple(b._spec[1:])
    return BoltArrayMesh.wrap(part, b._mesh, shape, 1, spec)._constrained()


def _local_segment(b, labels, num_segments, op):
    """The numpy oracle of :func:`segment_reduce` (the reference's)."""
    from bolt_tpu_torch.local.array import BoltArrayLocal
    x = np.asarray(b)
    vshape = x.shape[1:]
    if op in ("sum", "mean"):
        if op == "mean" and not np.issubdtype(x.dtype, np.floating):
            x = x.astype(np.float64)
        out = np.zeros((num_segments,) + vshape, x.dtype)
        np.add.at(out, labels, x)
        if op == "mean":
            cnt = np.bincount(labels, minlength=num_segments)
            out = out / np.maximum(cnt, 1).reshape(
                (num_segments,) + (1,) * len(vshape)).astype(x.dtype)
    else:
        if np.issubdtype(x.dtype, np.floating):
            init = -np.inf if op == "max" else np.inf
        else:
            info = np.iinfo(x.dtype)
            init = info.min if op == "max" else info.max
        out = np.full((num_segments,) + vshape, init, x.dtype)
        (np.maximum if op == "max" else np.minimum).at(out, labels, x)
    return BoltArrayLocal(out)


def _record_blocks(base, funcs, split, n, shape, dtype):
    """``(start, stop, records)`` of the chain over ``base`` (mapped values
    of ``shape`` and numpy ``dtype``) as ``(stop - start, V)`` axis-0
    records, further key axes riding in the value block: one block with
    no chain, else blocks of about ``_BLOCK_BYTES``."""
    from bolt_tpu_torch.gpu.array import (_block_records, _chain_blocks,
                                          _chain_rec_bytes)
    if not funcs:
        yield 0, n, base.reshape(n, -1)
        return
    # the chain runs over flat keys; an axis-0 record is `inner` of them
    inner = prod(base.shape[1:split])
    per = max(1, _block_records(_chain_rec_bytes(base, split, shape, dtype))
              // inner) * inner
    for s, e, recs in _chain_blocks(base, funcs, split, per):
        yield s // inner, e // inner, recs.reshape((e - s) // inner, -1)


def _segment_program(data, funcs, split, lab, nseg, op, use_matmul, pr,
                     shape, vdtype):
    """The card program of :func:`segment_reduce`: ``(nseg, *vshape)``."""
    n = data.shape[0]
    vshape = tuple(shape[1:])
    lab = lab.to(torch.int64)
    out = None

    def promote(x):
        if op == "mean" and not (x.dtype.is_floating_point
                                 or x.dtype.is_complex):
            return x.to(torch.float64)
        return x

    def scatter():
        acc = None
        for s, e, x in _record_blocks(data, funcs, split, n, shape,
                                      vdtype):
            x = promote(x)
            if acc is None:
                acc = _scatter_init(op, x.dtype, nseg, x.shape[1],
                                    x.device)
            li = lab[s:e]
            if op in ("sum", "mean"):
                acc.index_add_(0, li, x)
            else:
                acc.scatter_reduce_(0, li[:, None].expand(-1, x.shape[1]),
                                    x, reduce="amax" if op == "max"
                                    else "amin", include_self=True)
        return acc

    if n == 0:
        from bolt_tpu_torch.gpu.dtypes import torch_dtype
        dt = torch_dtype(vdtype)
        if op == "mean" and not (dt.is_floating_point or dt.is_complex):
            dt = torch.float64
        out = _scatter_init(op, dt, nseg, prod(vshape), data.device)
    elif use_matmul:
        with _precision.f32_matmul(pr):
            for s, e, x in _record_blocks(data, funcs, split, n, shape,
                                          vdtype):
                x = promote(x)
                oh = (lab[None, s:e] == torch.arange(
                    nseg, device=x.device)[:, None]).to(x.dtype)
                part = torch.matmul(oh, x)
                out = part if out is None else out + part
        # 0 x NaN poisons whole value columns through the one-hot, so a
        # non-finite record always surfaces as a non-finite result entry:
        # one host read of the small (nseg, V) result decides, and any hit
        # recomputes with the exact scatter combine (numpy's semantics)
        if not bool(torch.isfinite(out).all()):
            out = scatter()
    else:
        out = scatter()
    if op == "mean" and n:
        cnt = torch.bincount(lab, minlength=nseg).to(out.dtype)
        out = out / torch.clamp(cnt, min=1)[:, None]
    return out.reshape((nseg,) + vshape)


def _scatter_init(op, dtype, nseg, width, device):
    """The empty-group value of ``op``: 0 for sum/mean, the dtype's
    identity for max/min."""
    if op in ("sum", "mean"):
        return torch.zeros((nseg, width), dtype=dtype, device=device)
    if dtype.is_floating_point:
        init = -float("inf") if op == "max" else float("inf")
    else:
        info = torch.iinfo(dtype)
        init = info.min if op == "max" else info.max
    return torch.full((nseg, width), init, dtype=dtype, device=device)


# ---------------------------------------------------------------------
# topk
# ---------------------------------------------------------------------

def _topk_desc(moved, k):
    """Largest ``k`` along the LAST axis, descending, with ``lax.top_k``'s
    tie and NaN order (the reference's ``_topk_desc``): stable-ascending
    argsort the index-reversed array (ties there resolve to the HIGHER
    original index), map back, reverse — descending, ties to the LOWER
    index, NaNs first (largest).  No negation, so unsigned, INT_MIN and
    bool inputs order correctly."""
    n = moved.shape[-1]
    x = _sortable(moved)
    idx_rev = torch.argsort(x.flip(-1), dim=-1, stable=True)
    idx = (n - 1 - idx_rev).flip(-1)[..., :k]
    return _unsortable(torch.take_along_dim(x, idx, dim=-1), moved.dtype), idx


def _np_topk_desc(moved, k):
    n = moved.shape[-1]
    idx_rev = np.argsort(moved[..., ::-1], axis=-1, kind="stable")
    idx = (n - 1 - idx_rev)[..., ::-1][..., :k]
    return np.take_along_axis(moved, idx, axis=-1), idx


# an op whose device transient is a multiple of its input (topk's moved
# copy and int64 argsort index, unique's sorted copy) slabs or chunks above
# this many input bytes: torch.sort of n elements holds the sorted values,
# an int64 index per element and its own scratch, about 4-5x the input, so
# 4 GiB keeps that under a third of the card's 80 GB
_CHUNK_MAX_BYTES = 4 << 30


def slab_plan(shape, axis, in_bytes):
    """``(carry_axis, bounds)`` for slabbing an op along an axis other than
    its target ``axis`` (reference: ``bolt_tpu.tpu.array.slab_plan``):
    slabs of at most ``_CHUNK_MAX_BYTES``, cut along the LARGEST other
    axis.  ``None`` when no other axis can carry the slabbing."""
    cands = [a for a in range(len(shape)) if a != axis and shape[a] > 1]
    if not cands:
        return None
    cax = max(cands, key=lambda a: shape[a])
    nslabs = min(shape[cax], max(2, -(-in_bytes // _CHUNK_MAX_BYTES)))
    bounds = np.linspace(0, shape[cax], nslabs + 1).astype(int)
    pairs = [(int(s0), int(s1))
             for s0, s1 in zip(bounds[:-1], bounds[1:]) if s0 != s1]
    return cax, pairs


def topk(b, k, axis=-1):
    """Largest ``k`` values (descending) and their int64 indices along
    ``axis`` (reference: ``bolt_tpu.ops.topk``, ``lax.top_k`` semantics);
    returns ``(values, indices)`` bolt arrays whose ``axis`` dimension
    becomes ``k``.  Ties keep the lower index first and NaN counts as the
    largest value.  ``mode='local'`` computes the same in numpy.  Above
    ``_CHUNK_MAX_BYTES`` a non-last ``axis`` is slabbed along another
    axis."""
    if not isinstance(k, Integral):
        raise TypeError("k must be an integer, got %r" % (k,))
    k = int(k)
    ndim = b.ndim
    if not isinstance(axis, (int, np.integer)):
        raise TypeError("axis must be an integer, got %r" % (axis,))
    axis = int(axis)
    if axis < 0:
        axis += ndim
    if axis < 0 or axis >= ndim:
        raise ValueError("axis out of range for %d-d array" % ndim)
    if not 1 <= k <= b.shape[axis]:
        raise ValueError("k=%d out of range for axis of size %d"
                         % (k, b.shape[axis]))

    if b.mode == "local":
        from bolt_tpu_torch.local.array import BoltArrayLocal
        moved = np.moveaxis(np.asarray(b), axis, -1)
        vals, idx = _np_topk_desc(moved, k)
        return (BoltArrayLocal(np.moveaxis(vals, -1, axis)),
                BoltArrayLocal(np.moveaxis(idx, -1, axis)))

    from bolt_tpu_torch.gpu.array import (BoltArrayGPU, _cached_jit,
                                          _chain_apply, hbm_check)
    from bolt_tpu_torch.gpu.mesharray import on_mesh
    if on_mesh(b):
        # each rank's box made whole along ``axis``: its indices are
        # global, and the other axes keep their layout
        keep = [None if a == axis else a for a in range(ndim)]
        res = []
        for i in range(2):
            res.append(b._on_whole([axis], lambda loc, i=i: topk(
                loc, k, axis)[i], keep, b.split))
        return tuple(res)
    split = b.split
    itemsize = np.dtype(b.dtype).itemsize
    in_bytes = prod(b.shape) * itemsize
    plan = slab_plan(b.shape, axis, in_bytes) \
        if axis != ndim - 1 and in_bytes > _CHUNK_MAX_BYTES else None
    if plan is not None:
        slab_bytes = in_bytes // len(plan[1])
        hbm_check("topk", in_bytes + 2 * slab_bytes
                  + (slab_bytes // itemsize) * 8,
                  "input + per-slab moved copy + per-slab argsort index",
                  b.device)
        vals, idx = _topk_slabs(b._data, axis, k, plan)
        return (BoltArrayGPU(vals, split, b.device),
                BoltArrayGPU(idx, split, b.device))
    hbm_check("topk", 2 * in_bytes + prod(b.shape) * 8,
              "input + moved copy + argsort index array", b.device)
    base, funcs = b._chain_parts()

    def build():
        def run(data):
            x = _chain_apply(funcs, split, data)
            vals, idx = _topk_desc(x.movedim(axis, -1), k)
            return vals.movedim(-1, axis), idx.movedim(-1, axis)
        return run

    vals, idx = _cached_jit(("topk", funcs, tuple(base.shape),
                             str(base.dtype), split, axis, k, b.device),
                            build)(base)
    return (BoltArrayGPU(vals, split, b.device),
            BoltArrayGPU(idx, split, b.device))


def _topk_slabs(data, axis, k, plan):
    """topk over a non-last ``axis`` one slab of ``plan`` at a time, so the
    moved copy and the argsort index never exceed a slab; the k-sized
    results concatenate back along the slab axis."""
    cax, pairs = plan
    vs, ids = [], []
    for s0, s1 in pairs:
        slab = data.narrow(cax, s0, s1 - s0)
        v, i = _topk_desc(slab.movedim(axis, -1), k)
        vs.append(v.movedim(-1, axis))
        ids.append(i.movedim(-1, axis))
        del slab
    return torch.cat(vs, dim=cax), torch.cat(ids, dim=cax)


# ---------------------------------------------------------------------
# unique
# ---------------------------------------------------------------------

def _sort_mask(flat):
    """Sorted values and the first-occurrence mask, with numpy's NaN
    collapse: sorted NaNs are contiguous at the end, so "both NaN" marks a
    duplicate (the reference's ``_sort_mask``)."""
    s = torch.sort(_sortable(flat)).values
    neq = s[1:] != s[:-1]
    if s.dtype.is_floating_point:
        neq &= ~(torch.isnan(s[1:]) & torch.isnan(s[:-1]))
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=s.device),
                       neq])
    return _unsortable(s, flat.dtype), first


def _gather_uniques(s, mask, return_counts, dtype):
    """The unique values of one sorted piece (and their counts, as index
    differences) as host arrays.  ``nonzero`` is the one sync: it sizes
    the result."""
    from bolt_tpu_torch.gpu.array import _download
    idx = torch.nonzero(mask).reshape(-1)
    uniq = s.index_select(0, idx).to(dtype)
    if not return_counts:
        return _download(uniq), None
    ends = torch.cat([idx[1:], torch.tensor([s.shape[0]], dtype=idx.dtype,
                                            device=idx.device)])
    return _download(uniq), _download(ends - idx).astype(np.int64)


def _merge_unique_parts(vals_parts, cnt_parts, return_counts):
    """Exact host merge of per-piece uniques (+counts): the union of piece
    uniques is the global unique set and counts add (np.unique's NaN
    collapse maps every piece's NaN to one slot)."""
    allv = np.concatenate(vals_parts)
    if not return_counts:
        return np.unique(allv)
    uniq, inv = np.unique(allv, return_inverse=True)
    tot = np.zeros(len(uniq), np.int64)
    np.add.at(tot, inv, np.concatenate(cnt_parts))
    return uniq, tot


def unique(b, return_counts=False):
    """``numpy.unique`` over ALL elements (flattened): sorted unique values
    as a host ndarray, optionally with per-value counts (reference:
    ``bolt_tpu.ops.unique``).  One sort, a first-occurrence mask and a
    gather of the uniques: the host receives only the uniques.  All NaNs
    collapse into one entry, as in modern numpy.  Above
    ``_CHUNK_MAX_BYTES`` the flattened array is sorted one chunk at a time
    and the per-chunk uniques and counts merge exactly on the host."""
    if b.mode == "local":
        return np.unique(np.asarray(b), return_counts=return_counts)
    from bolt_tpu_torch.gpu.mesharray import on_mesh
    if on_mesh(b):
        return _unique_sharded(b, return_counts)
    from bolt_tpu_torch.gpu.array import _cached_jit, _chain_apply
    from bolt_tpu_torch.gpu.dtypes import torch_dtype
    n = prod(b.shape)
    if n == 0:
        empty = np.empty(0, np.dtype(b.dtype))
        return (empty, np.empty(0, np.int64)) if return_counts else empty
    dtype = torch_dtype(b.dtype)
    if n * np.dtype(b.dtype).itemsize > _CHUNK_MAX_BYTES:
        return _unique_chunked(b._data, return_counts, dtype)
    base, funcs = b._chain_parts()
    split = b.split

    def build():
        def run(data):
            s, mask = _sort_mask(_chain_apply(funcs, split, data).reshape(-1))
            return _gather_uniques(s, mask, return_counts, dtype)
        return run

    uniq, cnt = _cached_jit(("unique", funcs, tuple(base.shape),
                             str(base.dtype), split, return_counts,
                             b.device), build)(base)
    return (uniq, cnt) if return_counts else uniq


def _unique_sharded(b, return_counts):
    """``unique`` on a mesh of more than one rank (the reference's
    ``_unique_sharded``): each rank sorts and masks its own box (a
    partition of the elements is all unique needs), the uniques and
    counts of the distinct boxes are gathered once, and the host merges
    them exactly.  Only the ranks that differ along the mesh axes that
    shard the array exchange, so a replicated layout counts each element
    once, not once a replica."""
    from bolt_tpu_torch.parallel import multihost, sharding
    loc = b.local
    with b._scope():
        u, c = unique(loc, return_counts=True) if loc.size else (
            np.empty(0, np.dtype(b.dtype)), np.empty(0, np.int64))
    maxes = sharding.shard_axes(b._spec, range(b.ndim))
    group = b._mesh.group(maxes) if maxes else None
    blobs = multihost.all_gather_bytes(torch.from_numpy(np.frombuffer(
        np.int64(u.size).tobytes() + u.tobytes() + c.tobytes(),
        dtype=np.uint8).copy()), group)
    vals, cnts = [], []
    for blob in blobs:
        raw = blob.cpu().numpy().tobytes()
        m = int(np.frombuffer(raw[:8], np.int64)[0])
        end = 8 + m * u.itemsize
        vals.append(np.frombuffer(raw[8:end], u.dtype))
        cnts.append(np.frombuffer(raw[end:end + 8 * m], np.int64))
    return _merge_unique_parts(vals, cnts if return_counts else None,
                               return_counts)


def _unique_chunked(data, return_counts, dtype):
    """``unique`` one ``_CHUNK_MAX_BYTES`` slice of the flattened array at
    a time (the device transient stays bounded by the chunk), merged
    exactly on the host."""
    flat = data.reshape(-1)
    chunk = max(1, _CHUNK_MAX_BYTES // data.element_size())
    vals, cnts = [], []
    for start in range(0, flat.shape[0], chunk):
        s, mask = _sort_mask(flat[start:start + chunk])
        u, c = _gather_uniques(s, mask, return_counts, dtype)
        vals.append(u)
        cnts.append(c)
        del s, mask
    return _merge_unique_parts(vals, cnts if return_counts else None,
                               return_counts)


# ---------------------------------------------------------------------
# bincount
# ---------------------------------------------------------------------

# bincount counts per chunk of this many elements when set (None: one
# pass).  torch.bincount counts in int64, so no bin can wrap and the card
# needs no chunking; tests set it small to drive the chunked
# accumulation, which the reference needs for its int32 counts
_BINCOUNT_CHUNK = None


def bincount(b, minlength=0):
    """``numpy.bincount`` over ALL elements of an integer bolt array
    (flattened, like numpy); returns a host int64 ndarray of length
    ``max(minlength, max(b) + 1)`` (reference: ``bolt_tpu.ops.bincount``).
    The range check and the length cost one sync of two scalars."""
    if not np.issubdtype(np.dtype(b.dtype), np.integer):
        raise TypeError("bincount requires an integer array, got %s"
                        % (b.dtype,))
    minlength = int(minlength)
    if minlength < 0:
        raise ValueError("'minlength' must not be negative")
    if b.size == 0:
        return np.zeros(minlength, np.int64)
    if b.mode == "local":
        return np.bincount(np.asarray(b).reshape(-1), minlength=minlength)

    from bolt_tpu_torch.gpu.array import _cached_jit, _chain_apply, _download
    from bolt_tpu_torch.gpu.mesharray import on_mesh
    if on_mesh(b):
        return _mesh_bincount(b, minlength)
    base, funcs = b._chain_parts()
    split = b.split
    chunk = _BINCOUNT_CHUNK

    def build():
        def run(data):
            x = _chain_apply(funcs, split, data).reshape(-1)
            if x.dtype not in (torch.uint8, torch.int8, torch.int16,
                               torch.int32, torch.int64):
                x = x.to(torch.int64)
            mn, mx = _label_minmax(x)
            if mn < 0:
                raise ValueError("bincount requires non-negative values")
            length = max(minlength, mx + 1)
            if chunk is None or x.shape[0] <= chunk:
                return _download(torch.bincount(x, minlength=length))
            total = torch.zeros(length, dtype=torch.int64, device=x.device)
            for start in range(0, x.shape[0], chunk):
                total += torch.bincount(x[start:start + chunk],
                                        minlength=length)
            return _download(total)
        return run

    return _cached_jit(("bincount", funcs, tuple(base.shape),
                        str(base.dtype), split, minlength, chunk, b.device),
                       build)(base).astype(np.int64)


def _mesh_bincount(b, minlength):
    """:func:`bincount` on a mesh of more than one rank: the range folds
    over the ranks first (every rank then counts into the same length),
    each rank counts its own box, and the counts of the ranks holding
    distinct boxes add in rank order (int64: nothing wraps)."""
    from bolt_tpu_torch.gpu.array import _chain_apply, _download
    from bolt_tpu_torch.parallel import multihost, sharding
    loc = b.local
    maxes = sharding.shard_axes(b._spec, range(b.ndim))
    group = b._mesh.group(maxes) if maxes else None
    with b._scope():
        base, funcs = loc._chain_parts()
        x = _chain_apply(funcs, loc.split, base).reshape(-1)
        if x.dtype not in (torch.uint8, torch.int8, torch.int16,
                           torch.int32, torch.int64):
            x = x.to(torch.int64)
        mm = torch.stack(torch.aminmax(x)).to(torch.int64) if x.numel() \
            else torch.tensor([2 ** 62, -1], dtype=torch.int64,
                              device=x.device)
        mm = multihost.fold_partials(mm, lambda p, q: torch.stack(
            [torch.minimum(p[0], q[0]), torch.maximum(p[1], q[1])]), group)
        mn, mx = (int(v) for v in mm.tolist())
        if mn < 0:
            raise ValueError("bincount requires non-negative values")
        length = max(minlength, mx + 1)
        counts = torch.bincount(x, minlength=length) if x.numel() else \
            torch.zeros(length, dtype=torch.int64, device=x.device)
        counts = multihost.fold_partials(counts.to(torch.int64), torch.add,
                                         group)
    return _download(counts).astype(np.int64)
