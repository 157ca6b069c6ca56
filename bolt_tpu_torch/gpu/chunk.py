"""Chunking: block decomposition of the value axes.

Port of ``bolt_tpu/tpu/chunk.py :: ChunkedArray`` (reference:
``bolt/spark/chunk.py``).  A ``ChunkedArray`` is a thin view: ``chunk()``
records a plan without moving a byte and ``unchunk()`` returns the
wrapped array; only ``map`` computes.  The uniform no-padding path
reshapes the value axes into (grid, block) pairs and nested-vmaps the
function over keys and grid; the general path (ragged tails, halo
padding) groups blocks into at most four static clamp categories per
chunked axis, cuts each category's padded blocks as ``unfold`` views,
vmaps ``func`` over them, trims the halo and reassembles with the same
recursive concatenate as the reference.
"""

import torch
from torch.func import vmap

from bolt_tpu_torch.gpu.array import BoltArrayGPU, _traceable, torch_dtype
from bolt_tpu_torch.utils import (check_value_shape, chunk_align, chunk_pad,
                                  chunk_plan, iterexpand, tupleize)


def _axis_categories(v, c, p, g):
    """Static clamp categories for a chunked axis of length ``v`` with
    chunk size ``c``, halo ``p`` and ``g`` blocks (the reference's
    ``_axis_categories``): first, interior, penultimate and last blocks,
    each dict holding ``count`` blocks whose padded slices start at
    ``start0 + i*stride`` with length ``size`` and core ``[t0, t1)``."""
    if g == 1:
        return [dict(count=1, start0=0, stride=0, size=v, t0=0, t1=v)]
    cats = [dict(count=1, start0=0, stride=0, size=min(v, c + p),
                 t0=0, t1=c)]
    if g >= 3:
        if g > 3:
            cats.append(dict(count=g - 3, start0=c - p, stride=c,
                             size=c + 2 * p, t0=p, t1=p + c))
        pen0 = (g - 2) * c - p
        cats.append(dict(count=1, start0=pen0, stride=0,
                         size=min(v, (g - 1) * c + p) - pen0, t0=p,
                         t1=p + c))
    hi0 = (g - 1) * c - p
    tail = v - (g - 1) * c
    cats.append(dict(count=1, start0=hi0, stride=0, size=v - hi0,
                     t0=p, t1=p + tail))
    return cats


def _nested_vmap(func, levels):
    for _ in range(levels):
        func = vmap(func)
    return func


def _uniform_map_body(data, func, split, plan, canon=None):
    """Reshape the value axes into (grid, block) pairs, nested-vmap
    ``func`` over keys+grid, reassemble, optionally cast (reference:
    ``_uniform_map_body``)."""
    kshape = tuple(data.shape[:split])
    vshape = tuple(data.shape[split:])
    nv = len(vshape)
    grid = tuple(v // c for v, c in zip(vshape, plan))
    r = data.reshape(kshape + tuple(
        x for v, c in zip(vshape, plan) for x in (v // c, c)))
    g_axes = [split + 2 * i for i in range(nv)]
    c_axes = [split + 2 * i + 1 for i in range(nv)]
    r = r.permute(tuple(range(split)) + tuple(g_axes) + tuple(c_axes))
    out = _nested_vmap(func, split + nv)(r)
    ob = tuple(out.shape[split + nv:])
    if len(ob) != nv:
        raise ValueError(
            "chunked map must preserve block rank: block %s -> %s"
            % (str(tuple(plan)), str(ob)))
    perm = tuple(range(split)) + tuple(
        x for i in range(nv) for x in (split + i, split + nv + i))
    out = out.permute(perm).reshape(
        kshape + tuple(g * o for g, o in zip(grid, ob)))
    return out if canon is None else out.to(canon)


def _general_map_body(data, func, split, plan, pad, canon=None):
    """The ragged-tail / halo-padding chunked map (reference:
    ``_general_map_body``).  For each product of per-axis clamp
    categories, the padded blocks are ``unfold`` windows of ``data`` (no
    copy), ``func`` is vmapped over the block counts and the keys, the
    halo is trimmed, and the categories are concatenated back in order."""
    kshape = tuple(data.shape[:split])
    vshape = tuple(data.shape[split:])
    nv = len(vshape)
    grid = tuple(-(-v // c) for v, c in zip(vshape, plan))
    axes_cats = [_axis_categories(vshape[i], plan[i], pad[i], grid[i])
                 for i in range(nv)]

    def group(sig):
        sizes = tuple(c["size"] for c in sig)
        blk = data
        for i, c in enumerate(sig):
            span = (c["count"] - 1) * c["stride"] + c["size"]
            blk = blk.narrow(split + i, c["start0"], span).unfold(
                split + i, c["size"], max(c["stride"], 1))
        # (*kshape, count_0.., size_0..) -> (count_0.., *kshape, size_0..)
        blk = blk.permute(tuple(range(split, split + nv))
                          + tuple(range(split))
                          + tuple(range(split + nv, split + 2 * nv)))
        out = _nested_vmap(func, nv + split)(blk)
        if tuple(out.shape) != tuple(blk.shape):
            raise ValueError(
                "with padding or a ragged chunk plan, the mapped function "
                "must preserve the block shape; got %s -> %s"
                % (str(sizes), str(tuple(out.shape[nv + split:]))))
        trim = (slice(None),) * (nv + split) + tuple(
            slice(c["t0"], c["t1"]) for c in sig)
        res = out[trim]
        # (count_0.., *kshape, trim_0..) -> (*kshape, count_0*trim_0, ...)
        perm = tuple(range(nv, nv + split)) + tuple(
            x for i in range(nv) for x in (i, nv + split + i))
        return res.permute(perm).reshape(kshape + tuple(
            c["count"] * (c["t1"] - c["t0"]) for c in sig))

    def assemble(prefix, level):
        if level == nv:
            return group(tuple(prefix))
        parts = [assemble(prefix + [c], level + 1)
                 for c in axes_cats[level] if c["count"] > 0]
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts, dim=split + level)

    out = assemble([], 0)
    return out if canon is None else out.to(canon)


class ChunkedArray:
    """A chunk-plan view over a :class:`BoltArrayGPU`."""

    def __init__(self, barray, plan, padding):
        self._barray = barray
        self._plan = tuple(int(p) for p in plan)
        self._padding = tuple(int(p) for p in padding)

    @classmethod
    def chunk(cls, barray, size="150", axis=None, padding=None):
        """Compute the chunk ``plan``: a string ``size`` is a per-block
        megabyte budget, an int/tuple gives explicit chunk sizes for the
        ``axis`` set; ``padding`` adds a halo on the chunked axes
        (reference: ``ChunkedArray._chunk``)."""
        split = barray.split
        vshape = barray.shape[split:]
        axes, size, padding = chunk_align(vshape, axis, size, padding)
        plan = chunk_plan(vshape, barray.dtype.itemsize, size, axes,
                          padding=padding)
        pad = chunk_pad(plan, axes, padding, vshape)
        return cls(barray, plan, pad)

    @property
    def plan(self):
        return self._plan

    @property
    def padding(self):
        return self._padding

    @property
    def kshape(self):
        b = self._barray
        return b.shape[:b.split]

    @property
    def vshape(self):
        b = self._barray
        return b.shape[b.split:]

    @property
    def shape(self):
        return self._barray.shape

    @property
    def split(self):
        return self._barray.split

    @property
    def dtype(self):
        return self._barray.dtype

    @property
    def mode(self):
        return "gpu"

    @property
    def grid(self):
        """Number of chunks along each value axis."""
        return tuple(-(-v // c) for v, c in zip(self.vshape, self._plan))

    @property
    def uniform(self):
        """True when every chunk has the same shape (no ragged tail)."""
        return all(v % c == 0 for v, c in zip(self.vshape, self._plan))

    def map(self, func, value_shape=None, dtype=None):
        """Apply ``func`` to every chunk of every record; returns a new
        :class:`ChunkedArray`.  With no padding and a uniform plan
        ``func`` may change the block shape (rank-preserving — e.g. the
        per-chunk SVD of BASELINE config 5); with padding or a ragged tail
        it must preserve the block shape."""
        func = _traceable(func)
        b = self._barray
        if value_shape is not None:
            out = vmap(func)(torch.empty((1,) + self._plan, device="meta",
                                         dtype=torch_dtype(b.dtype)))
            check_value_shape(value_shape, tuple(out.shape[1:]))
        split = b.split
        canon = None if dtype is None else torch_dtype(dtype)
        data = b._mapped()
        if self.uniform and not any(self._padding):
            out = _uniform_map_body(data, func, split, self._plan, canon)
            grid = self.grid
            new_plan = tuple(o // g for o, g in zip(out.shape[split:], grid))
            return ChunkedArray(BoltArrayGPU(out, split, b.device), new_plan,
                                self._padding)
        out = _general_map_body(data, func, split, self._plan,
                                self._padding, canon)
        return ChunkedArray(BoltArrayGPU(out, split, b.device), self._plan,
                            self._padding)

    def keys_to_values(self, axes, size=None):
        """Move key axes into the values (they land at the FRONT of the
        value group in the order given, matching the swap algebra).
        Moving EVERY key axis is allowed; the result has ``split=0`` until
        ``values_to_keys`` restores key axes."""
        axes = tuple(tupleize(axes))
        split = self._barray.split
        for a in axes:
            if a < 0 or a >= split:
                raise ValueError(
                    "key axis %d out of range for split %d" % (a, split))
        if len(set(axes)) != len(axes):
            raise ValueError("keys_to_values axes must be unique")
        swapped = self._barray._do_swap(axes, ())
        moved = [self._barray.shape[a] for a in axes]
        if size is not None:
            sizes = iterexpand(size, len(moved))
            for s in sizes:
                if int(s) < 1:
                    raise ValueError(
                        "chunk size must be >= 1, got %d" % int(s))
            moved = [min(int(s), m) for s, m in zip(sizes, moved)]
        return ChunkedArray(swapped, tuple(moved) + self._plan,
                            (0,) * len(moved) + self._padding)

    def values_to_keys(self, axes):
        """Move value axes into the keys (appended after the existing key
        axes, matching the swap algebra)."""
        axes = tuple(tupleize(axes))
        nv = len(self.vshape)
        for a in axes:
            if a < 0 or a >= nv:
                raise ValueError(
                    "value axis %d out of range for %d value axes" % (a, nv))
        swapped = self._barray.swap((), axes)
        keep = [i for i in range(nv) if i not in axes]
        return ChunkedArray(swapped, tuple(self._plan[i] for i in keep),
                            tuple(self._padding[i] for i in keep))

    def unchunk(self):
        """Back to a :class:`BoltArrayGPU` — a no-op unwrap: the data never
        left its assembled layout."""
        return self._barray

    # the chunked view is thin: its reduction terminals are the array's

    def sum(self, axis=None, keepdims=False):
        return self._barray.sum(axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._barray.mean(axis=axis, keepdims=keepdims)

    def var(self, axis=None, keepdims=False, ddof=0):
        return self._barray.var(axis=axis, keepdims=keepdims, ddof=ddof)

    def std(self, axis=None, keepdims=False, ddof=0):
        return self._barray.std(axis=axis, keepdims=keepdims, ddof=ddof)

    def reduce(self, func, axis=(0,), keepdims=False):
        return self._barray.reduce(func, axis=axis, keepdims=keepdims)

    def __repr__(self):
        s = "ChunkedArray\n"
        s += "mode: gpu\n"
        s += "shape: %s\n" % str(self.shape)
        s += "split: %d\n" % self.split
        s += "plan: %s\n" % str(self._plan)
        s += "padding: %s\n" % str(self._padding)
        s += "grid: %s\n" % str(self.grid)
        return s
