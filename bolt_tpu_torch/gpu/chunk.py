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
recursive concatenate as the reference.  On a streamed source ``map``
records a stage that the slab programs run through these same two bodies
(``stream.chunked_map_stage``).

On a mesh (``gpu/mesharray.py``) a chunked value axis can itself be split
across a mesh axis (:meth:`ChunkedArray.shard`, the sequence-parallel
analog; ``vshard`` maps the value axis to its mesh axis).  ``map`` then
runs on each rank's block: the uniform path as it stands, a padded map
over the blocks of the rank's box extended by its neighbours' halos
(``parallel/halo.py :: exchange_halo``).  Where the chunk size does not
divide a rank's extent, the sharded axis is gathered first and the
result re-split, or left replicated with the reference's warning when
the output no longer divides the mesh.
"""

import warnings
from itertools import product as _product

import torch
from torch.func import vmap

from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.gpu.array import (BoltArrayGPU, _block_records,
                                      _chain_apply, _chain_donate_ok,
                                      _map_blocks, _traceable, torch_dtype)
from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.utils import (check_value_shape, chunk_align, chunk_pad,
                                  chunk_plan, iterexpand, prod, tupleize)


def _halo_extend(x, ax, pad, name, mesh):
    """This rank's block ``x`` extended along ``ax`` by ``pad`` elements
    of each neighbour on the mesh axis ``name``; the array's own edges
    get no halo (the chunked map clips there).  Returns the block and the
    offset of its own first element in it."""
    from bolt_tpu_torch.parallel.halo import exchange_halo
    ext = exchange_halo(x, pad, ax, name, mode="zero", mesh=mesh)
    idx, n = mesh.coords()[name], mesh.shape[name]
    start = pad if idx == 0 else 0
    stop = ext.shape[ax] - (pad if idx == n - 1 else 0)
    return ext.narrow(ax, start, stop - start), pad - start


def _constrain_chunked(barray, vshard, warning):
    """``barray`` on a mesh moved to the layout keeping the explicit
    value-axis shards ``vshard`` where its shape still divides them, else
    left on its key-only layout with ``warning`` (naming the shards) and
    no shard (reference: ``_constrain_chunked``).  Returns the array and
    the shards it keeps."""
    if not vshard:
        return barray, {}
    from bolt_tpu_torch.parallel.sharding import combined_spec
    try:
        spec = combined_spec(barray.mesh, barray.shape, barray.split, vshard)
    except ValueError:
        warnings.warn(warning % (vshard,))
        return barray, {}
    return barray._relaid(spec), dict(vshard)


def _block_map(ext, func, split, plan, pad, cores, offs, canon=None):
    """The padded chunked map over this rank's block ``ext`` (its own
    ``cores`` extents starting at ``offs`` on each value axis, halos
    around them): each block's padded slice, clipped to ``ext``, through
    ``func`` vmapped over the keys, trimmed to its core."""
    kshape = tuple(ext.shape[:split])
    nv = len(cores)
    out = None
    for idx in _product(*[range(-(-cores[i] // plan[i]))
                          for i in range(nv)]):
        sl, trim, dst = [], [], []
        for i, j in enumerate(idx):
            c0 = offs[i] + j * plan[i]
            c1 = min(offs[i] + cores[i], c0 + plan[i])
            s0 = max(0, c0 - pad[i])
            s1 = min(ext.shape[split + i], c1 + pad[i])
            sl.append(slice(s0, s1))
            trim.append(slice(c0 - s0, c1 - s0))
            dst.append(slice(c0 - offs[i], c1 - offs[i]))
        keys = (slice(None),) * split
        blk = ext[keys + tuple(sl)]
        res = _nested_vmap(func, split)(blk)
        if tuple(res.shape) != tuple(blk.shape):
            raise ValueError(
                "with padding or a ragged chunk plan, the mapped function "
                "must preserve the block shape; got %s -> %s"
                % (str(tuple(blk.shape[split:])),
                   str(tuple(res.shape[split:]))))
        if out is None:
            out = torch.empty(kshape + tuple(cores), dtype=res.dtype,
                              device=ext.device)
        out[keys + tuple(dst)] = res[keys + tuple(trim)]
    return out if canon is None else out.to(canon)


def _cached_jit(key, builder):
    """Keyed program dispatch through the engine (patched per module by
    ``bolt_tpu_torch.profile.instrument``)."""
    return _engine.get(key, builder)


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

    def __init__(self, barray, plan, padding, vshard=None):
        self._barray = barray
        self._plan = tuple(int(p) for p in plan)
        self._padding = tuple(int(p) for p in padding)
        # value-axis -> mesh-axis shards (sequence-parallel analog)
        self._vshard = dict(vshard) if vshard else {}

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

    @property
    def vshard(self):
        """Value-axis → mesh-axis shards (empty unless :meth:`shard`-ed)."""
        return dict(self._vshard)

    # ------------------------------------------------------------------
    # value-axis sharding on a mesh: the sequence/context-parallel analog
    # ------------------------------------------------------------------

    def shard(self, mesh_axis, axis=None):
        """Split a chunked value axis across the (unused) mesh axis
        ``mesh_axis``; ``axis`` defaults to the first chunked value axis.
        The data moves to the new layout by one all_to_all (reference:
        ``ChunkedArray.shard``)."""
        from bolt_tpu_torch.parallel.sharding import combined_spec
        b = self._barray
        if b.mesh is None:
            raise ValueError("shard() needs an array on a mesh (context= "
                             "a bolt_tpu_torch.parallel mesh); this one is "
                             "on %s" % (b.device,))
        if axis is None:
            chunked = [i for i, (v, c) in enumerate(zip(self.vshape,
                                                       self._plan))
                       if c < v]
            axis = chunked[0] if chunked else 0
        vshard = dict(self._vshard)
        vshard[axis] = mesh_axis
        spec = combined_spec(b.mesh, b.shape, b.split, vshard)  # validates
        return ChunkedArray(b._relaid(spec), self._plan, self._padding,
                            vshard)

    def _rewrap(self, barray, plan, padding, vshard):
        """Wrap a swapped array, re-applying the value-axis shards that
        survive the swap (the swap lays out by the key spec alone)."""
        barray, vshard = _constrain_chunked(
            barray, vshard, "value-axis shard %s no longer divides after "
            "the axis exchange; the axis is now replicated")
        return ChunkedArray(barray, plan, padding, vshard)

    def _mesh_map(self, func, value_shape, dtype):
        """``map`` on a mesh: each rank maps the blocks of its box (see
        the module docstring)."""
        from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
        from bolt_tpu_torch.parallel.sharding import spec_names
        b = self._barray
        mesh, split, spec = b.mesh, b.split, b._spec
        plan, pad, vshape = self._plan, self._padding, self.vshape
        nv = len(vshape)
        canon = None if dtype is None else torch_dtype(dtype)
        vshard = dict(self._vshard)
        ways = [prod([mesh.shape[n] for n in spec_names(spec[split + i])])
                for i in range(nv)]
        local_ok = all(
            w == 1 or (len(spec_names(spec[split + i])) == 1
                       and (vshape[i] // w) % plan[i] == 0
                       and pad[i] <= vshape[i] // w)
            for i, w in enumerate(ways))
        if not local_ok:
            # a block straddles ranks: map the gathered axis, re-split
            whole = b._whole_records()
            with whole._scope():
                out = ChunkedArray(whole._local, plan, pad).map(
                    func, value_shape=value_shape, dtype=dtype)
            shape = whole.shape[:split] + out._barray.shape[split:]
            res, vshard = _constrain_chunked(
                BoltArrayMesh(out._barray, mesh, shape, split,
                              whole._spec[:split] + (None,) * nv), vshard,
                "chunked map output does not divide the mesh for value "
                "shard %s; the axis is now replicated")
            return ChunkedArray(res, out._plan, pad, vshard)
        grid = self.grid
        with b._scope():
            x = b._local._mapped()
            if self.uniform and not any(pad):
                out = _uniform_map_body(x, func, split, plan, canon)
            else:
                offs = [0] * nv
                for i, w in enumerate(ways):
                    if w > 1 and pad[i]:
                        x, offs[i] = _halo_extend(
                            x, split + i, pad[i], spec[split + i], mesh)
                cores = [vshape[i] // w for i, w in enumerate(ways)]
                out = _block_map(x, func, split, plan, pad, cores, offs,
                                 canon)
        shape = tuple(b.shape[:split]) + tuple(
            out.shape[split + i] * w for i, w in enumerate(ways))
        res = BoltArrayMesh.wrap(out, mesh, shape, split, spec)
        if self.uniform and not any(pad):
            plan = tuple(o // g for o, g in zip(shape[split:], grid))
        return ChunkedArray(res, plan, pad, vshard)

    def map(self, func, value_shape=None, dtype=None):
        """Apply ``func`` to every chunk of every record; returns a new
        :class:`ChunkedArray`.  With no padding and a uniform plan
        ``func`` may change the block shape (rank-preserving — e.g. the
        per-chunk SVD of BASELINE config 5); with padding or a ragged tail
        it must preserve the block shape."""
        func = _traceable(func)
        b = self._barray
        _engine.strict_guard(b, "chunk().map()")
        split, plan, pad = b.split, self._plan, self._padding
        if value_shape is not None:
            blk = vmap(func)(torch.empty((1,) + plan, device="meta",
                                         dtype=torch_dtype(b.dtype)))
            check_value_shape(value_shape, tuple(blk.shape[1:]))
        if b.mesh is not None:
            return self._mesh_map(func, value_shape, dtype)
        if b._stream is not None:
            # a stream records the per-block map as a stage of its slab
            # program (NotImplemented: it materialises below)
            from bolt_tpu_torch import stream
            out = stream.chunked_map_stage(self, func, dtype)
            if out is not NotImplemented:
                return out
        b._guard_donated()
        # donating terminal (checked before the base local exists)
        donate = b.deferred and _chain_donate_ok(b._chain)
        canon = None if dtype is None else torch_dtype(dtype)
        uniform = self.uniform and not any(pad)
        grid = self.grid
        vshape = tuple(b.shape[split:])
        b_item = b.dtype.itemsize
        base, funcs = b._chain_parts()

        def body(recs, split=1):
            if uniform:
                return _uniform_map_body(recs, func, split, plan, canon)
            return _general_map_body(recs, func, split, plan, pad, canon)

        def build():
            def run(data):
                if not donate or not prod(data.shape[:split]):
                    return body(_chain_apply(funcs, split, data), split)
                # a donated base is read block by block of records, and
                # its storage takes the result where the shape allows
                rec = max(prod(vshape) * b_item, prod(data.shape[split:])
                          * data.element_size())
                return _map_blocks(data, funcs, split, body,
                                   _block_records(rec), True)
            return run

        path = "uniform" if uniform else "general"
        fn = _cached_jit(("chunk-map-u" if uniform else "chunk-map-g", func,
                          funcs, tuple(base.shape), str(base.dtype), split,
                          plan, pad, canon, donate, b.device), build)
        with _obs.span("chunk.map", path=path, donate=donate):
            out = fn(base)
        if donate:
            del base
            b._consume_donated("chunk().map()")
        if uniform:
            new_plan = tuple(o // g for o, g in zip(out.shape[split:], grid))
            return ChunkedArray(BoltArrayGPU(out, split, b.device), new_plan,
                                pad)
        return ChunkedArray(BoltArrayGPU(out, split, b.device), plan, pad)

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
        # surviving value axes shift right by the number moved in
        vshard = {va + len(moved): name for va, name in self._vshard.items()}
        return self._rewrap(swapped, tuple(moved) + self._plan,
                            (0,) * len(moved) + self._padding, vshard)

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
        vshard = {pos: self._vshard[old] for pos, old in enumerate(keep)
                  if old in self._vshard}
        return self._rewrap(swapped, tuple(self._plan[i] for i in keep),
                            tuple(self._padding[i] for i in keep), vshard)

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

    def filter(self, func, axis=(0,), sort=False):
        """Filter records by a predicate; the result leaves the chunked
        view (re-keyed flat, as the array method's).  On a stream the
        predicate stays a lazy stage whose mask the terminals fold."""
        return self._barray.filter(func, axis=axis, sort=sort)

    def __repr__(self):
        s = "ChunkedArray\n"
        s += "mode: gpu\n"
        s += "shape: %s\n" % str(self.shape)
        s += "split: %d\n" % self.split
        s += "plan: %s\n" % str(self._plan)
        s += "padding: %s\n" % str(self._padding)
        s += "grid: %s\n" % str(self.grid)
        if self._vshard:
            s += "vshard: %s\n" % str(self._vshard)
        return s
