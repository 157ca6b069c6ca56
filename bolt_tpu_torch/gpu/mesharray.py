"""Arrays on a device mesh: the mesh half of ``mode='gpu'``.

Port of the mesh half of ``bolt_tpu/tpu/array.py :: BoltArrayTPU``.  The
reference holds ONE global ``jax.Array`` sharded over the mesh, driven by
one process.  The port runs one process per rank
(:mod:`bolt_tpu_torch.parallel.multihost`): a :class:`BoltArrayMesh`
reports the GLOBAL shape, and holds this rank's box of it — the block
its layout (``_spec``, :mod:`~bolt_tpu_torch.parallel.sharding`) gives
the rank — as a single-device :class:`BoltArrayGPU` (``_local``), with
that array's laziness (deferred map chains, pending filters).  Every
rank calls the same methods in the same order, and a terminal returns
the same bits on every rank.

=============================  =========================================
reference on a mesh            here, on each rank
=============================  =========================================
SPMD ``vmap`` map              the rank's box maps (a deferred chain)
GSPMD all-reduce of a stat     the rank's terminal over its box (the
                               ``fused_map_reduce``/``fused_welford``
                               kernels), then the partials of the mesh
                               axes that shard the reduced axes are
                               gathered and folded in rank order
                               (``gpu/multistat.py :: mesh_stats``)
shard_map Welford              the rank's ``fused_welford`` moments and a
                               Chan combine (``gpu/stats.py``)
``reduce`` (pairwise tree)     the rank's tree, then ``func`` over the
                               ranks' partials in rank order
``swap`` (all_to_all reshard)  ``sharding.relayout``: one all_to_all
filter (mask, count, gather)   the rank's mask; survivor indices are
                               gathered, the survivors re-laid out by
                               ``key_spec`` of the new global shape by
                               one all_to_all (replicated when the key
                               extent does not divide)
``_gather_multihost``          ``sharding.gather``: each box broadcast
                               from its first holder in bounded pieces
=============================  =========================================

A stream on a mesh of more than one rank (``fromcallback(...,
per_process=True)``, a re-iterable ``fromiter``) is a mesh array whose
``_stream`` is set and which holds no box yet: its reduction terminals
stream every rank's rows of each slab and fold the slab's partial across
the ranks (``stream.execute``), its stages record lazily as on one
device, and any other consumer materialises it, each rank building its
own box (``stream.materialize``).

Mesh axes that shard no reduced axis are never folded over: their ranks
hold replicas.  A one-rank mesh is the single-device path: its box is the
whole array, every fold is over one partial, and any method outside this
slice runs the single-device method on the box.  On a mesh of more than
one rank every other method raises ``NotImplementedError`` naming its
ROADMAP item; nothing gathers quietly and nothing runs on one rank's
data alone.
"""

import numpy as np
import torch

from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.base import BoltArray
from bolt_tpu_torch.gpu import dtypes
from bolt_tpu_torch.gpu.array import (BoltArrayGPU, _download,
                                      _filter_blocks, _pred_mask,
                                      _traceable)
from bolt_tpu_torch.gpu.dtypes import torch_dtype
from bolt_tpu_torch.parallel import multihost, sharding
from bolt_tpu_torch.utils import prod, tupleize

# the ROADMAP item of everything on a multi-rank mesh outside this slice
SURFACE_ITEM = "A12d"

# the {regions, broadcasts, max_piece_bytes} of the last toarray() gather
# (the reference's tpu/array.py :: _LAST_GATHER_STATS)
_LAST_GATHER_STATS = None


def not_ported(what, mesh, item=SURFACE_ITEM):
    """The error of an operation this slice does not run on a mesh of
    more than one rank."""
    return NotImplementedError(
        "%s on a mesh of %d ranks is not ported yet (ROADMAP %s); it "
        "runs on a one-rank mesh or a single device" % (what, mesh.size,
                                                        item))


def topology_key(mesh):
    """The engine-key scope of work on ``mesh``: the pod's topology token
    and the mesh's geometry, so a program built for one mesh never serves
    another."""
    return ("mesh", multihost.topology_token(), mesh.geometry)


class BoltArrayMesh(BoltArrayGPU):
    """n-d array on a mesh of ranks: the global shape, and this rank's
    box as a single-device array."""

    def __init__(self, local, mesh, shape, split, spec):
        BoltArrayGPU.__init__(self, None, split, local._device)
        self._local = local
        self._mesh = mesh
        self._shape = None if shape is None else tuple(int(s) for s in shape)
        self._spec = None if spec is None else tuple(spec)
        self._dtype = local._dtype
        # a pending filter: the source's key box and global key shape,
        # until the survivors are counted and laid out
        self._mfilter = None

    @classmethod
    def wrap(cls, tensor, mesh, shape, split, spec):
        """A mesh array over this rank's box ``tensor``."""
        return cls(BoltArrayGPU(tensor, split, tensor.device), mesh, shape,
                   split, spec)

    @classmethod
    def _streamed(cls, source):
        """A lazy pod stream over ``source`` (``source.mesh`` spans more
        than one rank): the global shape and key layout, no box until a
        consumer materialises it."""
        from bolt_tpu_torch import stream
        st = stream.result_state(source)
        b = cls.__new__(cls)
        BoltArrayGPU.__init__(b, None, st.split, source.device)
        b._local = None
        b._mesh = source.mesh
        b._mfilter = None
        b._stream = source
        b._dtype = st.dtype
        b._shape = None if st.dynamic else tuple(st.shape)
        b._spec = None if st.dynamic else sharding.key_spec(
            source.mesh, b._shape, st.split)
        return b

    def _adopt_resolved(self, res):
        """Adopt ``res``, the mesh array a pod stream's swap resolved to
        (``stream.resolve_swaps``; a pod shuffle is resident)."""
        self._stream = None
        self._local, self._shape, self._spec = res._local, res._shape, \
            res._spec
        self._split, self._dtype, self._mfilter = res._split, res._dtype, \
            res._mfilter
        self._stat_group = None

    def _unstream(self):
        """Materialise a pod stream: each rank builds its box and the
        recorded stages replay on the mesh; this array adopts the
        result."""
        if self._stream is None:
            return
        from bolt_tpu_torch import stream
        self._adopt_resolved(stream.materialize(self._stream))

    def _scope(self):
        return _engine.topology(topology_key(self._mesh))

    def _multi(self):
        return self._mesh.size > 1

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------

    @property
    def shape(self):
        if self._stream is not None and self._shape is None:
            self._unstream()          # a streamed filter's survivors
        if self._mfilter is not None:
            self._resolve_mfilter()
        return self._shape

    @property
    def box(self):
        """This rank's block, one ``(start, stop)`` per axis."""
        self._unstream()
        if self._mfilter is not None:
            self._resolve_mfilter()
        return sharding.box(self._mesh, self._spec, self._shape)

    @property
    def local(self):
        """This rank's box as a single-device array."""
        self._unstream()
        if self._mfilter is not None:
            self._resolve_mfilter()
        return self._local

    @property
    def pending(self):
        return self._mfilter is not None

    @property
    def deferred(self):
        return self._stream is None and self._local.deferred

    @property
    def streaming(self):
        return self._stream is not None

    @property
    def _data(self):
        """This rank's box, materialised (under the mesh's key scope)."""
        self._unstream()
        if self._mfilter is not None:
            self._resolve_mfilter()
        with self._scope():
            return self._local._data

    def _wrap(self, data, split):
        if self._multi():
            raise not_ported("this operation", self._mesh)
        return BoltArrayGPU(data, split, self._device)

    def _like(self, local, shape, split, spec):
        return BoltArrayMesh(local, self._mesh, shape, split, spec)

    def _whole_records(self):
        """This array with every value axis whole on each rank (a value
        axis a chunk view sharded is gathered along its mesh axis)."""
        split = self._split
        if all(e is None for e in self._spec[split:]):
            return self
        spec = self._spec[:split] + (None,) * (self.ndim - split)
        return self._relaid(spec, split)

    def _relaid(self, spec, split=None, perm=None):
        """This array moved to the layout ``spec`` (of its transpose by
        ``perm``) by one all_to_all (``sharding.relayout``)."""
        split = self._split if split is None else split
        with self._scope():
            local = self._local._mapped()
        shape = self.shape if perm is None else tuple(
            self.shape[p] for p in perm)
        out = sharding.relayout(local, self._mesh, self.shape, self._spec,
                                spec, perm)
        return BoltArrayMesh.wrap(out, self._mesh, shape, split, spec)

    # ------------------------------------------------------------------
    # functional operators
    # ------------------------------------------------------------------

    def map(self, func, axis=(0,), value_shape=None, dtype=None,
            with_keys=False):
        """Apply ``func`` to every record: each rank maps its box (a
        deferred chain, as on one device), so the key layout is kept.
        Key axes other than the current ones move there first (a
        ``swap``); a value axis sharded by a chunk view is gathered
        first, as ``func`` sees whole records."""
        if with_keys and self._multi():
            raise not_ported("map(with_keys=True)", self._mesh)
        if self._stream is not None:
            # a stage of the pod stream's slab program
            return BoltArrayGPU.map(self, func, axis=axis,
                                    value_shape=value_shape, dtype=dtype)
        axes = sorted(tupleize(axis))
        src = self._align(axes)._whole_records()
        split = src._split
        with self._scope():
            loc = src._local.map(func, axis=tuple(range(split)),
                                 value_shape=value_shape, dtype=dtype,
                                 with_keys=with_keys)
        shape = src.shape[:split] + tuple(loc.shape[split:])
        spec = src._spec[:split] + (None,) * (len(shape) - split)
        return self._like(loc, shape, split, spec)

    def filter(self, func, axis=(0,), sort=False):
        """Keep the records whose predicate is true; survivors are
        re-keyed to one flat key axis in the original key order.  Pending
        (as on one device): ``sum``/``mean``/... over the key axis fold
        each rank's masked partials; any other consumer counts the
        survivors and lays them out by ``key_spec`` of the new global
        shape (replicated when the count does not divide the mesh)."""
        if self._stream is not None:
            return BoltArrayGPU.filter(self, func, axis=axis, sort=sort)
        func = _traceable(func)
        axes = sorted(tupleize(axis))
        src = self._align(axes)._whole_records()
        split = src._split
        with self._scope():
            loc = src._local.filter(func, axis=tuple(range(split)))
        if loc._fpending is None:
            # the predicate took the host fallback: its survivors carry no
            # key indices to lay them out by
            if self._multi():
                raise not_ported("filter with a predicate vmap cannot "
                                 "batch", self._mesh)
            return self._like(loc, tuple(loc.shape), 1, (None,) * loc.ndim)
        out = BoltArrayMesh(loc, self._mesh, None, 1, None)
        kbox = sharding.box(src._mesh, src._spec, src.shape)[:split]
        out._mfilter = (kbox, tuple(src.shape[:split]),
                        src._spec[:split], tuple(src.shape[split:]))
        return out

    def _resolve_mfilter(self):
        """Count the survivors of this pending filter across the ranks
        and lay them out by ``key_spec`` of ``(count, *vshape)``: each
        rank's mask and survivors come from its own box (one pass over
        blocks of records), the survivors' global key indices are
        gathered, and the records move to their new boxes by one
        all_to_all."""
        kbox, gkshape, kspec, vshape = self._mfilter
        mesh, loc = self._mesh, self._local
        pred = loc._fpending[2]
        dtype = torch_dtype(loc._dtype)
        device = loc._device
        with self._scope():
            parts, masks = [], []
            for _, _, recs in _filter_blocks(loc._fpending, dtype):
                m = _pred_mask(pred, recs) if recs.shape[0] else \
                    torch.zeros(0, dtype=torch.bool, device=recs.device)
                masks.append(m)
                parts.append(dtypes.rows(recs, m) if recs.shape[0] else recs)
            surv = torch.cat(parts) if len(parts) > 1 else parts[0]
            mask = torch.cat(masks) if len(masks) > 1 else masks[0]
        local_idx = np.nonzero(mask.cpu().numpy())[0]
        kb_shape = sharding.box_shape(kbox)
        if len(gkshape):
            coords = np.unravel_index(local_idx, kb_shape)
            glob = np.ravel_multi_index(
                tuple(c + s for c, (s, _) in zip(coords, kbox)), gkshape)
        else:
            glob = local_idx
        glob = torch.from_numpy(np.asarray(glob, dtype=np.int64))
        every = multihost.all_gather(glob.to(device),
                                     mesh.group(mesh.axis_names))
        every = [t.cpu().numpy() for t in every]
        # the distinct source boxes (replicas share one), their holders
        # and their survivors' positions in the global survivor order
        kboxes = [sharding.box(mesh, kspec, gkshape, r)
                  for r in range(mesh.size)]
        held = sharding._holders(kboxes)
        idx = [every[holders[0]] for _, holders in held]
        order = np.sort(np.concatenate(idx)) if idx else np.zeros(0, np.int64)
        pos = [np.searchsorted(order, a) for a in idx]
        total = int(order.size)
        shape = (total,) + tuple(vshape)
        spec = sharding.key_spec(mesh, shape, 1)
        me = mesh.rank
        rec_bytes = prod(vshape) * surv.element_size()
        sends = [[] for _ in range(mesh.size)]
        recv = [[] for _ in range(mesh.size)]
        lo_me, hi_me = sharding.box(mesh, spec, shape, me)[0]
        out = torch.empty((hi_me - lo_me,) + tuple(vshape),
                          dtype=surv.dtype, device=device)
        crossing = False
        for q in range(mesh.size):
            lo, hi = sharding.box(mesh, spec, shape, q)[0]
            for i, (_, holders) in enumerate(held):
                sel = np.nonzero((pos[i] >= lo) & (pos[i] < hi))[0]
                if not sel.size:
                    continue
                sender = sharding._sender(holders, q)
                crossing |= sender != q
                if sender == me and q == me:
                    out[torch.from_numpy(pos[i][sel] - lo).to(device)] = \
                        surv[torch.from_numpy(sel).to(device)]
                elif sender == me:
                    sends[q].append(surv[torch.from_numpy(sel).to(device)])
                elif q == me:
                    recv[sender].append(pos[i][sel] - lo)
        if crossing:
            empty = torch.empty(0, dtype=torch.uint8, device=device)
            payload = [torch.cat([empty] + [multihost._as_bytes(p)
                                            for p in ps]) for ps in sends]
            sizes = [sum(len(p) for p in ps) * rec_bytes for ps in recv]
            got = multihost.all_to_all(payload, sizes, device)
            for s in range(mesh.size):
                off = 0
                for p in recv[s]:
                    nb = len(p) * rec_bytes
                    rows = multihost._from_bytes(
                        got[s][off:off + nb], surv.dtype,
                        (len(p),) + tuple(vshape))
                    out[torch.from_numpy(p).to(device)] = rows
                    off += nb
        self._local = BoltArrayGPU(out, 1, device)
        self._shape = shape
        self._spec = spec
        self._mfilter = None

    def reduce(self, func, axis=(0,), keepdims=False):
        """Reduce the records with the binary ``func``: each rank's
        pairwise tree over its box, then ``func`` over the partials of
        the ranks that split the key axes, in rank order (the same bits
        on every rank).  A pod stream materialises first: a user
        ``func`` has no per-slab fold over the ranks."""
        func = _traceable(func)
        self._unstream()
        if self._mfilter is not None:
            self._resolve_mfilter()
        axes = sorted(tupleize(axis))
        src = self._align(axes)._whole_records()
        split = src._split
        mesh_axes = sharding.shard_axes(src._spec, range(split))
        with self._scope():
            if not mesh_axes:
                loc = src._local.reduce(func, axis=tuple(range(split)),
                                        keepdims=keepdims)
                loc._data
                return self._like(loc, tuple(loc.shape), loc.split,
                                  (None,) * loc.ndim)
            part = src._local.reduce(func, axis=tuple(range(split)))._data
            acc = multihost.fold_partials(part, func,
                                          self._mesh.group(mesh_axes))
        if keepdims:
            acc = acc.reshape((1,) * split + tuple(acc.shape))
        out = BoltArrayMesh.wrap(acc, self._mesh, tuple(acc.shape),
                                 split if keepdims else 0,
                                 (None,) * acc.ndim)
        return out

    # ------------------------------------------------------------------
    # statistics: each rank's terminal, folded over the sharding axes
    # ------------------------------------------------------------------

    def _stat(self, axis, name, keepdims=False, ddof=None):
        from bolt_tpu_torch.gpu import multistat
        if self._stream is not None:
            from bolt_tpu_torch import stream
            if stream.has_swap(self._stream):
                stream._swap_resolved(self)
        if self._stream is not None:
            # the pod stream's terminal: lazy in its stream group, or
            # streamed now; a geometry neither serves materialises
            _engine.strict_guard(self, "%s()" % name)
            out = multistat.defer_stat(self, axis, name, keepdims, ddof)
            if out is NotImplemented:
                from bolt_tpu_torch import stream
                out = stream.maybe_stat(self, axis, name, keepdims, ddof)
            if out is not NotImplemented:
                return out
            self._unstream()
        if self._mfilter is not None:
            out = multistat.mesh_filter_stats(self, [(name, axis, keepdims,
                                                      ddof)])
            if out is not NotImplemented:
                return out[0]
            self._resolve_mfilter()
        return multistat.mesh_stats(self, [(name, axis, keepdims, ddof)])[0]

    def stats(self, *requested, axis=None, accumulate=None, **kwargs):
        """:meth:`BoltArrayGPU.stats` on the mesh: the ``StatCounter`` form
        runs each rank's ``fused_welford`` moments and a Chan combine
        (``gpu/stats.py :: welford``); the fluent form folds every
        member's partial in one exchange (``gpu/multistat.py``).  A
        reduced-precision ``accumulate`` runs on a one-rank mesh only,
        as the single device's group."""
        if accumulate is not None:
            if self._multi():
                raise not_ported("stats(accumulate=...)", self._mesh)
            return self.local.stats(*requested, axis=axis,
                                    accumulate=accumulate, **kwargs)
        if not (requested and all(isinstance(r, str) for r in requested)):
            self._unstream()          # the StatCounter form reads boxes
        return BoltArrayGPU.stats(self, *requested, axis=axis, **kwargs)

    # ------------------------------------------------------------------
    # layout
    # ------------------------------------------------------------------

    def _do_swap(self, kaxes, vaxes, donate=False):
        """:meth:`BoltArrayGPU.swap`'s work on a mesh: the boxes move to
        the ``key_spec`` layout of the new shape by one all_to_all;
        ``donate`` releases this rank's box once moved.  A pod stream
        records the swap as a lazy stage (the consuming terminal resolves
        it by the pod shuffle), or materialises where it cannot."""
        if self._mfilter is not None:
            self._resolve_mfilter()
        split = self._split
        nvalue = self.ndim - split
        keys_rest = [k for k in range(split) if k not in kaxes]
        values_rest = [v for v in range(nvalue) if v not in vaxes]
        perm = (keys_rest + [split + v for v in vaxes]
                + list(kaxes) + [split + v for v in values_rest])
        new_split = len(keys_rest) + len(vaxes)
        if perm == list(range(self.ndim)) and new_split == split:
            return self
        if self._stream is not None:
            from bolt_tpu_torch import stream
            out = stream.swap_stage(self, tuple(perm), new_split)
            if out is not NotImplemented:
                return out
            self._unstream()
        new_shape = tuple(self.shape[p] for p in perm)
        out = self._relaid(sharding.key_spec(self._mesh, new_shape,
                                             new_split), new_split, perm)
        if donate:
            self._local._consume_donated("swap(..., donate=True)",
                                         granted=False)
        return out

    def toarray(self, out=None):
        """The whole array on every rank's host: the boxes gathered in
        pieces of bounded size (``sharding.gather``; its counts in
        ``_LAST_GATHER_STATS``)."""
        global _LAST_GATHER_STATS
        local = self._data
        a, _LAST_GATHER_STATS = sharding.gather(
            local, self._mesh, self.shape, self._spec, _download)
        if out is not None:
            BoltArray._check_out(out, a.shape, a.dtype)
            out[...] = a
            return out
        return a

    def __repr__(self):
        s = "BoltArray\n"
        s += "mode: gpu (mesh %s)\n" % (dict(self._mesh.shape),)
        if self._stream is not None:
            s += "streaming: %r\n" % (self._stream,)
        elif self._mfilter is not None:
            s += "shape: pending filter\n"
        else:
            s += "shape: %s\n" % (self.shape,)
            s += "spec: %s\n" % (self._spec,)
        s += "split: %d\n" % self._split
        s += "dtype: %s\n" % self.dtype
        return s


# the methods this slice runs on a multi-rank mesh: BoltArrayMesh's own
# (above) and these, inherited as they stand (they read only the global
# shape, or go through the methods above)
_INHERITED = {"chunk", "mean", "var", "std", "ptp", "sum", "max", "min",
              "prod", "all", "any", "swap", "cache", "keys", "values",
              "ndim", "size", "mode", "dtype", "split", "device", "mesh",
              "__len__", "_align", "_guard_donated", "_constructor"}


def _guarded(name, attr):
    """The inherited ``attr`` behind the multi-rank guard: a one-rank
    mesh runs it on its box (the single-device path); more ranks
    raise."""
    if isinstance(attr, property):
        def fget(self):
            if self._multi():
                raise not_ported(name, self._mesh)
            return getattr(self.local, name)
        return property(fget)

    def method(self, *args, **kwargs):
        if self._multi():
            raise not_ported(name if name.startswith("__") else
                             "%s()" % name, self._mesh)
        return getattr(self.local, name)(*args, **kwargs)
    method.__name__ = name
    method.__doc__ = getattr(attr, "__doc__", None)
    return method


def _install_guards():
    own = set(vars(BoltArrayMesh))
    for klass in BoltArrayGPU.__mro__[:-1]:
        for name, attr in vars(klass).items():
            if name in own or name in _INHERITED:
                continue
            if not (callable(attr) or isinstance(attr, property)):
                continue
            if isinstance(attr, (staticmethod, classmethod)):
                continue
            if name.startswith("_") and not name.startswith("__") and \
                    name not in ("_mapped", "_chain_parts", "_materialise",
                                 "_resolve_filter", "_fused_filter_stat",
                                 "_fused_filter_reduce", "_apply",
                                 "_unary", "_elementwise", "_operand"):
                continue
            setattr(BoltArrayMesh, name, _guarded(name, attr))
            own.add(name)


_install_guards()
