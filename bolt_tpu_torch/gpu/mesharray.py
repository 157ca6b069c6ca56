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
``_constrain`` of a result     the result moved to ``key_spec`` of its
                               shape (``_constrained``)
=============================  =========================================

The rest of the surface (operators and ufuncs, indexing and ``set``,
the ndarray methods, layout, ``stacked``/``concatenate``, the exits)
takes the first of three forms that applies:

1. box-local: an op per element, or along axes whole on every rank, runs
   the single-device method on the box and keeps the layout (a scalar
   operand joins the box's map chain; an array operand is sliced, or
   relaid, to the box);
2. a fold: a decomposable reduction over sharded axes (``ufunc.reduce``
   of an associative ufunc, ``argmax``/``argmin`` as ``(value, global
   index)`` pairs) folds each rank's partial in rank order;
3. a relayout: anything else that touches a sharded axis (sorts, scans,
   quantiles, a reshape across box edges) first moves the array to a
   layout where those axes are whole (``sharding.whole_spec``, one
   all_to_all), runs the single-device method, and moves the result to
   ``key_spec``; records picked by index (``__getitem__``, ``take``,
   ``repeat``, ``concatenate``) move by ``sharding.route``.

A stream on a mesh of more than one rank (``fromcallback(...,
per_process=True)``, a re-iterable ``fromiter``) is a mesh array whose
``_stream`` is set and which holds no box yet: its reduction terminals
stream every rank's rows of each slab and fold the slab's partial across
the ranks (``stream.execute``), its stages record lazily as on one
device, and any other consumer materialises it, each rank building its
own box (``stream.materialize``).

numpy's function table (``__array_function__``, ``gpu/npdispatch.py``)
takes the same three forms: the families that have a method call it, and
the table's shared program path (``npdispatch._device_fused``) runs one
program a rank over the operands' boxes, box-local, as a fold of
per-rank partials in rank order (a contraction over a sharded axis), or
on a layout where the axes its body touches are whole; every result is
laid out by ``key_spec`` of its shape and split.

Mesh axes that shard no reduced axis are never folded over: their ranks
hold replicas.  A one-rank mesh is the single-device path: its box is the
whole array, every fold is over one partial, and every method runs the
single-device method on the box.  On a mesh of more than one rank nothing
gathers quietly and nothing runs on one rank's data alone.
"""

import numpy as np
import torch

from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.base import BoltArray
from bolt_tpu_torch.gpu import dtypes
from bolt_tpu_torch.gpu import ufuncs
from bolt_tpu_torch.gpu.array import (BoltArrayGPU, _download,
                                      _filter_blocks, _infer_pred,
                                      _is_trace_error, _pred_mask,
                                      _raise_callable_bug, _traceable,
                                      _upload, _warn_fallback, check_mesh,
                                      hbm_check)
from bolt_tpu_torch.gpu.dtypes import torch_dtype
from bolt_tpu_torch.parallel import multihost, sharding
from bolt_tpu_torch.utils import inshape, prod, tupleize

# the {regions, broadcasts, max_piece_bytes} of the last toarray() gather
# (the reference's tpu/array.py :: _LAST_GATHER_STATS)
_LAST_GATHER_STATS = None


# a single-device internal that names no mesh form, reached on several
# ranks: a call site that never chose one fails here instead of
# gathering the whole array unseen
_NO_FORM = ("%s of a mesh array of several ranks names no form: read the "
            "box (.local), a relayout (_whole(axes)) or the whole array "
            "(_whole_tensor())")


def _one_rank_local(fn):
    """A method of the mesh that, on a one-rank mesh, is the single-device
    method on the box (that mesh's path since the mesh slices); ``fn`` on
    more ranks."""
    name = fn.__name__

    def method(self, *args, **kwargs):
        if not self._multi():
            return getattr(self.local, name)(*args, **kwargs)
        return fn(self, *args, **kwargs)
    method.__name__ = name
    method.__doc__ = fn.__doc__
    return method


def _check_move(op, mesh, shape, spec, local):
    """``hbm_check`` of a relayout's transient on this rank: its box, its
    new box of ``shape`` under ``spec`` and the exchange's buffers."""
    new = prod(sharding.box_shape(sharding.box(mesh, spec, shape)))
    item = local.element_size()
    hbm_check(op, (local.numel() + 2 * new) * item,
              "this rank's box + its new box + the exchange's buffers",
              local.device)


# the binary ufuncs whose reduce partials fold in any grouping
_ASSOCIATIVE = frozenset([
    "add", "multiply", "maximum", "minimum", "fmax", "fmin", "hypot",
    "logaddexp", "logaddexp2", "logical_and", "logical_or", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "gcd", "lcm"])


def _key_shifted(func, offset):
    """A ``map(..., with_keys=True)`` callable over a box whose key
    indices start at ``offset``: ``func`` sees each record's global key
    tuple."""
    def shifted(kv):
        keys, v = kv
        return func((tuple(k + o for k, o in zip(keys, offset)), v))
    return shifted


def on_mesh(b):
    """True for an array on a mesh of more than one rank."""
    return isinstance(b, BoltArrayMesh) and b._mesh.size > 1


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

    def _ready(self):
        """This array with its box built: a pod stream materialised, a
        pending filter's survivors laid out."""
        self._unstream()
        if self._mfilter is not None:
            self._resolve_mfilter()
        return self

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
        """A result ``data`` that is whole on every rank (the same bits on
        each), laid out by ``key_spec`` of its shape and ``split``: each
        rank keeps its box, with no exchange."""
        if self._multi():
            return self._result(data, tuple(data.shape), split,
                                (None,) * data.ndim)
        return BoltArrayGPU(data, split, self._device)

    @_one_rank_local
    def _clone(self):
        """A new mesh array over a clone of this rank's box wrapper (its
        chain and pending filter shared, as one device's ``_clone``)."""
        self._ready()
        return self._like(self._local._clone(), self.shape, self._split,
                          self._spec)

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
        self._ready()
        with self._scope():
            local = self._local._mapped()
        shape = self.shape if perm is None else tuple(
            self.shape[p] for p in perm)
        _check_move("relayout", self._mesh, shape, spec, local)
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
        first, as ``func`` sees whole records.  ``with_keys``: each
        record's key tuple is its global one, the box's own key indices
        shifted by the box's offsets."""
        if with_keys and self._stream is not None:
            self._unstream()        # global key indices need the boxes
        if self._stream is not None:
            # a stage of the pod stream's slab program
            return BoltArrayGPU.map(self, func, axis=axis,
                                    value_shape=value_shape, dtype=dtype)
        axes = sorted(tupleize(axis))
        src = self._align(axes)._whole_records()
        split = src._split
        if with_keys and self._multi():
            func = _key_shifted(_traceable(func), tuple(
                lo for lo, _ in src.box[:split]))
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
        if self._multi() and not src._batched_pred(func):
            return src._host_filter(func)
        with self._scope():
            loc = src._local.filter(func, axis=tuple(range(split)))
        if loc._fpending is None:
            # one rank: the predicate took the host fallback
            return self._like(loc, tuple(loc.shape), 1, (None,) * loc.ndim)
        out = BoltArrayMesh(loc, self._mesh, None, 1, None)
        kbox = sharding.box(src._mesh, src._spec, src.shape)[:split]
        out._mfilter = (kbox, tuple(src.shape[:split]),
                        src._spec[:split], tuple(src.shape[split:]))
        return out

    def _batched_pred(self, func):
        """Whether ``vmap`` batches the predicate ``func`` over this
        array's records (else it warns, as one device's host fallback
        does)."""
        vshape = tuple(self.shape[self._split:])
        try:
            _infer_pred(func, vshape, torch_dtype(self.dtype))
        except (RuntimeError, TypeError) as exc:
            if not _is_trace_error(exc):
                _raise_callable_bug("filter", func, exc, vshape)
            _warn_fallback("filter", func, exc)
            return False
        return True

    def _host_filter(self, func):
        """The filter of a predicate ``vmap`` cannot batch: each rank runs
        it on its own records on the host (the local oracle's truth
        rule), and the survivors, keyed by their global indices, are laid
        out as a batched predicate's are."""
        split = self._split
        vshape = tuple(self.shape[split:])
        with self._scope():
            recs = _download(self.local._mapped()).reshape((-1,) + vshape)
        mask = np.array([bool(func(v)) for v in recs], dtype=bool)
        surv = _upload(recs[mask], self._device)
        out = BoltArrayMesh.wrap(surv, self._mesh, None, 1, None)
        out._place(surv, torch.from_numpy(mask), self.box[:split],
                   tuple(self.shape[:split]), self._spec[:split], vshape)
        return out

    def _resolve_mfilter(self):
        """Count the survivors of this pending filter across the ranks
        and lay them out by ``key_spec`` of ``(count, *vshape)``: each
        rank's mask and survivors come from its own box (one pass over
        blocks of records), the survivors' global key indices are
        gathered, and the records move to their new boxes by one
        all_to_all."""
        kbox, gkshape, kspec, vshape = self._mfilter
        loc = self._local
        pred = loc._fpending[2]
        dtype = torch_dtype(loc._dtype)
        with self._scope():
            parts, masks = [], []
            for _, _, recs in _filter_blocks(loc._fpending, dtype):
                m = _pred_mask(pred, recs) if recs.shape[0] else \
                    torch.zeros(0, dtype=torch.bool, device=recs.device)
                masks.append(m)
                parts.append(_engine.host_sync("filter.rows", dtypes.rows,
                                               recs, m)
                             if recs.shape[0] else recs)
            surv = torch.cat(parts) if len(parts) > 1 else parts[0]
            mask = torch.cat(masks) if len(masks) > 1 else masks[0]
        self._place(surv, mask, kbox, gkshape, kspec, vshape)
        self._mfilter = None

    def _place(self, surv, mask, kbox, gkshape, kspec, vshape):
        """Adopt the survivors ``surv`` of this rank's source records (the
        key box ``kbox`` of the global key shape ``gkshape``, laid out by
        ``kspec``; ``mask`` over the box's records): their global key
        indices are gathered, and the records move to ``key_spec`` of
        ``(count, *vshape)`` by one all_to_all."""
        mesh = self._mesh
        device = surv.device
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
        lo_me, hi_me = sharding.box(mesh, spec, shape)[0]
        out = torch.empty((hi_me - lo_me,) + tuple(vshape),
                          dtype=surv.dtype, device=device)
        moves = []
        for q in range(mesh.size):
            lo, hi = sharding.box(mesh, spec, shape, q)[0]
            for i, (_, holders) in enumerate(held):
                sel = np.nonzero((pos[i] >= lo) & (pos[i] < hi))[0]
                if sel.size:
                    moves.append((sharding._sender(holders, q), q, [sel],
                                  [pos[i][sel] - lo]))
        sharding.exchange(surv, out, moves, mesh)
        self._local = BoltArrayGPU(out, 1, device)
        self._dtype = self._local._dtype
        self._shape = shape
        self._spec = spec

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
        member's partial in one exchange (``gpu/multistat.py``).  With a
        reduced-precision ``accumulate`` each rank's group runs at it and
        the partials fold in rank order, by the same fold."""
        fluent = bool(requested) and all(isinstance(r, str)
                                         for r in requested)
        if accumulate is not None and not self._multi():
            return self.local.stats(*requested, axis=axis,
                                    accumulate=accumulate, **kwargs)
        if accumulate is not None and fluent:
            from collections import OrderedDict
            from bolt_tpu_torch.gpu import multistat
            self._ready()
            return OrderedDict(zip(requested, multistat.mesh_stats(
                self, [(n, axis, False, None) for n in requested],
                accumulate=accumulate)))
        if not fluent:
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

    # ------------------------------------------------------------------
    # result layouts: every result is laid out by ``key_spec`` of its
    # shape and split (the reference's ``_constrain``)
    # ------------------------------------------------------------------

    def _constrained(self):
        """This array laid out by ``key_spec`` of its shape and split."""
        spec = sharding.key_spec(self._mesh, self.shape, self._split)
        return self if spec == self._spec else self._relaid(spec)

    def _whole(self, axes, move=True):
        """This array relaid so that ``axes`` are whole on every rank
        (``sharding.whole_spec``: their mesh axes shard another axis, or
        replicate)."""
        self._ready()
        spec = sharding.whole_spec(self._mesh, self.shape, self._spec,
                                   axes, move)
        return self if spec == self._spec else self._relaid(spec)

    def _whole_tensor(self):
        """The whole array on every rank's device: for an operand the
        reference broadcasts whole, or a result it replicates."""
        return self._whole(range(self.ndim), move=False)._data

    def _result(self, t, shape, split, spec):
        """A mesh array over this rank's result box ``t`` (global
        ``shape``, laid out by ``spec``), moved to ``key_spec``."""
        return BoltArrayMesh.wrap(t, self._mesh, tuple(shape), split,
                                  tuple(spec))._constrained()

    def _on_whole(self, axes, fn, keep, split):
        """``fn`` (the single-device work, given this rank's box as a
        :class:`BoltArrayGPU`) on a layout where ``axes`` are whole.
        ``keep`` names, for each axis of the result, the source axis
        whose length and layout it keeps, or ``None`` for an axis that is
        whole on every rank; the result moves to ``key_spec``."""
        src = self._whole(axes)
        with src._scope():
            t = fn(src._local)
            if isinstance(t, BoltArrayGPU):
                t = t._data
        spec = tuple(None if a is None else src._spec[a] for a in keep)
        shape = tuple(int(t.shape[j]) if a is None else src.shape[a]
                      for j, a in enumerate(keep))
        return src._result(t, shape, split, spec)

    # ------------------------------------------------------------------
    # elementwise operators and ufuncs: box-local
    # ------------------------------------------------------------------

    @_one_rank_local
    def _apply(self, fn):
        """``fn`` per element: joins each rank's map chain over the key
        axes, or runs on the box of a key-less array; the layout is
        kept."""
        if self._split:
            return self.map(fn, axis=tuple(range(self._split)))
        return BoltArrayMesh.wrap(fn(self._data), self._mesh, self.shape,
                                  0, self._spec)

    @_one_rank_local
    def _operand(self, other):
        """A non-scalar operand whole, as a tensor on this rank's
        device (a mesh array is gathered)."""
        if isinstance(other, BoltArrayMesh):
            check_mesh(self, other, "elementwise")
            return other._whole_tensor()
        return BoltArrayGPU._operand(self, other)

    def _operand_box(self, other, shape, spec):
        """The part of ``other``, broadcast to ``shape``, under this
        rank's box of a result laid out by ``spec``: a mesh array of that
        shape is relaid to ``spec``, a host array or a tensor is sliced
        (each rank uploads only its part)."""
        if isinstance(other, BoltArrayMesh) and other.shape == shape:
            check_mesh(self, other, "elementwise")
            return (other if other._spec == spec else
                    other._relaid(spec, other._split))._data
        if isinstance(other, BoltArrayGPU):
            full = self._operand(other)
        elif isinstance(other, BoltArray):
            full = other.toarray()
        elif isinstance(other, torch.Tensor):
            full = other
        else:
            full = np.asarray(other)
        bx = sharding.box(self._mesh, spec, shape)
        off = len(shape) - full.ndim
        part = full[tuple(slice(None) if full.shape[i] == 1 else
                          slice(*bx[off + i]) for i in range(full.ndim))]
        if isinstance(part, torch.Tensor):
            return part.to(self._device)
        return _upload(part, self._device)

    @_one_rank_local
    def _elementwise(self, other, name, reverse=False):
        """A binary ufunc against ``other``: a scalar joins the map chain;
        an array operand meets each rank's box under the result's
        layout.  A result that outgrows the keys (broadcasting adds
        leading axes) is key-less and replicated, as the reference's."""
        if isinstance(other, (int, float, complex, np.number, np.bool_)):
            return self._apply(ufuncs.scalar_fn(
                name, other, reverse, torch_dtype(self.dtype)))
        if isinstance(other, BoltArrayGPU):
            check_mesh(self, other, "elementwise")
        oshape = tuple(other.shape) if isinstance(other, BoltArray) else \
            tuple(np.shape(other))
        shape = tuple(np.broadcast_shapes(self.shape, oshape))
        split = self._split
        if len(shape) != self.ndim or shape[:split] != self.shape[:split]:
            split, spec = 0, (None,) * len(shape)
            x = self._whole_tensor()
        else:
            spec = self._spec
            x = self._data
        o = self._operand_box(other, shape, spec)
        out = ufuncs.binary(name, o, x) if reverse \
            else ufuncs.binary(name, x, o)
        return self._result(out, shape, split, spec)

    @_one_rank_local
    def _matmul(self, other, reverse=False, dot=False, precision=None):
        """``@`` / ``numpy.dot`` on the mesh: against a matrix or a
        vector the contraction runs on each rank's box made whole along
        the contracted axis, and the other axes keep their layout;
        other operand forms meet the whole array (the reference's
        result is then key-less and replicated)."""
        if isinstance(other, BoltArrayGPU):
            check_mesh(self, other, "matmul")
        oshape = tuple(other.shape) if isinstance(other, BoltArray) else \
            tuple(np.shape(other))
        nd = self.ndim
        if isinstance(other, BoltArrayMesh) and not (reverse or dot) \
                and nd >= 3 \
                and other.ndim == nd and other.shape[:-2] == self.shape[:-2]:
            # a stack of products over shared leading axes: both boxes
            # whole along their last two axes, the leading ones laid out
            # alike
            src = self._whole([nd - 2, nd - 1])
            spec = src._spec[:-2] + (None, None)
            o = other if other._spec == spec else other._relaid(spec)
            with src._scope():
                loc = src._local._matmul(o._local, precision=precision)
            return src._result(loc._data, self.shape[:-1] + other.shape[-1:],
                               loc.split, spec)
        if isinstance(other, BoltArrayMesh) or len(oshape) > 2 or nd < 1 \
                or (reverse and nd < 2):
            whole = BoltArrayGPU(self._whole_tensor(), self._split,
                                 self._device)
            op = other._whole_tensor() if isinstance(other, BoltArrayMesh) \
                else other
            loc = whole._matmul(op, reverse=reverse, dot=dot,
                                precision=precision)
            return self._result(loc._data, loc.shape, loc.split,
                                (None,) * loc.ndim)
        axis = nd - 2 if reverse else nd - 1
        if reverse:
            keep = list(range(nd - 2)) + ([None] if len(oshape) == 2
                                          else []) + [nd - 1]
        else:
            keep = list(range(nd - 1)) + ([None] if len(oshape) == 2
                                          else [])
        src = self._whole([axis])
        with src._scope():
            loc = src._local._matmul(other, reverse=reverse, dot=dot,
                                     precision=precision)
        spec = tuple(None if a is None else src._spec[a] for a in keep)
        shape = tuple(int(loc.shape[j]) if a is None else src.shape[a]
                      for j, a in enumerate(keep))
        return src._result(loc._data, shape, loc.split, spec)

    @_one_rank_local
    def _ufunc_reduce(self, ufunc, axes, dt, keepdims, initial, new_split):
        """``ufunc.reduce`` over ``axes``: each rank reduces its box, the
        partials of the mesh axes that shard ``axes`` fold in rank order
        with the ufunc itself, and ``initial`` joins once."""
        name = ufunc.__name__
        maxes = sharding.shard_axes(self._spec, axes)
        if maxes and name not in _ASSOCIATIVE:
            # a left fold's partials do not combine: the reduced axes
            # whole on each box instead
            keep = [None if a in axes else a for a in range(self.ndim)] \
                if keepdims else [a for a in range(self.ndim)
                                  if a not in axes]
            return self._on_whole(axes, lambda loc: ufuncs.ufunc_reduce(
                ufunc, loc._mapped(), axes, dt, keepdims, initial), keep,
                new_split)
        loc = self.local
        with self._scope():
            part = ufuncs.ufunc_reduce(ufunc, loc._mapped(), axes, dt, True,
                                       None if maxes else initial)
            if maxes:
                part = multihost.fold_partials(
                    part, lambda a, b: ufuncs.binary(name, a, b),
                    self._mesh.group(maxes))
                if initial is not None:
                    init = torch.as_tensor(initial, device=part.device)
                    part = ufuncs.binary(name, init, part).to(part.dtype)
        spec = tuple(None if a in axes else e
                     for a, e in enumerate(self._spec))
        shape = tuple(1 if a in axes else d for a, d in enumerate(self.shape))
        if not keepdims:
            part = part.reshape(tuple(d for a, d in enumerate(part.shape)
                                      if a not in axes))
            spec = tuple(e for a, e in enumerate(spec) if a not in axes)
            shape = tuple(d for a, d in enumerate(shape) if a not in axes)
        return self._result(part, shape, new_split, spec)

    @_one_rank_local
    def _along(self, axis, fn):
        """``fn`` along ``axis`` (keeping every other axis) on a layout
        where ``axis`` is whole."""
        return self._on_whole([axis], lambda loc: fn(loc._mapped()),
                              [None if a == axis else a
                               for a in range(self.ndim)], self._split)

    @_one_rank_local
    def _ufunc_outer(self, ufunc, inputs, dt):
        """``ufunc.outer``: this array's box against the whole other
        operand when it leads (its layout kept); a host operand leading
        gives a key-less result, replicated."""
        a, b = inputs
        if a is self:
            bt = b._whole_tensor() if isinstance(b, BoltArrayMesh) else \
                self._operand(b)
            with self._scope():
                out = ufuncs.ufunc_outer(ufunc, self.local._mapped(), bt, dt)
            extra = out.ndim - self.ndim
            return self._result(out, self.shape + tuple(out.shape[self.ndim:]),
                                self._split, self._spec + (None,) * extra)
        at = a._whole_tensor() if isinstance(a, BoltArrayMesh) else \
            self._operand(a)
        out = ufuncs.ufunc_outer(ufunc, at, self._whole_tensor(), dt)
        split = a.split if isinstance(a, BoltArrayGPU) else 0
        return self._result(out, tuple(out.shape), split, (None,) * out.ndim)

    # ------------------------------------------------------------------
    # the ndarray methods: folds and relayouts
    # ------------------------------------------------------------------

    @_one_rank_local
    def quantile(self, q, axis=None, keepdims=False, method="linear"):
        """The ``q``-th quantile over ``axis``, on a layout where the
        reduced axes are whole (the single device's sort and
        interpolation on each box)."""
        from bolt_tpu_torch.gpu.array import stat_axes, stat_split
        from bolt_tpu_torch.gpu.methods import quantile_of
        from bolt_tpu_torch.utils import check_q
        qarr = check_q(q)
        vector = qarr.ndim == 1
        axes = stat_axes(self.shape, self._split, axis)
        split = stat_split(self._split, axes, keepdims) + (1 if vector else 0)
        kept = [None if a in axes else a for a in range(self.ndim)] \
            if keepdims else [a for a in range(self.ndim) if a not in axes]

        def run(loc):
            out = quantile_of(loc._mapped(), qarr.reshape(-1), axes,
                              keepdims, method)
            return out if vector else out[0]
        return self._on_whole(axes, run, ([None] if vector else []) + kept,
                              split)

    @_one_rank_local
    def _arg_stat(self, fn, axis, keepdims):
        """argmax/argmin as a fold: each rank's ``(value, global index)``
        over its box, the boxes of the ranks that split the reduced axis
        compared in rank order, ties going to the lower index and a NaN
        winning, as in numpy."""
        from bolt_tpu_torch.gpu.methods import _sortable
        if axis is not None:
            axis = self._one_axis(axis)
        mx = fn is torch.argmax
        bx = self.box
        with self._scope():
            x = _sortable(self.local._mapped())
        if x.is_complex():
            raise TypeError("%s of a complex array is not supported (the "
                            "reference refuses it too); np.argsort takes "
                            "numpy's order" % fn.__name__)
        if axis is None:
            i = fn(x.reshape(-1))
            loc = np.unravel_index(int(i), x.shape)
            gidx = np.ravel_multi_index(
                tuple(c + lo for c, (lo, _) in zip(loc, bx)), self.shape)
            val = x.reshape(-1)[i].reshape(1)
            idx = torch.tensor([int(gidx)], dtype=torch.int64,
                               device=x.device)
            maxes = sharding.shard_axes(self._spec, range(self.ndim))
        else:
            i = fn(x, dim=axis, keepdim=True)
            val = torch.take_along_dim(x, i, axis).squeeze(axis)
            idx = i.squeeze(axis) + bx[axis][0]
            maxes = sharding.shard_axes(self._spec, [axis])
        if maxes:
            parts = multihost.all_gather((val, idx), self._mesh.group(maxes))
            val, idx = parts[0]
            for v, j in parts[1:]:
                vn, bn = torch.isnan(val), torch.isnan(v)
                better = (v > val) if mx else (v < val)
                take = (bn & ~vn) | (~vn & ~bn & better) | (
                    ((v == val) | (vn & bn)) & (j < idx))
                val, idx = torch.where(take, v, val), torch.where(take, j, idx)
        if axis is None:
            out = idx.reshape((1,) * self.ndim if keepdims else ())
            return BoltArrayMesh.wrap(out, self._mesh, tuple(out.shape), 0,
                                      (None,) * out.ndim)
        # the mesh axes that split ``axis`` now hold one result
        spec = tuple(e for a, e in enumerate(self._spec) if a != axis)
        shape = tuple(d for a, d in enumerate(self.shape) if a != axis)
        split = self._split - (1 if axis < self._split else 0)
        if keepdims:
            idx = idx.unsqueeze(axis)
            spec = spec[:axis] + (None,) + spec[axis:]
            shape = shape[:axis] + (1,) + shape[axis:]
            split = self._split
        return self._result(idx, shape, split, spec)

    @_one_rank_local
    def _cum(self, fn, axis):
        """cumsum/cumprod: along a whole axis on each box; ``None`` scans
        the flattened array, whole on every rank (a scan's bits are the
        single device's only in one sequence)."""
        if axis is None:
            flat = self.ravel()
            return flat._on_whole([0], lambda loc: loc._cum(fn, 0), [None],
                                  flat._split)
        axis = self._one_axis(axis)
        return self._on_whole([axis], lambda loc: loc._cum(fn, axis),
                              [None if a == axis else a
                               for a in range(self.ndim)], self._split)

    @_one_rank_local
    def argsort(self, axis=-1, kind=None):
        """Indices that sort along ``axis``, on a layout where it is
        whole (``None``: the flattened array, whole on every rank)."""
        from bolt_tpu_torch.gpu.methods import _check_sort_kind
        _check_sort_kind(kind)
        if axis is None:
            flat = self.ravel()
            return flat._on_whole([0], lambda loc: loc.argsort(0),
                                  [None], flat._split)
        axis = self._one_axis(axis)
        return self._on_whole([axis], lambda loc: loc.argsort(axis),
                              [None if a == axis else a
                               for a in range(self.ndim)], self._split)

    @_one_rank_local
    def sort(self, axis=-1, kind=None):
        """Sort along ``axis`` in place and return ``None``: each box,
        made whole along ``axis``, sorts, and this array adopts the
        result laid out by ``key_spec``."""
        from bolt_tpu_torch.gpu.methods import _check_sort_kind
        _check_sort_kind(kind)
        axis = self._one_axis(axis)

        def run(loc):
            loc.sort(axis)
            return loc
        out = self._on_whole([axis], run, [None if a == axis else a
                                           for a in range(self.ndim)],
                             self._split)
        self._local, self._spec = out._local, out._spec
        self._stat_group = None
        return None

    @_one_rank_local
    def take(self, indices, axis=None, mode="raise"):
        """Elements by index: the records move from their holders to the
        boxes of the result by one all_to_all (``sharding.route``)."""
        from bolt_tpu_torch.gpu.methods import _take_split
        wrapped, axis = self._take_indices(indices, axis, mode)
        ids = wrapped.reshape(-1).astype(np.int64)
        if axis is None:
            flat = self.ravel()
            return flat._routed([ids], flat._split)._reshaped(
                wrapped.shape, 1 if self._split and wrapped.ndim else 0)
        index = [np.arange(d) for d in self.shape]
        index[axis] = ids
        split = _take_split(self._split, axis, wrapped.ndim)
        if wrapped.ndim == 1:
            return self._routed(index, split)
        shape = self.shape[:axis] + wrapped.shape + self.shape[axis + 1:]
        return self._routed(index, self._split)._reshaped(shape, split)

    def _routed(self, index, split, out_spec=None):
        """``self[ix_(*index)]`` with ``split`` key axes, laid out by
        ``key_spec`` (or ``out_spec``) by one all_to_all."""
        shape = tuple(len(i) for i in index)
        spec = out_spec or sharding.key_spec(self._mesh, shape, split)
        local = self._data
        _check_move("gather", self._mesh, shape, spec, local)
        t = sharding.route(local, self._mesh, self.shape, self._spec, index,
                           spec)
        return BoltArrayMesh.wrap(t, self._mesh, shape, split, spec)

    @_one_rank_local
    def repeat(self, repeats, axis=None):
        """Repeat elements: each output position names its source index,
        and the records move by one all_to_all."""
        rep, axis = self._repeats(repeats, axis)
        if axis is None:
            flat = self.ravel()
            return flat.repeat(rep, axis=0)
        index = [np.arange(d) for d in self.shape]
        index[axis] = np.repeat(np.arange(self.shape[axis]), rep)
        return self._routed(index, self._split)

    @_one_rank_local
    def ravel(self, order="C"):
        """Flatten to 1-d (one flat key axis): a reshape that moves the
        boxes to contiguous blocks of the flat order first; ``F``
        flattens the transpose, moved in the same exchange."""
        if order not in ("C", "F", "A", "K"):
            raise ValueError("order must be one of 'C', 'F', 'A', or 'K' "
                             "(got %r)" % (order,))
        perm = tuple(reversed(range(self.ndim))) if order == "F" else None
        return self._reshaped((self.size,), 1 if self._split else 0, perm)

    def _reshaped(self, shape, split, perm=None):
        """This array (transposed by ``perm``) reshaped in C order: the
        boxes move to blocks of the flat order (the first axis of length
        above one split over the mesh axes whose product divides it in
        both shapes), reshape on each rank, and the result moves to
        ``key_spec``."""
        src_shape = self.shape if perm is None else tuple(
            self.shape[p] for p in perm)
        shape = tuple(int(d) for d in shape)
        lead_in = next((i for i, d in enumerate(src_shape) if d > 1), None)
        lead_out = next((i for i, d in enumerate(shape) if d > 1), None)
        names, ways = [], 1
        if lead_in is not None and lead_out is not None:
            for n in self._mesh.axis_names:
                w = ways * self._mesh.shape[n]
                if self._mesh.shape[n] > 1 and src_shape[lead_in] % w == 0 \
                        and shape[lead_out] % w == 0:
                    names.append(n)
                    ways = w
        entry = None if not names else names[0] if len(names) == 1 \
            else tuple(names)
        spec_in = [None] * len(src_shape)
        spec_out = [None] * len(shape)
        if entry is not None:
            spec_in[lead_in] = entry
            spec_out[lead_out] = entry
        spec_in = tuple(spec_in)
        src = self if perm is None and spec_in == self._spec else \
            self._relaid(spec_in, perm=perm)
        local = sharding.box_shape(sharding.box(self._mesh, spec_out, shape))
        return self._result(src._data.reshape(local), shape, split, spec_out)

    @_one_rank_local
    def _reshape_with_split(self, shape, new_split):
        shape = tuple(shape)
        if prod(shape[:new_split]) != prod(self.shape[:self._split]):
            raise ValueError(
                "new key shape %s does not match key size %d"
                % (str(shape[:new_split]), prod(self.shape[:self._split])))
        if shape == self.shape and new_split == self._split:
            return self
        return self._reshaped(shape, new_split)

    @_one_rank_local
    def squeeze(self, axis=None):
        """Drop axes of length one (never sharded): each box reshapes."""
        if axis is None:
            axes = tuple(i for i, s in enumerate(self.shape) if s == 1)
        else:
            axes = tupleize(axis)
            inshape(self.shape, axes)
            for a in axes:
                if self.shape[a] != 1:
                    raise ValueError("cannot squeeze axis %d of size %d"
                                     % (a, self.shape[a]))
        shape = tuple(s for i, s in enumerate(self.shape) if i not in axes)
        if shape == self.shape:
            return self
        split = self._split - sum(1 for a in axes if a < self._split)
        spec = tuple(e for i, e in enumerate(self._spec) if i not in axes)
        local = sharding.box_shape(sharding.box(self._mesh, spec, shape))
        return self._result(self._data.reshape(local), shape, split, spec)

    @_one_rank_local
    def transpose(self, *axes):
        """Permute axes within the keys and within the values: the boxes
        move to ``key_spec`` of the transpose in one exchange."""
        axes = self._transpose_axes(axes)
        if axes == tuple(range(self.ndim)):
            return self
        shape = tuple(self.shape[a] for a in axes)
        return self._relaid(sharding.key_spec(self._mesh, shape,
                                              self._split), perm=axes)

    @_one_rank_local
    def diagonal(self, offset=0, axis1=0, axis2=1):
        """The diagonals of the (``axis1``, ``axis2``) planes, on a
        layout where both axes are whole."""
        axis1, axis2 = self._diag_axes(axis1, axis2)
        rest = [a for a in range(self.ndim) if a not in (axis1, axis2)]
        return self._on_whole(
            [axis1, axis2], lambda loc: loc.diagonal(offset, axis1, axis2),
            rest + [None], self._diag_split(axis1, axis2))

    @_one_rank_local
    def trace(self, offset=0, axis1=0, axis2=1, dtype=None):
        """Sums of the (``axis1``, ``axis2``) diagonals, on a layout
        where both axes are whole."""
        axis1, axis2 = self._diag_axes(axis1, axis2)
        rest = [a for a in range(self.ndim) if a not in (axis1, axis2)]
        return self._on_whole(
            [axis1, axis2], lambda loc: loc.trace(offset, axis1, axis2,
                                                  dtype),
            rest, self._diag_split(axis1, axis2))

    @_one_rank_local
    def nonzero(self):
        """Indices of the non-zero elements (host int64 arrays, C order):
        each distinct box's hits as global indices, gathered once and
        ordered on the host."""
        mesh = self._mesh
        bx = self.box
        with self._scope():
            hits = torch.nonzero(self.local._mapped())
        glob = hits.to(torch.int64) + torch.tensor(
            [lo for lo, _ in bx], dtype=torch.int64, device=hits.device)
        every = multihost.all_gather(glob, mesh.group(mesh.axis_names))
        held = sharding._holders(sharding.boxes(mesh, self._spec,
                                                self.shape))
        parts = [every[holders[0]].cpu().numpy() for _, holders in held]
        allh = np.concatenate(parts) if parts else np.zeros((0, self.ndim),
                                                           np.int64)
        allh = allh.reshape(-1, self.ndim)
        order = np.argsort(np.ravel_multi_index(tuple(allh.T), self.shape)
                           if self.ndim else np.zeros(len(allh)),
                           kind="stable")
        allh = allh[order]
        return tuple(np.ascontiguousarray(allh[:, a]).astype(np.int64)
                     for a in range(self.ndim))

    @_one_rank_local
    def searchsorted(self, v, side="left", sorter=None):
        """Insertion points into this sorted 1-d array (host indices):
        the array whole on every rank, as the result is."""
        if isinstance(v, BoltArrayGPU):
            check_mesh(self, v, "searchsorted")
            if isinstance(v, BoltArrayMesh):
                v = v.toarray()
        if self.ndim != 1:
            raise ValueError("object too deep for desired array")
        whole = BoltArrayGPU(self._whole_tensor(), self._split, self._device)
        return whole.searchsorted(v, side=side, sorter=sorter)

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------

    @_one_rank_local
    def __getitem__(self, index):
        """Ints, slices, lists and int or bool arrays per axis
        (orthogonal, as the reference): each rank gathers its box of the
        result from the holders of its records, by one all_to_all
        (``sharding.route``)."""
        from bolt_tpu_torch.utils import normalize_index
        norm, squeezed = normalize_index(index, self.shape)
        index = [np.arange(d)[s] if isinstance(s, slice) else
                 np.asarray(s, dtype=np.int64).reshape(-1)
                 for s, d in zip(norm, self.shape)]
        shape = tuple(len(i) for a, i in enumerate(index)
                      if a not in squeezed)
        split = self._split - sum(1 for a in squeezed if a < self._split)
        spec = sharding.key_spec(self._mesh, shape, split)
        inner = list(spec)
        for a in sorted(squeezed):
            inner.insert(a, None)
        out = self._routed(index, self._split, tuple(inner))
        local = sharding.box_shape(sharding.box(self._mesh, spec, shape))
        return BoltArrayMesh.wrap(out._local._data.reshape(local),
                                  self._mesh, shape, split, spec)

    @_one_rank_local
    def set(self, index, value):
        """Functional indexed update: each rank writes the part of the
        region inside its box, from its part of the broadcast value."""
        from bolt_tpu_torch.utils import normalize_index
        norm, squeezed = normalize_index(index, self.shape)
        region = [np.arange(d)[s] if isinstance(s, slice) else
                  np.asarray(s, dtype=np.int64).reshape(-1)
                  for s, d in zip(norm, self.shape)]
        rshape = tuple(len(r) for a, r in enumerate(region)
                       if a not in squeezed)
        if isinstance(value, BoltArrayGPU):
            check_mesh(self, value, "set")
            val = value._whole_tensor() if isinstance(value, BoltArrayMesh) \
                else value._data.to(self._device)
        else:
            val = torch.as_tensor(np.asarray(value), device=self._device)
        while val.ndim > len(rshape) and val.shape[0] == 1:
            val = val.reshape(val.shape[1:])
        try:
            val = val.broadcast_to(rshape)
        except RuntimeError as exc:
            raise ValueError("could not broadcast the value into the "
                             "region: %s" % exc) from None
        bx = self.box
        put, take = [], []
        for a, (r, (lo, hi)) in enumerate(zip(region, bx)):
            p = np.nonzero((r >= lo) & (r < hi))[0]
            put.append(r[p] - lo)
            if a not in squeezed:
                take.append(p)
        with self._scope():
            out = self.local._mapped().clone()
        if all(len(p) for p in put):
            part = sharding._take(val, take).reshape(
                tuple(len(p) for p in put))
            sharding._put(out, put, part)
        return self._result(out, self.shape, self._split, self._spec)

    @_one_rank_local
    def item(self, *args):
        """One element as a Python scalar: its first holder reads it and
        broadcasts it to every rank."""
        multi = self._item_index(args)
        mesh = self._mesh
        src = next(r for r in range(mesh.size) if all(
            lo <= i < hi for i, (lo, hi) in
            zip(multi, sharding.box(mesh, self._spec, self.shape, r))))
        dt = torch_dtype(self.dtype)
        if mesh.rank == src:
            bx = self.box
            with self._scope():
                t = self.local._mapped()[tuple(
                    i - lo for i, (lo, _) in zip(multi, bx))].reshape(1).to(dt)
        else:
            t = torch.empty(1, dtype=dt, device="meta")
        return multihost.broadcast(t, src).cpu()[0].item()

    @_one_rank_local
    def first(self):
        """The value block at the first key tuple: the holder of record 0
        applies the chain to that one record and broadcasts it."""
        split = self._split
        if any(e is not None for e in self._spec[split:]):
            return self[(0,) * split].toarray()
        mesh = self._mesh
        src = next(r for r in range(mesh.size) if all(
            lo == 0 for lo, _ in
            sharding.box(mesh, self._spec, self.shape, r)[:split]))
        dt = torch_dtype(self.dtype)
        if mesh.rank == src:
            with self._scope():
                t = torch.from_numpy(np.ascontiguousarray(
                    self.local.first())).to(self._device, dt)
        else:
            t = torch.empty(self.shape[split:], dtype=dt, device="meta")
        return _download(multihost.broadcast(t, src))

    # ------------------------------------------------------------------
    # exits
    # ------------------------------------------------------------------

    @_one_rank_local
    def iter_shards(self):
        """``(index, block)`` of every shard this process holds (the
        reference's "every shard THIS process can address"): this rank's
        box."""
        yield (sharding.box_slices(self.box), _download(self._data))

    @_one_rank_local
    def togpu(self, context=None, axis=(0,)):
        """This array on its own mesh; elsewhere, the whole array moved
        (``BoltArray.togpu``)."""
        if context is None or context == self._mesh:
            return self
        return BoltArray.togpu(self, context=context, axis=axis)

    # ------------------------------------------------------------------
    # numpy's function table, and the internals only it reaches
    # ------------------------------------------------------------------

    def __array_function__(self, func, types, args, kwargs):
        """numpy's non-ufunc functions on the mesh (reference:
        ``BoltArrayTPU.__array_function__``): a one-rank mesh takes the
        single device's table on its box; on more ranks the table's
        handlers reach the mesh methods and the mesh form of
        ``npdispatch._device_fused`` (an operand on another mesh raises
        the reference's ``different meshes`` error).  A function outside
        the table, or a call the reference sends to the host, gathers
        every operand through ``__array__`` on every rank."""
        from bolt_tpu_torch.gpu import npdispatch
        return npdispatch.dispatch(func, types, args, kwargs)

    @_one_rank_local
    def _mapped(self):
        """Refused on several ranks: a caller reads this rank's box
        (``self.local._mapped()``), a relayout (``_whole(axes)``) or the
        whole array by name (``_whole_tensor()``)."""
        raise TypeError(_NO_FORM % "_mapped")

    @_one_rank_local
    def _chain_parts(self):
        """Refused on several ranks, as :meth:`_mapped` is."""
        raise TypeError(_NO_FORM % "_chain_parts")

    @_one_rank_local
    def _materialise(self):
        """Materialise this rank's box (its deferred chain)."""
        self._data

    @_one_rank_local
    def _resolve_filter(self):
        """Lay out a pending filter's survivors (``_resolve_mfilter``)."""
        self._ready()

    @_one_rank_local
    def _fused_filter_stat(self, axis, name, keepdims, ddof):
        """The masked terminal of a pending filter: each rank's partial
        folded in rank order (``multistat.mesh_filter_stats``), or
        NotImplemented for a geometry it does not serve."""
        from bolt_tpu_torch.gpu import multistat
        if self._mfilter is None:
            return NotImplemented
        out = multistat.mesh_filter_stats(self, [(name, axis, keepdims,
                                                  ddof)])
        return out if out is NotImplemented else out[0]

    @_one_rank_local
    def _fused_filter_reduce(self, func, axis, keepdims):
        """NotImplemented: a mesh ``reduce`` lays the survivors out first
        and folds the ranks' trees."""
        return NotImplemented

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


# the methods inherited as they stand (they read only the global shape,
# or go through the methods above)
_INHERITED = {"chunk", "mean", "var", "std", "ptp", "sum", "max", "min",
              "prod", "all", "any", "swap", "cache", "keys", "values",
              "ndim", "size", "mode", "dtype", "split", "device", "mesh",
              "__len__", "_align", "_guard_donated", "_constructor"}

def _guarded(name, attr):
    """The inherited ``attr`` on the mesh: a one-rank mesh runs it on its
    box (the single-device path); on more ranks it runs as inherited,
    through the mesh's own methods."""
    if isinstance(attr, property):
        def fget(self):
            if self._multi():
                return attr.fget(self)
            return getattr(self.local, name)
        return property(fget)

    def method(self, *args, **kwargs):
        if self._multi():
            return attr(self, *args, **kwargs)
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
                    name != "_unary":
                continue
            setattr(BoltArrayMesh, name, _guarded(name, attr))
            own.add(name)


_install_guards()
