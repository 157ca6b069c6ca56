"""Fused stat groups: lazy stat terminals, ``compute`` and the fluent
``stats("sum", ...)``.

Port of ``bolt_tpu/tpu/multistat.py``.  A ``sum``/``mean``/``var``/...
terminal of a gpu array returns at once an array holding a
:class:`PendingStat`, a member of the :class:`_StatGroup` of its source;
later terminals of the same source join the group, and the first read of
any member (or :func:`compute`) resolves every member together::

    s, v, lo, hi = bolt.compute(a.sum(), a.var(), a.min(), a.max())

What stays at the call is what the reference keeps there: axis
validation, the zero-size ``min``/``max``/``ptp`` error, and a filter's
``min``/``max`` (eager, for that error).  Every member equals its
standalone terminal bit for bit:

* a lone member resolves through the standalone terminal itself (a
  compiled chain's ``sum`` launches ``fused_map_reduce`` from the base);
* a ``chain`` group (a deferred map chain or a concrete base) applies the
  chain at most once, and reduces every slot as the terminals do
  (``gpu/array.py :: _chain_stats``: whole within one block of records,
  else each block's partials folded in block order); a ``sum`` the chain
  compiles for still takes ``fused_map_reduce`` from the base, as its
  standalone does; ``ptp`` is its group's ``max - min`` pair;
* an ``fpending`` group (a pending filter) runs the chain and predicate
  over blocks once and folds that mask into every member
  (``gpu/array.py :: _filter_stats``);
* a ``stream`` group (a lazy out-of-core source) streams the source once
  for every member (``stream.execute(terminal="multi")``): one ingest
  pass feeds a tuple of components, the ``(n, mu, M2)`` moments shared
  by every mean/var/std member; a lone ``sum``/``mean``/``var``/``std``/
  ``min``/``max`` member runs its standalone streamed terminal.
  ``prod``/``all``/``any`` have no streamed fold and materialise, as do
  ``min``/``max``/``ptp`` under a streamed filter.

Each group resolves through one engine program (``_cached_jit``: family
``"stat"`` for a lone member, ``"multi-stat"``, ``"filter-stat"`` and
``"multi-filter-stat"`` otherwise).  A group whose source is sole-owned
takes it as the reference's groups do: the first terminal's call consumes
the source (later reads of it raise), siblings still join the group, and
the group drops the base when it resolves.

The serve layer's micro-batching (``gpu/batched.py``) CLAIMS chain groups
for one batched dispatch: while a group is claimed, a new terminal
declines to join it and a concurrent read waits for the batched fill (or
the unclaim, after which it resolves standalone).  While a batching
server is armed, ``reduce(func)`` over the key axes of a chain defers
too (:func:`defer_reduce`), as a one-member group whose standalone
resolution is the eager terminal's own program.
"""

import sys
import weakref
from collections import OrderedDict

import numpy as np
import torch

from bolt_tpu_torch import _lockdep, _precision, engine
from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.gpu import dtypes, ufuncs
from bolt_tpu_torch.gpu.dtypes import torch_dtype
from bolt_tpu_torch.utils import prod, tupleize

# the terminals that defer (everything _stat serves)
LAZY_NAMES = ("sum", "mean", "var", "std", "min", "max", "prod", "all",
              "any", "ptp")

# a pending filter's lazy terminals: min/max keep their zero-size error
# at the call, ptp resolves the filter
_FPENDING_LAZY = ("sum", "prod", "any", "all", "mean", "var", "std")

# a stream group's terminals: the components its slab program folds
# (prod/all/any have no streamed fold and materialise)
_STREAM_LAZY = ("sum", "mean", "var", "std", "min", "max", "ptp")

# the terminals a reduced-precision accumulation applies to: the float
# modes (bf16, f32) take the additive family of float pipelines, int8 the
# integer sum/prod of integer pipelines; order statistics stay exact
_ADDITIVE = ("sum", "prod", "mean", "var", "std")
_INT_ADDITIVE = ("sum", "prod")


class PendingStat:
    """One lazy stat terminal: its spec, its result's shape and dtype,
    and (once its group resolves) the result tensor."""

    __slots__ = ("group", "name", "axes", "keepdims", "ddof", "shape",
                 "dtype", "new_split", "result", "__weakref__")

    def __init__(self, group, name, axes, keepdims, ddof, shape, dtype,
                 new_split):
        self.group = group
        self.name = name
        self.axes = axes
        self.keepdims = bool(keepdims)
        self.ddof = ddof
        self.shape = tuple(shape)
        self.dtype = dtype
        self.new_split = int(new_split)
        self.result = None

    def __repr__(self):
        return "PendingStat(%s, axes=%s%s)" % (
            self.name, self.axes,
            ", resolved" if self.result is not None else "")


def _slot(member):
    """The group results a member needs: ``ptp`` is the max/min pair, so
    its slots are shared with sibling ``max``/``min`` members."""
    if member.name == "ptp":
        return (("max", member.axes, member.keepdims, None),
                ("min", member.axes, member.keepdims, None))
    return ((member.name, member.axes, member.keepdims, member.ddof),)


def _out_shape(shape, axes, keepdims):
    if keepdims:
        return tuple(1 if a in axes else d for a, d in enumerate(shape))
    return tuple(d for a, d in enumerate(shape) if a not in axes)


class _StatGroup:
    """Pending stat terminals sharing one source.

    ``kind``: ``"chain"`` (``base``, ``funcs``, ``split``, the mapped
    ``shape`` and numpy ``dtype``), ``"fpending"`` (the pending filter
    ``fpending`` whose records have numpy ``dtype``) or ``"stream"`` (the
    stream ``source``).

    The group holds its members weakly (a member holds its group), so no
    reference cycle keeps a source alive, and a resolved group drops its
    source: a 10 GB base is freed with the last array that needs it."""

    def __init__(self, kind, split, shape, dtype, base=None, funcs=(),
                 fpending=None, device=None, donate=False, source=None):
        self.kind = kind
        self.source = source
        self.split = split
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.base = base
        self.funcs = funcs
        self.fpending = fpending
        self.device = device
        self.donate = donate
        self.members = []
        self.dispatched = False
        self.lock = _lockdep.lock("multistat.group")
        # a deferred reduce(func) (defer_reduce): the group's one member
        # is the reduce tree, which no stat member can share
        self.rfunc = None
        # the serve batched dispatch's claim (gpu/batched.py): while
        # claimed, resolve() waits on claim_event instead of dispatching
        # and try_join declines (a new member could never ride the batch)
        self.claimed = False
        self.claim_event = None

    def live_members(self):
        """The members still referenced."""
        return [m for m in (r() for r in self.members) if m is not None]

    def try_join(self, axis, name, keepdims, ddof):
        """A new member for ``name`` over ``axis``, or NotImplemented when
        the spec cannot ride this group (the caller takes the eager
        path), or when the group resolved or was claimed meanwhile."""
        if self.rfunc is not None:
            return NotImplemented
        if self.kind == "stream":
            h = self._stream_member(name, axis, keepdims, ddof)
        elif self.kind == "fpending":
            h = self._fpending_member(name, axis, keepdims, ddof)
        else:
            h = self._chain_member(name, axis, keepdims, ddof)
        if h is NotImplemented:
            return h
        with self.lock:
            if self.dispatched or self.claimed:
                # a concurrent reader resolved the group (or a serve
                # batched dispatch claimed it) between the caller's check
                # and this append: the member would never be filled
                return NotImplemented
            self.members.append(weakref.ref(h))
        return h

    def _chain_member(self, name, axis, keepdims, ddof):
        from bolt_tpu_torch.gpu.array import stat_axes, stat_split
        axes = stat_axes(self.shape, self.split, axis)
        if name in ("min", "max", "ptp") and \
                prod([self.shape[a] for a in axes]) == 0:
            return NotImplemented          # the eager zero-size error
        return self._member(name, axes, keepdims, ddof, self.shape,
                            stat_split(self.split, axes, keepdims))

    def _fpending_member(self, name, axis, keepdims, ddof):
        from bolt_tpu_torch.gpu.array import filter_axes
        vshape, n = self.fpending[4], self.fpending[5]
        axes = filter_axes(vshape, self.dtype, axis, name)
        if name not in _FPENDING_LAZY or axes is NotImplemented:
            return NotImplemented
        # the survivor count is unknown, but the key axis is reduced: the
        # result's shape is known without it
        return self._member(name, axes, keepdims, ddof,
                            (n,) + tuple(vshape), 1 if keepdims else 0)

    def _stream_member(self, name, axis, keepdims, ddof):
        from bolt_tpu_torch import stream
        st = stream.result_state(self.source)
        if name not in _STREAM_LAZY or keepdims or st.n == 0:
            return NotImplemented
        if axis is not None and tuple(sorted(tupleize(axis))) \
                != tuple(range(st.split)):
            return NotImplemented
        if st.pred is not None and name in ("min", "max", "ptp"):
            # no survivor needs the materialised error contract
            return NotImplemented
        if name in ("mean", "var", "std") and np.issubdtype(
                st.dtype, np.complexfloating):
            return NotImplemented
        return self._member(name, tuple(range(st.split)), False, ddof,
                            (st.n,) + tuple(st.vshape), 0)

    def _member(self, name, axes, keepdims, ddof, shape, new_split):
        from bolt_tpu_torch.gpu.array import numpy_dtype
        dtype = numpy_dtype(dtypes.stat_dtype(name, torch_dtype(self.dtype)))
        return PendingStat(self, name, axes, keepdims, ddof,
                           _out_shape(shape, axes, keepdims), dtype,
                           new_split)

    def resolve(self, accumulate=None):
        """Compute every member's result.  Idempotent and thread-safe;
        ``accumulate`` is the per-call reduced-precision mode of
        :func:`compute` (a deferred ``reduce`` ignores it and runs exact,
        as the eager terminal does).  While a serve batched dispatch holds
        the group's claim, a reader waits for the batched fill, or for
        the unclaim and then resolves standalone.  Under
        ``analysis.strict()`` the group is checked first, through one of
        its pending members."""
        if engine.strict_guarded():
            pend = [m for m in self.live_members() if m.result is None]
            if pend and not self.dispatched:
                engine.strict_guard(_wrap_handle(pend[0], self.device),
                                    "compute()")
        while True:
            with self.lock:
                if self.dispatched:
                    return
                ev = self.claim_event if self.claimed else None
                if ev is None:
                    self._resolve_locked(accumulate)
                    return
            # claimed on a serve worker: wait for the fill or the unclaim
            # and check again (the timeout only bounds a claim owner that
            # died without its unclaim)
            ev.wait(1.0)

    def _resolve_locked(self, accumulate):
        mode = _precision.resolve_accumulate(accumulate)
        if self.rfunc is not None:
            mode = None
        elif mode is not None and self.kind != "chain":
            if accumulate is not None:
                raise ValueError(
                    "accumulate=%r applies to in-memory fused "
                    "reductions only; this group %s and runs exact"
                    % (accumulate, "streams" if self.kind == "stream"
                       else "filters"))
            mode = None                  # an ambient scope: exact
        members = self.live_members()
        if self.rfunc is not None:
            self._resolve_reduce(members)
        elif self.kind == "chain":
            self._resolve_chain(members, mode)
        elif self.kind == "stream":
            self._resolve_stream(members)
        else:
            self._resolve_fpending(members)
        self.retire()

    def retire(self):
        """Mark the group resolved and drop its source (under the
        lock)."""
        self.dispatched = True
        self.claimed = False
        self.members = []
        self.base = self.fpending = self.source = None
        self.funcs = ()

    def _resolve_reduce(self, members):
        """A deferred ``reduce(func)`` read alone: the eager terminal's own
        program (the same engine key: the door refuses donating
        chains)."""
        from bolt_tpu_torch.gpu.array import _reduce_program
        if not members:
            return
        m = members[0]
        func, base, funcs, split = self.rfunc, self.base, self.funcs, \
            self.split
        n = prod(self.shape[:split])
        vshape = self.shape[split:]
        keepdims = m.keepdims
        fn = _cached_jit(("reduce", func, funcs, tuple(base.shape),
                          str(base.dtype), split, keepdims, False,
                          self.device),
                         lambda: _reduce_program(func, funcs, split, n,
                                                 vshape, keepdims))
        with _obs.span("array.reduce", funcs=len(funcs), donate=False):
            m.result = fn(base)

    def _resolve_chain(self, members, mode):
        from bolt_tpu_torch.gpu.array import _stat_program
        base, funcs, split = self.base, self.funcs, self.split
        donate = self.donate
        if len(members) == 1 and mode is None:
            # the standalone terminal itself (the same engine entry)
            m = members[0]
            fn = _stat_program(m.name, funcs, base, split, self.shape,
                               self.dtype, m.axes, m.keepdims, m.ddof,
                               donate, self.device)
            with _obs.span("array.stat", op=m.name, funcs=len(funcs),
                           donate=donate):
                m.result = fn(base)
            return
        slots = tuple(sorted({s for m in members for s in _slot(m)},
                             key=repr))
        shape, dtype = self.shape, self.dtype
        fn = _cached_jit(("multi-stat", slots, funcs, tuple(base.shape),
                          str(base.dtype), split, donate, mode, self.device),
                         lambda: _chain_group_program(funcs, split, shape,
                                                      dtype, slots, mode))
        with _obs.span("array.multi_stat", terminals=len(members),
                       slots=len(slots), funcs=len(funcs), donate=donate,
                       accumulate=mode or "exact"):
            out = dict(zip(slots, fn(base)))
        if len(members) > 1:
            engine.record_fused_stats(len(members))
        for m in members:
            if m.name == "ptp":
                mx, mn = (out[s] for s in _slot(m))
                m.result = ufuncs.binary("subtract", mx, mn)
            else:
                m.result = out[_slot(m)[0]]
            if mode is not None and m.name in _ADDITIVE and \
                    m.result.dtype in (torch.float32, torch.int32):
                # a reduced-precision member is in its accumulator's dtype
                from bolt_tpu_torch.gpu.array import numpy_dtype
                m.dtype = numpy_dtype(m.result.dtype)

    def _resolve_stream(self, members):
        """One streamed pass for every member: a lone member through its
        standalone streamed terminal, a group through the executor's
        multi-stat fold."""
        from bolt_tpu_torch import stream
        if len(members) == 1 and members[0].name in stream._STAT_NAMES:
            m = members[0]
            m.result = stream.execute(None, m.name, ddof=m.ddof,
                                      source=self.source)._data
            return
        outs = stream.execute(None, "multi", source=self.source,
                              specs=tuple((m.name, m.ddof)
                                          for m in members))
        if len(members) > 1:
            engine.record_fused_stats(len(members))
        for m, out in zip(members, outs):
            m.result = out

    def _resolve_fpending(self, members):
        from bolt_tpu_torch.gpu.array import _filter_stats
        slots = tuple(sorted({s for m in members for s in _slot(m)},
                             key=repr))
        base = self.fpending[0]
        geom = tuple(self.fpending[1:])
        dtype, donate = self.dtype, self.donate

        def build():
            def run(data):
                return _filter_stats((data,) + geom, dtype, slots)
            return run

        lone = len(members) == 1
        fn = _cached_jit(("filter-stat" if lone else "multi-filter-stat",
                          slots, geom[1], geom[0], tuple(base.shape),
                          str(base.dtype), geom[2], donate, self.device),
                         build)
        with _obs.span("array.multi_stat", terminals=len(members),
                       slots=len(slots), filtered=True, donate=donate):
            out = dict(zip(slots, fn(base)))
        if len(members) > 1:
            engine.record_fused_stats(len(members))
        for m in members:
            m.result = out[_slot(m)[0]]


def _cached_jit(key, builder):
    """Keyed program dispatch through the engine (patched per module by
    ``bolt_tpu_torch.profile.instrument``)."""
    return engine.get(key, builder)


def _chain_group_program(funcs, split, shape, dtype, slots, mode):
    """The program of a chain group's ``slots``: a compiled ``sum`` reads
    the base through ``fused_map_reduce``, as its standalone terminal
    does, and the other slots share one application of the chain; under
    a reduced-precision ``mode`` every slot reduces one mapped tensor."""
    from bolt_tpu_torch.gpu.array import _chain_group_lanes, _chain_values

    def run(base):
        if mode is None:
            return _chain_group_lanes([base], funcs, split, shape, dtype,
                                      slots)[0]
        mapped = _chain_values(base, funcs, split, shape, dtype)
        out = tuple(_accumulated(mapped, *slot, mode, dtype)
                    for slot in slots)
        del mapped
        return out
    return run


def _accumulated(mapped, name, axes, keepdims, ddof, mode, dtype):
    """One slot under the reduced-precision ``mode``: the additive
    terminals of float pipelines on bf16 values accumulated in f32
    (``bf16``) or on f32 values (``f32``), integer sum/prod on int8 values
    with an int32 accumulator (``int8``); anything else exact."""
    from bolt_tpu_torch.gpu.array import _reduce_stat
    dims = tuple(axes)
    fl = mapped.dtype.is_floating_point
    if mode == "int8" and name in _INT_ADDITIVE and not fl and \
            mapped.dtype != torch.bool:
        v = mapped.to(torch.int8)
        if name == "sum":
            return torch.sum(v, dim=dims, keepdim=keepdims,
                             dtype=torch.int32)
        out = v.to(torch.int32)
        for d in sorted(dims, reverse=True):
            out = torch.prod(out, dim=d, keepdim=keepdims)
        return out
    if mode in ("bf16", "f32") and name in _ADDITIVE and fl:
        v = mapped.to(torch.bfloat16) if mode == "bf16" else mapped
        v = v.to(torch.float32)
        return _reduce_stat(v, name, axes, keepdims, ddof, np.float32)
    return _reduce_stat(mapped, name, axes, keepdims, ddof, dtype)


def defer_stat(arr, axis, name, keepdims, ddof):
    """The lazy door of ``BoltArrayGPU._stat``: a pending result array of
    ``arr``'s ``name`` terminal, joined to (or starting) the group of its
    source; NotImplemented when the terminal takes the eager path (a
    name that does not defer, a donated array, a geometry a group does
    not serve).  A stream's pending swap resolves before its group
    forms."""
    if name not in LAZY_NAMES:
        return NotImplemented
    g = arr._stat_group
    if g is not None and (g.dispatched or (not arr._donated and (
            (g.kind == "stream" and arr._stream is None)
            or (g.kind == "fpending" and arr._fpending is None)
            or (g.kind == "chain" and g.funcs and arr._chain is None)))):
        # resolved, or the source materialised since the group formed:
        # new terminals reduce the concrete data, not the recorded chain
        g = arr._stat_group = None
    if g is not None:
        # a source the group consumed still serves its siblings
        h = g.try_join(axis, name, keepdims, ddof)
        return NotImplemented if h is NotImplemented else _wrap(arr, h)
    if arr._donated:
        return NotImplemented            # the eager path raises the guard
    from bolt_tpu_torch.gpu.array import _chain_donate_ok
    if arr._stream is not None:
        from bolt_tpu_torch import stream
        if stream.has_swap(arr._stream):
            stream._swap_resolved(arr)
    if arr._stream is not None:
        st = stream.result_state(arr._stream)
        g = _StatGroup("stream", st.split, (), st.dtype,
                       device=arr.device, source=arr._stream)
    elif arr._fpending is not None:
        donate = _chain_donate_ok(arr._fpending)     # [0] is the base
        g = _StatGroup("fpending", 1, (), arr.dtype,
                       fpending=arr._fpending, device=arr.device,
                       donate=donate)
    else:
        # checked before the base local exists
        donate = arr.deferred and _chain_donate_ok(arr._chain)
        base, funcs = arr._chain_parts()
        g = _StatGroup("chain", arr._split, arr.shape, arr.dtype,
                       base=base, funcs=funcs, device=arr.device,
                       donate=donate)
        del base
    h = g.try_join(axis, name, keepdims, ddof)
    if h is NotImplemented:
        return h
    arr._stat_group = g
    if g.donate:
        # one donation serves every member: the first terminal consumes
        # the source, siblings join this group
        arr._consume_donated("%s()" % name if g.kind == "chain"
                             else "filter().%s()" % name)
    return _wrap(arr, h)


def defer_reduce(arr, func, axes, keepdims):
    """The lazy door of ``reduce(func)``, open only while a batching
    server is armed (``gpu/batched.py :: armed``): a reduce over every key
    axis of a chain or a concrete array defers as a one-member group, so
    the serve scheduler can coalesce same-shape requests into one batched
    dispatch; read alone it runs the eager terminal's own program, so its
    result and its engine entry are the eager ones.  NotImplemented (the
    eager path) when the door is shut or the geometry does not fit: other
    axes, streams, filters, pending stats, donating chains, a reducer
    ``vmap`` cannot trace, or one whose value leaves the record shape
    (the eager call raises then)."""
    bt = sys.modules.get("bolt_tpu_torch.gpu.batched")
    if bt is None or not bt.armed():
        return NotImplemented
    if (arr._donated or arr._stream is not None
            or arr._fpending is not None or arr._spending is not None
            or arr._stat_group is not None):
        return NotImplemented
    split = arr._split
    if split == 0 or tuple(axes) != tuple(range(split)):
        return NotImplemented
    shape = tuple(arr._shape)
    if prod(shape[:split]) == 0:
        return NotImplemented          # the eager empty-reduce raise
    vshape = shape[split:]
    from bolt_tpu_torch.gpu.array import (_chain_donate_ok, _check_reducer,
                                          numpy_dtype)
    try:
        oshape, odtype = _check_reducer(func, vshape, torch_dtype(arr.dtype))
        odtype = numpy_dtype(odtype)
    except Exception:
        return NotImplemented          # the eager path raises or falls back
    if oshape != tuple(vshape):
        return NotImplemented          # the eager call-time ValueError
    if arr.deferred and _chain_donate_ok(arr._chain):
        return NotImplemented          # the donating eager terminal
    base, funcs = arr._chain_parts()
    g = _StatGroup("chain", split, shape, arr.dtype, base=base,
                   funcs=funcs, device=arr.device)
    del base
    g.rfunc = func
    m = PendingStat(g, "reduce", tuple(axes), keepdims, None,
                    ((1,) * split + tuple(vshape)) if keepdims
                    else tuple(vshape), odtype, split if keepdims else 0)
    g.members.append(weakref.ref(m))
    return _wrap(arr, m)


def _wrap(arr, handle):
    return _wrap_handle(handle, arr.device)


def _wrap_handle(handle, device):
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    out = BoltArrayGPU(None, handle.new_split, device)
    out._spending = handle
    out._shape = handle.shape
    out._dtype = handle.dtype
    return out


def compute(*stats, accumulate=None):
    """Resolve pending statistics with as few passes as possible::

        s, v, lo, hi = bolt.compute(a.sum(), a.var(), a.min(), a.max())

    Members of one group (one deferred chain, one concrete array or one
    pending filter) resolve together, from one application of the chain
    or one mask pass, each equal to its standalone terminal bit for bit.
    Anything already concrete (any backend, a number) passes through.
    Returns the inputs in order (a single input comes back bare).

    ``accumulate`` opts a chain group's additive terminals into reduced
    precision: ``"bf16"`` (bf16 values, f32 accumulation), ``"f32"`` or
    ``"int8"`` (an integer pipeline's sum/prod on int8 values, int32
    accumulation); ``None``, the default, is exact.  See
    :func:`bolt_tpu_torch.accumulate` for the scoped form."""
    if not stats:
        raise TypeError("compute() needs at least one statistic")
    seen, groups = set(), []
    for s in stats:
        h = getattr(s, "_spending", None)
        if h is not None and h.result is None and id(h.group) not in seen:
            seen.add(id(h.group))
            groups.append(h.group)
    for g in groups:
        g.resolve(accumulate)
    if accumulate is not None and not groups:
        _precision._check_accumulate(accumulate)
    return stats[0] if len(stats) == 1 else tuple(stats)


def fluent_stats(arr, names, axis=None, accumulate=None):
    """``a.stats("sum", "var", "min")``: one pending terminal per name
    (each exactly the standalone method's spec), resolved together by
    :func:`compute`, as an ordered ``{name: array}`` dict."""
    for n in names:
        if n not in LAZY_NAMES:
            raise ValueError("unknown statistic %r; choose from %s"
                             % (n, ", ".join(LAZY_NAMES)))
    if getattr(arr, "_mesh", None) is not None and arr._stream is None:
        # a mesh array: every member's partial in one exchange (a pod
        # stream's members form its stream group below)
        return OrderedDict(zip(names, mesh_stats(
            arr, [(n, axis, False, None) for n in names])))
    if arr._stream is not None and any(n not in _STREAM_LAZY
                                       for n in names):
        # a name with no streamed fold (prod/all/any) would materialise
        # the source in the middle of the list, consuming a one-shot
        # iterator under its streamed siblings: materialise once, first
        arr.cache()
    handles = [getattr(arr, n)(axis=axis) for n in names]
    compute(*handles, accumulate=accumulate)
    return OrderedDict(zip(names, handles))


# ---------------------------------------------------------------------
# stat groups on a mesh (gpu/mesharray.py): each rank's partial of every
# member, ONE exchange over the mesh axes that shard the reduced axes,
# and the same fold in rank order on every rank
# ---------------------------------------------------------------------

def _mesh_kinds(name, dtype=None):
    """The partials a member ``name`` folds over the mesh: the shared
    ``(count, mean, M2)`` moments of ``var``/``std``, the ``sum`` of
    ``mean`` (divided by the count once folded, as one device divides its
    blocks' sum; a half float's ``mean`` takes the moments, whose
    accumulators are f32), ``ptp``'s ``max`` and ``min``, else its own
    terminal's."""
    if name == "mean" and dtype is not None and torch_dtype(dtype) not in (
            torch.float16, torch.bfloat16):
        return ("sum",)
    if name in ("mean", "var", "std"):
        return ("moments",)
    if name == "ptp":
        return ("max", "min")
    return (name,)


def _mesh_moments(loc, axes):
    """``(count, mean, M2)`` of the box ``loc`` over ``axes``: one
    ``fused_welford`` launch when the axes lead (``gpu/stats.py ::
    _moments``)."""
    from bolt_tpu_torch.gpu.stats import _moments
    mu, m2, _, _ = _moments(loc._mapped(), axes)
    n = prod([loc.shape[a] for a in axes])
    return torch.tensor(n, dtype=torch.int64, device=mu.device), mu, m2


def _mesh_combine(kind, a, b):
    """Two ranks' partials of one ``kind`` as one, as the terminals fold
    their blocks (``gpu/array.py :: _fold_partials``): ``"moments"``
    ``(count, mean, M2)`` by Chan's pairwise combine, ``"sums"`` a tuple
    of sums element by element, a terminal's name by its ``_COMBINE``."""
    from bolt_tpu_torch.gpu.array import _COMBINE, _fold_partials
    if kind == "moments":
        return _fold_partials("var", (int(a[0]), a[1], a[2]),
                              (int(b[0]), b[1], b[2]))
    if kind == "sums":
        return tuple(x + y for x, y in zip(a, b))
    return _COMBINE[kind](a, b)


def mesh_fold(kinds, partials, group):
    """This rank's ``partials`` (one of each of ``kinds``) folded with
    those of every rank of ``group``: ONE exchange, then
    :func:`_mesh_combine` in rank order, so every rank holds the same
    bits.  The one fold of the mesh's stat terminals, stat groups,
    ``stats()`` and masked filter terminals."""
    from bolt_tpu_torch.parallel import multihost
    return multihost.fold_partials(
        tuple(partials), lambda a, b: tuple(
            _mesh_combine(k, x, y) for k, x, y in zip(kinds, a, b)),
        group)


def _mesh_final(name, acc, ddof, dtype, count=None, out_dt=None):
    """The stat ``name`` of its folded partial (numpy ``dtype`` is the
    array's; ``count`` the elements a folded ``mean`` sum holds; the
    result takes ``out_dt``, by default the stat's own dtype)."""
    if out_dt is None:
        out_dt = dtypes.stat_dtype(name, torch_dtype(dtype))
    if name == "mean" and isinstance(acc, torch.Tensor):
        out = acc.to(dtypes.inexact(acc.dtype)) / count
    elif name in ("mean", "var", "std"):
        n, mu, m2 = acc
        if name == "mean":
            out = mu
        else:
            out = m2 / max(0, int(n) - (0 if ddof is None else ddof))
            if name == "std":
                out = torch.sqrt(out)
    elif name == "ptp":
        out = ufuncs.binary("subtract", acc[0], acc[1])
    else:
        out = acc
    return out if out.dtype == out_dt else out.to(out_dt)


def _mesh_result(arr, out, axes, keepdims, split):
    """A mesh array over this rank's result ``out`` (a tensor or a
    single-device array) of a stat over ``axes``: the kept axes keep
    their layout, the reduced ones are whole on every rank, then the
    result moves to ``key_spec``."""
    from bolt_tpu_torch.gpu.array import stat_split
    from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
    shape, spec = arr.shape, arr._spec
    if keepdims:
        oshape = tuple(1 if a in axes else d for a, d in enumerate(shape))
        ospec = tuple(None if a in axes else e for a, e in enumerate(spec))
    else:
        oshape = tuple(d for a, d in enumerate(shape) if a not in axes)
        ospec = tuple(e for a, e in enumerate(spec) if a not in axes)
    new_split = stat_split(split, axes, keepdims)
    if isinstance(out, torch.Tensor):
        from bolt_tpu_torch.parallel import sharding
        local = sharding.box_shape(sharding.box(arr._mesh, ospec, oshape))
        res = BoltArrayMesh.wrap(out.reshape(local), arr._mesh, oshape,
                                 new_split, ospec)
    else:
        res = BoltArrayMesh(out, arr._mesh, oshape, new_split, ospec)
    # laid out by key_spec of its shape and split, as the reference
    # constrains a result (a mesh axis freed by the reduction may now
    # shard a kept axis: each rank keeps part of its box)
    return res._constrained()


def _accumulated_dtype(arr, name, axes, keepdims, ddof, mode):
    """The torch dtype one device's group gives the member ``name`` of
    ``arr`` under the reduced-precision ``mode`` (:func:`_accumulated`
    on a ``meta`` tensor)."""
    from bolt_tpu_torch.gpu.array import numpy_dtype
    dt = torch_dtype(arr.dtype)
    return _accumulated(torch.empty(arr.shape, dtype=dt, device="meta"),
                        name, axes, keepdims, ddof, mode,
                        numpy_dtype(dt)).dtype


def mesh_stats(arr, slots, accumulate=None):
    """The stat terminals ``slots`` (``(name, axis, keepdims, ddof)``) of
    the mesh array ``arr``, in order.  A member whose reduced axes no
    mesh axis shards is this rank's own terminal (on a one-rank mesh,
    the single-device path); the others take each rank's partial
    (:func:`_mesh_kinds`: every handle made before any is read, so the
    rank's box resolves them as ONE group; the moment terminals share
    one :func:`_mesh_moments` for each set of axes), exchange each
    distinct partial once in ONE gather over those mesh axes, and fold
    them in rank order (:func:`mesh_fold`) — the same bits on every
    rank.  ``accumulate``: the rank's group resolves at that reduced
    precision (:func:`compute`), its moments from the group's ``mean``
    and ``var``, and each result takes the dtype one device's group
    gives it."""
    from bolt_tpu_torch.gpu.array import stat_axes
    from bolt_tpu_torch.gpu.mesharray import topology_key
    from bolt_tpu_torch.parallel import sharding
    shape, split, spec = arr.shape, arr._split, arr._spec
    plans = []
    for name, axis, keepdims, ddof in slots:
        if name not in LAZY_NAMES:
            raise ValueError("unknown statistic %r" % (name,))
        axes = stat_axes(shape, split, axis)
        if name in ("max", "min", "ptp") and \
                prod([shape[a] for a in axes]) == 0:
            raise ValueError("zero-size array to reduction operation %s "
                             "which has no identity" % name)
        plans.append((name, axes, keepdims, ddof,
                      sharding.shard_axes(spec, axes)))
    loc = arr._local
    out = [None] * len(plans)
    with engine.topology(topology_key(arr._mesh)):
        # the moments before any handle (a group may consume a sole-owned
        # box), then every partial's handle, each (kind, axes) once: the
        # first read below resolves the rank's whole stat group at once
        moments, handles, groups = {}, {}, {}
        for name, axes, _, _, maxes in plans:
            if maxes and "moments" in _mesh_kinds(name, arr.dtype) and \
                    axes not in moments:
                moments[axes] = _mesh_moments(loc, axes) if \
                    accumulate is None else \
                    (loc._stat(axes, "mean"), loc._stat(axes, "var"))
        for i, (name, axes, keepdims, ddof, maxes) in enumerate(plans):
            if not maxes:
                out[i] = loc._stat(axes, name, keepdims, ddof)
                continue
            groups.setdefault(maxes, []).append(i)
            for kind in _mesh_kinds(name, arr.dtype):
                if kind != "moments" and (kind, axes) not in handles:
                    handles[kind, axes] = loc._stat(axes, kind)
        if accumulate is not None:
            mode = _precision.resolve_accumulate(accumulate)
            compute(*[o for o in out if o is not None],
                    *handles.values(),
                    *[h for pair in moments.values() for h in pair],
                    accumulate=accumulate)
            for axes, (mu, var) in moments.items():
                n = prod([loc.shape[a] for a in axes])
                mu = mu._data
                moments[axes] = (torch.tensor(n, dtype=torch.int64,
                                              device=mu.device), mu,
                                 var._data * n)
        for maxes, items in groups.items():
            keys = list(dict.fromkeys(
                (kind, plans[i][1]) for i in items
                for kind in _mesh_kinds(plans[i][0], arr.dtype)))
            acc = dict(zip(keys, mesh_fold(
                [kind for kind, _ in keys],
                [moments[axes] if kind == "moments" else
                 handles[kind, axes]._data for kind, axes in keys],
                arr._mesh.group(maxes))))
            for i in items:
                name, axes = plans[i][:2]
                part = tuple(acc[kind, axes]
                             for kind in _mesh_kinds(name, arr.dtype))
                out[i] = _mesh_final(
                    name, part if name == "ptp" else part[0], plans[i][3],
                    arr.dtype, prod([shape[a] for a in axes]),
                    None if accumulate is None else _accumulated_dtype(
                        arr, name, axes, plans[i][2], plans[i][3], mode))
        # the rank's own terminals resolve here, under the mesh's key
        # scope (the group resolved above if any member was read)
        for o in out:
            if not isinstance(o, torch.Tensor):
                o._data
    return [_mesh_result(arr, o, p[1], p[2], split)
            for o, p in zip(out, plans)]


def mesh_filter_stats(arr, slots):
    """The masked terminals ``slots`` of the pending filter on the mesh
    array ``arr``, in order: each rank's masked partials from one pass of
    its box (``gpu/array.py :: _filter_partials``, ``fused_map_reduce``
    with the mask for a compiled chain's ``sum``/``mean``), ONE gather
    over the mesh axes that shard the source's key axes, the fold in rank
    order and the terminals of the fold.  NotImplemented for the
    geometries the masked form does not serve (the caller resolves the
    filter)."""
    from bolt_tpu_torch.gpu.array import (_COMBINE, _filter_final,
                                          _filter_partials, filter_axes)
    from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh, topology_key
    from bolt_tpu_torch.parallel import sharding
    kbox, gkshape, kspec, vshape = arr._mfilter
    loc = arr._local
    resolved = []
    for name, axis, keepdims, ddof in slots:
        axes = filter_axes(vshape, arr.dtype, axis, name)
        if axes is NotImplemented:
            return NotImplemented
        resolved.append((name, axes, keepdims, ddof))
    maxes = sharding.shard_axes(kspec, range(len(kspec)))
    res = []
    with engine.topology(topology_key(arr._mesh)):
        if not maxes:
            locs = [loc._stat(axis, name, keepdims, ddof)
                    for name, axis, keepdims, ddof in slots]
            for o in locs:
                o._data          # resolved under the mesh's key scope
                res.append(BoltArrayMesh(o, arr._mesh, o.shape, o.split,
                                         (None,) * len(o.shape)))
        else:
            accs, fused, count, kept = _filter_partials(
                tuple(loc._fpending), arr.dtype, resolved)
            kinds = ["sum" if fused[i] else name if name in _COMBINE
                     else "sums" for i, (name, _, _, _) in
                     enumerate(resolved)] + ["sum", "any"]
            *accs, count, kept = mesh_fold(kinds, accs + [count, kept],
                                           arr._mesh.group(maxes))
            for i, slot in enumerate(resolved):
                o = _filter_final(slot, accs[i], fused[i], count, kept,
                                  vshape, arr.dtype)
                res.append(BoltArrayMesh.wrap(o, arr._mesh,
                                              tuple(o.shape), o.ndim -
                                              len(vshape), (None,) * o.ndim))
    return res
