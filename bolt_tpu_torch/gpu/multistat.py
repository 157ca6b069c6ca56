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
  (``gpu/array.py :: _filter_stats``).

Each group resolves through one engine program (``_cached_jit``: family
``"stat"`` for a lone member, ``"multi-stat"``, ``"filter-stat"`` and
``"multi-filter-stat"`` otherwise).  A group whose source is sole-owned
takes it as the reference's groups do: the first terminal's call consumes
the source (later reads of it raise), siblings still join the group, and
the group drops the base when it resolves.

Left out until their modules come: stream groups (a streamed source's
terminals stay the eager streamed terminals, which :func:`compute`
passes through) and the serve layer's batched claim.
"""

import weakref
from collections import OrderedDict

import numpy as np
import torch

from bolt_tpu_torch import _lockdep, _precision, engine
from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.gpu import dtypes
from bolt_tpu_torch.gpu.dtypes import torch_dtype
from bolt_tpu_torch.utils import prod

# the terminals that defer (everything _stat serves)
LAZY_NAMES = ("sum", "mean", "var", "std", "min", "max", "prod", "all",
              "any", "ptp")

# a pending filter's lazy terminals: min/max keep their zero-size error
# at the call, ptp resolves the filter
_FPENDING_LAZY = ("sum", "prod", "any", "all", "mean", "var", "std")

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
    ``shape`` and numpy ``dtype``) or ``"fpending"`` (the pending filter
    ``fpending`` whose records have numpy ``dtype``).

    The group holds its members weakly (a member holds its group), so no
    reference cycle keeps a source alive, and a resolved group drops its
    source: a 10 GB base is freed with the last array that needs it."""

    def __init__(self, kind, split, shape, dtype, base=None, funcs=(),
                 fpending=None, device=None, donate=False):
        self.kind = kind
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

    def try_join(self, axis, name, keepdims, ddof):
        """A new member for ``name`` over ``axis``, or NotImplemented when
        the spec cannot ride this group (the caller takes the eager
        path), or when the group resolved meanwhile."""
        if self.kind == "fpending":
            h = self._fpending_member(name, axis, keepdims, ddof)
        else:
            h = self._chain_member(name, axis, keepdims, ddof)
        if h is NotImplemented:
            return h
        with self.lock:
            if self.dispatched:
                # a concurrent reader resolved the group between the
                # caller's check and this append: the member would never
                # be filled
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

    def _member(self, name, axes, keepdims, ddof, shape, new_split):
        from bolt_tpu_torch.gpu.array import numpy_dtype
        dtype = numpy_dtype(dtypes.stat_dtype(name, torch_dtype(self.dtype)))
        return PendingStat(self, name, axes, keepdims, ddof,
                           _out_shape(shape, axes, keepdims), dtype,
                           new_split)

    def resolve(self, accumulate=None):
        """Compute every member's result.  Idempotent and thread-safe;
        ``accumulate`` is the per-call reduced-precision mode of
        :func:`compute`."""
        with self.lock:
            if self.dispatched:
                return
            mode = _precision.resolve_accumulate(accumulate)
            if mode is not None and self.kind != "chain":
                if accumulate is not None:
                    raise ValueError(
                        "accumulate=%r applies to in-memory fused "
                        "reductions only; this group filters and runs "
                        "exact" % (accumulate,))
                mode = None                  # an ambient scope: exact
            members = [m for m in (r() for r in self.members)
                       if m is not None]
            if self.kind == "chain":
                self._resolve_chain(members, mode)
            else:
                self._resolve_fpending(members)
            self.dispatched = True
            self.members = []
            self.base = self.fpending = None
            self.funcs = ()

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
                m.result = mx - mn
            else:
                m.result = out[_slot(m)[0]]

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
    from bolt_tpu_torch.gpu.array import (_chain_stats, _chain_sum,
                                          _chain_values)

    def run(base):
        out = {}
        if mode is None:
            for slot in slots:
                name, axes, keepdims, _ = slot
                r = _chain_sum(base, funcs, split, axes) \
                    if name == "sum" else None
                if r is not None:
                    out[slot] = r.reshape(_out_shape(shape, axes, keepdims))
            rest = [s for s in slots if s not in out]
            out.update(zip(rest, _chain_stats(base, funcs, split, shape,
                                              dtype, rest)))
        else:
            mapped = _chain_values(base, funcs, split, shape, dtype)
            for slot in slots:
                out[slot] = _accumulated(mapped, *slot, mode, dtype)
            del mapped
        return tuple(out[s] for s in slots)
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
    name that does not defer, a stream, a donated array, a geometry a
    group does not serve)."""
    if name not in LAZY_NAMES or arr._stream is not None:
        return NotImplemented
    g = arr._stat_group
    if g is not None and (g.dispatched or (not arr._donated and (
            (g.kind == "fpending" and arr._fpending is None)
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
    if arr._fpending is not None:
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


def _wrap(arr, handle):
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    out = BoltArrayGPU(None, handle.new_split, arr.device)
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
    if arr._stream is not None and len(names) > 1:
        # streamed terminals are single passes until the stream groups
        # come (ROADMAP A9): materialise once, so a one-shot source
        # serves every name
        arr.cache()
    handles = [getattr(arr, n)(axis=axis) for n in names]
    compute(*handles, accumulate=accumulate)
    return OrderedDict(zip(names, handles))
