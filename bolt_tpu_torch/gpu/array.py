"""The ``mode='gpu'`` backend: a ``torch.Tensor`` on one ``torch.device``.

Port of ``bolt_tpu/tpu/array.py :: BoltArrayTPU``.  The array holds ONE
tensor carrying the full logical shape, key axes leading; ``split`` says
how many leading axes are keys.  Where the reference maps key axes onto a
mesh, this backend runs on a single card, so a re-axis is a permute and a
contiguous copy, and every terminal runs eagerly in PyTorch:

=========================  =======================================
reference lowering         here
=========================  =======================================
``jit(vmap(func))``        nested ``torch.func.vmap`` over the keys
``jax.eval_shape``         ``func`` run on a ``device="meta"`` tensor
pairwise tree (jit)        the same fixed-order pairwise tree, eager
``jnp`` reductions         torch reductions, numpy's output dtypes
chain fused into ``sum``   ``fused_map_reduce`` CUDA kernel, the
                           chain compiled to an expression program
shard_map Welford          ``fused_welford`` CUDA kernel (stats.py)
transpose+reshard          ``permute`` + ``contiguous``
filter compaction          a boolean gather of the survivor rows
masked filter terminals    ``fused_map_reduce`` with a record mask
=========================  =======================================

**Laziness.**  As in the reference, a traceable ``map`` is deferred: the
array records a chain of per-record functions over its parent.  A
terminal (``reduce``, ``sum``/``mean``/..., ``swap``, ``first``) applies
the chain without keeping the mapped tensor; any other consumer
materialises it once and keeps it.  ``sum`` over the key axes (or every
axis) of a chain that compiles (``bolt_tpu_torch/ops/mapexpr.py``: a
pointwise chain of the opcode table) reads the base once through the
``fused_map_reduce`` kernel, with no mapped temporary.

**Filter.**  ``filter`` is deferred too: the result is *pending* (its
survivor count unknown) until its shape or data is read.  ``sum``/
``mean``/``var``/... and ``reduce`` over the key axis fold the predicate's
mask into the reduction instead (the reference's fused filter terminals);
any other consumer resolves it by one boolean gather of the survivors.

**Streams.**  ``fromcallback``/``fromiter`` with an explicit dtype give
an array over a lazy out-of-core source (``bolt_tpu_torch/stream.py``):
``map`` records a per-record stage, ``sum``/``mean``/``var``/``std``/
``min``/``max``/``reduce`` over the key axes stream it slab by slab, and
any other consumer materialises it (the whole array must then fit).

**Host fallback.**  A callable ``torch.func.vmap`` cannot batch
(data-dependent control flow, ``.item()``, numpy coercion of a tensor)
reroutes through the local NumPy oracle with a
:class:`~bolt_tpu_torch.base.HostFallbackWarning`; any other error out of
the callable is a bug in it and surfaces.
"""

import operator
import warnings
from functools import lru_cache

import numpy as np
import torch
from torch.func import vmap

from bolt_tpu_torch.base import BoltArray, HostFallbackWarning
from bolt_tpu_torch.gpu import dtypes
from bolt_tpu_torch.gpu.dtypes import torch_dtype
from bolt_tpu_torch.ops import kernels, mapexpr
from bolt_tpu_torch.utils import (argpack, check_value_shape, inshape,
                                  isreshapeable, istransposeable, prod,
                                  tupleize)


@lru_cache(maxsize=None)
def numpy_dtype(dtype):
    """The numpy dtype of torch ``dtype`` (``TypeError`` for bfloat16,
    which numpy has no type for)."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def _traceable(func):
    """Translate a NumPy ufunc to its torch twin (``np.add`` → ``torch.add``,
    ``np.maximum`` → ``torch.maximum``) so reference user code
    (``b.reduce(np.maximum)``) runs on the card; other callables pass
    through."""
    if isinstance(func, np.ufunc):
        tf = getattr(torch, func.__name__, None)
        if tf is not None:
            return tf
    return func


# Messages of the errors that mean "vmap cannot batch this callable": the
# data-dependent control flow and .item() refusals of torch.func.vmap, and
# numpy coercion of a (meta) tensor — the counterparts of the reference's
# _TRACE_ERRORS (tracer concreteness and array conversion).  Anything else
# out of shape inference (a bad reshape, a typo, a user assert) is a bug in
# the callable and must surface, not reroute a host round-trip.
_TRACE_MESSAGES = ("vmap: It looks like you're",
                   "can't convert meta device type tensor to numpy")


def _is_trace_error(exc):
    return isinstance(exc, (RuntimeError, TypeError)) and \
        str(exc).startswith(_TRACE_MESSAGES)


def _warn_fallback(op, func, exc):
    name = getattr(func, "__name__", repr(func))
    warnings.warn(
        "%s: callable %r cannot be batched by torch.func.vmap (%s: %s); "
        "falling back to the local oracle via a device->host->device "
        "round-trip. Rewrite with torch tensor operations to stay on "
        "device." % (op, name, type(exc).__name__,
                     str(exc).splitlines()[0] if str(exc) else ""),
        HostFallbackWarning, stacklevel=3)


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _infer_map(func, vshape, dtype, split=None):
    """Per-record output ``(shape, dtype)`` of ``func``, from a vmapped call
    on a one-record meta tensor (``split`` set: a ``with_keys`` func,
    called with ``split`` int32 key scalars)."""
    x = _meta((1,) + tuple(vshape), dtype)
    if split is None:
        out = vmap(func)(x)
    else:
        keys = [_meta((1,), torch.int32) for _ in range(split)]
        out = vmap(lambda v, *k: func((tuple(k), v)))(x, *keys)
    if not isinstance(out, torch.Tensor):
        raise TypeError("map function must return a tensor, got %s"
                        % type(out).__name__)
    return tuple(out.shape[1:]), out.dtype


class _WithKeysFunc:
    """Deferred-chain entry for ``map(func, with_keys=True)``: ``func``
    takes ``((k0, ..., kn-1), value)``, so :func:`_chain_apply` vmaps it
    over flattened records zipped with their int32 key tuples."""

    __slots__ = ("func",)

    def __init__(self, func):
        self.func = func


def _chain_apply(funcs, split, data):
    """Apply a deferred map chain: each func nested-vmapped over the
    ``split`` leading key axes, in order; ``with_keys`` entries vmap over
    flattened records zipped with their int32 key tuples."""
    out = data
    for func in funcs:
        if isinstance(func, _WithKeysFunc):
            kshape = tuple(out.shape[:split])
            n = prod(kshape)
            flat = out.reshape((n,) + tuple(out.shape[split:]))
            keys = [k.to(torch.int32) for k in torch.unravel_index(
                torch.arange(n, device=out.device), kshape)]

            def one(v, *k, _f=func.func):
                return _f((tuple(k), v))

            res = vmap(one)(flat, *keys)
            out = res.reshape(kshape + tuple(res.shape[1:]))
            continue
        f = func
        for _ in range(split):
            f = vmap(f)
        out = f(out)
    return out


def _reduce_tree(data, func, n, vshape):
    """The fixed-order pairwise tree of ``bolt_tpu/tpu/array.py ::
    _reduce_tree_expr`` (and of the local oracle's ``reduce``): each round
    combines the first half of the records with the second, the odd one
    out carried to the end, so integral reduces stay bit-identical."""
    x = data.reshape((n,) + tuple(vshape))
    vfunc = vmap(func)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        combined = vfunc(x[:half], x[half:2 * half])
        rem = x[2 * half:]
        x = torch.cat([combined, rem], dim=0) if rem.shape[0] else combined
    out = x[0]
    if tuple(out.shape) != tuple(vshape):
        raise ValueError("reduce produced shape %s, expected value shape %s"
                         % (tuple(out.shape), tuple(vshape)))
    return out


def _reduce_stat(x, name, axes, keepdims, ddof, dtype):
    """One stat terminal over ``axes`` of ``x`` with the reference's
    (jnp's) dtype rule: ``mean`` of int32 is f32, ``sum`` of int32 int64."""
    out_dt = dtypes.stat_dtype(name, torch_dtype(dtype))
    if not axes:
        # numpy reduces nothing over axis=(); torch reads dim=() as "all"
        x, axes = x.unsqueeze(0), (0,)
        keepdims = False
    dims = tuple(axes)
    # torch has no uint64 sum or product: accumulate in int64, which wraps
    # modulo 2**64 alike, and cast at the end
    acc_dt = torch.int64 if out_dt == torch.uint64 else out_dt
    if name == "sum":
        out = torch.sum(x, dim=dims, keepdim=keepdims, dtype=acc_dt)
    elif name == "mean":
        out = torch.mean(x.to(out_dt), dim=dims, keepdim=keepdims)
    elif name in ("var", "std"):
        op = torch.var if name == "var" else torch.std
        out = op(x.to(out_dt), dim=dims, keepdim=keepdims,
                 correction=0 if ddof is None else ddof)
    elif name == "max":
        out = torch.amax(x, dim=dims, keepdim=keepdims)
    elif name == "min":
        out = torch.amin(x, dim=dims, keepdim=keepdims)
    elif name == "ptp":
        out = torch.amax(x, dim=dims, keepdim=keepdims) - \
            torch.amin(x, dim=dims, keepdim=keepdims)
    elif name == "prod":
        # torch.prod takes one dim: fold the axes from the last one down
        out = x
        for d in sorted(dims, reverse=True):
            out = torch.prod(out, dim=d, keepdim=keepdims, dtype=acc_dt)
    elif name in ("all", "any"):
        out = getattr(torch, name)(x, dim=dims, keepdim=keepdims)
    else:
        raise ValueError("unknown statistic %r" % (name,))
    return out if out.dtype == out_dt else out.to(out_dt)


def _as_tensor(out, device):
    """A predicate's value as a tensor (a Python bool or number too)."""
    return out if isinstance(out, torch.Tensor) else torch.tensor(
        out, device=device)


def _pred_mask(pred, flat):
    """The filter predicate as a bool mask over the flattened records —
    the reference's ONE coercion rule (``asarray(..., bool).reshape(())``
    per record), shared by the resolution and the fused terminals."""
    return vmap(lambda v: _as_tensor(pred(v), flat.device).to(
        torch.bool).reshape(()))(flat).contiguous()


def _identity(name, dtype):
    """The value a dropped record takes in the masked ``name`` reduction
    (reference: ``_masked_stat_expr``)."""
    if name in ("sum", "prod", "any", "all"):
        return {"sum": 0, "prod": 1, "any": False, "all": True}[name]
    if dtype.is_floating_point or dtype.is_complex:
        return -np.inf if name == "max" else np.inf
    if dtype == torch.bool:
        return name == "min"
    info = torch.iinfo(dtype)
    return info.min if name == "max" else info.max


def _masked_stat(name, flat, mask, axes, keepdims, ddof, vshape, vdtype):
    """ONE masked reduction over the flattened filtered records, the
    arithmetic of the reference's ``_masked_stat_expr``: ``mean``/``var``/
    ``std`` divide by the masked COUNT (var as the one-pass moment form
    ``(Σx² − (Σx)²/n)/(n−ddof)``); the rest fold dropped records onto
    their identity."""
    mfull = mask.reshape(mask.shape + (1,) * len(vshape))
    if name in ("sum", "prod", "any", "all", "max", "min"):
        ident = torch.tensor(_identity(name, flat.dtype), device=flat.device
                             ).to(flat.dtype)
        return _reduce_stat(torch.where(mfull, flat, ident), name, axes,
                            keepdims, None, vdtype)
    out_dt = dtypes.stat_dtype(name, torch_dtype(vdtype))
    # element count each output slot divides by beyond the mask: the
    # reduced VALUE axes are dense (the mask only thins records)
    prodv = prod([vshape[a - 1] for a in axes if a > 0])
    den = (mask.sum(dtype=torch.int32) * prodv).to(out_dt)
    xf = torch.where(mfull, flat, torch.zeros((), dtype=flat.dtype,
                                              device=flat.device)).to(out_dt)
    s1 = xf.sum(dim=axes, keepdim=keepdims)
    if name == "mean":
        return s1 / den
    dd = 0.0 if ddof is None else ddof
    s2 = (xf * xf).sum(dim=axes, keepdim=keepdims)
    out = (s2 - s1 * s1 / den) / (den - dd)
    return torch.sqrt(out) if name == "std" else out


# the elementwise operators that fuse into the map chain with a scalar
# operand: (operator, its dtype rule)
_OPS = {"add": (operator.add, dtypes.promote),
        "sub": (operator.sub, dtypes.promote),
        "mul": (operator.mul, dtypes.promote),
        "truediv": (operator.truediv, dtypes.true_divide)}


def _scalar_fn(name, other, reverse, dtype):
    """Per-record ``v (op) other`` computed in the reference's (jnp's)
    result dtype: a Python scalar is weakly typed, a numpy scalar strongly
    (``int32 / 2`` and ``int32 + np.float32(1.5)`` are f32, ``int32 * 2.5``
    is f64, ``f32 * 2.0`` stays f32)."""
    op, rule = _OPS[name]
    out_dt = rule(torch_dtype(dtype), other)
    scalar = other.item() if isinstance(other, np.generic) else other

    def fn(v):
        v = v.to(out_dt)
        return op(scalar, v) if reverse else op(v, scalar)
    fn.__name__ = name
    return fn


# the reductions a pending filter folds its mask into (reference:
# BoltArrayTPU._FUSED_STAT_NAMES)
_FUSED_STAT_NAMES = ("sum", "prod", "any", "all", "mean", "var", "std",
                     "max", "min")


class BoltArrayGPU(BoltArray):
    """n-d array on one ``torch.device``: key axes leading, value axes
    after them."""

    _mode = "gpu"
    # numpy defers to the reflected operators (np.ones(3) * b → b.__rmul__)
    __array_ufunc__ = None

    def __init__(self, data, split, device):
        if data is not None and (split < 0 or split > data.ndim):
            raise ValueError("split %d out of range for %d-d array"
                             % (split, data.ndim))
        self._concrete = data
        self._split = int(split)
        self._device = device
        # deferred map chain: (base tensor, (func, ...)) or None
        self._chain = None
        # lazy out-of-core source (bolt_tpu_torch.stream.StreamSource) or
        # None: nothing is on the device until a consumer needs it
        self._stream = None
        # deferred filter: (base, funcs, predicate, parent split, value
        # shape, records) or None — the survivor count is unknown until a
        # consumer resolves it (see filter)
        self._fpending = None
        self._donated = False
        self._shape = None if data is None else tuple(data.shape)
        self._dtype = None if data is None else numpy_dtype(data.dtype)

    @classmethod
    def _deferred(cls, base, funcs, split, device, shape, dtype):
        b = cls(None, split, device)
        b._chain = (base, tuple(funcs))
        b._shape = tuple(shape)
        b._dtype = np.dtype(dtype)
        return b

    @classmethod
    def _streamed(cls, source):
        """Wrap a lazy :class:`bolt_tpu_torch.stream.StreamSource`:
        shape and dtype come from its recorded stages, the streamed
        terminals run the executor, anything else materialises through
        ``_data``."""
        from bolt_tpu_torch import stream
        st = stream.result_state(source)
        b = cls(None, st.split, source.device)
        b._stream = source
        b._shape = tuple(st.shape)
        b._dtype = st.dtype
        return b

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------

    @property
    def shape(self):
        if self._fpending is not None:
            self._resolve_filter()
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def split(self):
        """Number of leading key axes (reference: ``BoltArraySpark.split``)."""
        return self._split

    @property
    def device(self):
        """The ``torch.device`` holding the data (the reference's mesh)."""
        return self._device

    @property
    def deferred(self):
        """True while this array is an unmaterialised map chain."""
        return self._concrete is None and self._chain is not None

    @property
    def pending(self):
        """True while this array is an unresolved ``filter`` result: its
        survivor count is unknown until its shape (or any consumer but a
        fused reduction) is read; ``repr`` and ``dtype`` leave it
        pending."""
        return self._fpending is not None

    @property
    def streaming(self):
        """True while this array is a lazy out-of-core stream: nothing is
        on the device; reduction terminals stream it slab by slab, other
        consumers materialise it."""
        return self._stream is not None

    @property
    def keys(self):
        """Key-axis shape view (reference: ``bolt/spark/shapes.py :: Keys``)."""
        from bolt_tpu_torch.gpu.shapes import Keys
        return Keys(self)

    @property
    def values(self):
        """Value-axis shape view (reference: ``bolt/spark/shapes.py :: Values``)."""
        from bolt_tpu_torch.gpu.shapes import Values
        return Values(self)

    @property
    def _constructor(self):
        from bolt_tpu_torch.gpu.construct import ConstructGPU
        return ConstructGPU

    def _wrap(self, data, split):
        return BoltArrayGPU(data, split, self._device)

    def _clone(self):
        """A new wrapper over the same device state (reference:
        ``BoltArrayTPU._clone``): the identity filter returns it, so a
        result never aliases its input wrapper."""
        b = BoltArrayGPU(self._concrete, self._split, self._device)
        b._chain = self._chain
        # a stream source is shared: either wrapper materialising adopts
        # its own concrete tensor
        b._stream = self._stream
        b._fpending = self._fpending
        b._shape = self._shape
        b._dtype = self._dtype
        b._donated = self._donated
        return b

    def _guard_donated(self):
        if self._donated:
            raise RuntimeError(
                "this array's device buffer was donated to %s and can no "
                "longer be read" % self._donated)

    @property
    def _data(self):
        """The concrete tensor; materialises (and keeps) a deferred chain."""
        self._guard_donated()
        if self._fpending is not None:
            self._resolve_filter()
        if self._stream is not None:
            from bolt_tpu_torch import stream
            out = stream.materialize(self._stream)
            data = out._data
            # adopt only after materialising succeeded: a failing source
            # leaves the array streaming, so a retry raises the real error
            self._stream = None
            self._concrete = data
            self._split = out._split
            return data
        if self._concrete is None:
            base, funcs = self._chain
            self._concrete = _chain_apply(funcs, self._split, base)
            self._chain = None
        return self._concrete

    def _mapped(self):
        """The tensor a terminal consumes: the deferred chain applied
        without keeping the result (the reference fuses the chain into the
        terminal's program), or the concrete data."""
        self._guard_donated()
        if self.deferred:
            base, funcs = self._chain
            return _chain_apply(funcs, self._split, base)
        return self._data

    def _align(self, axes):
        """Ensure ``axes`` are exactly the key axes, swapping if not — value
        axes named in ``axes`` move to keys, key axes missing from ``axes``
        move to values (reference: ``BoltArraySpark._align``)."""
        inshape(self.shape, axes)
        tokeys = [a - self._split for a in axes if a >= self._split]
        tovalues = [a for a in range(self._split) if a not in axes]
        if tokeys or tovalues:
            return self.swap(tovalues, tokeys)
        return self

    # ------------------------------------------------------------------
    # functional operators
    # ------------------------------------------------------------------

    def map(self, func, axis=(0,), value_shape=None, dtype=None,
            with_keys=False):
        """Apply ``func`` to every key's value block, batched over the key
        axes with nested ``torch.func.vmap`` (reference:
        ``BoltArrayTPU.map``).  Deferred: the map joins the array's chain
        and runs when a consumer needs the data.  Shape inference runs
        ``func`` on a meta tensor; a callable vmap cannot batch falls back
        to the local oracle with a :class:`HostFallbackWarning`.
        ``value_shape``/``dtype`` are validated / applied when given."""
        func = _traceable(func)
        axes = sorted(tupleize(axis))
        aligned = self._align(axes)
        split = aligned._split
        kshape = aligned.shape[:split]
        vshape = aligned.shape[split:]
        try:
            out_vshape, out_dtype = _infer_map(
                func, vshape, torch_dtype(aligned.dtype),
                split if with_keys else None)
        except (RuntimeError, TypeError) as exc:
            if not _is_trace_error(exc):
                raise
            _warn_fallback("map", func, exc)
            local = aligned.tolocal().map(
                func, axis=tuple(range(split)), value_shape=value_shape,
                dtype=dtype, with_keys=with_keys)
            return self._constructor.array(
                local.toarray(), context=self._device,
                axis=tuple(range(split)))
        check_value_shape(value_shape, out_vshape)
        if aligned._stream is not None and not with_keys:
            # a stream records the map as a stage of its slab program
            # (with_keys needs global key indices: it materialises below)
            from bolt_tpu_torch import stream
            out = stream.map_stage(aligned, func)
            if dtype is not None and np.dtype(dtype) != out.dtype:
                return out.astype(dtype)
            return out
        entry = _WithKeysFunc(func) if with_keys else func
        if aligned.deferred:
            base, funcs = aligned._chain
            funcs = funcs + (entry,)
        else:
            base, funcs = aligned._data, (entry,)
        out = BoltArrayGPU._deferred(base, funcs, split, self._device,
                                     kshape + out_vshape,
                                     numpy_dtype(out_dtype))
        if dtype is not None and np.dtype(dtype) != out.dtype:
            return out.astype(dtype)
        return out

    def filter(self, func, axis=(0,), sort=False):
        """Keep the records whose predicate ``func`` is true (reference:
        ``BoltArrayTPU.filter``).  Survivors are re-keyed to a flat
        ``(n,)`` key axis, ``split=1``, in the original key order; a
        filter on value axes aligns first.  ``sort`` is accepted for
        parity: the output is always ordered.

        Deferred: no work runs here.  The result is *pending* until its
        shape or data is needed; then the deferred map chain and the
        predicate run under ``vmap`` and one boolean gather keeps the
        survivor rows (on one card that gather already yields survivor
        rows only, so the reference's padded-buffer resolution and its
        two-phase path above ``_FILTER_FUSED_MAX_BYTES`` are one path
        here).  A reduction terminal folds the predicate's mask into its
        own pass instead (:meth:`_fused_filter_stat`,
        :meth:`_fused_filter_reduce`).  The predicate must give a scalar
        truth value per record; one ``vmap`` cannot batch takes the host
        fallback with a :class:`HostFallbackWarning`.  A streamed source
        materialises first, as for any other consumer."""
        func = _traceable(func)
        axes = sorted(tupleize(axis))
        aligned = self._align(axes)
        split = aligned._split
        vshape = tuple(aligned.shape[split:])
        n = prod(aligned.shape[:split])
        try:
            out = vmap(lambda v: _as_tensor(func(v), "meta"))(
                _meta((1,) + vshape, torch_dtype(aligned.dtype)))
        except (RuntimeError, TypeError) as exc:
            if not _is_trace_error(exc):
                raise
            _warn_fallback("filter", func, exc)
            local = aligned.tolocal().filter(func, axis=tuple(range(split)))
            return self._wrap(_upload(np.asarray(local), self._device), 1)
        if prod(tuple(out.shape[1:])) != 1:
            raise ValueError(
                "filter predicate must return a scalar truth value per "
                "record; got shape %s for value shape %s"
                % (tuple(out.shape[1:]), vshape))
        if aligned.deferred:
            base, funcs = aligned._chain
        else:
            base, funcs = aligned._data, ()
        out = BoltArrayGPU(None, 1, self._device)
        out._fpending = (base, funcs, func, split, vshape, n)
        out._dtype = aligned.dtype
        return out

    def _filtered(self):
        """The pending filter's mapped records, flattened to ``(n,
        *vshape)``, and the predicate's bool mask over them."""
        base, funcs, pred, split, vshape, n = self._fpending
        flat = _chain_apply(funcs, split, base).reshape((n,) + vshape)
        return flat, _pred_mask(pred, flat)

    def _resolve_filter(self):
        """Run the pending filter: the chain and the predicate under
        ``vmap``, then one boolean gather of the survivor rows."""
        self._guard_donated()
        flat, mask = self._filtered()
        self._concrete = flat[mask]
        self._shape = tuple(self._concrete.shape)
        self._fpending = None

    def _fused_filter_stat(self, axis, name, keepdims, ddof):
        """Single-pass ``filter(...).sum()``-family terminal (reference:
        ``BoltArrayTPU._fused_filter_stat``): the predicate's mask folds
        into the reduction, so no survivor tensor is gathered.  ``sum``
        and ``mean`` over the key axis of a chain that compiles run the
        ``fused_map_reduce`` kernel with the mask (a dropped record is not
        read); the others run the reference's masked expression.
        ``max``/``min`` with no survivor raise the zero-size
        ``ValueError``.  Returns NotImplemented for geometries the fused
        form does not serve (the caller resolves and takes the
        materialising path): reductions that keep the key axis, ``ptp``,
        complex ``var``/``std``."""
        base, funcs, pred, split, vshape, n = self._fpending
        ndim = 1 + len(vshape)
        if axis is None:
            axes = (0,)                      # the flat key axis (split=1)
        else:
            axes = tuple(sorted(tupleize(axis)))
            if any(not 0 <= a < ndim for a in axes):
                return NotImplemented        # let the eager path reject
        if 0 not in axes or name not in _FUSED_STAT_NAMES:
            return NotImplemented
        vdtype = self.dtype
        if name in ("var", "std") and np.issubdtype(vdtype,
                                                    np.complexfloating):
            return NotImplemented
        self._guard_donated()
        new_split = 1 if keepdims else 0
        flat, mask = self._filtered()
        program = None
        if name in ("sum", "mean") and axes == (0,) and \
                base.is_contiguous():
            program = mapexpr.compile(funcs, base.shape[split:], base.dtype)
        if program is None:
            out = _masked_stat(name, flat, mask, axes, keepdims, ddof,
                               vshape, vdtype)
            if name in ("max", "min") and not bool(mask.any()):
                raise ValueError("zero-size array to reduction operation "
                                 "%s which has no identity" % name)
            return self._wrap(out, new_split)
        del flat                    # B1 reads the base through the chain
        out = kernels.fused_map_reduce_cols(
            base.reshape(n, prod(vshape)), program, mask).reshape(vshape)
        if name == "mean":
            out = out / mask.sum(dtype=torch.int32).to(out.dtype)
        if keepdims:
            out = out.reshape((1,) + vshape)
        return self._wrap(out, new_split)

    def _fused_filter_reduce(self, func, axis, keepdims):
        """Single-pass ``filter(...).reduce(func)`` (reference:
        ``BoltArrayTPU._fused_filter_reduce``): the pairwise tree carries
        a validity bit per slot; combining a valid with an invalid slot
        keeps the valid operand unchanged, so dropped records (NaN too)
        never reach the result.  No survivor raises the empty-reduce
        ``TypeError``.  NotImplemented (the resolving path) off the flat
        key axis or for a reducer ``vmap`` cannot batch."""
        if tuple(sorted(tupleize(axis))) != (0,):
            return NotImplemented
        base, funcs, pred, split, vshape, n = self._fpending
        if n == 0:
            raise TypeError("reduce of an empty array with no initial value")
        try:
            rec = _meta((1,) + vshape, torch_dtype(self.dtype))
            vmap(func)(rec, rec)
        except (RuntimeError, TypeError) as exc:
            if not _is_trace_error(exc):
                raise
            return NotImplemented        # the host fallback path resolves
        self._guard_donated()
        x, valid = self._filtered()
        vfunc = vmap(func)

        def bc(m, like):
            return m.reshape(m.shape + (1,) * (like.ndim - 1))

        while x.shape[0] > 1:
            half = x.shape[0] // 2
            a, b = x[:half], x[half:2 * half]
            va, vb = valid[:half], valid[half:2 * half]
            comb = vfunc(a, b)
            if comb.shape != a.shape:
                raise ValueError("reduce produced shape %s, expected value "
                                 "shape %s" % (tuple(comb.shape[1:]), vshape))
            # both valid: combined; one valid: that operand (the combined
            # slot may be garbage and is discarded)
            sel = torch.where(bc(va & vb, comb), comb,
                              torch.where(bc(va, comb), a, b))
            vsel = va | vb
            rem, vrem = x[2 * half:], valid[2 * half:]
            if rem.shape[0]:
                x = torch.cat([sel, rem], dim=0)
                valid = torch.cat([vsel, vrem], dim=0)
            else:
                x, valid = sel, vsel
        if not bool(valid[0]):
            # every record was filtered out: the contract of reducing an
            # (0, ...)-shaped resolved result
            raise TypeError("reduce of an empty array with no initial value")
        out = x[0]
        if keepdims:
            out = out.reshape((1,) + vshape)
        return self._wrap(out, 1 if keepdims else 0)

    def reduce(self, func, axis=(0,), keepdims=False):
        """Fixed-order pairwise tree reduction over the key axes (reference:
        ``BoltArrayTPU.reduce``): each round vmaps the binary ``func`` over
        half the records, in the local oracle's order.  A deferred map
        chain on the input is applied first."""
        func = _traceable(func)
        if self._fpending is not None:
            # a pending filter feeding the reduce: fold the predicate into
            # the pairwise tree (NotImplemented geometries resolve)
            out = self._fused_filter_reduce(func, axis, keepdims)
            if out is not NotImplemented:
                return out
        axes = sorted(tupleize(axis))
        aligned = self._align(axes)
        split = aligned._split
        kshape = aligned.shape[:split]
        vshape = aligned.shape[split:]
        n = prod(kshape)
        if n == 0:
            # same error contract as the local oracle (and functools.reduce)
            raise TypeError("reduce of an empty array with no initial value")
        new_split = split if keepdims else 0
        try:
            rec = _meta((1,) + tuple(vshape), torch_dtype(aligned.dtype))
            vmap(func)(rec, rec)
        except (RuntimeError, TypeError) as exc:
            if not _is_trace_error(exc):
                raise
            _warn_fallback("reduce", func, exc)
            out = aligned.tolocal().reduce(
                func, axis=tuple(range(split)), keepdims=keepdims)
            return self._wrap(_upload(np.asarray(out), self._device),
                              new_split)
        if aligned._stream is not None:
            from bolt_tpu_torch import stream
            out = stream.maybe_reduce(aligned, func, tuple(axes), keepdims)
            if out is not NotImplemented:
                return out
        out = _reduce_tree(aligned._mapped(), func, n, vshape)
        if keepdims:
            out = out.reshape((1,) * split + tuple(vshape))
        return self._wrap(out, new_split)

    # ------------------------------------------------------------------
    # statistics: eager torch reductions with numpy's output dtypes
    # ------------------------------------------------------------------

    def _stat(self, axis, name, keepdims=False, ddof=None):
        if self._stream is not None:
            from bolt_tpu_torch import stream
            out = stream.maybe_stat(self, axis, name, keepdims, ddof)
            if out is not NotImplemented:
                return out
        if self._fpending is not None:
            # a pending filter feeding a reduction: fold the predicate's
            # mask into it (other geometries resolve below)
            out = self._fused_filter_stat(axis, name, keepdims, ddof)
            if out is not NotImplemented:
                return out
        if axis is None:
            axes = tuple(range(self._split)) if self._split \
                else tuple(range(self.ndim))
        else:
            axes = tuple(sorted(tupleize(axis)))
            inshape(self.shape, axes)
        split = self._split
        nkeys_reduced = sum(1 for a in axes if a < split)
        new_split = split if keepdims else split - nkeys_reduced
        out = None
        if name == "sum" and self.deferred:
            out = self._fused_sum(axes)
        if out is None:
            out = _reduce_stat(self._mapped(), name, axes, keepdims, ddof,
                               self.dtype)
        elif keepdims:
            out = out.reshape(tuple(1 if a in axes else d
                                    for a, d in enumerate(self.shape)))
        return self._wrap(out, new_split)

    def _fused_sum(self, axes):
        """``sum`` of the deferred chain over ``axes`` through the
        ``fused_map_reduce`` kernel, reading the base once with no mapped
        temporary: the column form when ``axes`` are the key axes, the
        full form when they are every axis.  ``None`` (the caller keeps
        the torch path) when the chain does not compile, the base is not
        contiguous or the axes are another set — a plan decision, made
        before any launch."""
        base, funcs = self._chain
        split = self._split
        if not base.is_contiguous():
            return None
        cols = split > 0 and axes == tuple(range(split))
        if not cols and axes != tuple(range(self.ndim)):
            return None
        vshape = tuple(base.shape[split:])
        program = mapexpr.compile(funcs, vshape, base.dtype)
        if program is None:
            return None
        if not cols:
            return kernels.fused_map_reduce_program(base, program)
        n = prod(base.shape[:split])
        return kernels.fused_map_reduce_cols(
            base.reshape(n, prod(vshape)), program).reshape(vshape)

    def mean(self, axis=None, keepdims=False):
        """Mean over ``axis`` (default: all key axes)."""
        return self._stat(axis, "mean", keepdims)

    def var(self, axis=None, keepdims=False, ddof=0):
        """Variance over ``axis`` (``ddof=0`` population default; fractional
        ``ddof`` passes through like numpy's)."""
        return self._stat(axis, "var", keepdims, ddof=ddof)

    def std(self, axis=None, keepdims=False, ddof=0):
        """Standard deviation over ``axis`` (``ddof`` like :meth:`var`)."""
        return self._stat(axis, "std", keepdims, ddof=ddof)

    def ptp(self, axis=None, keepdims=False):
        """Peak-to-peak (max − min) over ``axis``."""
        return self._stat(axis, "ptp", keepdims)

    def sum(self, axis=None, keepdims=False):
        return self._stat(axis, "sum", keepdims)

    def max(self, axis=None, keepdims=False):
        return self._stat(axis, "max", keepdims)

    def min(self, axis=None, keepdims=False):
        return self._stat(axis, "min", keepdims)

    def prod(self, axis=None, keepdims=False):
        """Product over ``axis`` (default: all KEY axes, like mean)."""
        return self._stat(axis, "prod", keepdims)

    def all(self, axis=None, keepdims=False):
        """Truth-reduction AND over ``axis`` (default: the key axes)."""
        return self._stat(axis, "all", keepdims)

    def any(self, axis=None, keepdims=False):
        """Truth-reduction OR over ``axis`` (default: the key axes)."""
        return self._stat(axis, "any", keepdims)

    def stats(self, *requested, axis=None, **kwargs):
        """Count/mean/var/std/min/max in one pass, as a
        :class:`~bolt_tpu_torch.statcounter.StatCounter` of value-shaped
        moments (``bolt_tpu_torch/gpu/stats.py :: welford``, whose default
        geometry runs the ``fused_welford`` kernel).  Positional legacy
        form ``stats(requested[, axis])`` as in the reference."""
        if requested and all(isinstance(r, str) for r in requested):
            raise NotImplementedError(
                "the fluent stats(%s) form is the fused multi-stat, not "
                "ported to the gpu backend yet (ROADMAP A3); call the "
                "terminals (b.sum(), b.var(), ...) one by one"
                % ", ".join(repr(r) for r in requested))
        from bolt_tpu_torch.gpu.stats import welford
        if requested:
            if len(requested) > 2:
                raise TypeError("stats() takes at most 2 positional "
                                "arguments (requested, axis)")
            kwargs.setdefault("requested", requested[0])
            if len(requested) == 2:
                if axis is not None:
                    raise TypeError("stats() got axis twice")
                axis = requested[1]
        return welford(self, axis=axis, **kwargs)

    # ------------------------------------------------------------------
    # elementwise operators: a scalar operand joins the map chain
    # ------------------------------------------------------------------

    def _elementwise(self, other, name, reverse=False):
        if isinstance(other, (int, float, complex, np.number)):
            fn = _scalar_fn(name, other, reverse, self.dtype)
            if self._split == 0:
                return self._wrap(fn(self._data), 0)
            return self.map(fn, axis=tuple(range(self._split)))
        if isinstance(other, BoltArrayGPU):
            if other._device != self._device:
                raise ValueError(
                    "elementwise operands live on different devices (%s vs "
                    "%s); move one explicitly first" % (self._device,
                                                        other._device))
            odata = other._data
        elif isinstance(other, BoltArray):
            odata = _upload(other.toarray(), self._device)
        elif isinstance(other, torch.Tensor):
            odata = other.to(self._device)
        else:
            odata = _upload(np.asarray(other), self._device)
        op, rule = _OPS[name]
        # numpy broadcasting is symmetric: keys survive while they remain
        # the leading axes with unchanged lengths
        out_shape = np.broadcast_shapes(self.shape, tuple(odata.shape))
        split = self._split
        if out_shape != self.shape and (
                len(out_shape) != self.ndim
                or out_shape[:split] != self.shape[:split]):
            split = 0
        out_dt = rule(torch_dtype(self.dtype), odata.dtype)
        x, y = self._data.to(out_dt), odata.to(out_dt)
        return self._wrap(op(y, x) if reverse else op(x, y), split)

    def __add__(self, other):
        return self._elementwise(other, "add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._elementwise(other, "sub")

    def __rsub__(self, other):
        return self._elementwise(other, "sub", reverse=True)

    def __mul__(self, other):
        return self._elementwise(other, "mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._elementwise(other, "truediv")

    def __rtruediv__(self, other):
        return self._elementwise(other, "truediv", reverse=True)

    # ------------------------------------------------------------------
    # re-axis
    # ------------------------------------------------------------------

    def swap(self, kaxes, vaxes, size="150", donate=False):
        """Move key axes ``kaxes`` into the values and value axes ``vaxes``
        into the keys.  New keys = (remaining keys) + (moved-in value
        axes); new values = (moved-out key axes) + (remaining value axes)
        — the reference's composite-key algebra (``BoltArrayTPU.swap``).
        On one card this is one ``permute`` plus ``.contiguous()``.
        ``donate=True`` releases this array's tensor once the copy exists
        (the array is unreadable afterwards); ``size`` is accepted for
        signature parity."""
        kaxes = tuple(tupleize(kaxes) or ())
        vaxes = tuple(tupleize(vaxes) or ())
        split = self._split
        nvalue = self.ndim - split
        for a in kaxes:
            if a < 0 or a >= split:
                raise ValueError("key axis %d out of range for split %d"
                                 % (a, split))
        for a in vaxes:
            if a < 0 or a >= nvalue:
                raise ValueError("value axis %d out of range for %d value "
                                 "axes" % (a, nvalue))
        if len(set(kaxes)) != len(kaxes) or len(set(vaxes)) != len(vaxes):
            raise ValueError("swap axes must be unique")
        if len(kaxes) == split and len(vaxes) == 0:
            raise ValueError("cannot perform a swap that would leave the "
                             "array with no key axes")
        return self._do_swap(kaxes, vaxes, donate=donate)

    def _do_swap(self, kaxes, vaxes, donate=False):
        """The swap without the no-key-axes guard — the chunk primitives
        (``keys_to_values`` over every key axis) produce key-less
        intermediates, which this representation holds as ``split=0``."""
        split = self._split
        nvalue = self.ndim - split
        keys_rest = [k for k in range(split) if k not in kaxes]
        values_rest = [v for v in range(nvalue) if v not in vaxes]
        perm = (keys_rest + [split + v for v in vaxes]
                + list(kaxes) + [split + v for v in values_rest])
        new_split = len(keys_rest) + len(vaxes)
        if perm == list(range(self.ndim)) and new_split == split:
            return self
        out = self._mapped().permute(perm).contiguous()
        if donate:
            self._concrete = None
            self._chain = None
            self._donated = "swap(..., donate=True)"
        return self._wrap(out, new_split)

    def chunk(self, size="150", axis=None, padding=None):
        """Decompose the value axes into chunks; returns a
        :class:`~bolt_tpu_torch.gpu.chunk.ChunkedArray` view — no data
        moves until its ``map`` runs."""
        from bolt_tpu_torch.gpu.chunk import ChunkedArray
        return ChunkedArray.chunk(self, size=size, axis=axis,
                                  padding=padding)

    # ------------------------------------------------------------------
    # shaping (within-group only, no data shuffle)
    # ------------------------------------------------------------------

    def transpose(self, *axes):
        axes = argpack(axes)
        if len(axes) == 0:
            axes = tuple(reversed(range(self.ndim)))
        if not istransposeable(axes, range(self.ndim)):
            raise ValueError("axes %s is not a permutation of %d axes"
                             % (str(axes), self.ndim))
        split = self._split
        if sorted(axes[:split]) != list(range(split)):
            raise ValueError(
                "transpose may not move axes between keys and values; "
                "use swap (key axes: %s)" % str(tuple(range(split))))
        if tuple(axes) == tuple(range(self.ndim)):
            return self
        return self._wrap(self._data.permute(tuple(axes)), split)

    @property
    def T(self):
        """Reverse keys among themselves and values among themselves."""
        split = self._split
        perm = tuple(reversed(range(split))) + tuple(
            reversed(range(split, self.ndim)))
        return self.transpose(*perm)

    def swapaxes(self, axis1, axis2):
        perm = list(range(self.ndim))
        perm[axis1], perm[axis2] = perm[axis2], perm[axis1]
        return self.transpose(*perm)

    def reshape(self, *shape):
        shape = argpack(shape)
        if not isreshapeable(shape, self.shape):
            raise ValueError("cannot reshape %s to %s"
                             % (str(self.shape), str(shape)))
        ksize = prod(self.shape[:self._split])
        # the boundary: the smallest non-empty key prefix whose product
        # matches (the keys/values views state it explicitly instead)
        start = 1 if self._split > 0 else 0
        new_split = None
        for k in range(start, len(shape) + 1):
            if prod(shape[:k]) == ksize:
                new_split = k
                break
        if new_split is None:
            raise ValueError(
                "new shape %s does not preserve the key/value boundary "
                "(key size %d)" % (str(shape), ksize))
        return self._reshape_with_split(shape, new_split)

    def _reshape_with_split(self, shape, new_split):
        """Reshape to ``shape`` with an explicitly stated key-axis count
        (used by the ``keys``/``values`` views, which know the boundary)."""
        shape = tuple(shape)
        if prod(shape[:new_split]) != prod(self.shape[:self._split]):
            raise ValueError(
                "new key shape %s does not match key size %d"
                % (str(shape[:new_split]), prod(self.shape[:self._split])))
        if shape == self.shape and new_split == self._split:
            return self
        return self._wrap(self._data.reshape(shape), new_split)

    def squeeze(self, axis=None):
        if axis is None:
            axes = tuple(i for i, s in enumerate(self.shape) if s == 1)
        else:
            axes = tupleize(axis)
            inshape(self.shape, axes)
            for a in axes:
                if self.shape[a] != 1:
                    raise ValueError("cannot squeeze axis %d of size %d"
                                     % (a, self.shape[a]))
        new_shape = tuple(s for i, s in enumerate(self.shape)
                          if i not in axes)
        new_split = self._split - sum(1 for a in axes if a < self._split)
        if new_shape == self.shape:
            return self
        return self._wrap(self._data.reshape(new_shape), new_split)

    # ------------------------------------------------------------------
    # indexing: per-axis int/slice/list/bool; advanced indices apply
    # orthogonally per axis, like the reference
    # ------------------------------------------------------------------

    def __getitem__(self, index):
        from bolt_tpu_torch.utils import normalize_index
        norm, squeezed = normalize_index(index, self.shape)
        slices, takes = [], {}
        for ax, s in enumerate(norm):
            if isinstance(s, slice) and s.step > 0:
                slices.append(s)
                continue
            # torch slices take no negative step: gather those axes too
            takes[ax] = s if isinstance(s, np.ndarray) \
                else np.ascontiguousarray(np.arange(self.shape[ax])[s])
            slices.append(slice(None))
        out = self._data[tuple(slices)]
        for ax, idx in takes.items():
            out = torch.index_select(out, ax, torch.as_tensor(
                idx, dtype=torch.int64, device=out.device))
        if squeezed:
            out = out.reshape(tuple(s for i, s in enumerate(out.shape)
                                    if i not in squeezed))
        new_split = self._split - sum(1 for a in squeezed if a < self._split)
        return self._wrap(out, new_split)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    # ------------------------------------------------------------------
    # conversions
    # ------------------------------------------------------------------

    def toarray(self, out=None):
        """Copy to a host ``numpy.ndarray`` in key order; with ``out=`` the
        copy lands in the caller's buffer."""
        a = _download(self._data)
        if out is not None:
            BoltArray._check_out(out, a.shape, a.dtype)
            out[...] = a
            return out
        return a

    def iter_shards(self):
        """One ``(index, block)`` covering the whole array: a single card
        holds a single shard."""
        yield (tuple(slice(0, d) for d in self.shape), self.toarray())

    def tolocal(self):
        from bolt_tpu_torch.local.array import BoltArrayLocal
        return BoltArrayLocal(self.toarray())

    def togpu(self, context=None, axis=(0,)):
        if context is None or context == self._device:
            return self
        return BoltArray.togpu(self, context=context, axis=axis)

    def totorch(self):
        """Unwrap to the engine-native object, the device tensor
        (materialises a deferred chain first) — the structural slot of the
        reference's ``tojax``."""
        return self._data

    def first(self):
        """The value block at the first key tuple; on a deferred chain the
        chain runs on that one record only."""
        if self.deferred:
            base, funcs = self._chain
            split = self._split
            rec = base[(slice(0, 1),) * split]
            return _download(_chain_apply(funcs, split, rec)[(0,) * split])
        return _download(self._data[(0,) * self._split])

    def astype(self, dtype, casting="unsafe"):
        """Cast elements (deferred like a map, so it joins the chain);
        ``casting`` is validated against numpy's rules."""
        np.empty(0, dtype=self.dtype).astype(dtype, casting=casting)
        target = torch_dtype(dtype)
        if self._split == 0:
            return self._wrap(self._data.to(target), 0)

        def cast(v):
            return v.to(target)
        return self.map(cast, axis=tuple(range(self._split)))

    def cache(self):
        """Materialise a deferred chain and keep the result."""
        self._data
        return self

    def __repr__(self):
        s = "BoltArray\n"
        s += "mode: %s\n" % self.mode
        if self._fpending is not None:
            # don't run the filter just to print; show what is known
            s += "shape: (%s)\n" % ", ".join(
                ["?"] + [str(d) for d in self._fpending[4]])
        else:
            s += "shape: %s\n" % str(self.shape)
        s += "split: %d\n" % self._split
        s += "dtype: %s\n" % str(self.dtype)
        s += "device: %s\n" % str(self._device)
        if self._donated:
            s += "donated: buffer consumed by %s\n" % self._donated
        elif self._stream is not None:
            s += "streaming: %r\n" % (self._stream,)
        elif self.deferred:
            s += "deferred: %d-op map chain\n" % len(self._chain[1])
        elif self._fpending is not None:
            s += "pending: deferred filter (predicate not yet run)\n"
        return s


def _upload(a, device):
    """A numpy array as a tensor on ``device`` (a copy: the caller's array
    never aliases the bolt array)."""
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _download(t):
    """A tensor as a host numpy array that aliases nothing."""
    return t.detach().to("cpu", copy=True).numpy()
