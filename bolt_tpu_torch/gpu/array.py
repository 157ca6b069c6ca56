"""The ``mode='gpu'`` backend: a ``torch.Tensor`` on one ``torch.device``.

Port of ``bolt_tpu/tpu/array.py :: BoltArrayTPU``.  The array holds ONE
tensor carrying the full logical shape, key axes leading; ``split`` says
how many leading axes are keys.  This module is the single-device half: a
re-axis is a permute and a contiguous copy, and every terminal runs
eagerly in PyTorch.  The mesh half (key axes spread over a mesh of ranks,
one process each) is ``gpu/mesharray.py :: BoltArrayMesh``, which holds
this rank's box as one of these arrays:

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
``jnp`` ufuncs/operators   torch twins with jnp's dtypes
                           (``gpu/ufuncs.py``)
ndarray methods            torch sorts, gathers, scans
                           (``gpu/methods.py``)
fused multi-stat program   a stat group (``gpu/multistat.py``)
XLA executable cache       the engine's program cache
                           (``bolt_tpu_torch/engine.py``)
buffer donation            the result written into the base's own
                           storage, or the base dropped once read
=========================  =======================================

**Programs.**  Each terminal builds its program once per key through the
engine (``_cached_jit``: op family, user funcs, shapes, dtype, split,
device, donation) and calls the cached program afterwards; shape
inference of ``map``/``filter``/``reduce`` is cached per (callable,
record shape, dtype) in ``_EVAL_CACHE``, as the reference caches its
``eval_shape``.

**Donation.**  A terminal consuming a deferred chain (materialisation,
``reduce``, the stat terminals, the filter terminals, ``chunk().map()``,
``stacked().map()``) takes the chain's base when the chain is its sole
owner and it is at least ``engine.donation_min_bytes()`` (64 MB by
default) — see :func:`_chain_donate_ok`.  Where the output has the
base's record shape and dtype, it is written into the base's own storage
block by block (block *i* reads only records of block *i*); otherwise the
base is dropped once read.  A consumed array raises on any later read,
naming the terminal.

**Laziness.**  As in the reference, a traceable ``map`` is deferred: the
array records a chain of per-record functions over its parent.  A
terminal (``reduce``, ``sum``/``mean``/..., ``swap``, ``first``) applies
the chain without keeping the mapped tensor; any other consumer
materialises it once and keeps it.  ``sum`` over the key axes (or every
axis) of a chain that compiles (``bolt_tpu_torch/ops/mapexpr.py``: a
pointwise chain of the opcode table) reads the base once through the
``fused_map_reduce`` kernel, with no mapped temporary.  A scalar
operator or a unary numpy ufunc (``np.exp(-(b ** 2)) * 0.5``) joins the
chain too.  The stat terminals are lazy: ``sum()`` returns a pending
member of its source's group, resolved on its first read together with
the other members (``bolt_tpu_torch.compute``).

**Filter.**  ``filter`` is deferred too: the result is *pending* (its
survivor count unknown) until its shape or data is read.  ``sum``/
``mean``/``var``/... and ``reduce`` over the key axis fold the predicate's
mask into the reduction instead (the reference's fused filter terminals);
any other consumer resolves it by one boolean gather of the survivors.
The chain and the predicate run over blocks of about 768 MB of mapped
records, so neither path holds the whole mapped chain; a stat terminal
over the key axes of a longer chain folds the blocks' partials the same
way.

**Streams.**  ``fromcallback``/``fromiter`` with an explicit dtype give
an array over a lazy out-of-core source (``bolt_tpu_torch/stream.py``):
``map``, ``filter``, ``chunk().map()``, ``stacked().map()`` and ``swap``
record stages, ``sum``/``mean``/``var``/``std``/``min``/``max``/
``reduce`` over the key axes (several at once as one stat group) stream
it slab by slab, and any other consumer materialises it (the whole array
must then fit).

**Host fallback.**  A callable ``torch.func.vmap`` cannot batch
(data-dependent control flow, ``.item()``, numpy coercion of a tensor)
reroutes through the local NumPy oracle with a
:class:`~bolt_tpu_torch.base.HostFallbackWarning`; any other error out of
the callable is a bug in it and surfaces.
"""

import sys
import warnings
import weakref
from collections import OrderedDict
from functools import lru_cache

import numpy as np
import torch
from torch.func import vmap

from bolt_tpu_torch import _lockdep
from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.base import BoltArray, HostFallbackWarning
from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.gpu import dtypes, ufuncs
from bolt_tpu_torch.gpu.dtypes import torch_dtype
from bolt_tpu_torch.gpu.methods import ArrayMethods
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
    """Translate a NumPy ufunc to its torch twin (``np.add`` → ``torch.add``)
    so reference user code (``b.reduce(np.maximum)``) runs on the card;
    the orderings (``np.maximum``, ``np.minimum``, ``np.fmax``,
    ``np.fmin``) to ``gpu/ufuncs.py``'s, which order complex numbers and
    the unsigned carriers as numpy does.  Other callables pass through."""
    if isinstance(func, np.ufunc):
        if func.__name__ in ufuncs.ORDERING_FNS:
            return ufuncs.ORDERING_FNS[func.__name__]
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


def _raise_callable_bug(op, func, exc, vshape):
    """Raise the error of a bug in the user callable ``func`` that shape
    inference on a ``vshape`` record met: torch's ``RuntimeError`` (a bad
    reshape, mismatched shapes) as the reference's ``TypeError``, chained
    to it, with a message that names the record's shape and not vmap's
    batched one; any other error as it is."""
    if not isinstance(exc, RuntimeError):
        raise exc
    raise TypeError(
        "%s: the callable %r fails on a record of shape %s (%s; torch's "
        "error is chained below)" % (op, getattr(func, "__name__", func),
                                     tuple(vshape), type(exc).__name__)
    ) from exc


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


_LRU_MAX = 512
_LRU_LOCK = _lockdep.rlock("gpu.lru")


def _lru_get(cache, key, build):
    """The bounded LRU of the shape-inference cache: ``build`` runs under
    the lock (meta-tensor work, never a device program).  A ``build``
    that raises stores nothing, so the error repeats on the next call."""
    with _LRU_LOCK:
        out = cache.get(key)
        if out is None:
            out = build()
            cache[key] = out
            if len(cache) > _LRU_MAX:
                cache.popitem(last=False)
        else:
            cache.move_to_end(key)
        return out


# shape-inference results, keyed on (op, func identity, record shape,
# dtype) as the reference keys its eval_shape cache: a vmapped call on a
# meta tensor costs a few hundred microseconds of host time per call
_EVAL_CACHE = OrderedDict()


def _cached_eval_shape(key, thunk):
    return _lru_get(_EVAL_CACHE, key, thunk)


def _cached_jit(key, builder):
    """Keyed program dispatch through the engine: built at most once per
    key, counted and shared across every op family
    (``bolt_tpu_torch.profile.instrument`` patches this name per module
    to count calls and builds)."""
    return _engine.get(key, builder)


def _infer_map(func, vshape, dtype, split=None):
    """Per-record output ``(shape, dtype)`` of ``func``, from a vmapped call
    on a one-record meta tensor (``split`` set: a ``with_keys`` func,
    called with ``split`` int32 key scalars); cached per (func, record
    shape, dtype, split)."""
    vshape = tuple(vshape)
    if split is None:
        return _cached_eval_shape(("map", func, vshape, str(dtype)),
                                  lambda: _infer_record(func, vshape, dtype))
    return _cached_eval_shape(("map-wk", func, split, vshape, str(dtype)),
                              lambda: _infer_record(func, vshape, dtype,
                                                    split))


def _infer_record(func, vshape, dtype, split=None):
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


def _infer_pred(func, vshape, dtype):
    """The shape of the predicate ``func``'s value on one record (cached
    per (func, record shape, dtype))."""
    def run():
        out = vmap(lambda v: _as_tensor(func(v), "meta"))(
            _meta((1,) + vshape, dtype))
        return tuple(out.shape[1:])
    return _cached_eval_shape(("filter", func, vshape, str(dtype)), run)


def _check_reducer(func, vshape, dtype):
    """Trace the binary reducer ``func`` once on meta records (cached per
    (func, record shape, dtype)): raises what ``vmap`` raises, else
    returns the ``(shape, dtype)`` of its value on two records."""
    def run():
        rec = _meta((1,) + tuple(vshape), dtype)
        out = vmap(func)(rec, rec)
        if not isinstance(out, torch.Tensor):
            return None, None
        return tuple(out.shape[1:]), out.dtype
    return _cached_eval_shape(("reduce", func, tuple(vshape), str(dtype)),
                              run)


# ---------------------------------------------------------------------
# donation: who owns a chain's base
# ---------------------------------------------------------------------

class _Shared(tuple):
    """A deferred chain ``(base, funcs)`` or a pending filter tuple,
    with weak references to the wrappers holding it: ``_clone`` shares
    one tuple between wrappers, and a tuple held by more than one live
    wrapper is never donated."""

    def __new__(cls, items, owner):
        t = super().__new__(cls, items)
        t.owners = [weakref.ref(owner)]
        return t

    def share(self, owner):
        self.owners = [r for r in self.owners if r() is not None]
        self.owners.append(weakref.ref(owner))


def _sharers(shared):
    """Live wrappers holding ``shared`` as their chain or filter."""
    n = 0
    for r in shared.owners:
        w = r()
        if w is not None and (w._chain is shared or w._fpending is shared):
            n += 1
    return n


def _py_refs(shared):
    """Python references to ``shared``'s base, as this function sees
    them."""
    return sys.getrefcount(shared[0])


def _storage_refs(t):
    """Holders of ``t``'s storage (tensors and views), or ``None`` where
    torch does not say."""
    use_count = getattr(torch._C, "_storage_Use_Count", None)
    if use_count is None:
        return None
    return use_count(t.untyped_storage()._cdata)


# the counts of a base that nothing but its chain holds, measured once on
# this interpreter and torch through the same two functions: sole
# ownership compares with these, never with a number fixed in advance
_LONE_PY = _py_refs((torch.empty(1),))
_LONE_STORAGE = _storage_refs(torch.empty(1))


def _chain_donate_ok(shared):
    """True when a terminal consuming the deferred chain or pending
    filter ``shared`` (``(base, funcs, ...)``) may take its base: donation
    is on, the base is at least ``engine.donation_min_bytes()``, exactly
    one live wrapper holds the tuple (a ``_clone`` shares it), no other
    Python object holds the base (a live parent array, a stat group, the
    caller's tensor), the base is no view (its storage would belong to a
    tensor someone else holds) and no view of it exists.  Each count is
    taken explicitly; a caller must not bind its own local to the base
    before asking (that reference refuses the donation: it fails safe).
    A donation that would be wrong is refused, and then nothing changes.
    """
    floor = _engine.donation_min_bytes()
    if floor is None or not isinstance(shared, _Shared) or \
            _LONE_STORAGE is None:
        return False
    if shared[0].numel() * shared[0].element_size() < floor:
        return False
    if _py_refs(shared) != _LONE_PY or _sharers(shared) != 1:
        return False
    return shared[0]._base is None and \
        _storage_refs(shared[0]) == _LONE_STORAGE


def _aliases(t, base):
    """True when ``t`` shares ``base``'s storage."""
    return t.untyped_storage().data_ptr() == base.untyped_storage().data_ptr()


def _map_blocks(base, funcs, split, body, per, inplace):
    """The chain ``funcs`` and then ``body`` (``None``: nothing) applied
    to ``base`` block by block of ``per`` records (flattened: ``body``
    sees ``split`` 1), each block's result written in record order into
    one output tensor of ``(*keys, *block result record)``.  With
    ``inplace`` (a donated base) the output is the base's own storage
    when the result keeps the base's record shape and dtype and the base
    is contiguous: block *i* reads only records of block *i*, so no
    record is overwritten before it is read.  Needs at least one
    record."""
    n = prod(base.shape[:split])
    kshape = tuple(base.shape[:split])
    out = dst = None
    for s, e, recs in _chain_blocks(base, funcs, split, per):
        if body is not None:
            recs = body(recs)
        if out is None:
            rshape = tuple(recs.shape[1:])
            if inplace and rshape == tuple(base.shape[split:]) and \
                    recs.dtype == base.dtype and base.is_contiguous():
                out = base
            else:
                out = torch.empty(kshape + rshape, dtype=recs.dtype,
                                  device=base.device)
            dst = out.view((n,) + rshape)
        if out is base and _aliases(recs, base):
            recs = recs.clone()     # a view of the block: copy before
            #                         writing over the records it reads
        dst[s:e] = recs
        del recs        # free the block before the next one is mapped
    return out


class _WithKeysFunc:
    """Deferred-chain entry for ``map(func, with_keys=True)``: ``func``
    takes ``((k0, ..., kn-1), value)``, so :func:`_chain_apply` vmaps it
    over flattened records zipped with their int32 key tuples."""

    __slots__ = ("func",)

    def __init__(self, func):
        self.func = func


# per user callable and (argument dtypes, device type): None where torch
# runs it on the arguments' own dtypes, else the result dtype it gives on
# them (it then runs on their carriers)
_CARRIED_CALLS = weakref.WeakKeyDictionary()


def _user_call(func, args, depth=0, key=None):
    """``func(*args)`` of a user callable, vmapped ``depth`` times over
    the arguments' leading axes.  Where torch has no kernel for an
    unsigned argument's dtype, ``func`` runs on the arguments' carriers
    under ``dtypes.CarrierMode``, which computes what torch would on the
    unsigned values or raises ``TypeError``; the result takes back the
    dtype ``func`` gives on meta tensors of the arguments' own dtypes.
    Which of the two runs is found once per callable (``key``, else
    ``func``), argument dtypes and device."""
    def batched(f):
        for _ in range(depth):
            f = vmap(f)
        return f

    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    sig = (tuple(a.dtype for a in tensors), tensors[0].device.type)
    try:
        plans = _CARRIED_CALLS.setdefault(func if key is None else key, {})
    except TypeError:           # not weakly referable (a builtin)
        plans = {}
    if sig not in plans:
        try:
            out = batched(func)(*args)
        except NotImplementedError as exc:
            if not dtypes.missing_unsigned_kernel(exc, args):
                raise
            plans[sig] = batched(func)(*[
                a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args]).dtype
        else:
            plans[sig] = None
            return out
    want = plans[sig]
    if want is None:
        return batched(func)(*args)
    mode = dtypes.CarrierMode()
    try:
        with mode:
            out = batched(mode.entry(func, args))(*[
                dtypes.carry(a) if isinstance(a, torch.Tensor) else a
                for a in args])
    except TypeError as exc:
        if mode.refused is None:
            raise
        raise TypeError(mode.refused) from exc
    return dtypes.uncarry(out, want)


def _chain_apply(funcs, split, data, kshape=None, start=0):
    """Apply a deferred map chain: each func nested-vmapped over the
    ``split`` leading key axes, in order; ``with_keys`` entries vmap over
    flattened records zipped with their int32 key tuples.  ``kshape`` and
    ``start``: ``data`` holds records ``start...`` of a flattened key
    space of shape ``kshape`` (``split`` is then 1), so a ``with_keys``
    entry still sees each record's own key tuple."""
    out = data
    for func in funcs:
        if isinstance(func, _WithKeysFunc):
            ks = tuple(out.shape[:split])
            n = prod(ks)
            flat = out.reshape((n,) + tuple(out.shape[split:]))
            keys = [k.to(torch.int32) for k in torch.unravel_index(
                torch.arange(start, start + n, device=out.device),
                ks if kshape is None else kshape)]

            def one(v, *k, _f=func.func):
                return _f((tuple(k), v))

            res = _user_call(one, (flat, *keys), 1, key=func.func)
            out = res.reshape(ks + tuple(res.shape[1:]))
            continue
        out = _user_call(func, (out,), split)
    return out


def _reduce_tree(data, func, n, vshape):
    """The fixed-order pairwise tree of ``bolt_tpu/tpu/array.py ::
    _reduce_tree_expr`` (and of the local oracle's ``reduce``): each round
    combines the first half of the records with the second, the odd one
    out carried to the end, so integral reduces stay bit-identical."""
    x = data.reshape((n,) + tuple(vshape))
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        combined = _user_call(func, (x[:half], x[half:2 * half]), 1)
        rem = x[2 * half:]
        x = torch.cat([combined, rem], dim=0) if rem.shape[0] else combined
    out = x[0]
    if tuple(out.shape) != tuple(vshape):
        raise ValueError("reduce produced shape %s, expected value shape %s"
                         % (tuple(out.shape), tuple(vshape)))
    return out


def _reduce_body(data, func, funcs, split, n, vshape, keepdims):
    """The ``reduce(func)`` terminal of the chain ``funcs`` over ``data``
    (``n`` records of ``vshape`` after the chain): :func:`_reduce_tree`,
    the one body of the eager terminal, its deferred handle and a lane of
    a serve batched dispatch (``gpu/batched.py``)."""
    out = _reduce_tree(_chain_apply(funcs, split, data), func, n, vshape)
    if keepdims:
        out = out.reshape((1,) * split + tuple(vshape))
    return out


def _reduce_program(func, funcs, split, n, vshape, keepdims):
    """The engine program of :func:`_reduce_body` (key ``"reduce"``)."""
    def run(data):
        return _reduce_body(data, func, funcs, split, n, vshape, keepdims)
    return run


def _reduce_stat(x, name, axes, keepdims, ddof, dtype):
    """One stat terminal over ``axes`` of ``x`` with the reference's
    (jnp's) dtype rule: ``mean`` of int32 is f32, ``sum`` of int32 int64."""
    out_dt = dtypes.stat_dtype(name, torch_dtype(dtype))
    if not axes:
        # numpy reduces nothing over axis=(); torch reads dim=() as "all"
        x, axes = x.unsqueeze(0), (0,)
        keepdims = False
    dims = tuple(axes)
    # the unsigned dtypes torch leaves out reduce in their carriers
    # (gpu/dtypes.py): sums and products wrap modulo 2**bits alike, and
    # the extrema of uint64 order its sign-flipped bits
    acc_dt = dtypes.carrier(out_dt)
    if name in ("max", "min", "ptp") and x.is_complex():
        raise TypeError("%s of a complex array is not supported (the "
                        "reference refuses it too); order by np.sort or "
                        "reduce(np.maximum), which take numpy's order"
                        % name)
    if name in ("max", "min", "ptp") and dtypes.carried(x.dtype):
        c = dtypes.carry(x, ordered=True)
        hi = dtypes.uncarry(torch.amax(c, dim=dims, keepdim=keepdims),
                            x.dtype, ordered=True)
        lo = dtypes.uncarry(torch.amin(c, dim=dims, keepdim=keepdims),
                            x.dtype, ordered=True)
        if name != "ptp":
            return hi if name == "max" else lo
        return dtypes.uncarry(dtypes.carry(hi) - dtypes.carry(lo), x.dtype)
    if name in ("sum", "prod"):
        x = dtypes.carry(x)
    if name == "sum":
        out = torch.sum(x, dim=dims, keepdim=keepdims, dtype=acc_dt)
    elif name == "mean":
        out = torch.mean(x.to(out_dt), dim=dims, keepdim=keepdims)
    elif name in ("var", "std"):
        # a complex array's variance is real: torch's var of the complex
        # values, not of their real parts
        op = torch.var if name == "var" else torch.std
        out = op(x.to(dtypes.inexact(x.dtype)), dim=dims, keepdim=keepdims,
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
    return _user_call(lambda v: _as_tensor(pred(v), flat.device).to(
        torch.bool).reshape(()), (flat,), 1, key=pred).contiguous()


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


# a pending filter runs its chain and predicate, and a stat terminal its
# chain, over blocks of about this many bytes of records (at least one
# record): no filter pass and no stat over the key axes holds the whole
# mapped chain.  The largest size that keeps config 4's filter under 1 GB
# of peak growth at the north-star; smaller blocks pay more host dispatch
# a byte (tools/block_probe.py)
_BLOCK_BYTES = 768 << 20

def _carried_pair(fn, ordered=False):
    """The binary ``fn`` computed in the carrier of its operands' dtype
    (``gpu/dtypes.py``) where torch leaves that dtype out."""
    def f(a, b):
        if not dtypes.carried(a.dtype):
            return fn(a, b)
        return dtypes.uncarry(fn(dtypes.carry(a, ordered),
                                 dtypes.carry(b, ordered)), a.dtype, ordered)
    return f


# how the partials of one block's masked reduction join the others'
_COMBINE = {"sum": _carried_pair(torch.add),
            "prod": _carried_pair(torch.mul), "any": torch.logical_or,
            "all": torch.logical_and,
            "max": _carried_pair(torch.maximum, ordered=True),
            "min": _carried_pair(torch.minimum, ordered=True)}


def _block_records(rec_bytes):
    """Records in a block of about ``_BLOCK_BYTES`` (at least one)."""
    return max(1, _BLOCK_BYTES // max(1, rec_bytes))


def _chain_blocks(base, funcs, split, per):
    """``(start, stop, records)`` for each block of ``per`` records: the
    chain applied to the base's flattened records ``start:stop``."""
    n = prod(base.shape[:split])
    kshape = tuple(base.shape[:split])
    flat = base.reshape((n,) + tuple(base.shape[split:]))
    for s in range(0, n, per):
        e = min(n, s + per)
        yield s, e, _chain_apply(funcs, 1, flat[s:e], kshape, s)


def _filter_blocks(fp, dtype):
    """``(start, stop, records)`` for each block of the pending filter
    ``fp`` whose mapped records are ``(stop - start, *vshape)`` of torch
    ``dtype``.  No record: one empty block."""
    base, funcs, pred, split, vshape, n = fp
    if n == 0:
        yield 0, 0, torch.empty((0,) + vshape, dtype=dtype,
                                device=base.device)
        return
    yield from _chain_blocks(base, funcs, split,
                             _block_records(prod(vshape) * dtype.itemsize))


def _filter_values(fp, dtype):
    """The pending filter ``fp``'s mapped records, ``(n, *vshape)`` of
    torch ``dtype``, and the predicate's mask over them, both evaluated
    over the blocks of :func:`_filter_blocks` (the validity-bit tree of
    ``reduce`` needs every record at once): a chain longer than one block
    is written block by block into one tensor, with no second mapped
    tensor beside it."""
    base, funcs, pred, split, vshape, n = fp
    x = base.reshape((n,) + vshape) if not funcs else None
    masks = []
    for s, e, recs in _filter_blocks(fp, dtype):
        masks.append(_pred_mask(pred, recs))
        if funcs and e - s == n:
            x = recs
        elif funcs:
            if x is None:
                x = torch.empty((n,) + vshape, dtype=dtype,
                                device=base.device)
            x[s:e] = recs
        del recs        # free the block before the next one is mapped
    return x, torch.cat(masks)


def _masked_partial(slot, recs, mask, vshape, vdtype):
    """One block's part of the masked terminal ``slot``: the reduction of
    the block with dropped records on the identity, or the block's
    ``(Σx, Σx²)`` of the moment terminals."""
    name, axes, keepdims, _ = slot
    mfull = mask.reshape(mask.shape + (1,) * len(vshape))
    if name in _COMBINE:
        ident = torch.tensor(_identity(name, recs.dtype), device=recs.device
                             ).to(recs.dtype)
        return _reduce_stat(dtypes.where(mfull, recs, ident), name, axes,
                            keepdims, None, vdtype)
    out_dt = dtypes.stat_dtype(name, torch_dtype(vdtype))
    xf = dtypes.where(mfull, recs, torch.zeros((), dtype=recs.dtype,
                                               device=recs.device)).to(out_dt)
    return (xf.sum(dim=axes, keepdim=keepdims),
            (xf * xf).sum(dim=axes, keepdim=keepdims))


def _masked_final(slot, acc, count, vshape, vdtype):
    """The masked terminal ``slot`` from its folded partials: ``mean``/
    ``var``/``std`` divide by the kept COUNT (var as the one-pass moment
    form ``(Σx² − (Σx)²/n)/(n−ddof)``, as the reference's
    ``_masked_stat_expr``)."""
    name, axes, _, ddof = slot
    if name in _COMBINE:
        return acc
    out_dt = dtypes.stat_dtype(name, torch_dtype(vdtype))
    # the reduced VALUE axes are dense: only records are thinned
    s1, s2 = acc
    den = (count * prod([vshape[a - 1] for a in axes if a > 0])).to(out_dt)
    if name == "mean":
        return s1 / den
    out = (s2 - s1 * s1 / den) / (den - (0.0 if ddof is None else ddof))
    return torch.sqrt(out) if name == "std" else out


def _filter_partials(fp, vdtype, slots):
    """The partials of the masked terminals ``slots`` (``(name, axes,
    keepdims, ddof)``, ``axes`` holding the flat key axis 0) of the
    pending filter ``fp`` whose records have numpy dtype ``vdtype``, from
    one pass of the chain and the predicate over blocks:
    ``(accs, fused, count, any_kept)``.  ``sum`` and ``mean`` over the
    key axis of a chain that compiles run ``fused_map_reduce`` with the
    mask (a dropped record is not read; their partial is the masked sum,
    ``fused`` true); the others fold their block partials in block order.
    :func:`_filter_final` makes each terminal of its partial; a mesh
    folds the partials of its ranks in between.

    A chain the compiler has not seen is traced after the mask pass is
    queued, so the trace's host time overlaps the card's work; if it does
    not compile, the ``sum``/``mean`` slots take a second pass of
    partials (once: the compiler caches the answer)."""
    base, funcs, pred, split, vshape, n = fp
    cand = [base.is_contiguous() and s[0] in ("sum", "mean")
            and s[1] == (0,) for s in slots]
    vs = base.shape[split:]
    known = not any(cand) or mapexpr.compiled(funcs, vs, base.dtype)
    program = mapexpr.compile(funcs, vs, base.dtype) \
        if any(cand) and known else None
    # the slots whose partials the first pass folds: all but those that
    # run (or may run, when not known yet) fused_map_reduce
    first = [not c or (known and program is None) for c in cand]
    accs = [None] * len(slots)

    def fold(i, slot, recs, m):
        part = _masked_partial(slot, recs, m, vshape, vdtype)
        if accs[i] is None:
            accs[i] = part
        elif slot[0] in _COMBINE:
            accs[i] = _COMBINE[slot[0]](accs[i], part)
        else:
            accs[i] = tuple(a + p for a, p in zip(accs[i], part))

    masks, count = [], None
    for _, _, recs in _filter_blocks(fp, torch_dtype(vdtype)):
        m = _pred_mask(pred, recs) if recs.shape[0] else torch.zeros(
            0, dtype=torch.bool, device=recs.device)
        masks.append(m)
        c = m.sum(dtype=torch.int32)
        count = c if count is None else count + c
        for i, slot in enumerate(slots):
            if first[i] and not (slot[0] in ("max", "min") and not len(m)):
                fold(i, slot, recs, m)
        del recs
    if not known:
        program = mapexpr.compile(funcs, vs, base.dtype)
        if program is None:
            for k, (_, _, recs) in enumerate(_filter_blocks(
                    fp, torch_dtype(vdtype))):
                for i, slot in enumerate(slots):
                    if cand[i]:
                        fold(i, slot, recs, masks[k])
                del recs
    fused = [c and program is not None for c in cand]
    mask = torch.cat(masks) if len(masks) > 1 else masks[0]
    for i, slot in enumerate(slots):
        if fused[i]:
            accs[i] = kernels.fused_map_reduce_cols(
                base.reshape(n, prod(vshape)), program, mask).reshape(vshape)
    return accs, fused, count, mask.any()


def _filter_final(slot, acc, fused, count, any_kept, vshape, vdtype):
    """The masked terminal ``slot`` from its folded partial ``acc`` (of
    :func:`_filter_partials`), the kept ``count`` and whether any record
    was kept."""
    name, _, keepdims, _ = slot
    if name in ("max", "min") and not _engine.host_sync(
            "filter.any_kept", bool, any_kept):
        raise ValueError("zero-size array to reduction operation %s "
                         "which has no identity" % name)
    if not fused:
        return _masked_final(slot, acc, count, vshape, vdtype)
    r = acc
    if name == "mean":
        r = r / count.to(r.dtype)
    return r.reshape((1,) + vshape) if keepdims else r


def _filter_stats(fp, vdtype, slots):
    """The masked terminals ``slots`` of the pending filter ``fp`` (see
    :func:`_filter_partials`), in order."""
    accs, fused, count, any_kept = _filter_partials(fp, vdtype, slots)
    return [_filter_final(slot, accs[i], fused[i], count, any_kept,
                          fp[4], vdtype) for i, slot in enumerate(slots)]


def _chain_sum_plan(base, funcs, split, axes):
    """How ``sum`` of the chain ``funcs`` over ``base`` reads it through
    the ``fused_map_reduce`` kernel: ``(program, cols)``, the column form
    when ``axes`` are the key axes, the full form when they are every
    axis; ``None`` (the torch path) when the chain is empty or does not
    compile, the base is not contiguous or the axes are another set.  A
    plan decision, made before any launch."""
    if not funcs or not base.is_contiguous():
        return None
    cols = split > 0 and axes == tuple(range(split))
    if not cols and axes != tuple(range(base.ndim)):
        return None
    program = mapexpr.compile(funcs, tuple(base.shape[split:]), base.dtype)
    if program is None:
        return None
    return program, cols


def _chain_sum(base, funcs, split, axes):
    """``sum`` of the chain ``funcs`` over ``base`` through the
    ``fused_map_reduce`` kernel, reading the base once with no mapped
    temporary (:func:`_chain_sum_plan`), or ``None``."""
    plan = _chain_sum_plan(base, funcs, split, axes)
    if plan is None:
        return None
    program, cols = plan
    if not cols:
        return kernels.fused_map_reduce_program(base, program)
    vshape = tuple(base.shape[split:])
    n = prod(base.shape[:split])
    return kernels.fused_map_reduce_cols(
        base.reshape(n, prod(vshape)), program).reshape(vshape)


def _chain_sum_lanes(bases, funcs, split, axes):
    """:func:`_chain_sum` of each of ``bases`` (one shape and dtype, the
    lanes of a serve batched dispatch) as ``{lane: result}`` for the lanes
    the kernel plans for: one base launches the standalone entry, several
    one ``fused_map_reduce_lanes`` launch, whose lanes equal their
    standalone launches bit for bit.  The lanes left out take the torch
    path, as their standalone terminals do."""
    if len(bases) == 1:
        out = _chain_sum(bases[0], funcs, split, axes)
        return {} if out is None else {0: out}
    # the lanes share funcs, shape and dtype, so one plan serves the batch;
    # only contiguity is a lane's own
    idx = [i for i, b in enumerate(bases) if b.is_contiguous()]
    if not idx:
        return {}
    plan = _chain_sum_plan(bases[idx[0]], funcs, split, axes)
    if plan is None:
        return {}
    program, cols = plan
    vshape = tuple(bases[0].shape[split:])
    n = prod(bases[0].shape[:split])
    xs = [bases[i].reshape(n, prod(vshape)) if cols else bases[i]
          for i in idx]
    outs = kernels.fused_map_reduce_lanes(xs, program, cols=cols)
    return {i: (outs[j].reshape(vshape) if cols else outs[j])
            for j, i in enumerate(idx)}


def _chain_rec_bytes(base, split, shape, dtype):
    """Bytes of one record of the chain over ``base``: the larger of a
    base record and a mapped record (``shape`` of numpy ``dtype``)."""
    return max(prod(shape[split:]) * torch_dtype(dtype).itemsize,
               prod(base.shape[split:]) * base.element_size())


def _chain_values(base, funcs, split, shape, dtype, inplace=False):
    """The chain ``funcs`` applied to ``base``: the mapped tensor of
    ``shape`` and numpy ``dtype``.  A chain longer than one block (see
    ``_BLOCK_BYTES``) is written block by block of records into one
    tensor, so a chain of several ops holds one mapped tensor, not two;
    ``inplace`` (a donated base) lets that tensor be the base itself
    (:func:`_map_blocks`)."""
    if not funcs:
        return base
    n = prod(shape[:split])
    per = _block_records(_chain_rec_bytes(base, split, shape, dtype))
    if n == 0:
        return torch.empty(shape, dtype=torch_dtype(dtype),
                           device=base.device)
    if n <= per and not inplace:
        (_, _, recs), = _chain_blocks(base, funcs, split, per)
        return recs.reshape(shape)
    return _map_blocks(base, funcs, split, None, per, inplace)


def _wide(dtype):
    """The dtype a block partial accumulates in: f32 for the half
    floats, the carrier of an unsigned dtype torch leaves out, else
    ``dtype``."""
    if dtype in (torch.float16, torch.bfloat16):
        return torch.float32
    return dtypes.carrier(dtype)


def _block_partial(recs, name, dims, dtype):
    """One block's part of the stat terminal ``name`` over ``dims`` of the
    block ``recs`` (records of numpy ``dtype``): the reduction itself for
    ``min``/``max``/``any``/``all``, a wide sum or product, ``(count,
    Σx)`` for ``mean`` and ``(count, mean, M2)`` for ``var``/``std``."""
    out_dt = dtypes.stat_dtype(name, torch_dtype(dtype))
    if name in ("max", "min", "any", "all"):
        return _reduce_stat(recs, name, dims, False, None, dtype)
    acc = _wide(out_dt)
    if name == "sum":
        return torch.sum(dtypes.carry(recs), dim=dims, dtype=acc)
    if name == "prod":
        out = dtypes.carry(recs)
        for d in sorted(dims, reverse=True):
            out = torch.prod(out, dim=d, dtype=acc)
        return out
    x = recs.to(dtypes.inexact(recs.dtype))
    x = x.to(_wide(x.dtype))
    count = prod([recs.shape[d] for d in dims])
    if name == "mean":
        return count, torch.sum(x, dim=dims)
    var, mean = torch.var_mean(x, dim=dims, correction=0)
    return count, mean, var * count


def _fold_partials(name, a, b):
    """Two blocks' partials of ``name`` as one: the moment terminals by
    Chan's pairwise combine of ``(count, mean, M2)``."""
    if name in _COMBINE:
        return _COMBINE[name](a, b)
    if name == "mean":
        return a[0] + b[0], a[1] + b[1]
    (na, ma, qa), (nb, mb, qb) = a, b
    n = na + nb
    d = mb - ma
    d2 = d.real * d.real + d.imag * d.imag if d.is_complex() else d * d
    return n, ma + d * (nb / n), qa + qb + d2 * (na * nb / n)


def _final(name, acc, ddof, dtype):
    """The stat terminal ``name`` from its folded partials."""
    out_dt = dtypes.stat_dtype(name, torch_dtype(dtype))
    if name == "mean":
        acc = acc[1] / acc[0]
    elif name in ("var", "std"):
        n, _, q = acc
        # torch's rule: no fewer than zero degrees of freedom
        acc = q / max(0, n - (0 if ddof is None else ddof))
        if name == "std":
            acc = torch.sqrt(acc)
    return acc if acc.dtype == out_dt else acc.to(out_dt)


def _chain_stats(base, funcs, split, shape, dtype, slots):
    """The stat terminals ``slots`` (``(name, axes, keepdims, ddof)``;
    ``ptp`` is a group's ``max``/``min`` pair) of the chain ``funcs`` over
    ``base`` (mapped values of ``shape`` and numpy ``dtype``), in order,
    from one application of the chain.

    No chain, or one that fits one block (``_BLOCK_BYTES``): every slot
    reduces the mapped values whole with :func:`_reduce_stat`.  A longer
    chain is applied block by block of records and never held whole: a
    slot over every key axis folds its blocks' partials in block order,
    a slot over value axes only joins its blocks' results, and a slot
    over some key axes reduces the mapped values the loop writes into one
    tensor.  Grouped or not, a slot takes the same path, so a group's
    members equal their standalone terminals bit for bit."""
    if not slots:
        return []
    n = prod(shape[:split])
    rec = _chain_rec_bytes(base, split, shape, dtype) if funcs else 0
    if not funcs or n <= _block_records(rec):
        mapped = _chain_values(base, funcs, split, shape, dtype)
        return [_reduce_stat(mapped, name, axes, keepdims, ddof, dtype)
                for name, axes, keepdims, ddof in slots]
    keys = set(range(split))
    folded = [i for i, sl in enumerate(slots) if keys <= set(sl[1])]
    joined = [i for i, sl in enumerate(slots) if not keys & set(sl[1])]
    rest = [i for i in range(len(slots)) if i not in folded + joined]
    # the slots' axes in a block's terms: the flat key axis is 0
    dims = [tuple(([0] if i in folded else []) + [a - split + 1 for a in
                                                  sl[1] if a >= split])
            for i, sl in enumerate(slots)]
    mapped = torch.empty(shape, dtype=torch_dtype(dtype),
                         device=base.device) if rest else None
    accs, parts = {}, {i: [] for i in joined}
    for s, e, recs in _chain_blocks(base, funcs, split,
                                    _block_records(rec)):
        if rest:
            mapped.view((n,) + tuple(shape[split:]))[s:e] = recs
        for i in folded:
            p = _block_partial(recs, slots[i][0], dims[i], dtype)
            accs[i] = p if i not in accs else _fold_partials(
                slots[i][0], accs[i], p)
        for i in joined:
            name, _, keepdims, ddof = slots[i]
            parts[i].append(_reduce_stat(recs, name, dims[i], keepdims,
                                         ddof, dtype))
        del recs        # free the block before the next one is mapped
    out = []
    for i, (name, axes, keepdims, ddof) in enumerate(slots):
        oshape = tuple(1 if a in axes else d for a, d in enumerate(shape)
                       ) if keepdims else tuple(
            d for a, d in enumerate(shape) if a not in axes)
        if i in folded:
            out.append(_final(name, accs[i], ddof, dtype).reshape(oshape))
        elif i in joined:
            out.append(torch.cat(parts[i]).reshape(oshape))
        else:
            out.append(_reduce_stat(mapped, name, axes, keepdims, ddof,
                                    dtype))
    return out


def _chain_group_lanes(bases, funcs, split, shape, dtype, slots):
    """The stat ``slots`` (``(name, axes, keepdims, ddof)``) of the chain
    ``funcs`` over each of ``bases`` (mapped values of ``shape`` and numpy
    ``dtype``), as one tuple of results per base: a compiled ``sum``
    through ``fused_map_reduce`` (:func:`_chain_sum_lanes`, one launch for
    every lane), every other slot by :func:`_chain_stats` of the lane.
    The one body of a chain stat group's program (one base) and of a serve
    batched dispatch of such groups (``gpu/batched.py``, a base a lane),
    so each lane equals its standalone group bit for bit."""
    outs = [{} for _ in bases]
    for slot in slots:
        name, axes, keepdims, _ = slot
        if name != "sum":
            continue
        oshape = tuple(1 if a in axes else d for a, d in enumerate(shape)
                       ) if keepdims else tuple(
            d for a, d in enumerate(shape) if a not in axes)
        for i, r in _chain_sum_lanes(bases, funcs, split, axes).items():
            outs[i][slot] = r.reshape(oshape)
    for base, out in zip(bases, outs):
        rest = [s for s in slots if s not in out]
        out.update(zip(rest, _chain_stats(base, funcs, split, shape, dtype,
                                          rest)))
    return [tuple(out[s] for s in slots) for out in outs]


def _chain_stat(base, funcs, split, shape, dtype, name, axes, keepdims,
                ddof):
    """The stat terminal ``name`` over ``axes`` of the chain ``funcs``
    over ``base`` (mapped values of ``shape`` and numpy ``dtype``): a
    compiled chain's ``sum`` through ``fused_map_reduce``
    (:func:`_chain_sum`), everything else by :func:`_chain_stats`
    (``ptp`` as its ``max``/``min`` pair, as a group takes it)."""
    if name == "sum":
        out = _chain_sum(base, funcs, split, axes)
        if out is not None:
            if keepdims:
                out = out.reshape(tuple(1 if a in axes else d
                                        for a, d in enumerate(shape)))
            return out
    if name == "ptp":
        mx, mn = _chain_stats(base, funcs, split, shape, dtype,
                              [("max", axes, keepdims, None),
                               ("min", axes, keepdims, None)])
        return ufuncs.binary("subtract", mx, mn)
    return _chain_stats(base, funcs, split, shape, dtype,
                        [(name, axes, keepdims, ddof)])[0]


def _stat_program(name, funcs, base, split, shape, dtype, axes, keepdims,
                  ddof, donate, device):
    """The engine's program of the stat terminal ``name`` over ``axes``
    of the chain ``funcs`` over ``base`` (mapped values of ``shape`` and
    numpy ``dtype``): :func:`_chain_stat`, with a compiled chain's
    expression program traced at the build."""
    def build():
        if name == "sum" and funcs:
            mapexpr.compile(funcs, tuple(base.shape[split:]), base.dtype)

        def run(data):
            return _chain_stat(data, funcs, split, shape, dtype, name, axes,
                               keepdims, ddof)
        return run

    return _cached_jit(("stat", name, funcs, tuple(base.shape),
                        str(base.dtype), split, axes, keepdims, ddof, donate,
                        device), build)


def stat_axes(shape, split, axis):
    """The validated axes of a stat terminal over an array of ``shape``
    with ``split`` key axes (default: the key axes, or every axis without
    keys)."""
    if axis is None:
        return tuple(range(split)) if split else tuple(range(len(shape)))
    axes = tuple(sorted(tupleize(axis)))
    inshape(shape, axes)
    return axes


def stat_split(split, axes, keepdims):
    """The key axes left after reducing ``axes``."""
    return split if keepdims else split - sum(1 for a in axes if a < split)


def filter_axes(vshape, dtype, axis, name):
    """The axes of the masked terminal ``name`` of a pending filter with
    records of ``vshape`` and numpy ``dtype``, or NotImplemented for the
    geometries the masked form does not serve (the caller resolves the
    filter and takes the eager path): reductions that keep the key axis,
    ``ptp``, complex ``var``/``std``, axes out of range (the eager path
    rejects them)."""
    if axis is None:
        axes = (0,)                          # the flat key axis (split=1)
    else:
        axes = tuple(sorted(tupleize(axis)))
        if any(not 0 <= a <= len(vshape) for a in axes):
            return NotImplemented
    if 0 not in axes or name not in _FUSED_STAT_NAMES or (
            name in ("var", "std")
            and np.issubdtype(dtype, np.complexfloating)):
        return NotImplemented
    return axes


def _real(v):
    return torch.real(v) if v.is_complex() else v


def _imag(v):
    return torch.imag(v) if v.is_complex() else torch.zeros_like(v)


def _masked_tree(fp, dtype, func, keepdims):
    """The pairwise tree of ``reduce(func)`` over the pending filter
    ``fp`` (records of torch ``dtype``) with a validity bit per slot:
    combining a valid with an invalid slot keeps the valid operand, so
    dropped records (NaN too) never reach the result.  No survivor raises
    the empty-reduce ``TypeError``."""
    vshape = fp[4]
    x, valid = _filter_values(fp, dtype)

    def bc(m, like):
        return m.reshape(m.shape + (1,) * (like.ndim - 1))

    while x.shape[0] > 1:
        half = x.shape[0] // 2
        a, b = x[:half], x[half:2 * half]
        va, vb = valid[:half], valid[half:2 * half]
        comb = _user_call(func, (a, b), 1)
        if comb.shape != a.shape:
            raise ValueError("reduce produced shape %s, expected value "
                             "shape %s" % (tuple(comb.shape[1:]), vshape))
        # both valid: combined; one valid: that operand (the combined
        # slot may be garbage and is discarded)
        sel = dtypes.where(bc(va & vb, comb), comb,
                           dtypes.where(bc(va, comb), a, b))
        vsel = va | vb
        rem, vrem = x[2 * half:], valid[2 * half:]
        if rem.shape[0]:
            x = torch.cat([sel, rem], dim=0)
            valid = torch.cat([vsel, vrem], dim=0)
        else:
            x, valid = sel, vsel
    if not _engine.host_sync("filter.any_valid", bool, valid[0]):
        # every record was filtered out: the contract of reducing an
        # (0, ...)-shaped resolved result
        raise TypeError("reduce of an empty array with no initial value")
    out = x[0]
    if keepdims:
        out = out.reshape((1,) + vshape)
    return out


# the reductions a pending filter folds its mask into (reference:
# BoltArrayTPU._FUSED_STAT_NAMES)
_FUSED_STAT_NAMES = ("sum", "prod", "any", "all", "mean", "var", "std",
                     "max", "min")


class BoltArrayGPU(ArrayMethods, BoltArray):
    """n-d array on one ``torch.device``: key axes leading, value axes
    after them."""

    _mode = "gpu"
    # the mesh of ranks (gpu/mesharray.py :: BoltArrayMesh); None on one
    # device
    _mesh = None

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
        # lazy stat terminal (gpu/multistat.py): this array is the
        # unresolved result of a sum()/var()/... terminal, a PendingStat
        # of a group that resolves on the first read of any member
        self._spending = None
        # the live group of this array's stat terminals: later terminals
        # join it, so stats of one source share one application of its
        # chain (or one mask pass of its filter)
        self._stat_group = None
        self._donated = False
        self._shape = None if data is None else tuple(data.shape)
        self._dtype = None if data is None else numpy_dtype(data.dtype)

    @classmethod
    def _deferred(cls, base, funcs, split, device, shape, dtype):
        b = cls(None, split, device)
        b._chain = _Shared((base, tuple(funcs)), b)
        b._shape = tuple(shape)
        b._dtype = np.dtype(dtype)
        return b

    @classmethod
    def _streamed(cls, source):
        """Wrap a lazy :class:`bolt_tpu_torch.stream.StreamSource`:
        shape and dtype come from its recorded stages (behind a filter
        the shape is unknown until materialised), the streamed terminals
        run the executor, anything else materialises through ``_data``."""
        from bolt_tpu_torch import stream
        st = stream.result_state(source)
        b = cls(None, st.split, source.device)
        b._stream = source
        b._shape = None if st.dynamic else tuple(st.shape)
        b._dtype = st.dtype
        return b

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------

    @property
    def shape(self):
        if self._shape is None:
            # a consumed filter never learnt its survivor count
            self._guard_donated()
        if self._stream is not None and self._shape is None:
            # a streamed filter: the survivor count is unknown until the
            # source materialises
            self._data
        if self._fpending is not None:
            self._resolve_filter()
        return self._shape

    @property
    def dtype(self):
        h = self._spending
        # a lazy stat's dtype is its handle's (a reduced-precision group
        # sets it when it resolves)
        return self._dtype if h is None else h.dtype

    @property
    def split(self):
        """Number of leading key axes (reference: ``BoltArraySpark.split``)."""
        return self._split

    @property
    def device(self):
        """The ``torch.device`` holding the data (on a mesh, this rank's
        device)."""
        return self._device

    @property
    def mesh(self):
        """The mesh of ranks the array lives on (reference:
        ``BoltArrayTPU.mesh``), ``None`` on a single device
        (``gpu/mesharray.py`` holds the mesh half)."""
        return self._mesh

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
        # the chain and the pending filter are shared, and counted as
        # shared: neither wrapper's terminal may donate their base
        b._chain = self._chain
        b._fpending = self._fpending
        for shared in (b._chain, b._fpending):
            if isinstance(shared, _Shared):
                shared.share(b)
        # a stream source is shared: either wrapper materialising adopts
        # its own concrete tensor
        b._stream = self._stream
        # a pending stat is shared: either wrapper's first read resolves
        # the group once and both adopt the same result
        b._spending = self._spending
        b._stat_group = self._stat_group
        b._shape = self._shape
        b._dtype = self._dtype
        b._donated = self._donated
        return b

    def _consume_donated(self, op="a donating pipeline terminal",
                         granted=True):
        """Mark this array consumed by the donating operation ``op``: its
        chain's base was taken, so the chain can never run again — reads
        now raise :meth:`_guard_donated`, naming ``op``.  ``granted=False``
        records a consumption the caller asked for (``swap(donate=True)``)
        without counting it as a policy grant."""
        self._chain = None
        self._concrete = None
        self._fpending = None
        self._donated = op
        if granted:
            _engine.donation_granted()

    def _guard_donated(self):
        """THE donation gate: every read of this array's device state
        goes through here; a consumed array raises, naming the
        terminal that consumed it."""
        if self._donated:
            _obs.event("array.donated_read", op=self._donated)
            raise RuntimeError(
                "this array's device buffer was donated to %s and can no "
                "longer be read (donating terminals consume a sole-owned "
                "array; scope bolt_tpu_torch.engine.donation(None) to keep "
                "sources readable)" % self._donated)

    def _adopt_materialised(self, data):
        """Adopt ``data`` as this array's materialised value: the scatter
        half of a serve batched dispatch (``gpu/batched.py``), whose lane
        is what the standalone ``("chain", ...)`` program would have
        produced, or an in-place ``sort`` (``gpu/methods.py``); any chain
        simply retires."""
        self._concrete = data
        self._shape = tuple(data.shape)
        self._chain = None

    def _adopt_resolved(self, res):
        """Adopt ``res``, the result of resolving this stream's swap stages
        (``stream.resolve_swaps``): still streaming over spilled buckets,
        or concrete (resident), possibly a deferred chain or a pending
        filter of the stages after the swap.  It IS this array's value,
        so the identity moves onto it and later terminals see a swap-free
        source."""
        self._stream = res._stream
        self._concrete = res._concrete
        self._chain = None if res._chain is None else _Shared(
            tuple(res._chain), self)
        self._fpending = None if res._fpending is None else _Shared(
            tuple(res._fpending), self)
        self._split = res._split
        self._shape = res._shape
        self._dtype = res._dtype

    @property
    def _data(self):
        """The concrete tensor; materialises (and keeps) a deferred chain."""
        self._guard_donated()
        if self._spending is not None:
            self._resolve_spending()
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
            self._shape = tuple(data.shape)
            return data
        if self._concrete is None:
            self._materialise()
        return self._concrete

    def _materialise(self):
        """The chain-materialising terminal: one engine program applying
        the chain block by block.  A donated base takes the result in its
        own storage when the record shape and dtype are unchanged; else
        the base is dropped once read."""
        _engine.strict_guard(self, "map-chain materialisation")
        donate = _chain_donate_ok(self._chain)    # before binding the base
        base, funcs = self._chain
        split, shape, dtype = self._split, self._shape, self._dtype

        def build():
            def run(data):
                return _chain_values(data, funcs, split, shape, dtype,
                                     donate)
            return run

        fn = _cached_jit(("chain", funcs, tuple(base.shape), str(base.dtype),
                          split, donate, self._device), build)
        with _obs.span("array.chain", funcs=len(funcs), donate=donate,
                       bytes=base.numel() * base.element_size()):
            self._concrete = fn(base)
        self._chain = None
        if donate:
            _engine.donation_granted()

    def _resolve_spending(self):
        """Adopt the result of this array's lazy stat terminal, resolving
        its group (every member of it at once) on first need."""
        h = self._spending
        if h.result is None:
            h.group.resolve()
        self._concrete = h.result
        self._shape = tuple(h.result.shape)
        self._dtype = h.dtype
        self._spending = None

    def _chain_parts(self):
        """``(base tensor, funcs)`` of this array: the deferred chain, or
        the concrete data and no func."""
        return self._chain if self.deferred else (self._data, ())

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
                _raise_callable_bug("map", func, exc, vshape)
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
        fallback with a :class:`HostFallbackWarning`.  On a streamed
        source the predicate stays lazy, a trailing stage of the stream:
        its ``sum``/``mean``/``var``/``std`` fold the mask slab by slab,
        and any other consumer materialises it."""
        func = _traceable(func)
        axes = sorted(tupleize(axis))
        aligned = self._align(axes)
        split = aligned._split
        vshape = tuple(aligned.shape[split:])
        n = prod(aligned.shape[:split])
        try:
            pshape = _infer_pred(func, vshape, torch_dtype(aligned.dtype))
        except (RuntimeError, TypeError) as exc:
            if not _is_trace_error(exc):
                _raise_callable_bug("filter", func, exc, vshape)
            _warn_fallback("filter", func, exc)
            local = aligned.tolocal().filter(func, axis=tuple(range(split)))
            return self._wrap(_upload(np.asarray(local), self._device), 1)
        if prod(pshape) != 1:
            raise ValueError(
                "filter predicate must return a scalar truth value per "
                "record; got shape %s for value shape %s"
                % (pshape, vshape))
        if aligned._stream is not None:
            from bolt_tpu_torch import stream
            return stream.filter_stage(aligned, func)
        if aligned.deferred:
            base, funcs = aligned._chain
        else:
            base, funcs = aligned._data, ()
        out = BoltArrayGPU(None, 1, self._device)
        out._fpending = _Shared((base, funcs, func, split, vshape, n), out)
        out._dtype = aligned.dtype
        return out

    def _resolve_filter(self):
        """Run the pending filter block by block (the chain and the
        predicate under ``vmap`` over about ``_BLOCK_BYTES`` of
        mapped records), gathering each block's survivor rows.  A donated
        base is dropped once the survivors are gathered."""
        self._guard_donated()
        _engine.strict_guard(self, "filter() compaction")
        donate = _chain_donate_ok(self._fpending)   # [0] is the base
        geom = tuple(self._fpending[1:])
        dtype = torch_dtype(self._dtype)

        def build():
            def run(data):
                fp = (data,) + geom
                parts = [_engine.host_sync("filter.rows", dtypes.rows,
                                           recs, _pred_mask(fp[2], recs))
                         if recs.shape[0] else recs
                         for _, _, recs in _filter_blocks(fp, dtype)]
                return torch.cat(parts) if len(parts) > 1 else parts[0]
            return run

        base = self._fpending[0]
        fn = _cached_jit(("filter-fused", geom[1], geom[0],
                          tuple(base.shape), str(base.dtype), geom[2],
                          donate, self._device), build)
        with _obs.span("array.filter", funcs=len(geom[0]), donate=donate):
            self._concrete = fn(base)
        self._shape = tuple(self._concrete.shape)
        self._fpending = None
        if donate:
            _engine.donation_granted()

    def _fused_filter_stat(self, axis, name, keepdims, ddof):
        """Single-pass ``filter(...).sum()``-family terminal (reference:
        ``BoltArrayTPU._fused_filter_stat``): the predicate's mask folds
        into the reduction, so no survivor tensor is gathered and no pass
        holds more than a block of mapped records (:func:`_filter_stats`).
        Returns NotImplemented for the geometries :func:`filter_axes`
        refuses."""
        axes = filter_axes(self._fpending[4], self.dtype, axis, name)
        if axes is NotImplemented:
            return NotImplemented
        self._guard_donated()
        donate = _chain_donate_ok(self._fpending)   # [0] is the base
        geom = tuple(self._fpending[1:])
        dtype = self.dtype
        slots = ((name, axes, keepdims, ddof),)

        def build():
            def run(data):
                return _filter_stats((data,) + geom, dtype, slots)[0]
            return run

        base = self._fpending[0]
        fn = _cached_jit(("filter-stat", name, geom[1], geom[0],
                          tuple(base.shape), str(base.dtype), geom[2], axes,
                          keepdims, ddof, donate, self._device), build)
        try:
            with _obs.span("array.filter_stat", op=name,
                           funcs=len(geom[0]), donate=donate):
                out = fn(base)
        finally:
            if donate:
                # the terminal read the base: a zero-size raise leaves this
                # array guarded, not pointing at a dropped base
                del base
                self._consume_donated("filter().%s()" % name)
        return self._wrap(out, 1 if keepdims else 0)

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
        vshape, n = self._fpending[4], self._fpending[5]
        if n == 0:
            raise TypeError("reduce of an empty array with no initial value")
        try:
            _check_reducer(func, vshape, torch_dtype(self.dtype))
        except (RuntimeError, TypeError) as exc:
            if not _is_trace_error(exc):
                _raise_callable_bug("reduce", func, exc, vshape)
            return NotImplemented        # the host fallback path resolves
        self._guard_donated()
        donate = _chain_donate_ok(self._fpending)   # [0] is the base
        geom = tuple(self._fpending[1:])
        dtype = torch_dtype(self.dtype)

        def build():
            def run(data):
                return _masked_tree((data,) + geom, dtype, func, keepdims)
            return run

        base = self._fpending[0]
        fn = _cached_jit(("filter-reduce", func, geom[1], geom[0],
                          tuple(base.shape), str(base.dtype), geom[2],
                          keepdims, donate, self._device), build)
        try:
            out = fn(base)
        finally:
            if donate:
                # before the zero-survivor raise: the base was read, so
                # this array must carry the guard
                del base
                self._consume_donated("filter().reduce()")
        return self._wrap(out, 1 if keepdims else 0)

    def reduce(self, func, axis=(0,), keepdims=False):
        """Fixed-order pairwise tree reduction over the key axes (reference:
        ``BoltArrayTPU.reduce``): each round vmaps the binary ``func`` over
        half the records, in the local oracle's order.  A deferred map
        chain on the input is applied first."""
        func = _traceable(func)
        _engine.strict_guard(self, "reduce()")
        if self._fpending is not None:
            # a pending filter feeding the reduce: fold the predicate into
            # the pairwise tree (NotImplemented geometries resolve)
            out = self._fused_filter_reduce(func, axis, keepdims)
            if out is not NotImplemented:
                return out
        axes = sorted(tupleize(axis))
        # the lazy door while a batching server is armed
        # (gpu/multistat.py :: defer_reduce): a reduce over every key axis
        # of a chain defers as a pending handle the serve scheduler can
        # coalesce; read alone it runs this terminal's own program.
        # NotImplemented takes the eager path below.
        from bolt_tpu_torch.gpu import multistat
        out = multistat.defer_reduce(self, func, tuple(axes), keepdims)
        if out is not NotImplemented:
            return out
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
            _check_reducer(func, vshape, torch_dtype(aligned.dtype))
        except (RuntimeError, TypeError) as exc:
            if not _is_trace_error(exc):
                _raise_callable_bug("reduce", func, exc, vshape)
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
        aligned._guard_donated()
        # donating terminal: a sole-owned chain's base is dropped once the
        # tree has read it (checked before the base local exists)
        donate = aligned.deferred and _chain_donate_ok(aligned._chain)
        base, funcs = aligned._chain_parts()
        fn = _cached_jit(("reduce", func, funcs, tuple(base.shape),
                          str(base.dtype), split, keepdims, donate,
                          self._device),
                         lambda: _reduce_program(func, funcs, split, n,
                                                 vshape, keepdims))
        with _obs.span("array.reduce", funcs=len(funcs), donate=donate):
            out = fn(base)
        if donate:
            del base
            aligned._consume_donated("reduce()")
        return self._wrap(out, new_split)

    # ------------------------------------------------------------------
    # statistics: eager torch reductions with numpy's output dtypes
    # ------------------------------------------------------------------

    def _stat(self, axis, name, keepdims=False, ddof=None):
        _engine.strict_guard(self, "%s()" % name)
        # the lazy door (gpu/multistat.py): the stat defers as a pending
        # member of this source's group; validation stays here, at the
        # call.  NotImplemented takes the eager paths below (streams,
        # zero-size extrema, geometries a group does not serve).
        from bolt_tpu_torch.gpu import multistat
        out = multistat.defer_stat(self, axis, name, keepdims, ddof)
        if out is not NotImplemented:
            return out
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
        axes = stat_axes(self.shape, self._split, axis)
        if name in ("max", "min", "ptp") and \
                prod([self.shape[a] for a in axes]) == 0:
            raise ValueError("zero-size array to reduction operation %s "
                             "which has no identity" % name)
        self._guard_donated()
        # donating terminal (checked before the base local exists)
        donate = self.deferred and _chain_donate_ok(self._chain)
        base, funcs = self._chain_parts()
        fn = _stat_program(name, funcs, base, self._split, self.shape,
                           self.dtype, axes, keepdims, ddof, donate,
                           self._device)
        with _obs.span("array.stat", op=name, funcs=len(funcs),
                       donate=donate):
            out = fn(base)
        if donate:
            del base
            self._consume_donated("%s()" % name)
        return self._wrap(out, stat_split(self._split, axes, keepdims))

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

    def stats(self, *requested, axis=None, accumulate=None, **kwargs):
        """Statistics in one pass, two forms (reference:
        ``BoltArrayTPU.stats``):

        * ``stats()`` / ``stats(("mean", "var"))`` / ``stats(requested=...,
          axis=...)``: a :class:`~bolt_tpu_torch.statcounter.StatCounter`
          of value-shaped moments (``gpu/stats.py :: welford``, whose
          default geometry runs the ``fused_welford`` kernel), the legacy
          positional ``stats(requested[, axis])`` too;
        * ``stats("sum", "var", "min", ...)``: the fused stat group
          (``gpu/multistat.py``), an ordered ``{name: array}`` dict, each
          array equal to its standalone terminal; ``accumulate`` opts the
          additive terminals into reduced precision (see
          :func:`bolt_tpu_torch.compute`)."""
        if requested and all(isinstance(r, str) for r in requested):
            from bolt_tpu_torch.gpu.multistat import fluent_stats
            return fluent_stats(self, requested, axis=axis,
                                accumulate=accumulate)
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
    # elementwise operators and numpy's ufuncs: a scalar operand joins
    # the map chain (gpu/ufuncs.py holds the ops and their dtype rules)
    # ------------------------------------------------------------------

    def _apply(self, fn):
        """``fn`` per record: joins the map chain over the key axes, or
        runs at once on a key-less array."""
        if self._split == 0:
            return self._wrap(fn(self._data), 0)
        return self.map(fn, axis=tuple(range(self._split)))

    def _unary(self, name):
        return self._apply(ufuncs.unary_fn(name, torch_dtype(self.dtype)))

    def _operand(self, other):
        """A non-scalar operand as a tensor on this array's device."""
        if isinstance(other, BoltArrayGPU):
            check_mesh(self, other, "elementwise")
            if other._device != self._device:
                raise ValueError(
                    "operands live on different devices (%s vs %s); move "
                    "one explicitly first" % (self._device, other._device))
            return other._data
        if isinstance(other, BoltArray):
            return _upload(other.toarray(), self._device)
        if isinstance(other, torch.Tensor):
            return other.to(self._device)
        return _upload(np.asarray(other), self._device)

    def _elementwise(self, other, name, reverse=False):
        if isinstance(other, (int, float, complex, np.number, np.bool_)):
            return self._apply(ufuncs.scalar_fn(
                name, other, reverse, torch_dtype(self.dtype)))
        odata = self._operand(other)
        # numpy broadcasting is symmetric: keys survive while they remain
        # the leading axes with unchanged lengths
        out_shape = np.broadcast_shapes(self.shape, tuple(odata.shape))
        split = self._split
        if out_shape != self.shape and (
                len(out_shape) != self.ndim
                or out_shape[:split] != self.shape[:split]):
            split = 0
        x = self._data
        out = ufuncs.binary(name, odata, x) if reverse \
            else ufuncs.binary(name, x, odata)
        return self._wrap(out, split)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """numpy's ufuncs on this array (reference:
        ``BoltArrayTPU.__array_ufunc__``): ``__call__`` of a one- or
        two-input ufunc with a torch twin joins the map chain like the
        operators (``np.exp(b)``, ``np.add(x, b)``), ``np.matmul`` is
        ``@``, and the methods ``reduce``/``accumulate``/``outer``/
        ``reduceat`` run on the device.  ``out=``, a masking ``where=``,
        ``at``, multi-output ufuncs and ufuncs with no torch twin return
        NotImplemented, so numpy raises ``TypeError`` (never a silent
        copy to the host)."""
        if method in ("reduce", "accumulate", "outer", "reduceat"):
            from bolt_tpu_torch.gpu.methods import ufunc_method
            return ufunc_method(self, ufunc, method, inputs, kwargs)
        if method != "__call__" or kwargs or ufunc.nout != 1 \
                or len(inputs) not in (1, 2):
            return NotImplemented
        name = ufunc.__name__
        if name == "matmul" and len(inputs) == 2:
            a, b = inputs
            return self._matmul(b if a is self else a, reverse=a is not self)
        if not ufuncs.has(name, len(inputs)):
            return NotImplemented
        if len(inputs) == 1:
            return self._unary(name)
        a, b = inputs
        if a is self:
            return self._elementwise(b, name)
        return self._elementwise(a, name, reverse=True)

    def __array_function__(self, func, types, args, kwargs):
        """numpy's non-ufunc functions on this array (reference:
        ``BoltArrayTPU.__array_function__``): ``np.sum(b)``,
        ``np.histogram(b)``, ``np.cov(b)`` and the rest of
        :mod:`bolt_tpu_torch.gpu.npdispatch`'s table run on the card with
        numpy's semantics and return bolt arrays; any other function
        copies the operands to the host and runs numpy (warning above
        ``IMPLICIT_GATHER_WARN_BYTES``)."""
        from bolt_tpu_torch.gpu import npdispatch
        return npdispatch.dispatch(func, types, args, kwargs)

    def __add__(self, other):
        return self._elementwise(other, "add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._elementwise(other, "subtract")

    def __rsub__(self, other):
        return self._elementwise(other, "subtract", reverse=True)

    def __mul__(self, other):
        return self._elementwise(other, "multiply")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._elementwise(other, "true_divide")

    def __rtruediv__(self, other):
        return self._elementwise(other, "true_divide", reverse=True)

    def __pow__(self, other):
        return self._elementwise(other, "power")

    def __rpow__(self, other):
        return self._elementwise(other, "power", reverse=True)

    def __mod__(self, other):
        return self._elementwise(other, "remainder")

    def __rmod__(self, other):
        return self._elementwise(other, "remainder", reverse=True)

    def __floordiv__(self, other):
        return self._elementwise(other, "floor_divide")

    def __rfloordiv__(self, other):
        return self._elementwise(other, "floor_divide", reverse=True)

    def __matmul__(self, other):
        return self._matmul(other)

    def __rmatmul__(self, other):
        return self._matmul(other, reverse=True)

    # in-place forms rebind to a new array (device tensors are not
    # mutated; other references to the old array keep its values)
    __iadd__ = __add__
    __isub__ = __sub__
    __imul__ = __mul__
    __itruediv__ = __truediv__
    __ifloordiv__ = __floordiv__
    __ipow__ = __pow__
    __imod__ = __mod__
    __imatmul__ = __matmul__

    def __neg__(self):
        # a bool array refuses, like numpy's and jnp's negative
        return self._unary("negative")

    def __abs__(self):
        return self._unary("absolute")

    def __lt__(self, other):
        return self._elementwise(other, "less")

    def __le__(self, other):
        return self._elementwise(other, "less_equal")

    def __gt__(self, other):
        return self._elementwise(other, "greater")

    def __ge__(self, other):
        return self._elementwise(other, "greater_equal")

    def __eq__(self, other):
        try:
            return self._elementwise(other, "equal")
        except (TypeError, ValueError, RuntimeError):
            # an operand that does not compare elementwise (None, a
            # sentinel): Python falls back to identity
            return NotImplemented

    def __ne__(self, other):
        try:
            return self._elementwise(other, "not_equal")
        except (TypeError, ValueError, RuntimeError):
            return NotImplemented

    # elementwise == makes the array unhashable, as an ndarray is
    __hash__ = None

    def clip(self, min=None, max=None, a_min=None, a_max=None):
        """Bound values to ``[min, max]`` (``ndarray.clip``'s keywords;
        ``a_min``/``a_max`` as aliases): ``maximum(min)`` then
        ``minimum(max)``, numpy's order (the upper bound wins when
        ``min > max``), so scalar bounds join the map chain and array
        bounds broadcast like operands."""
        if a_min is not None:
            if min is not None:
                raise ValueError("pass min= or a_min=, not both")
            min = a_min
        if a_max is not None:
            if max is not None:
                raise ValueError("pass max= or a_max=, not both")
            max = a_max
        if min is None and max is None:
            raise ValueError("clip needs at least one of min/max")
        out = self
        if min is not None:
            out = out._elementwise(min, "maximum")
        if max is not None:
            out = out._elementwise(max, "minimum")
        return out

    def round(self, decimals=0):
        """Round to ``decimals`` places, halves to even (``jnp.round``)."""
        from numbers import Integral
        if not isinstance(decimals, Integral):
            raise TypeError("decimals must be an integer, got %r"
                            % (decimals,))
        return self._apply(ufuncs.round_fn(int(decimals)))

    @property
    def real(self):
        """Real part (elementwise; joins the map chain)."""
        return self._apply(_real)

    @property
    def imag(self):
        """Imaginary part, zeros of the same dtype for real input."""
        return self._apply(_imag)

    def conj(self):
        """Elementwise complex conjugate (identity for real dtypes)."""
        return self._unary("conjugate")

    conjugate = conj

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
        if self._stream is not None:
            # a stream records the swap as a lazy stage, which the
            # consuming terminal resolves by the two-phase shuffle;
            # NotImplemented (behind a filter, under a lossy codec)
            # materialises below
            from bolt_tpu_torch import stream
            out = stream.swap_stage(self, tuple(perm), new_split)
            if out is not NotImplemented:
                return out
        self._guard_donated()
        _engine.strict_guard(self, "swap()")
        base, funcs = self._chain_parts()

        def build():
            def run(data):
                return _chain_apply(funcs, split, data).permute(
                    perm).contiguous()
            return run

        fn = _cached_jit(("swap", funcs, tuple(base.shape), str(base.dtype),
                          split, tuple(perm), self._device), build)
        with _obs.span("array.swap", funcs=len(funcs),
                       bytes=base.numel() * base.element_size()):
            out = fn(base)
        if donate:
            del base
            self._consume_donated("swap(..., donate=True)", granted=False)
        return self._wrap(out, new_split)

    def stacked(self, size=1000):
        """Batch flat key records into blocks of ``size`` (reference:
        ``BoltArrayTPU.stacked``); returns a
        :class:`~bolt_tpu_torch.gpu.stack.StackedArray` view."""
        from bolt_tpu_torch.gpu.stack import StackedArray
        return StackedArray.stack(self, size=size)

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
        axes = self._transpose_axes(axes)
        if axes == tuple(range(self.ndim)):
            return self
        return self._wrap(self._data.permute(axes), self._split)

    def _transpose_axes(self, axes):
        """``transpose``'s argument checked: a permutation that keeps the
        key axes among themselves."""
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
        return tuple(int(a) for a in axes)

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

    def __array__(self, dtype=None, copy=None):
        """The host copy numpy asks for (``np.asarray(b)``,
        ``np.allclose(b, x)``): :meth:`toarray` in this array's dtype, or
        cast to ``dtype``.  A copy is always made, so ``copy=False``
        raises as numpy 2 asks; above ``IMPLICIT_GATHER_WARN_BYTES`` the
        first such copy of the process warns."""
        if copy is False:
            raise ValueError("a device array cannot be viewed as a host "
                             "array without a copy")
        implicit_gather_warning(self.size * self.dtype.itemsize)
        a = self.toarray()
        return a if dtype is None else a.astype(dtype, copy=False)

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
        reference's ``tojax``.  On a mesh it is this rank's box (the
        reference's sharded array addresses this process's shards);
        ``toarray`` gathers the whole array."""
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

        def cast(v):
            return v.to(target)
        return self._apply(cast)

    def cache(self):
        """Materialise a deferred chain and keep the result."""
        self._data
        return self

    def unpersist(self):
        """Counterpart of :meth:`cache`; the caching allocator owns the
        memory, so this is a no-op kept for parity."""
        return self

    def repartition(self, npartitions):
        """Accepted for parity: one card holds one partition."""
        return self

    def concatenate(self, arry, axis=0):
        """Concatenate with another array along ``axis`` (reference:
        ``BoltArrayTPU.concatenate``); the result keeps this array's
        split."""
        from bolt_tpu_torch.gpu.construct import ConstructGPU
        return ConstructGPU.concatenate((self, arry), axis=int(axis))

    def __repr__(self):
        s = "BoltArray\n"
        s += "mode: %s\n" % self.mode
        if self._fpending is not None:
            # don't run the filter just to print; show what is known
            s += "shape: (%s)\n" % ", ".join(
                ["?"] + [str(d) for d in self._fpending[4]])
        elif self._stream is not None and self._shape is None:
            from bolt_tpu_torch import stream
            s += "shape: (%s)\n" % ", ".join(
                ["?"] + [str(d) for d in
                         stream.result_state(self._stream).vshape])
        else:
            # a consumed array shows what it recorded, never the guard
            s += "shape: %s\n" % str(self._shape if self._donated
                                      else self.shape)
        s += "split: %d\n" % self._split
        s += "dtype: %s\n" % str(self.dtype)
        s += "device: %s\n" % str(self._device)
        if self._donated:
            s += "donated: buffer consumed by %s\n" % self._donated
        elif self._stream is not None:
            s += "streaming: %r\n" % (self._stream,)
        elif self.deferred:
            s += "deferred: %d-op map chain\n" % len(self._chain[1])
        elif self._spending is not None:
            s += "pending: lazy %s() terminal (its group is not resolved " \
                 "yet)\n" % self._spending.name
        elif self._fpending is not None:
            s += "pending: deferred filter (predicate not yet run)\n"
        return s


def check_mesh(a, b, what):
    """Binary operands of which one lies on a mesh of more than one rank
    share that mesh (reference: ``BoltArrayTPU._check_mesh``): moving a
    foreign array onto it would hide a data move."""
    ma, mb = getattr(a, "_mesh", None), getattr(b, "_mesh", None)
    if ma == mb or all(m is None or m.size == 1 for m in (ma, mb)):
        return
    shape = [None if m is None else tuple(m.sizes) for m in (ma, mb)]
    raise ValueError(
        "%s operands live on different meshes (%s vs %s); move one "
        "explicitly first, e.g. other.tolocal().togpu(context=self.mesh) "
        "or bolt_tpu_torch.parallel.reshard" % (what, shape[0], shape[1]))


# np.asarray(b) above this many bytes warns once a process: a silent copy
# of a large device array to the host is the easiest way to lose the card
IMPLICIT_GATHER_WARN_BYTES = 64 << 20
_gather_warned = []


def implicit_gather_warning(nbytes):
    """Warn, once a process, when numpy implicitly copies ``nbytes`` of a
    device array to the host (reference:
    ``npdispatch.implicit_gather_warning``)."""
    if _gather_warned or nbytes < IMPLICIT_GATHER_WARN_BYTES:
        return
    _gather_warned.append(True)
    warnings.warn(
        "a %.0f MB device array is being implicitly copied to the host "
        "(e.g. np.asarray(b)); use bolt methods to stay on the device, or "
        "call .toarray() to make the transfer explicit"
        % (nbytes / float(1 << 20)), stacklevel=3)


# device-memory limit of hbm_check: an explicit override, else
# BOLT_HBM_BYTES, else the card's own report (torch.cuda.mem_get_info,
# read once per card), else an ASSUMED 80 GB H100 (warn-only).  A CPU
# device has no limit here.
_HBM_LIMIT_OVERRIDE = None
_ASSUMED_HBM_BYTES = 80 << 30
_HBM_DEVICE_REPORT = {}


def _hbm_limit(device=None):
    """``(bytes, known)``: the device-memory budget of ``device`` and
    whether it is known (configured or reported) or assumed; ``(None,
    False)`` on the CPU."""
    import os
    if _HBM_LIMIT_OVERRIDE is not None:
        return int(_HBM_LIMIT_OVERRIDE), True
    env = os.environ.get("BOLT_HBM_BYTES")
    if env:
        return int(env), True
    if device is None or torch.device(device).type != "cuda":
        return None, False
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _HBM_DEVICE_REPORT:
        try:
            report = (int(torch.cuda.mem_get_info(idx)[1]), True)
        except Exception:
            report = (_ASSUMED_HBM_BYTES, False)
        _HBM_DEVICE_REPORT[idx] = report
    return _HBM_DEVICE_REPORT[idx]


def hbm_check(op, need_bytes, model, device=None):
    """Fail fast (or warn, when the limit is only assumed) when ``op``'s
    estimated device demand ``need_bytes`` on ``device`` cannot fit
    (reference: ``bolt_tpu/tpu/array.py :: hbm_check``).  ``model`` is
    the memory model shown in the message ("input + output + sort
    scratch")."""
    limit, known = _hbm_limit(device)
    if limit is None or need_bytes <= limit:
        return
    msg = ("%s needs ~%.1f GB of device memory (%s) but the device "
           "holds %.1f GB" % (op, need_bytes / float(1 << 30), model,
                              limit / float(1 << 30)))
    if known:
        raise MemoryError(msg)
    from bolt_tpu_torch.base import HBMPressureWarning
    warnings.warn(msg + "; this limit is ASSUMED (the card did not report "
                  "its capacity) — set BOLT_HBM_BYTES to the card's memory "
                  "size for an exact up-front check", HBMPressureWarning,
                  stacklevel=3)


def _upload(a, device):
    """A numpy array as a tensor on ``device`` (a copy: the caller's array
    never aliases the bolt array)."""
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _download(t):
    """A tensor as a host numpy array that aliases nothing (a counted
    synchronisation: :func:`bolt_tpu_torch.engine.host_sync`)."""
    return _engine.host_sync("download", t.detach().to, "cpu",
                             copy=True).numpy()
