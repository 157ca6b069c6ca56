"""Result dtypes of the gpu mode: jnp's promotion rule, as a table.

The reference's device mode computes with ``jax.numpy`` under the x64
setting its tests run with, so its result dtypes follow jnp's type
promotion, not numpy's (the local mode keeps numpy's, as the reference's
local mode does).  This module holds that rule for the operand kinds the
port takes, with no jax import:

* the promotion lattice of ``jax._src.dtypes`` over bool, int8–int64,
  uint8–uint64, f16/bf16/f32/f64 and complex64/128, plus the weakly typed
  Python scalars ``i*`` (int), ``f*`` (float) and ``c*`` (complex).  A
  result that stays weak takes the x64 default (int64, float64,
  complex128); numpy scalars are strongly typed;
* jnp's ``to_inexact`` table behind ``/`` and ``mean``/``var``/``std``:
  bool and integers up to 32 bits → float32, int64/uint64 → float64.

So ``int32 * 2.5`` is float64 (weak float), but ``int32 / 2`` and
``int32 + np.float32(1.5)`` are float32, and the mean of int32 is float32.
``var``/``std`` of a complex array are real (float32 for complex64).

torch leaves out most kernels of ``uint16``, ``uint32`` and ``uint64``
(``add``, the comparisons, ``amax``, ``cumsum``, ...).  Those dtypes
compute in a signed CARRIER (:func:`carry`) and hand the reference's
dtype back (:func:`uncarry`): ``uint16`` widens to int32 and ``uint32``
to int64 by value; ``uint64`` is read as int64 bits, which wrap alike
for ``+``, ``-`` and ``*``, and for an ordering (comparisons,
``min``/``max``, sorts, ``argmax``, ``clip``) its sign bit is flipped
so that the signed order is the unsigned one.

Inside a user callable the rules are torch's, not jnp's (a callable
is torch code): an ``int32`` record minus ``0.25`` is float32 there,
where the reference gives float64, and ``Tensor.mean()`` refuses an
integer record, so ``filter(lambda v: v.mean() > 0)`` raises on an
integer array.  A callable on unsigned records runs on the records'
own dtype; where torch has no kernel for it, it runs on their carriers
under :class:`CarrierMode`, which gives each op torch's result for the
unsigned values: ``(v - 5) // 2`` of a ``uint16`` 0 is 32765, as in
numpy.  An op on a ``uint64`` record that its int64 carrier cannot do
exactly (a division, a right shift, a conversion to float) raises
``TypeError`` there instead.
"""

import weakref
from functools import lru_cache

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_unflatten

# each node and the nodes directly above it (jax._src.dtypes
# _type_promotion_lattice, with numpy-style names)
_LATTICE = {
    "b1": ("i*",),
    "i*": ("u1", "i1"),
    "u1": ("i2", "u2"), "u2": ("i4", "u4"), "u4": ("i8", "u8"),
    "u8": ("f*",),
    "i1": ("i2",), "i2": ("i4",), "i4": ("i8",), "i8": ("f*",),
    "f*": ("c*", "bf16", "f2"),
    "bf16": ("f4",), "f2": ("f4",), "f4": ("f8", "c8"), "f8": ("c16",),
    "c*": ("c8",), "c8": ("c16",), "c16": (),
}

_TORCH = {
    "b1": torch.bool, "u1": torch.uint8, "u2": torch.uint16,
    "u4": torch.uint32, "u8": torch.uint64, "i1": torch.int8,
    "i2": torch.int16, "i4": torch.int32, "i8": torch.int64,
    "bf16": torch.bfloat16, "f2": torch.float16, "f4": torch.float32,
    "f8": torch.float64, "c8": torch.complex64, "c16": torch.complex128,
    # weak kinds that stay weak: the x64 defaults
    "i*": torch.int64, "f*": torch.float64, "c*": torch.complex128,
}
_NODE = {v: k for k, v in _TORCH.items() if not k.endswith("*")}

# jnp's to_inexact: bool and integers up to 32 bits widen to float32,
# 64-bit integers to float64; floats and complex stay
_INEXACT = {torch.bool: torch.float32, torch.int8: torch.float32,
            torch.int16: torch.float32, torch.int32: torch.float32,
            torch.uint8: torch.float32, torch.uint16: torch.float32,
            torch.uint32: torch.float32, torch.int64: torch.float64,
            torch.uint64: torch.float64}


def _upper(node):
    """``node`` and every node above it in the lattice."""
    out, todo = {node}, [node]
    while todo:
        for up in _LATTICE[todo.pop()]:
            if up not in out:
                out.add(up)
                todo.append(up)
    return frozenset(out)


_UPPER = {n: _upper(n) for n in _LATTICE}


def _node(operand):
    """The lattice node of an operand: a torch or numpy dtype, a numpy
    scalar (strong), or a Python bool/int/float/complex (weak)."""
    if isinstance(operand, np.generic):      # np.float64 is a float too
        operand = operand.dtype
    elif isinstance(operand, bool):
        return "b1"
    if isinstance(operand, int):
        return "i*"
    if isinstance(operand, float):
        return "f*"
    if isinstance(operand, complex):
        return "c*"
    if not isinstance(operand, torch.dtype):
        operand = torch_dtype(operand)
    try:
        return _NODE[operand]
    except KeyError:
        raise TypeError("no jnp promotion rule for %s" % (operand,)) \
            from None


@lru_cache(maxsize=None)
def torch_dtype(dtype):
    """The torch dtype holding numpy ``dtype``."""
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


@lru_cache(maxsize=None)
def _join(a, b):
    common = _UPPER[a] & _UPPER[b]
    # the least upper bound: the common node every other common node lies
    # above
    for n in common:
        if common <= _UPPER[n]:
            return n
    raise TypeError("no common type for %s and %s" % (a, b))


def promote(a, b):
    """jnp's result dtype of ``a (op) b`` for ``+``, ``-``, ``*``."""
    return _TORCH[_join(_node(a), _node(b))]


def inexact(dtype):
    """jnp's ``to_inexact``: the float dtype an integer or bool widens to
    for a true division or a mean (floats unchanged)."""
    return _INEXACT.get(dtype, dtype)


def true_divide(a, b):
    """jnp's result dtype of ``a / b``."""
    return inexact(promote(a, b))


def stat_dtype(name, dtype):
    """jnp's output dtype of the statistic ``name`` of a ``dtype`` array:
    ``mean`` widens integers (``inexact``), ``var``/``std`` too and give a
    complex array its real dtype, ``sum``/``prod``
    take bool and signed integers to int64 and unsigned to uint64,
    ``all``/``any`` give bool, ``min``/``max``/``ptp`` keep ``dtype``."""
    if name in ("var", "std") and dtype.is_complex:
        return dtype.to_real()
    if name in ("mean", "var", "std"):
        return inexact(dtype)
    if name in ("sum", "prod"):
        if dtype == torch.bool or (not dtype.is_floating_point
                                   and not dtype.is_complex
                                   and dtype.is_signed):
            return torch.int64
        if dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64):
            return torch.uint64
        return dtype
    if name in ("all", "any"):
        return torch.bool
    return dtype


# the unsigned dtypes torch leaves most kernels out of, and the signed
# dtype each computes in
_CARRIER = {torch.uint16: torch.int32, torch.uint32: torch.int64,
            torch.uint64: torch.int64}
_SIGN_BIT = -(1 << 63)


def carrier(dtype):
    """The dtype ``dtype`` computes in: its carrier when torch leaves its
    kernels out, else ``dtype``."""
    return _CARRIER.get(dtype, dtype)


def carried(dtype):
    """Whether ``dtype`` computes in a carrier."""
    return dtype in _CARRIER


def carry(t, ordered=False):
    """The tensor ``t`` in its carrier (``t`` itself for other dtypes; a
    bool as uint8 when ``ordered``, for the sorts).  ``uint64`` is read as
    int64 bits; ``ordered`` flips their sign bit, for an operation that
    only orders (the carrier's arithmetic is then not ``t``'s)."""
    dt = t.dtype
    if dt == torch.uint64:
        # a conversion, not a view: it wraps modulo 2**64 alike, and
        # vmap batches it on every torch version
        bits = t.to(torch.int64)
        return bits ^ _SIGN_BIT if ordered else bits
    if dt in _CARRIER:
        return t.to(_CARRIER[dt])
    if ordered and dt == torch.bool:
        return t.to(torch.uint8)
    return t


def uncarry(t, dtype, ordered=False):
    """A carrier's result ``t`` back in ``dtype`` (modulo 2**bits for the
    unsigned dtypes; ``ordered`` as given to :func:`carry`)."""
    if dtype == torch.uint64 and t.dtype == torch.int64:
        return (t ^ _SIGN_BIT if ordered else t).to(torch.uint64)
    return t if t.dtype == dtype else t.to(dtype)


def where(cond, x, y):
    """``torch.where(cond, x, y)`` of two tensors of one dtype, in their
    carrier for a carried dtype (torch's CUDA build selects no uint16,
    uint32 or uint64 elements)."""
    if x.dtype in _CARRIER:
        return uncarry(torch.where(cond, carry(x), carry(y)), x.dtype)
    return torch.where(cond, x, y)


def rows(x, mask):
    """``x[mask]``, the rows a bool ``mask`` keeps, in the carrier for a
    carried dtype (torch's CUDA build indexes no uint16, uint32 or
    uint64 tensor)."""
    if x.dtype in _CARRIER:
        return uncarry(carry(x)[mask], x.dtype)
    return x[mask]


def missing_unsigned_kernel(exc, tensors):
    """Whether ``exc`` is torch refusing an unsigned dtype of ``tensors``
    it has no kernel for."""
    return isinstance(exc, NotImplementedError) and "UInt" in str(exc) \
        and any(isinstance(t, torch.Tensor) and t.dtype in _CARRIER
                for t in tensors)


# a uint64 carrier holds its value's bits: these ops give the same bits
# whether the bits are read signed or unsigned (the wrapping arithmetic,
# the bitwise ops, equality, and the ops that only move elements)
_U64_EXACT = frozenset("""
    add add_ sub sub_ __rsub__ rsub subtract mul mul_ multiply neg neg_
    negative square bitwise_and bitwise_and_ __and__ __iand__ bitwise_or
    bitwise_or_ __or__ __ior__ bitwise_xor bitwise_xor_ __xor__ __ixor__
    bitwise_not bitwise_not_ __invert__ bitwise_left_shift __lshift__
    __ilshift__ eq __eq__ ne __ne__ not_equal equal sum prod cumsum
    cumprod __get__ __getitem__ __setitem__ reshape view view_as flatten
    unflatten ravel squeeze unsqueeze permute transpose swapaxes swapdims
    movedim moveaxis t expand expand_as broadcast_to contiguous clone
    detach select narrow index_select gather take take_along_dim cat
    concat concatenate stack hstack vstack dstack flip fliplr flipud roll
    repeat tile chunk split unbind tensor_split diagonal diag tril triu
    where zeros_like ones_like empty_like full_like new_zeros new_ones
    new_empty new_full masked_fill copy_ fill_ to type type_as long int
    short char byte bool size dim numel __len__ is_contiguous
""".split())
# the orderings, which run on sign-flipped bits; those of the first line
# also take a Python int as a value to order against
_U64_ORDER_SCALAR = frozenset("""
    gt lt ge le greater less greater_equal less_equal clamp clip
    clamp_min clamp_max
""".split())
_U64_ORDER = _U64_ORDER_SCALAR | frozenset("""
    maximum minimum fmax fmin amax amin max min argmax argmin sort
    argsort msort topk
""".split())
_MASK = {torch.uint16: 0xFFFF, torch.uint32: 0xFFFFFFFF}


def _flip_number(c):
    """A Python int ordered against uint64 bits: its sign-flipped bits,
    read as int64."""
    if not 0 <= c < 1 << 64:
        raise TypeError("%d is outside the range of uint64" % c)
    c ^= 1 << 63
    return c - (1 << 64) if c >= 1 << 63 else c


class CarrierMode(TorchFunctionMode):
    """What torch would compute on unsigned values it has no kernels for,
    computed on their carriers: the mode a user callable reruns under
    (``gpu/array.py :: _user_call``).

    Every tensor that stands for a ``uint16``/``uint32``/``uint64`` value
    is tracked.  An op on one computes on the carriers and takes the
    result dtype torch gives on meta tensors of the unsigned dtypes (its
    own rule, as inside any callable).  An unsigned result is a carrier
    again: a ``uint16``/``uint32`` one is masked back into its range, so
    a later ordering or division sees the wrapped unsigned value.  A
    ``uint64`` carrier holds its value's bits, which an op of
    ``_U64_EXACT`` keeps exact and an ordering of ``_U64_ORDER`` reads on
    sign-flipped bits; any other op on one (a division, a right shift, a
    conversion to float) raises ``TypeError`` rather than read 2**63 and
    more as negative.  torch turns a ``TypeError`` out of an operator
    (``v // 2``) into Python's own, so the refusal is kept in
    ``refused`` for the caller to raise."""

    def __init__(self):
        super().__init__()
        self._unsigned = {}         # id(tensor) -> (weakref, dtype)
        self.refused = None

    def _refuse(self, msg):
        self.refused = msg
        raise TypeError(msg)

    def mark(self, t, dtype):
        """Track ``t`` as the carrier of a ``dtype`` value."""
        key, table = id(t), self._unsigned

        def gone(ref):
            if table.get(key, (None,))[0] is ref:
                del table[key]
        table[key] = (weakref.ref(t, gone), dtype)

    def entry(self, func, args):
        """``func`` with its arguments at the places of ``args`` that are
        carried tensors tracked first (the per-record function a vmap
        wraps: it sees the batched arguments)."""
        places = [(i, a.dtype) for i, a in enumerate(args)
                  if isinstance(a, torch.Tensor) and a.dtype in _CARRIER]

        def tracked(*inner):
            for i, dt in places:
                self.mark(inner[i], dt)
            return func(*inner)
        return tracked

    def _kind(self, x):
        """The unsigned dtype tensor ``x`` stands for, or None."""
        hit = self._unsigned.get(id(x))
        if hit is not None and hit[0]() is x:
            return hit[1]
        return x.dtype if x.dtype in _CARRIER else None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        flat, spec = tree_flatten((args, kwargs or {}))
        kinds = [self._kind(x) if isinstance(x, torch.Tensor) else None
                 for x in flat]
        if not any(kinds):
            return func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", repr(func))
        u64 = torch.uint64 in kinds
        order = u64 and name in _U64_ORDER
        if u64 and not order and name not in _U64_EXACT:
            self._refuse(
                "%s of a uint64 record in a callable: torch has no uint64 "
                "kernel for it, and its int64 carrier would read values "
                "of 2**63 or more as negative; astype a signed or float "
                "dtype first" % name)
        cflat = []
        for x, k in zip(flat, kinds):
            if k is not None:
                x = x if x.dtype == _CARRIER[k] else carry(x)
                if order and k == torch.uint64:
                    x = x ^ _SIGN_BIT
            elif u64 and isinstance(x, int) and not isinstance(x, bool):
                if order and name in _U64_ORDER_SCALAR:
                    x = _flip_number(x)
                elif x >= 1 << 63:
                    x -= 1 << 64            # the same bits, wrapped
            cflat.append(x)
        cargs, ckwargs = tree_unflatten(cflat, spec)
        out = func(*cargs, **ckwargs)
        oflat, ospec = tree_flatten(out)
        if not any(isinstance(o, (torch.Tensor, torch.dtype))
                   for o in oflat):
            return out
        # torch's result dtypes for the unsigned operands themselves
        mflat = [torch.empty(tuple(x.shape), dtype=k or x.dtype,
                             device="meta")
                 if isinstance(x, torch.Tensor) else x
                 for x, k in zip(flat, kinds)]
        margs, mkwargs = tree_unflatten(mflat, spec)
        want = tree_flatten(func(*margs, **mkwargs))[0]
        inputs = {id(x) for x in cflat if isinstance(x, torch.Tensor)}
        return tree_unflatten([self._result(o, w, u64, order, name,
                                            id(o) in inputs)
                               for o, w in zip(oflat, want)], ospec)

    def _result(self, o, w, u64, order, name, inplace):
        """One output ``o`` of the carrier op, given its meta twin ``w``."""
        if isinstance(o, torch.dtype):
            return w
        if not isinstance(o, torch.Tensor):
            return o
        dt = w.dtype
        if u64 and (dt.is_floating_point or dt.is_complex):
            self._refuse(
                "%s of a uint64 record in a callable gives %s: its int64 "
                "carrier would read values of 2**63 or more as negative; "
                "astype a float dtype first" % (name, dt))
        if dt not in _CARRIER:
            return o if o.dtype == dt else o.to(dt)
        if dt == torch.uint64:
            o = o.to(torch.int64) if o.dtype != torch.int64 else o
            if order:
                o = o ^ _SIGN_BIT
        else:
            if o.dtype != _CARRIER[dt]:
                o = carry(o) if o.dtype in _CARRIER else o
                o = (o & _MASK[dt]).to(_CARRIER[dt])
            elif inplace:
                o.bitwise_and_(_MASK[dt])
            else:
                o = o & _MASK[dt]
        self.mark(o, dt)
        return o
