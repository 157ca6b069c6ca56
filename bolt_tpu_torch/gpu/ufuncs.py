"""Elementwise operations of the gpu mode: numpy's ufuncs and the array
operators, computed with torch ops in the reference's (jnp's) result
dtypes and, where torch and jnp part, with jnp's values.

Port of the elementwise half of ``bolt_tpu/tpu/array.py``
(``__array_ufunc__``, ``_ufunc_method``, ``_scalar_fn``, ``_unary`` and the
operators, which call ``jnp`` twins).  Each ufunc the port serves has an
entry here: its torch computation and its dtype rule.  The rules are jnp's
under x64 (``gpu/dtypes.py`` holds its promotion lattice):

* ``same``: the operand's dtype (``negative``, ``abs``, ``floor``, ...);
* ``inexact``: floats widen integers (``exp``, ``sqrt``, ``/``, ``hypot``);
* ``bool``: comparisons, ``isnan``, the logical ops;
* ``int32_bool``: the operand's (promoted) dtype, bool taken to int32
  (``//``, ``%``, ``**``, ``square``); the shifts too, refusing floats;
* ``integral``/``integer``: the bitwise ops (bool too) and ``gcd``/``lcm``
  (integers only), refusing floats as jnp does.

Where the values of torch and jnp part, jnp's are computed: integer
``//``, ``%`` and ``fmod`` by zero give jnp's answers (``-1``/``-2`` for
signed ``x // 0``, all ones unsigned, ``0`` for the remainders) where
torch raises on the CPU; float ``//`` is jnp's ``(x - fmod(x, y)) / y``
rounding (NaN for a zero divisor where torch gives inf); an integer
``**`` an integer array is jnp's six-step binary exponentiation (a
negative exponent reads its low six bits), and an integer raised to a
negative integer scalar raises ``TypeError`` as jnp does; ``sign`` keeps
NaN.  A ufunc with no torch twin (``cbrt``, ``spacing``, ``frexp``, ...)
returns ``NotImplemented``, so numpy raises ``TypeError``.

A scalar operand joins the caller's deferred map chain (see
``BoltArrayGPU._elementwise``): :func:`scalar_fn` and :func:`unary_fn`
return one cached callable per (op, operand, dtype), so a repeated
expression compiles once in ``ops/mapexpr.py``; the add, subtract,
multiply, divide, power and comparison operators keep the Python
operator's traced form, which the ``fused_map_reduce`` program takes.
"""

import operator
import struct
from functools import lru_cache

import numpy as np
import torch

from bolt_tpu_torch.gpu import dtypes

_INTS = (torch.int8, torch.int16, torch.int32, torch.int64)
_UINTS = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _is_int(dt):
    return dt in _INTS or dt in _UINTS


def _is_float(dt):
    return dt.is_floating_point or dt.is_complex


# ---------------------------------------------------------------------
# the computations jnp and torch disagree on
# ---------------------------------------------------------------------

def _sign(v):
    out = torch.sign(v)
    return torch.where(torch.isnan(v), v, out) if _is_float(v.dtype) \
        else out


def _round_away(d):
    """``lax.round``'s default: halves away from zero."""
    t = torch.trunc(d)
    return torch.where((d - t).abs() >= 0.5, t + torch.sign(d), t)


def _floor_divide(x, y):
    if _is_float(x.dtype):
        mod = torch.fmod(x, y)
        div = (x - mod) / y
        fix = (mod != 0) & (torch.sign(y) != torch.sign(mod))
        return _round_away(torch.where(fix, div - 1, div))
    zero = y == 0
    safe = torch.where(zero, torch.ones_like(y), y)
    if x.dtype in _UINTS:
        q = torch.div(x, safe, rounding_mode="trunc")
        return torch.where(zero, torch.full_like(q, -1), q)
    q = torch.div(x, safe, rounding_mode="trunc")
    fix = (torch.sign(x) != torch.sign(safe)) & (x - q * safe != 0)
    q = torch.where(fix, q - 1, q)
    # XLA's x / 0 is -1 and rem(x, 0) is x: jnp's floor correction then
    # gives -2 for every x but 0
    return torch.where(zero, torch.where(x == 0, -1, -2).to(q.dtype), q)


def _remainder(x, y):
    if _is_float(x.dtype):
        mod = torch.fmod(x, y)
        plus = ((mod < 0) != (y < 0)) & (mod != 0)
        return torch.where(plus, mod + y, mod)
    zero = y == 0
    safe = torch.where(zero, torch.ones_like(y), y)
    return torch.where(zero, torch.zeros_like(x), torch.remainder(x, safe))


def _fmod(x, y, keep=False):
    """jnp's ``fmod``: an integer zero divisor gives 0, a bool one (which
    jnp divides as int32 with no guard) gives the dividend (``keep``)."""
    if _is_float(x.dtype):
        return torch.fmod(x, y)
    zero = y == 0
    safe = torch.where(zero, torch.ones_like(y), y)
    return torch.where(zero, x if keep else torch.zeros_like(x),
                       torch.fmod(x, safe))


def _int_power(x, y):
    """jnp's integer ``x ** y`` for an integer array exponent: six steps
    of binary exponentiation over the low six bits of ``y``, wrapping
    like the products it is made of."""
    acc = torch.ones_like(x)
    e = torch.bitwise_and(y, 63)
    for _ in range(6):
        acc = torch.where(torch.bitwise_and(e, 1) != 0, acc * x, acc)
        x = x * x
        e = torch.bitwise_right_shift(e, 1)
    return acc


def _power(x, y):
    if isinstance(x, torch.Tensor) and _is_int(x.dtype):
        if isinstance(y, torch.Tensor):
            return _int_power(x, y)
        if y < 0:
            raise TypeError("Integers cannot be raised to negative powers, "
                            "got %s ** %r" % (x.dtype, y))
        return x ** y
    if isinstance(y, torch.Tensor) and _is_int(y.dtype):
        return _int_power(torch.full_like(y, x), y)
    return x ** y


def _bool_identity(fn):
    """``fn`` for numbers, the identity for bool (jnp's ``abs``,
    ``floor``, ... of a bool array is that array)."""
    def f(v):
        return v if v.dtype == torch.bool else fn(v)
    return f


# ---------------------------------------------------------------------
# the tables: name -> (computation, dtype rule)
# ---------------------------------------------------------------------

_UNARY = {
    "negative": (torch.neg, "same"), "positive": (lambda v: v, "same"),
    "absolute": (_bool_identity(torch.abs), "same"),
    "fabs": (torch.abs, "inexact"), "sign": (_sign, "same"),
    "floor": (_bool_identity(torch.floor), "same"),
    "ceil": (_bool_identity(torch.ceil), "same"),
    "trunc": (_bool_identity(torch.trunc), "same"),
    "rint": (torch.round, "float"),
    "square": (torch.square, "int32_bool"),
    "conjugate": (lambda v: torch.conj(v).resolve_conj(), "same"),
    "invert": (torch.bitwise_not, "integral"),
    "isnan": (torch.isnan, "bool"), "isinf": (torch.isinf, "bool"),
    "isfinite": (torch.isfinite, "bool"),
    "signbit": (torch.signbit, "bool"),
    "logical_not": (torch.logical_not, "bool"),
}
for _n in ("sqrt", "exp", "exp2", "expm1", "log", "log2", "log10", "log1p",
           "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh",
           "tanh", "arcsinh", "arccosh", "arctanh", "deg2rad", "rad2deg",
           "reciprocal"):
    _UNARY[_n] = (getattr(torch, _n), "inexact")
_UNARY["degrees"] = _UNARY["rad2deg"]
_UNARY["radians"] = _UNARY["deg2rad"]

_BINARY = {
    "add": (operator.add, "promote"), "subtract": (operator.sub, "promote"),
    "multiply": (operator.mul, "promote"),
    "true_divide": (operator.truediv, "inexact"),
    "floor_divide": (_floor_divide, "int32_bool"),
    "power": (_power, "int32_bool"),
    "float_power": (operator.pow, "inexact"),
    "remainder": (_remainder, "int32_bool"), "fmod": (_fmod, "int32_bool"),
    "maximum": (torch.maximum, "promote"),
    "minimum": (torch.minimum, "promote"),
    "fmax": (torch.fmax, "promote"), "fmin": (torch.fmin, "promote"),
    "arctan2": (torch.atan2, "inexact"), "hypot": (torch.hypot, "inexact"),
    "logaddexp": (torch.logaddexp, "inexact"),
    "logaddexp2": (torch.logaddexp2, "inexact"),
    "copysign": (torch.copysign, "inexact"),
    "nextafter": (torch.nextafter, "inexact"),
    "heaviside": (torch.heaviside, "inexact"),
    "greater": (operator.gt, "bool"), "greater_equal": (operator.ge, "bool"),
    "less": (operator.lt, "bool"), "less_equal": (operator.le, "bool"),
    "equal": (operator.eq, "bool"), "not_equal": (operator.ne, "bool"),
    "logical_and": (torch.logical_and, "bool"),
    "logical_or": (torch.logical_or, "bool"),
    "logical_xor": (torch.logical_xor, "bool"),
    "bitwise_and": (torch.bitwise_and, "integral"),
    "bitwise_or": (torch.bitwise_or, "integral"),
    "bitwise_xor": (torch.bitwise_xor, "integral"),
    "left_shift": (torch.bitwise_left_shift, "shift"),
    "right_shift": (torch.bitwise_right_shift, "shift"),
    "gcd": (torch.gcd, "integer"), "lcm": (torch.lcm, "integer"),
}
_BINARY["divide"] = _BINARY["true_divide"]
_BINARY["mod"] = _BINARY["remainder"]
# ops whose torch form takes a Python number as an operand (the others
# get it as a 0-d tensor of the computation dtype)
_TAKES_NUMBER = frozenset(("add", "subtract", "multiply", "true_divide",
                           "divide", "power", "float_power", "greater",
                           "greater_equal", "less", "less_equal", "equal",
                           "not_equal"))
# ops numpy rejects for bool operands (jnp raises TypeError alike)
_NO_BOOL = frozenset(("negative", "sign", "subtract"))


def has(name, nin):
    """Whether ufunc ``name`` of ``nin`` inputs has a torch twin here."""
    return name in (_UNARY if nin == 1 else _BINARY)


def _rule_dtype(rule, name, dt):
    """The result and computation dtype of rule ``rule`` for the
    (promoted) operand dtype ``dt``."""
    if dt == torch.bool and name in _NO_BOOL:
        raise TypeError("numpy boolean %s is not supported; use the "
                        "logical or bitwise form" % name)
    if rule == "same" or rule == "promote":
        return dt, dt
    if rule == "inexact":
        out = dtypes.inexact(dt)
        return out, out
    if rule == "float":
        out = dt if _is_float(dt) else torch.float64
        return out, out
    if rule == "int32_bool":
        out = torch.int32 if dt == torch.bool else dt
        return out, out
    if rule in ("integral", "shift") and _is_float(dt):
        raise TypeError("%s is only defined for integer and bool "
                        "operands, got %s" % (name, dt))
    if rule == "integer" and not _is_int(dt):
        raise ValueError("arguments to %s must be integers, got %s"
                         % (name, dt))
    if rule == "shift" and dt == torch.bool:
        return torch.int32, torch.int32
    if rule in ("integral", "integer", "shift"):
        return dt, dt
    return torch.bool, dt                          # "bool"


def unary_dtype(name, dtype):
    """``(result dtype, computation dtype)`` of unary ufunc ``name`` on a
    torch ``dtype``."""
    return _rule_dtype(_UNARY[name][1], name, dtype)


def binary_dtype(name, a, b):
    """``(result dtype, computation dtype)`` of binary ufunc ``name`` on
    operands ``a`` and ``b`` (torch dtypes, or Python/numpy scalars, which
    promote weakly/strongly as in ``gpu/dtypes.py``)."""
    dt = dtypes.promote(a, b)
    if name == "power" and a == torch.bool and isinstance(b, int) \
            and not isinstance(b, bool):
        # jnp raises to a Python int by lax.integer_pow, in the base's
        # dtype: a bool base counts in int32
        dt = torch.bool
    return _rule_dtype(_BINARY[name][1], name, dt)


def unary(name, v):
    """Unary ufunc ``name`` of the tensor ``v``."""
    fn, _ = _UNARY[name]
    out_dt, cdt = unary_dtype(name, v.dtype)
    out = fn(v.to(cdt))
    return out if out.dtype == out_dt else out.to(out_dt)


def _number(s):
    return s.item() if isinstance(s, np.generic) else s


def binary(name, a, b):
    """Binary ufunc ``name`` of ``a`` and ``b``, at least one a tensor,
    the other a tensor or a Python/numpy scalar."""
    fn, _ = _BINARY[name]
    da = a.dtype if isinstance(a, torch.Tensor) else a
    db = b.dtype if isinstance(b, torch.Tensor) else b
    out_dt, cdt = binary_dtype(name, da, db)
    like = a if isinstance(a, torch.Tensor) else b

    def operand(x):
        if isinstance(x, torch.Tensor):
            return x.to(cdt)
        x = _number(x)
        if name in _TAKES_NUMBER:
            return x
        return torch.scalar_tensor(x, dtype=cdt, device=like.device)

    if name == "fmod" and dtypes.promote(da, db) == torch.bool:
        out = _fmod(operand(a), operand(b), keep=True)
    else:
        # a number on the left takes the reflected Python operator
        out = fn(operand(a), operand(b))
    return out if out.dtype == out_dt else out.to(out_dt)


def _bits(x):
    """The bit pattern of a float or complex operand (``None`` for the
    rest): ``-0.0 == 0.0`` and the two hash alike, yet ``b / -0.0`` is
    ``-inf`` where ``b / 0.0`` is ``inf``."""
    if isinstance(x, np.generic):
        return x.tobytes()
    if isinstance(x, float):
        return struct.pack("<d", x)
    if isinstance(x, complex):
        return struct.pack("<dd", x.real, x.imag)
    return None


@lru_cache(maxsize=1024)
def _scalar_fn(name, kind, bits, other, reverse, dtype):
    def fn(v):
        return binary(name, other, v) if reverse else binary(name, v, other)
    fn.__name__ = name
    return fn


def scalar_fn(name, other, reverse, dtype):
    """The per-record ``v (name) other`` (``other (name) v`` when
    ``reverse``) for records of torch ``dtype``: one callable per (op,
    operand type, operand, side, dtype), so a repeated expression reuses
    its compiled program.  The operand's type is part of the key: ``2``,
    ``2.0`` and ``True`` hash alike but promote differently; so is a
    float's bit pattern: ``0.0`` and ``-0.0`` are equal but divide
    differently."""
    binary_dtype(name, dtype, other)          # reject before deferring
    return _scalar_fn(name, type(other), _bits(other), other, reverse,
                      dtype)


@lru_cache(maxsize=256)
def unary_fn(name, dtype):
    """The per-record unary ufunc ``name`` for records of torch
    ``dtype``, one callable per pair (see :func:`scalar_fn`)."""
    unary_dtype(name, dtype)                  # reject before deferring

    def fn(v):
        return unary(name, v)
    fn.__name__ = name
    return fn


@lru_cache(maxsize=256)
def round_fn(decimals):
    """``jnp.round(v, decimals)``: floats ``round(v * 10**d) / 10**d``,
    halves to even; integers unchanged for ``decimals >= 0``."""
    factor = 10.0 ** decimals

    def fn(v):
        if not _is_float(v.dtype):
            if decimals < 0:
                raise NotImplementedError(
                    "integer round is not implemented for decimals < 0")
            return v
        if decimals == 0:
            return torch.round(v)
        return torch.round(v * factor) / factor
    fn.__name__ = "round_%d" % decimals
    return fn


# ---------------------------------------------------------------------
# the ufunc methods: reduce / accumulate / outer / reduceat
# ---------------------------------------------------------------------

# binary ufuncs whose reduce/reduceat fold order provably matches numpy's
# (the reference's _UFUNC_FOLD_SAFE: numpy's generic non-reorderable
# reduce is neither a left nor a right fold, so power/arctan2 and the
# unverified rest refuse instead of returning other numbers)
UFUNC_FOLD_SAFE = frozenset([
    "add", "subtract", "multiply", "divide", "true_divide",
    "floor_divide", "maximum", "minimum", "fmax", "fmin", "hypot",
    "logaddexp", "logaddexp2", "copysign", "nextafter", "heaviside",
    "fmod", "mod", "remainder", "float_power", "logical_and",
    "logical_or", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_xor", "left_shift", "right_shift", "gcd", "lcm"])


def _fold(name, v, axis):
    """numpy's ``ufunc.reduce`` over one ``axis``: a left fold (torch's
    reduction where one computes the same function)."""
    if name == "add":
        return torch.sum(v, dim=axis, dtype=dtypes.stat_dtype(
            "sum", v.dtype))
    if name == "multiply":
        return torch.prod(v, dim=axis, dtype=dtypes.stat_dtype(
            "prod", v.dtype))
    if name in ("maximum", "minimum") and v.shape[axis]:
        return (torch.amax if name == "maximum" else torch.amin)(v, dim=axis)
    if name == "logical_and":
        return torch.all(v, dim=axis)
    if name == "logical_or":
        return torch.any(v, dim=axis)
    n = v.shape[axis]
    if n == 0:
        return None
    out = v.select(axis, 0)
    for i in range(1, n):
        out = binary(name, out, v.select(axis, i))
    return out


def ufunc_reduce(ufunc, v, axes, dt, keepdims, initial):
    """``ufunc.reduce(v, axis=axes, dtype=dt, keepdims=keepdims,
    initial=initial)`` over the tensor ``v``, one axis at a time from the
    last (``initial`` joins once).  ``logical_xor`` is the parity of the
    count, as in the reference."""
    name = ufunc.__name__
    if not axes:
        out = v.to(dt) if dt is not None else v
        return out if initial is None else binary(name, initial, out)
    if name == "logical_xor":
        cnt = torch.sum(v.to(torch.bool).to(torch.int32), dim=axes,
                        keepdim=keepdims)
        out = torch.remainder(cnt, 2).to(torch.bool)
        if initial is not None:
            out = torch.logical_xor(out, torch.tensor(bool(initial)))
        return out if dt is None else out.to(dt)
    if dt is not None:
        v = v.to(dt)
    out = v
    for ax in sorted(axes, reverse=True):
        red = _fold(name, out, ax)
        if red is None:
            if ufunc.identity is None and initial is None:
                raise ValueError("zero-size array to reduction operation "
                                 "%s which has no identity" % name)
            shape = out.shape[:ax] + out.shape[ax + 1:]
            fill = ufunc.identity if initial is None else initial
            red = torch.full(shape, fill, dtype=out.dtype,
                             device=out.device)
            initial = None
        out = red
    if initial is not None:
        out = binary(name, initial, out)
    if keepdims:
        for ax in sorted(axes):
            out = out.unsqueeze(ax)
    return out if dt is None or out.dtype == dt else out.to(dt)


def ufunc_accumulate(ufunc, v, axis, dt):
    """``ufunc.accumulate(v, axis=axis, dtype=dt)``: torch's cumulative
    op where one computes the same function, else a left scan."""
    name = ufunc.__name__
    if dt is not None:
        v = v.to(dt)
    if name == "add":
        return torch.cumsum(v, dim=axis, dtype=v.dtype)
    if name == "multiply":
        return torch.cumprod(v, dim=axis, dtype=v.dtype)
    if name in ("maximum", "minimum") and v.shape[axis]:
        return (torch.cummax if name == "maximum" else torch.cummin)(
            v, dim=axis).values
    if v.shape[axis] == 0:
        return v
    outs = [v.select(axis, 0)]
    for i in range(1, v.shape[axis]):
        outs.append(binary(name, outs[-1], v.select(axis, i)))
    return torch.stack(outs, dim=axis)


def ufunc_reduceat(ufunc, v, idx, axis, dt):
    """``ufunc.reduceat(v, idx, axis=axis, dtype=dt)`` with host indices
    ``idx`` (validated by the caller): each slice ``idx[i]:idx[i + 1]``
    reduced, or the element ``idx[i]`` where the next index is not
    larger."""
    name = ufunc.__name__
    if dt is not None:
        v = v.to(dt)
    n = v.shape[axis]
    outs = []
    for i, s in enumerate(idx):
        e = int(idx[i + 1]) if i + 1 < len(idx) else n
        s = int(s)
        if e > s:
            outs.append(_fold(name, v.narrow(axis, s, e - s), axis))
        else:
            outs.append(v.select(axis, s))
    return torch.stack([o.to(outs[0].dtype) for o in outs], dim=axis)


def ufunc_outer(ufunc, a, b, dt):
    """``ufunc.outer(a, b)`` of two tensors: ``a``'s axes lead."""
    x = a.reshape(tuple(a.shape) + (1,) * b.ndim)
    out = binary(ufunc.__name__, x, b)
    return out if dt is None else out.to(dt)

