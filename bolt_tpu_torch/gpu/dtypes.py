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
"""

from functools import lru_cache

import numpy as np
import torch

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
    ``mean``/``var``/``std`` widen integers (``inexact``), ``sum``/``prod``
    take bool and signed integers to int64 and unsigned to uint64,
    ``all``/``any`` give bool, ``min``/``max``/``ptp`` keep ``dtype``."""
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
