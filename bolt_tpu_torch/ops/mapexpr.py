"""Compile a chain of per-record callables into an expression program.

The body of ``fused_map_reduce`` (``csrc/mapreduce.cu``) applies a user
``map`` function inside the reduction, but a CUDA kernel cannot call
Python.  So a chain that is pointwise is traced once, on a fake record,
with ``torch.fx.experimental.proxy_tensor.make_fx``, and its flat graph of
aten ops becomes a short register program that one prebuilt kernel
interprets per element.  :func:`evaluate` runs the same program with torch
ops in the kernel's order: it is the kernel's plain version, and on the
CPU it equals ``fn(x)`` bit for bit.

A chain qualifies (:func:`compile` returns a :class:`Program`) when its
record dtype is f16, bf16, f32 or f64, every func is callable, and each
traced graph has one placeholder, no ``get_attr`` (no tensor closed
over), only ``call_function`` nodes whose target carries
``torch.Tag.pointwise`` and is in the opcode table, Python numbers (or an
``aten.scalar_tensor`` of one) as the other arguments, and an output of
the record's shape and dtype.  Anything else returns ``None`` and the
caller keeps its torch path: that is a plan decision, made before any
launch.

A program is at most ``MAX_INSTRUCTIONS`` instructions
``(opcode, dst, a, b, const)`` over ``MAX_REGISTERS`` registers; register
0 holds the record's element on entry, and the result is the last
instruction's (``out`` names its register).  ``WHERE`` reads its
condition from ``dst`` and overwrites it.  Arithmetic runs in the accumulator type
(f32 for f16/bf16) and each arithmetic result is rounded to the record
dtype, as torch rounds each op; a comparison with a number compares with
the number rounded to the record dtype, as torch does.
"""

from collections import OrderedDict, namedtuple

import torch

from bolt_tpu_torch import _lockdep, engine
from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.obs.trace import clock as _clock

MAX_INSTRUCTIONS = 32
MAX_REGISTERS = 8

# opcodes, shared with csrc/mapreduce.cu (enum Op); *C takes the constant
# as its second operand, R* as its first
OPS = ("MOV", "LOADC", "ADD", "ADDC", "SUB", "SUBC", "RSUBC", "MUL", "MULC",
       "DIV", "DIVC", "NEG", "ABS", "SQRT", "RSQRT", "EXP", "LOG", "SIN",
       "COS", "TANH", "SIGMOID", "RECIP", "POWC", "MAX", "MIN", "CLAMPMINC",
       "CLAMPMAXC", "GT", "GE", "LT", "LE", "EQ", "NE", "GTC", "GEC", "LTC",
       "LEC", "EQC", "NEC", "WHERE")
OP = {name: i for i, name in enumerate(OPS)}
FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
_HALF = (torch.float16, torch.bfloat16)
# exponents torch's pow (and the kernel's POWC) computes by a special case
POW_SPECIAL = (2, 3, 0.5, -0.5, -1, -2)

Instr = namedtuple("Instr", "op dst a b const")


class Program(namedtuple("Program", "instrs out dtype")):
    """``instrs``: a tuple of :data:`Instr`; ``out``: the register holding
    the result; ``dtype``: the record dtype the program was compiled for.
    ``kernel``: what the kernel's wrapper derives from the program (its
    encoding, ``ops/kernels.py``), kept here on its first launch so that
    it is made once a program."""

    kernel = None


_aten = torch.ops.aten
# unary aten ops -> opcode
_UNARY = {_aten.neg.default: "NEG", _aten.abs.default: "ABS",
          _aten.sqrt.default: "SQRT", _aten.rsqrt.default: "RSQRT",
          _aten.exp.default: "EXP", _aten.log.default: "LOG",
          _aten.sin.default: "SIN", _aten.cos.default: "COS",
          _aten.tanh.default: "TANH", _aten.sigmoid.default: "SIGMOID",
          _aten.reciprocal.default: "RECIP"}
# binary aten ops -> (register-register opcode, register-number opcode,
# number-register opcode); None where the form does not exist
_BINARY = {
    _aten.add.Tensor: ("ADD", "ADDC", "ADDC"),
    _aten.add.Scalar: ("ADD", "ADDC", "ADDC"),
    _aten.sub.Tensor: ("SUB", "SUBC", "RSUBC"),
    _aten.sub.Scalar: ("SUB", "SUBC", "RSUBC"),
    _aten.mul.Tensor: ("MUL", "MULC", "MULC"),
    _aten.mul.Scalar: ("MUL", "MULC", "MULC"),
    _aten.div.Tensor: ("DIV", "DIVC", None),
    _aten.div.Scalar: ("DIV", "DIVC", None),
    _aten.maximum.default: ("MAX", None, None),
    _aten.minimum.default: ("MIN", None, None),
}
_COMPARE = {}
for _name in ("gt", "ge", "lt", "le", "eq", "ne"):
    for _ovl in ("Tensor", "Scalar"):
        _COMPARE[getattr(getattr(_aten, _name), _ovl)] = _name.upper()
# a comparison with the number on the left is the mirrored comparison
_MIRROR = {"GT": "LT", "GE": "LE", "LT": "GT", "LE": "GE", "EQ": "EQ",
           "NE": "NE"}
_TRUTH = frozenset(("GT", "GE", "LT", "LE", "EQ", "NE", "GTC", "GEC", "LTC",
                    "LEC", "EQC", "NEC"))


class _Reject(Exception):
    """The chain does not qualify."""


def _number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _round_to(k, dtype):
    """The number ``k`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(k, dtype=torch.float64).to(dtype))


class _Lowering:
    """Lowers traced graphs to instructions over virtual values (one per
    node), then allocates registers by liveness."""

    def __init__(self, vshape, dtype):
        self.vshape = vshape
        self.dtype = dtype
        self.code = []          # (op, dst value, a value, b value, const)
        self.nvalues = 1        # value 0: the record's element

    def value(self):
        self.nvalues += 1
        return self.nvalues - 1

    def emit(self, op, a=None, b=None, const=0.0):
        dst = self.value()
        self.code.append((op, dst, a, b, float(const)))
        return dst

    def lower(self, graph, entry):
        """Append the instructions of one traced func whose placeholder is
        the value ``entry``; returns the value of its output."""
        env, out = {}, None
        for node in graph.nodes:
            if node.op == "placeholder":
                if env:
                    raise _Reject("more than one placeholder")
                env[node] = entry
            elif node.op == "call_function":
                env[node] = self.node(node, env)
            elif node.op == "output":
                res = node.args[0]
                if isinstance(res, (tuple, list)):
                    if len(res) != 1:
                        raise _Reject("more than one output")
                    res = res[0]
                val = res.meta.get("val") if isinstance(
                    res, torch.fx.Node) else None
                if res not in env or isinstance(env[res], tuple) or \
                        not isinstance(val, torch.Tensor) or \
                        tuple(val.shape) != self.vshape or \
                        val.dtype != self.dtype:
                    raise _Reject("the output is not a record of the "
                                  "input's shape and dtype")
                out = env[res]
            else:                           # get_attr: a closed-over tensor
                raise _Reject("%s node" % node.op)
        return out

    def node(self, node, env):
        target = node.target
        if not (hasattr(target, "tags") and torch.Tag.pointwise in target.tags
                or target is _aten.scalar_tensor.default):
            raise _Reject("%s is not pointwise" % target)
        val = node.meta.get("val")
        if target is _aten.scalar_tensor.default:
            (k,) = node.args
            if not _number(k) or val is None or val.dtype != self.dtype:
                raise _Reject("scalar_tensor of another dtype")
            # a tensor constant: its number is rounded to the record dtype
            return ("const", _round_to(k, self.dtype))
        if not isinstance(val, torch.Tensor):
            raise _Reject("no tensor metadata")
        args = [self.arg(a, env) for a in node.args]
        kwargs = dict(node.kwargs)
        if kwargs.pop("alpha", 1) != 1 or kwargs:
            raise _Reject("keyword arguments %s" % sorted(node.kwargs))
        if target in _COMPARE:
            if val.dtype != torch.bool:
                raise _Reject("comparison output")
            return self.compare(_COMPARE[target], args)
        if val.dtype != self.dtype:
            raise _Reject("%s gives %s" % (target, val.dtype))
        if target in _UNARY:
            (a,) = args
            return self.emit(_UNARY[target], self.reg(a))
        if target is _aten.relu.default:
            (a,) = args
            return self.emit("CLAMPMINC", self.reg(a), const=0.0)
        if target in _BINARY:
            if len(args) != 2:
                raise _Reject("arguments of %s" % target)
            rr, rc, cr = _BINARY[target]
            a, b = args
            if _is_reg(a) and not _is_reg(b) and rc and b[0] == "num":
                return self.emit(rc, a, const=self.arith_const(rc, b[1]))
            if _is_reg(b) and not _is_reg(a) and cr and a[0] == "num":
                return self.emit(cr, b, const=self.arith_const(cr, a[1]))
            return self.emit(rr, self.reg(a), self.reg(b))
        if target is _aten.rsub.Scalar:
            a, k = args
            return self.emit("RSUBC", self.reg(a),
                             const=self.arith_const("RSUBC", self.num(k)))
        if target is _aten.pow.Tensor_Scalar:
            a, k = args
            return self.power(self.reg(a), self.num(k))
        if target in (_aten.clamp.default, _aten.clamp_min.default,
                      _aten.clamp_max.default):
            a, lo, hi = (args + [None, None])[:3]
            if target is _aten.clamp_max.default:
                lo, hi = None, lo
            out = self.reg(a)
            if lo is None and hi is None:
                raise _Reject("clamp without bounds")
            if lo is not None:
                out = self.emit("CLAMPMINC", out, const=self.num(lo))
            if hi is not None:
                out = self.emit("CLAMPMAXC", out, const=self.num(hi))
            return out
        if target is _aten.where.self:
            c, a, b = args
            if not _is_reg(c) or not self.is_bool(c):
                raise _Reject("where without a comparison")
            return self.emit("WHERE", self.reg(a), self.reg(b), const=c)
        raise _Reject("%s is not in the opcode table" % target)

    def arith_const(self, op, k):
        """The constant of a register-number op as torch uses it: f16/bf16
        ``+``/``-`` take the number rounded to the record dtype, ``*`` and
        ``/`` take it in f32."""
        if op in ("ADDC", "SUBC", "RSUBC") and self.dtype in _HALF:
            return _round_to(k, self.dtype)
        return k

    def power(self, a, k):
        """``a ** k`` as torch computes it: 2, 3, 0.5, -0.5, -1 and -2 by
        their special cases (bf16 rounds ``a * a`` before the next
        product), any other exponent rounded to an f16/bf16 record dtype
        first."""
        if self.dtype == torch.bfloat16 and k in (3, -2):
            sq = self.emit("MUL", a, a)
            return self.emit("MUL", sq, a) if k == 3 else \
                self.emit("RECIP", sq)
        if k not in POW_SPECIAL and self.dtype in _HALF:
            k = _round_to(k, self.dtype)
        return self.emit("POWC", a, const=k)

    def compare(self, name, args):
        a, b = args
        for v in (a, b):
            if _is_reg(v) and self.is_bool(v):
                raise _Reject("comparison of a truth value")
        if _is_reg(a) and _is_reg(b):
            return self.emit(name, self.reg(a), self.reg(b))
        if not _is_reg(a):
            a, b, name = b, a, _MIRROR[name]
        if not _is_reg(a):
            raise _Reject("comparison of two numbers")
        # torch compares with the number cast to the tensor's dtype
        return self.emit(name + "C", a, const=_round_to(self.num(b),
                                                         self.dtype))

    def is_bool(self, v):
        """Whether value ``v`` is a comparison's truth value (value ``v``
        is made by instruction ``v - 1``)."""
        return v > 0 and self.code[v - 1][0] in _TRUTH

    def arg(self, a, env):
        if a is None:               # an optional operand left out (clamp)
            return None
        if isinstance(a, torch.fx.Node):
            if a not in env:
                raise _Reject("argument %s" % a)
            return env[a]
        if _number(a):
            return ("num", float(a))
        raise _Reject("argument %r" % (a,))

    def reg(self, v):
        """A value operand: a tensor constant is loaded into a register."""
        if _is_reg(v):
            return v
        if v[0] == "const":
            return self.emit("LOADC", const=v[1])
        raise _Reject("a number where a tensor is needed")

    def num(self, v):
        if _is_reg(v):
            raise _Reject("a tensor where a number is needed")
        return v[1]

    def allocate(self, out):
        """Registers by liveness: a value's register is freed after its
        last use, so a result may take an operand's register (the kernel
        reads operands before it writes).  ``WHERE``'s condition register
        becomes its destination; a condition still needed later is copied
        first."""
        last = {out: len(self.code)}
        for i, (op, dst, a, b, const) in enumerate(self.code):
            for v in (a, b) + ((int(const),) if op == "WHERE" else ()):
                if v is not None:
                    last[v] = i
        code, reg, free = [], {0: 0}, list(range(1, MAX_REGISTERS))
        made = 0                # the value the last instruction made

        def release(v, i):
            if v is not None and last.get(v) == i and v in reg:
                free.append(reg.pop(v))
                free.sort()

        for i, (op, dst, a, b, const) in enumerate(self.code):
            if op == "WHERE":
                cond = int(const)
                if last[cond] == i:
                    r = reg.pop(cond)
                else:
                    if not free:
                        raise _Reject("more than %d registers"
                                      % MAX_REGISTERS)
                    r = free.pop(0)
                    code.append(Instr(OP["MOV"], r, reg[cond], 0, 0.0))
                code.append(Instr(OP["WHERE"], r, reg[a], reg[b], 0.0))
                release(a, i)
                release(b, i)
                reg[dst] = r
                made = dst
                continue
            ra = reg[a] if a is not None else 0
            rb = reg[b] if b is not None else 0
            release(a, i)
            release(b, i)
            if dst not in last:         # a value nothing reads
                continue
            if not free:
                raise _Reject("more than %d registers" % MAX_REGISTERS)
            r = free.pop(0)
            reg[dst] = r
            code.append(Instr(OP[op], r, ra, rb, const))
            made = dst
        if len(code) > MAX_INSTRUCTIONS:
            raise _Reject("more than %d instructions" % MAX_INSTRUCTIONS)
        if made != out:
            # the kernel's result is the last instruction's
            raise _Reject("the output is not the last value computed")
        return Program(tuple(code), reg[out], self.dtype)


def _is_reg(v):
    return isinstance(v, int)


def _trace(func, vshape, dtype):
    """The aten graph of ``func`` on one fake record (no memory is
    allocated for it, whatever its size)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    return make_fx(func, tracing_mode="fake")(
        torch.empty(vshape, dtype=dtype, device="meta"))


def _compile(funcs, vshape, dtype):
    if dtype not in FLOAT_DTYPES or not all(callable(f) for f in funcs):
        return None
    lowering = _Lowering(vshape, dtype)
    out = 0
    try:
        for func in funcs:
            out = lowering.lower(_trace(func, vshape, dtype).graph, out)
        return lowering.allocate(out)
    except _Reject:
        return None
    except Exception:       # noqa: BLE001 — a callable make_fx cannot trace
        # (a real tensor closed over, data-dependent control flow, a
        # numpy call) does not qualify; the caller's torch path runs it
        # and surfaces any error of its own
        return None


# compiled programs (None for a chain that does not qualify) by (funcs,
# vshape, dtype), least recently used first.  The engine's builders
# compile here, so a trace is accounted to the engine entry whose build
# ran it; a lookup from outside any engine build or dispatch counts in
# the engine's hits and misses itself (no program is counted twice)
_PROGRAMS = OrderedDict()
_PROGRAMS_MAX = 256
_LOCK = _lockdep.lock("mapexpr.programs")


def _key(funcs, vshape, dtype):
    return tuple(funcs), tuple(int(d) for d in vshape), dtype


def compile(funcs, vshape, dtype):
    """The :class:`Program` of the chain ``funcs`` (a sequence of
    per-record callables, applied in order) on records of shape ``vshape``
    and torch ``dtype``, or ``None`` when the chain does not qualify.  An
    empty chain is the empty program (the identity).  Cached by the funcs
    themselves, ``vshape`` and ``dtype``."""
    key = _key(funcs, vshape, dtype)
    counted = not engine.in_program()
    with _LOCK:
        if key in _PROGRAMS:
            _PROGRAMS.move_to_end(key)
            if counted:
                engine._COUNTERS.add("hits")
            return _PROGRAMS[key]
    sp = _obs.begin("engine.lower")
    t0 = _clock()
    try:
        program = _compile(*key)
    finally:
        _obs.end(sp)
    if counted:
        engine._COUNTERS.update(misses=1, aot_compiles=1,
                                lower_seconds=_clock() - t0)
    with _LOCK:
        _PROGRAMS[key] = program
        if len(_PROGRAMS) > _PROGRAMS_MAX:
            _PROGRAMS.popitem(last=False)
    return program


def compiled(funcs, vshape, dtype):
    """Whether :func:`compile` of these arguments comes from its cache,
    with no trace (a caller can queue device work before a trace, so the
    trace's host time overlaps it)."""
    return _key(funcs, vshape, dtype) in _PROGRAMS


def _rounding(dtype):
    """Round an f32 result to the record dtype and back (f16/bf16), or
    nothing (f32/f64, which compute in their own dtype)."""
    if dtype in _HALF:
        return lambda t: t.to(dtype).to(torch.float32)
    return lambda t: t


def evaluate(program, x):
    """Run ``program`` on every element of the tensor ``x`` (of the
    program's dtype) with torch ops, in the kernel's order: f16/bf16
    compute each op in f32 and round its result to the storage dtype.
    Returns a tensor of ``x``'s shape and dtype."""
    dtype = program.dtype
    if x.dtype != dtype:
        raise TypeError("program compiled for %s, got %s" % (dtype, x.dtype))
    rnd = _rounding(dtype)
    comp = torch.float32 if dtype in _HALF else dtype
    r = [None] * MAX_REGISTERS
    r[0] = x.to(comp)
    for op, dst, a, b, k in program.instrs:
        name = OPS[op]
        ra, rb = r[a], r[b]
        if name == "MOV":
            v = ra
        elif name == "LOADC":
            v = torch.full(x.shape, k, dtype=comp, device=x.device)
        elif name == "WHERE":
            v = torch.where(r[dst], ra, rb)
        elif name in _TRUTH:
            rhs = k if name.endswith("C") else rb
            v = getattr(torch, name[:2].lower())(ra, rhs)
        else:
            v = rnd(_ARITH_TORCH[name](ra, rb, k))
        r[dst] = v
    return r[program.out].to(dtype)


def _num(k):
    """A program constant as the Python number the trace held (an integral
    constant as an int, as ``v + 1`` and ``v ** 2`` pass it)."""
    return int(k) if float(k).is_integer() else k


_ARITH_TORCH = {
    "ADD": lambda a, b, k: torch.add(a, b),
    "ADDC": lambda a, b, k: torch.add(a, _num(k)),
    "SUB": lambda a, b, k: torch.sub(a, b),
    "SUBC": lambda a, b, k: torch.sub(a, _num(k)),
    "RSUBC": lambda a, b, k: torch.rsub(a, _num(k)),
    "MUL": lambda a, b, k: torch.mul(a, b),
    "MULC": lambda a, b, k: torch.mul(a, _num(k)),
    "DIV": lambda a, b, k: torch.div(a, b),
    "DIVC": lambda a, b, k: torch.div(a, _num(k)),
    "NEG": lambda a, b, k: torch.neg(a),
    "ABS": lambda a, b, k: torch.abs(a),
    "SQRT": lambda a, b, k: torch.sqrt(a),
    "RSQRT": lambda a, b, k: torch.rsqrt(a),
    "EXP": lambda a, b, k: torch.exp(a),
    "LOG": lambda a, b, k: torch.log(a),
    "SIN": lambda a, b, k: torch.sin(a),
    "COS": lambda a, b, k: torch.cos(a),
    "TANH": lambda a, b, k: torch.tanh(a),
    "SIGMOID": lambda a, b, k: torch.sigmoid(a),
    "RECIP": lambda a, b, k: torch.reciprocal(a),
    "POWC": lambda a, b, k: torch.pow(a, _num(k)),
    "MAX": lambda a, b, k: torch.maximum(a, b),
    "MIN": lambda a, b, k: torch.minimum(a, b),
    "CLAMPMINC": lambda a, b, k: torch.clamp_min(a, _num(k)),
    "CLAMPMAXC": lambda a, b, k: torch.clamp_max(a, _num(k)),
}
