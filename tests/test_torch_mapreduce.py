"""The port's ``fused_map_reduce`` and its expression compiler against the
reference.

On the CPU the port's wrappers run their plain version
(``mapexpr.evaluate`` and a torch sum: the tensors lie on the CPU); the
reference's Pallas kernel runs in interpret mode, as
``test_ops_kernels.py`` runs it, on the same seeded numpy inputs.
Tolerances: the reference's own (``abs < 1e-2`` for the (32, 256) f32
sums, ``rtol=1e-3`` for the 2-d grid shape, exact for the unaligned and
integer cases), f64 ``rtol=1e-10`` (the summation order differs), bf16
``rtol=atol=1.6e-2`` (results are bf16).

``mapexpr.evaluate`` must equal the callable itself bit for bit on the
CPU (both are torch; a NaN compares by position, its payload bits aside),
for every opcode in f32, f64 and bf16.  The CUDA kernel is held against
the plain version on the card by ``test_torch_card.py`` and
``chip_smoke.py``.
"""

import ctypes
import math
import os
import re
from operator import add

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu.ops.kernels import fused_map_reduce as ref_map_reduce
from bolt_tpu_torch.gpu.array import _WithKeysFunc
from bolt_tpu_torch.ops import kernels as K
from bolt_tpu_torch.ops import mapexpr as M

CPU = torch.device("cpu")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bolt_tpu_torch", "ops", "csrc", "mapreduce.cu")


def _rs(seed=0):
    return np.random.RandomState(seed)


def _float(v):
    return float(np.asarray(v, dtype=np.float64))


# ---------------------------------------------------------------------------
# fused_map_reduce against the reference (test_ops_kernels.py:31-77)
# ---------------------------------------------------------------------------

def test_fused_map_reduce_matches_reference():
    x = _rs(0).randn(32, 256).astype(np.float32)
    want = _float(ref_map_reduce(jnp.asarray(x), lambda v: v * 2 + 1,
                                 interpret=True))
    got = K.fused_map_reduce(torch.from_numpy(x), lambda v: v * 2 + 1)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) < 1e-2
    # the identity
    want = _float(ref_map_reduce(jnp.asarray(x), interpret=True))
    assert abs(float(K.fused_map_reduce(torch.from_numpy(x))) - want) < 1e-2


def test_unaligned_shape_sums_exactly():
    x = np.ones((5, 7), np.float32)
    want = _float(ref_map_reduce(jnp.asarray(x), lambda v: v + 1,
                                 interpret=True))
    got = K.fused_map_reduce(torch.from_numpy(x), lambda v: v + 1)
    assert want == float(got) == 70.0


def test_integer_inputs_sum_in_numpys_dtype():
    x = np.full((8, 128), 100, dtype=np.int16)
    want = ref_map_reduce(jnp.asarray(x), interpret=True)
    got = K.fused_map_reduce(torch.from_numpy(x))
    assert int(want) == int(got) == 102400
    assert got.dtype == torch.int64 and np.dtype(want.dtype) == np.int64


def test_two_d_grid_shape():
    x = _rs(2).randn(3, 1024, 16, 128).astype(np.float32)
    want = _float(ref_map_reduce(jnp.asarray(x), lambda v: v + 1,
                                 interpret=True))
    got = float(K.fused_map_reduce(torch.from_numpy(x), lambda v: v + 1))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(got, float((x.astype(np.float64) + 1).sum()),
                               rtol=1e-3)


@pytest.mark.parametrize("dtype,tol", [
    ("float64", dict(rtol=1e-10, atol=0)),
    ("bfloat16", dict(rtol=1.6e-2, atol=1.6e-2))])
def test_other_float_dtypes_match_reference(dtype, tol):
    x = _rs(4).randn(16, 256)
    f = lambda v: v * 0.5 - 1        # noqa: E731
    if dtype == "bfloat16":
        xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
            torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want = _float(ref_map_reduce(xj, f, interpret=True))
    got = K.fused_map_reduce(xt, f)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(float(got), want, **tol)


@pytest.mark.parametrize("dtype,jdtype", [
    (torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)])
def test_half_maps_round_each_op_like_reference(dtype, jdtype):
    # the reference's kernel, run in interpret mode, rounds fn's result op
    # by op to the storage dtype, as the port's kernel and evaluate do:
    # one element x (every other is 0, and fn(0) == 0) for which
    # round(round(x * 3) * 0.7) differs from round(x * 3 * 0.7), so the
    # sum is fn(x) and tells the two rules apart
    f = lambda v: v * 3 * 0.7           # noqa: E731
    cand = torch.arange(0x3C01, 0x3D00, dtype=torch.int16).view(dtype) \
        if dtype == torch.float16 else \
        torch.arange(0x3F81, 0x4000, dtype=torch.int16).view(dtype)
    per_op = ((cand.float() * 3).to(dtype).float() * 0.7).to(dtype)
    kept = (cand.float() * 3 * 0.7).to(dtype)
    i = int(torch.nonzero(per_op != kept)[0])
    x = np.zeros((16, 256), np.float32)
    x[3, 17] = float(cand[i])
    want = _float(ref_map_reduce(jnp.asarray(x, jdtype), f, interpret=True))
    got = K.fused_map_reduce(torch.from_numpy(x).to(dtype), f)
    assert got.dtype == dtype
    assert float(got) == want == float(per_op[i]) != float(kept[i])


def test_a_map_that_does_not_compile_is_summed_by_torch():
    x = torch.from_numpy(_rs(5).randn(6, 10))
    got = K.fused_map_reduce(x, lambda v: v - v.mean())
    want = ref_map_reduce(jnp.asarray(x.numpy()), lambda v: v - v.mean(),
                          interpret=True)
    np.testing.assert_allclose(float(got), _float(want), atol=1e-12)


# ---------------------------------------------------------------------------
# the compiler: evaluate equals fn bit for bit, for every opcode
# ---------------------------------------------------------------------------

def _arith(v):
    a = torch.abs(v) + 0.5
    w = (v * 1.5 - 0.25) * (v - a) / (a + 1) - (0.75 - v) / 3 - v
    return torch.maximum(w, v) + torch.minimum(w, -v)


def _unary(v):
    a = torch.abs(v) + 0.5
    w = torch.sqrt(a) + torch.rsqrt(a) + torch.exp(-v * v) + torch.log(a)
    w = w + torch.tanh(v) + torch.sigmoid(v) + 2 / a + a ** 1.5
    return torch.clamp(w, -50.0, 50.0) + torch.relu(v)


def _trig(v):
    return torch.sin(v) * torch.cos(v) + v ** 2 + v ** 3 + v ** -2


def _compare(v):
    w = v * 0.5
    c = v > 0.25
    out = torch.where(c, v, 1.0) + torch.where(c, 2.0, w)
    out = out + torch.where(v >= w, v, w) + torch.where(v < w, 1.0, w)
    out = out + torch.where(v <= w, w, v) + torch.where(v == w, v, 0.0)
    return out + torch.where(v != w, w, 0.5)


def _compare_number(v):
    w = v * 0.5
    out = torch.where(v >= 0.5, v, w) + torch.where(v < -0.5, v, w)
    out = out + torch.where(v <= 0.1, w, v) + torch.where(v == 0.0, w, v)
    return out + torch.where(v != 1.0, v, w) + torch.where(v > w, w, v)


PROGRAMS = {"arith": _arith, "unary": _unary, "trig": _trig,
            "compare": _compare, "compare_number": _compare_number,
            "v+1": lambda v: v + 1, "v*2+1": lambda v: v * 2 + 1,
            "pow": lambda v: torch.abs(v) ** 0.5 + v ** -1 + v ** 4,
            "clamp_max": lambda v: v.clamp(max=0.3) - 0.1,
            "sub_add": lambda v: (v + 0.7) - 0.3 + (0.6 - v) + v / 0.7}
DTYPES = [torch.float32, torch.float64, torch.bfloat16]


def _inputs(dtype, shape=(64, 24)):
    x = _rs(7).randn(*shape) * 2
    flat = x.reshape(-1)
    flat[:10] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, 0.1, -0.2, 1.0,
                 0.25]
    t = torch.from_numpy(x).to(dtype)
    if dtype == torch.bfloat16:
        # every bf16 bit pattern as well
        every = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
            torch.bfloat16)
        return [t, every.reshape(-1, 16)]
    return [t]


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    assert bool(same.all()), int((~same).sum())


def test_programs_use_every_opcode():
    used = set()
    for f in PROGRAMS.values():
        used.update(i.op for i in M.compile((f,), (24,), torch.float32).instrs)
    assert sorted(M.OPS[i] for i in set(range(len(M.OPS))) - used) == []


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_evaluate_equals_fn_bit_for_bit(name, dtype):
    f = PROGRAMS[name]
    for x in _inputs(dtype):
        program = M.compile((f,), tuple(x.shape[1:]), dtype)
        assert program is not None
        assert len(program.instrs) <= M.MAX_INSTRUCTIONS
        assert all(0 <= r < M.MAX_REGISTERS for i in program.instrs
                   for r in (i.dst, i.a, i.b))
        _same(M.evaluate(program, x), f(x))


def test_evaluate_of_f16_within_an_ulp():
    # torch's f16 CPU kernels round a few transcendentals differently from
    # f32-then-round; the rest match exactly
    x = _inputs(torch.float16)[0]
    for name, f in PROGRAMS.items():
        got = M.evaluate(M.compile((f,), (24,), torch.float16), x)
        np.testing.assert_allclose(got.float().numpy(), f(x).float().numpy(),
                                   rtol=2 ** -10, atol=2 ** -14)


def test_a_chain_is_one_program():
    fs = (lambda v: v + 1, lambda v: v * 2, torch.exp)
    x = _inputs(torch.float32)[0]
    program = M.compile(fs, (24,), torch.float32)
    assert [M.OPS[i.op] for i in program.instrs] == ["ADDC", "MULC", "EXP"]
    _same(M.evaluate(program, x), torch.exp((x + 1) * 2))
    assert M.compile((), (24,), torch.float32).instrs == ()
    assert M.compile(fs, (24,), torch.float32) is program      # cached


@pytest.mark.parametrize("label,funcs,dtype", [
    ("reduction", (lambda v: v - v.mean(),), torch.float32),
    ("closed-over tensor", ((lambda t: (lambda v: v + t))(torch.ones(24)),),
     torch.float32),
    ("dtype change", (lambda v: v.to(torch.float64),), torch.float32),
    ("integer promotes to float", (lambda v: v / 2,), torch.int32),
    ("integer record", (lambda v: v + 1,), torch.int32),
    ("python value", (lambda v: True,), torch.float32),
    ("shape change", (lambda v: v[:3],), torch.float32),
    ("with_keys entry", (_WithKeysFunc(lambda kv: kv[1]),), torch.float32),
    ("too many instructions", tuple(
        (lambda k: (lambda v: v * 1.5 + k))(k) for k in range(20)),
     torch.float32),
    # nine values live at once, and the element
    ("too many registers", (lambda v: math.prod(
        [v * (1 + k / 10) for k in range(9)]),), torch.float32)])
def test_compile_declines(label, funcs, dtype):
    assert M.compile(funcs, (24,), dtype) is None, label


def test_integer_scalar_fn_declines_but_float_fuses():
    # the operator closures of `b + 1` trace like any func
    b = bolt.ones((4, 6), CPU, dtype=np.int32)
    assert M.compile(((b + 1.5)._chain[1][0],), (6,), torch.int32) is None
    f = bolt.ones((4, 6), CPU) * 2
    program = M.compile(f._chain[1], (6,), torch.float64)
    assert [M.OPS[i.op] for i in program.instrs] == ["MULC"]


# ---------------------------------------------------------------------------
# the kernel's encoding: the opcode table, the parameter struct and the
# data-flow flags, simulated here as the kernel runs them
# ---------------------------------------------------------------------------

def test_opcode_table_matches_the_kernel():
    with open(CSRC) as f:
        src = f.read()
    body = re.search(r"enum Op : int \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in body.replace("\n", " ").split(",")]
    assert names[:-1] == list(M.OPS) and names[-1] == "kNumOps"
    assert ctypes.sizeof(K._Instr) == 16
    assert ctypes.sizeof(K._Program) == 16 + 16 * M.MAX_INSTRUCTIONS
    assert "kMaxInstrs = %d;" % M.MAX_INSTRUCTIONS in src
    assert "kRegs = %d;" % M.MAX_REGISTERS in src


def _simulate(program, x):
    """mapreduce.cu's interpreter in torch: operands from the register file
    or, where the flags say so, the previous result; results stored only
    where the flags say so; the result is the last instruction's."""
    struct = K._program_struct(program)
    rnd = M._rounding(program.dtype)
    comp = torch.float32 if program.dtype in (torch.float16,
                                              torch.bfloat16) \
        else program.dtype
    file = [None] * struct.nfile
    xv = x.to(comp)
    if struct.flags & K._STORE_X:
        file[0] = xv
    prev = xv
    for i in range(struct.n):
        ins = struct.ins[i]
        f = ins.flags

        def operand(read, fwd, reg):
            if not f & read:
                return None
            return prev if f & fwd else file[reg]

        a = operand(K._READ_A, K._A_PREV, ins.a)
        b = operand(K._READ_B, K._B_PREV, ins.b)
        c = operand(K._READ_C, K._C_PREV, ins.dst)
        name = M.OPS[ins.op]
        if name == "MOV":
            d = a
        elif name == "LOADC":
            d = torch.full(x.shape, ins.k, dtype=comp)
        elif name == "WHERE":
            d = torch.where(c.to(torch.bool), a, b)
        elif name in M._TRUTH:
            rhs = ins.k if name.endswith("C") else b
            d = getattr(torch, name[:2].lower())(a, rhs).to(comp)
        else:
            d = rnd(M._ARITH_TORCH[name](a, b, ins.k))
        if f & K._STORE:
            file[ins.dst] = d
        prev = d
    return prev.to(program.dtype)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_kernel_encoding_computes_the_program(name):
    for dtype in DTYPES:
        x = _inputs(dtype)[0]
        program = M.compile((PROGRAMS[name],), (24,), dtype)
        _same(_simulate(program, x), M.evaluate(program, x))


def test_encoding_keeps_a_chain_out_of_the_register_file():
    struct = K._program_struct(M.compile((lambda v: v * 2 + 1,), (3,),
                                         torch.float32))
    assert struct.nfile == 0 and struct.flags == 0
    assert all(struct.ins[i].flags == K._READ_A | K._A_PREV
               for i in range(struct.n))


# ---------------------------------------------------------------------------
# the column form and its mask
# ---------------------------------------------------------------------------

def test_cols_skips_masked_rows_even_nan():
    x = torch.from_numpy(_rs(8).randn(10, 12))
    x[3] = float("nan")
    mask = torch.ones(10, dtype=torch.bool)
    mask[3] = mask[7] = False
    program = M.compile((lambda v: v + 1,), (12,), torch.float64)
    got = K.fused_map_reduce_cols(x, program, mask)
    want = (x[mask] + 1).sum(0)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    got_u8 = K.fused_map_reduce_cols(x, program, mask.to(torch.uint8))
    assert torch.equal(got, got_u8)


def test_cols_checks_its_arguments():
    program = M.compile((), (4,), torch.float32)
    with pytest.raises(TypeError):
        K.fused_map_reduce_cols(torch.ones(3, 4, dtype=torch.float64),
                                program)
    with pytest.raises(ValueError):
        K.fused_map_reduce_cols(torch.ones(3, 4, 1), program)
    with pytest.raises(ValueError):
        K.fused_map_reduce_cols(torch.ones(3, 4), program,
                                torch.ones(2, dtype=torch.bool))


# ---------------------------------------------------------------------------
# map(fn).sum() routes through the kernel's wrappers
# ---------------------------------------------------------------------------

@pytest.fixture
def calls(monkeypatch):
    """Count the calls of the two kernel entry points."""
    seen = {"cols": 0, "full": 0}

    def wrap(key, fn):
        def w(*a, **k):
            seen[key] += 1
            return fn(*a, **k)
        return w

    monkeypatch.setattr(K, "fused_map_reduce_cols",
                        wrap("cols", K.fused_map_reduce_cols))
    monkeypatch.setattr(K, "fused_map_reduce_program",
                        wrap("full", K.fused_map_reduce_program))
    return seen


@pytest.mark.parametrize("axis,keepdims,form", [
    (None, False, "cols"), ((0,), True, "cols"), ((0, 1, 2), False, "full"),
    ((0, 1, 2), True, "full"), ((1,), False, None), ((0, 2), False, None)])
def test_map_sum_matches_reference(mesh, calls, axis, keepdims, form):
    x = _rs(9).randn(8, 4, 5)
    f = lambda v: v * 2 + 1          # noqa: E731
    want = ref.array(x, mesh).map(f).sum(axis=axis, keepdims=keepdims)
    got = bolt.array(x, CPU).map(f).sum(axis=axis, keepdims=keepdims)
    assert got.shape == want.shape and got.split == want.split
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-10)
    assert calls == {"cols": int(form == "cols"), "full": int(form == "full")}


def test_map_sum_keys_of_two_axes(mesh, calls):
    x = _rs(10).randn(4, 3, 5)
    want = ref.array(x, mesh, axis=(0, 1)).map(lambda v: v - 0.5).sum()
    got = bolt.array(x, CPU, axis=(0, 1)).map(lambda v: v - 0.5).sum()
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-10)
    assert calls["cols"] == 1


def test_other_sums_keep_the_torch_path(calls):
    x = _rs(11).randn(8, 4, 5)
    b = bolt.array(x, CPU)
    b.sum()                                           # concrete
    b.map(lambda v: v - v.mean()).sum()               # does not compile
    b.map(lambda v: v + 1).reduce(add)                # the pairwise tree
    bolt.array(x.astype(np.int32), CPU).map(lambda v: v + 1).sum()
    b.map(lambda v: v + 1).mean()
    assert calls == {"cols": 0, "full": 0}


def test_config1_map_sum_stays_exact():
    # integer-valued f32 sums are exact in any order: the local oracle's
    # sum bit for bit
    shape = (20, 6, 8, 8)
    got = bolt.ones(shape, CPU, dtype=np.float32).map(lambda v: v + 1).sum()
    want = np.asarray(bolt.ones(shape, dtype=np.float32).map(
        lambda v: v + 1)).sum(axis=0)
    assert np.array_equal(got.toarray(), want)


def test_ops_export_runs_the_chain_of_its_callable():
    from bolt_tpu_torch import ops
    x = torch.from_numpy(_rs(12).randn(6, 20).astype(np.float32))
    got = ops.fused_map_reduce(x, lambda v: torch.where(v > 0, v, 0.0))
    np.testing.assert_allclose(float(got), float(x.clamp_min(0).double()
                                                 .sum()), rtol=1e-6)
