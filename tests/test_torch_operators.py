"""The port's operators and numpy ufuncs against the reference's.

The assertions of ``tests/test_tpu_operators.py`` on the port, on the CPU
(``context=torch.device("cpu")``), with ``bolt_tpu`` on the same seeded
inputs where a value is compared: dtypes exactly, values at ``rtol=1e-10``
in f64 (``allclose`` where the reference test compares with numpy).
Left out, with no single-device counterpart: ``test_mesh_mismatch_raises``
(two meshes; the port's operands on two devices need two cards) and
``test_jax_array_operands_no_host_roundtrip``/
``test_foreign_device_operand_falls_back`` (``jax.Array`` operands; their
port counterpart, a ``torch.Tensor`` operand that never passes through
numpy, is ``test_tensor_operands_no_host_roundtrip`` below).
"""

import operator

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch.gpu import ufuncs

CPU = torch.device("cpu")


def _x():
    return np.random.RandomState(12).randn(8, 4, 5)


def _pair(mesh, x, **kw):
    return ref.array(x, mesh, **kw), bolt.array(x, CPU, **kw)


def _same(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12)


def test_scalar_ops(mesh):
    x = _x()
    t, g = _pair(mesh, x)
    for f in (lambda b: b + 1, lambda b: 1 + b, lambda b: b - 2,
              lambda b: 2 - b, lambda b: b * 3, lambda b: b / 2,
              lambda b: 2 / (b + 10), lambda b: b ** 2, lambda b: -b,
              lambda b: abs(b)):
        _same(f(g).toarray(), f(t).toarray())
        assert bolt.allclose(f(g).toarray(), f(x))


def test_scalar_ops_defer():
    x = _x()
    m = (bolt.array(x, CPU) + 1) * 2 - 3
    assert m.deferred
    assert bolt.allclose(m.toarray(), (x + 1) * 2 - 3)


def test_array_operand(mesh):
    x = _x()
    t, g = _pair(mesh, x)
    other = np.random.RandomState(13).randn(*x.shape)
    row = np.random.RandomState(14).randn(5)
    for o in (other, row):
        _same((g + o).toarray(), (t + o).toarray())
        _same((g * o).toarray(), (t * o).toarray())
    with pytest.raises(ValueError):
        g + np.ones((9, 1, 1))


def test_array_operand_broadcast_outgrows_self(mesh):
    x = _x()
    t, g = _pair(mesh, x)
    s = g.mean(axis=(0, 1, 2))
    out = np.ones(8) * s
    assert isinstance(out, bolt.BoltArrayGPU) and out.split == 0
    _same(out.toarray(), (np.ones(8) * t.mean(axis=(0, 1, 2))).toarray())
    assert bolt.allclose((np.arange(6.0) + s).toarray(),
                         np.arange(6.0) + x.mean())
    col = bolt.array(x[:, :, :1], CPU)
    grown = col * np.ones(5)
    assert grown.split == 1 and grown.shape == (8, 4, 5)
    led = g + np.ones((3, 8, 4, 5))
    assert led.split == 0
    assert bolt.allclose(led.toarray(), x + np.ones((3, 8, 4, 5)))


def test_bolt_operand(mesh):
    x = _x()
    g = bolt.array(x, CPU)
    out = g + bolt.array(x * 2, CPU)
    assert out.split == 1
    assert bolt.allclose(out.toarray(), x * 3)
    assert bolt.allclose((g + bolt.array(np.ones_like(x))).toarray(), x + 1)


def test_comparisons(mesh):
    x = _x()
    t, g = _pair(mesh, x)
    for f in (lambda b: b > 0, lambda b: b <= 0.5, lambda b: b < -0.2,
              lambda b: b >= 0, lambda b: b == b, lambda b: b != b,
              lambda b: b == 1, lambda b: b != x):
        got, want = f(g), f(t)
        assert got.dtype == want.dtype == np.bool_
        assert np.array_equal(got.toarray(), want.toarray())
    assert (g == g).toarray().all() and not (g != g).toarray().any()


def test_value_shaped_result_ops(mesh):
    x = _x()
    t, g = _pair(mesh, x)
    s = g.sum()
    assert s.split == 0
    _same((s + 1).toarray(), (t.sum() + 1).toarray())
    _same(abs(s).toarray(), abs(t.sum()).toarray())


def test_mixed_expression(mesh):
    x = _x()
    t, g = _pair(mesh, x)
    _same(((g + 1) * (g - 1)).mean().toarray(),
          ((t + 1) * (t - 1)).mean().toarray())


def test_numpy_left_operand_reflects():
    x = _x()
    g = bolt.array(x, CPU)
    out = np.ones_like(x) + g
    assert isinstance(out, bolt.BoltArrayGPU)
    assert bolt.allclose(out.toarray(), x + 1)
    out = np.float64(2.0) * g
    assert isinstance(out, bolt.BoltArrayGPU)
    assert bolt.allclose(out.toarray(), x * 2)


def test_eq_sentinel():
    g = bolt.array(_x(), CPU)
    assert (g == None) is False      # noqa: E711 — the point of the test
    assert (g != None) is True       # noqa: E711
    assert (g == "nope") is False


def test_neg_bool_parity(mesh):
    x = _x()
    with pytest.raises(TypeError):
        -(x > 0)
    with pytest.raises(TypeError):
        -(ref.array(x, mesh) > 0)
    with pytest.raises(TypeError):
        -(bolt.array(x, CPU) > 0)


def test_scalar_ops_cache_stable():
    # a repeated scalar expression reuses its callable, so its program
    # compiles once (the reference counts jit cache entries)
    g = bolt.array(_x(), CPU)
    assert (g + 1.0)._chain[1] == (g + 1.0)._chain[1]
    assert (g * 2)._chain[1] != (g * 2.0)._chain[1]     # type-aware key
    assert np.sin(g)._chain[1] == np.sin(g)._chain[1]


@pytest.mark.parametrize("other", [0.0, np.float64(0.0), np.float32(0.0),
                                   complex(0.0, 0.0)])
def test_scalar_ops_cache_keeps_the_sign_of_zero(other):
    # 0.0 == -0.0 and both hash alike: the cached callable of `b / 0.0`
    # must not serve `b / -0.0`, whichever runs first
    x = _x()
    g = bolt.array(x, CPU)
    neg = -other
    with np.errstate(divide="ignore", invalid="ignore"):
        for first, second in ((other, neg), (neg, other)):
            for f in (lambda b, s: b / s, lambda b, s: b * s,
                      lambda b, s: s / b):
                np.testing.assert_array_equal(f(g, first).toarray(),
                                              f(x, first))
                np.testing.assert_array_equal(f(g, second).toarray(),
                                              f(x, second))
            if isinstance(other, complex):
                continue
            for uf in (np.copysign, np.arctan2, np.nextafter):
                np.testing.assert_array_equal(uf(g, first).toarray(),
                                              uf(x, first))
                np.testing.assert_array_equal(uf(g, second).toarray(),
                                              uf(x, second))
    assert (g / 0.0)._chain[1] is not (g / -0.0)._chain[1]


def test_floordiv(mesh):
    x = _x() * 10
    t, g = _pair(mesh, x)
    other = np.random.RandomState(15).randn(*x.shape) + 5
    for f in (lambda b: b // 3, lambda b: 100 // (abs(b) + 1),
              lambda b: b // other):
        _same(f(g).toarray(), f(t).toarray())
        assert bolt.allclose(f(g).toarray(), f(x))


def test_mod_reflected(mesh):
    x = abs(_x()) + 1
    t, g = _pair(mesh, x)
    for f in (lambda b: b % 2, lambda b: 7 % b, lambda b: 2.0 ** b):
        _same(f(g).toarray(), f(t).toarray())
        assert bolt.allclose(f(g).toarray(), f(x))


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64, np.uint8])
def test_integer_division_by_zero_matches_reference(mesh, dtype):
    # torch raises on an integer // 0 or % 0 on the CPU; the port gives
    # the reference's (jnp's) answers
    x = np.array([[7, 0, 5], [1, 3, 0]], dtype=dtype)
    if np.dtype(dtype).kind == "i":
        x[0, 2] = -5
    y = np.array([[0, 0, 2], [0, 1, 0]], dtype=dtype)
    t, g = _pair(mesh, x)
    for op in (operator.floordiv, operator.mod):
        for other in (y, 0, 2):
            got, want = op(g, other), op(t, other)
            assert got.dtype == want.dtype
            assert np.array_equal(got.toarray(), want.toarray()), (op, other)
        got = op(7, bolt.array(y, CPU))
        assert np.array_equal(got.toarray(), op(7, ref.array(y, mesh))
                              .toarray())
    for f in (np.fmod, np.remainder, np.floor_divide):
        assert np.array_equal(f(g, y).toarray(), f(t, y).toarray()), f


def test_float_floor_divide_and_remainder_match_reference(mesh):
    x = np.array([[7.0, -7.0, 0.5, -0.5, 3.0], [1.0, -2.5, 0.0, 9.0, -4.0]])
    y = np.array([[2.0, 2.0, -0.25, 0.25, 0.0], [0.0, 1.5, 3.0, -2.0, 0.5]])
    t, g = _pair(mesh, x)
    for f in (np.floor_divide, np.remainder, np.fmod):
        got, want = f(g, y).toarray(), f(t, y).toarray()
        assert np.array_equal(got, want, equal_nan=True), f


def test_integer_power_matches_reference(mesh):
    x = np.array([[2, 1, -1, 3, 0], [5, -2, 4, 1, 7]], dtype=np.int32)
    e = np.array([[-1, -2, -3, 2, -1], [0, 3, 70, 64, 2]], dtype=np.int32)
    t, g = _pair(mesh, x)
    assert np.array_equal((g ** e).toarray(), (t ** e).toarray())
    assert np.array_equal((2 ** g).toarray(), (2 ** t).toarray())
    assert np.array_equal((g ** 3).toarray(), (t ** 3).toarray())
    assert (g ** 3).dtype == (t ** 3).dtype == np.int32
    for b in (t, g):
        with pytest.raises(TypeError):
            (b ** -1).toarray()


def test_matmul_batched_over_keys(mesh):
    x = _x()
    w = np.random.RandomState(16).randn(5, 3)
    t, g = _pair(mesh, x)
    out = g @ w
    assert out.split == (t @ w).split == 1
    _same(out.toarray(), (t @ w).toarray())


def test_matmul_2d_and_reflected(mesh):
    rs = np.random.RandomState(17)
    x, w = rs.randn(8, 5), rs.randn(5, 8)
    t, g = _pair(mesh, x)
    _same((g @ w).toarray(), (t @ w).toarray())
    _same((w @ g).toarray(), (w @ t).toarray())
    _same(np.matmul(w, g).toarray(), np.matmul(w, t).toarray())


def test_matmul_bolt_operand(mesh):
    rs = np.random.RandomState(18)
    x, y = rs.randn(8, 4, 5), rs.randn(8, 5, 2)
    out = bolt.array(x, CPU) @ bolt.array(y, CPU)
    want = ref.array(x, mesh) @ ref.array(y, mesh)
    assert out.split == want.split == 1
    _same(out.toarray(), want.toarray())


def test_matmul_bad_shapes_raise(mesh):
    for b in _pair(mesh, _x()):
        with pytest.raises(ValueError):
            b @ np.ones((7, 2))


def test_inplace_forms():
    x = _x()
    b = bolt.array(x, CPU)
    orig = b
    b += 1
    b *= 2
    b //= 1
    assert bolt.allclose(b.toarray(), ((x + 1) * 2) // 1)
    assert bolt.allclose(orig.toarray(), x)


def test_numpy_ufunc_dispatch(mesh):
    x = _x()
    t, g = _pair(mesh, x)
    out = np.sin(g)
    assert isinstance(out, bolt.BoltArrayGPU) and out.deferred
    for f in (np.sin, np.exp, lambda b: np.add(b, 1),
              lambda b: np.add(np.ones_like(x), b),
              lambda b: np.maximum(b, 0), np.isnan):
        got, want = f(g), f(t)
        assert got.dtype == want.dtype
        _same(got.toarray(), want.toarray())
    assert np.isnan(g).toarray().sum() == 0


def test_numpy_ufunc_parity_both_backends(mesh):
    x = _x()
    lo, g = bolt.array(x), bolt.array(x, CPU)
    for uf in (np.sin, np.exp, np.sqrt, np.tanh):
        assert bolt.allclose(uf(abs(lo) + 1).toarray(),
                             uf(abs(g) + 1).toarray())


_UNARY = sorted(n for n in ufuncs._UNARY)
_BINARY = sorted(n for n in ufuncs._BINARY if n != "mod")


def _operand(name, dtype, seed):
    rs = np.random.RandomState(seed)
    if dtype == np.bool_:
        return rs.rand(6, 5) > 0.5
    if np.dtype(dtype).kind in "iu":
        lo = 1 if name in ("left_shift", "right_shift", "power") else -4
        lo = max(lo, 0) if np.dtype(dtype).kind == "u" else lo
        return rs.randint(lo, 5, (6, 5)).astype(dtype)
    x = rs.randn(6, 5) * 2
    if name in ("arccosh",):
        x = abs(x) + 1
    elif name in ("arcsin", "arccos", "arctanh"):
        x = np.clip(x, -0.9, 0.9)
    elif name in ("sqrt", "log", "log2", "log10", "reciprocal"):
        x = abs(x) + 0.1
    elif name == "log1p":
        x = abs(x)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32,
                                   np.int64, np.uint8, np.bool_])
@pytest.mark.parametrize("name", _UNARY)
def test_every_unary_ufunc_matches_reference(mesh, name, dtype):
    # the port's table against jnp: the same dtype (or the same refusal)
    # and the values, per record through the map chain
    uf = getattr(np, name)
    x = _operand(name, dtype, 30)
    t, g = _pair(mesh, x)
    try:
        want = uf(t).toarray()
    except (TypeError, ValueError) as exc:
        with pytest.raises(type(exc)):
            uf(g).toarray()
        return
    got = uf(g)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got.toarray(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32,
                                   np.uint8, np.bool_])
@pytest.mark.parametrize("name", _BINARY)
def test_every_binary_ufunc_matches_reference(mesh, name, dtype):
    uf = getattr(np, name)
    x, y = _operand(name, dtype, 31), _operand(name, dtype, 32)
    t, g = _pair(mesh, x)
    for other in (y, 2):
        try:
            want = uf(t, other).toarray()
        except (TypeError, ValueError) as exc:
            with pytest.raises(type(exc)):
                uf(g, other).toarray()
            continue
        got = uf(g, other)
        assert got.dtype == want.dtype, (other, got.dtype, want.dtype)
        np.testing.assert_allclose(got.toarray(), want, rtol=1e-6,
                                   atol=1e-6, err_msg=str(other))


def test_ufunc_unsupported_methods_raise():
    b = bolt.array(_x(), CPU)
    with pytest.raises(TypeError):
        np.add.at(b, [0], 1.0)
    with pytest.raises(TypeError):
        np.add.reduce(b, out=np.empty(b.shape[1:]))
    with pytest.raises(TypeError):
        np.add.reduce(b, where=np.zeros(b.shape, bool))
    with pytest.raises(TypeError):
        np.add(b, 1, out=np.empty(b.shape))
    with pytest.raises(TypeError):
        np.cbrt(b)                      # no torch twin


def test_ufunc_reduce_parity(mesh):
    x = _x()
    t, g = _pair(mesh, x)
    lo = bolt.array(x)
    cases = [
        lambda b: np.add.reduce(b),
        lambda b: np.add.reduce(b, axis=None),
        lambda b: np.add.reduce(b, axis=(0, 2)),
        lambda b: np.add.reduce(b, axis=1, keepdims=True),
        lambda b: np.add.reduce(b, axis=()),
        lambda b: np.maximum.reduce(b, initial=100.0),
        lambda b: np.multiply.reduce(b, axis=2),
        lambda b: np.hypot.reduce(b),
        lambda b: np.hypot.reduce(b, axis=(0, 1)),
        lambda b: np.add.reduce(b, axis=(0, 1), initial=7.0),
        lambda b: np.logical_and.reduce(abs(b) > 0.01),
        lambda b: np.logical_xor.reduce(b > 0),
        lambda b: np.logical_xor.reduce(b > 0, axis=(0, 1)),
        lambda b: np.logical_xor.reduce(b > 0, axis=2),
        lambda b: np.add.reduce(b, axis=(), initial=7.0),
        lambda b: np.subtract.reduce(b, axis=(), initial=7.0),
        lambda b: np.subtract.reduce(b, axis=1),
        lambda b: np.add.reduce(b, where=np.True_),
        lambda b: np.add.reduce(b, initial=np.array(5.0)),
    ]
    for f in cases:
        got, want = f(g).toarray(), np.asarray(f(t).toarray())
        assert got.shape == want.shape
        assert bolt.allclose(got, want) and bolt.allclose(got, f(lo))
    out = np.add.reduce(g, axis=0)
    assert isinstance(out, bolt.BoltArrayGPU) and out.split == 0
    with pytest.raises(ValueError, match="duplicate value in 'axis'"):
        np.add.reduce(g, axis=(0, 0))
    with pytest.raises(ValueError, match="reorderable"):
        np.subtract.reduce(g, axis=(0, 1))
    with pytest.raises(TypeError):
        np.power.reduce(g)
    with pytest.raises(TypeError):
        np.arctan2.reduce(g)
    xi = np.arange(24).reshape(8, 3)
    gi = bolt.array(xi, CPU)
    with pytest.raises(TypeError):
        np.bitwise_xor.reduce(gi)
    assert np.array_equal(np.bitwise_xor.reduce(gi, axis=1).toarray(),
                          np.bitwise_xor.reduce(xi, axis=1))


def test_ufunc_accumulate_reduceat_parity(mesh):
    x = _x()
    t, g = _pair(mesh, x)
    lo = bolt.array(x)
    cases = [
        lambda b: np.add.accumulate(b),
        lambda b: np.add.accumulate(b, axis=2),
        lambda b: np.multiply.accumulate(b, axis=1),
        lambda b: np.maximum.accumulate(b),
        lambda b: np.add.reduceat(b, [0, 2, 5], axis=0),
        lambda b: np.add.reduceat(b, [0, 3], axis=1),
    ]
    for f in cases:
        got = f(g).toarray()
        assert got.shape == np.asarray(f(lo)).shape
        assert bolt.allclose(got, f(lo))
        _same(got, f(t).toarray())
    out = np.add.accumulate(g)
    assert isinstance(out, bolt.BoltArrayGPU) and out.split == g.split
    idx = bolt.array(np.array([0, 2, 5]), CPU)
    assert bolt.allclose(np.add.reduceat(g, idx).toarray(),
                         np.add.reduceat(x, [0, 2, 5], axis=0))
    for b in (lo, g):
        with pytest.raises(IndexError):
            np.add.reduceat(b, [0, 99], axis=0)
        with pytest.raises(IndexError):
            np.add.reduceat(b, [0, -2], axis=0)
        with pytest.raises(ValueError, match="does not allow multiple"):
            np.add.accumulate(b, axis=None)
        with pytest.raises(ValueError, match="does not allow multiple"):
            np.add.reduceat(b, [0], axis=None)
    for b in (bolt.array(np.zeros((0, 3))), bolt.array(np.zeros((0, 3)),
                                                       CPU)):
        with pytest.raises(IndexError):
            np.add.reduceat(b, [0], axis=0)
    assert bolt.allclose(np.add.reduce(g, where=1).toarray(),
                         np.add.reduce(x, where=1))


def test_ufunc_outer_parity(mesh):
    x = _x()[:, 0, 0]
    w = np.linspace(-1.0, 1.0, 3)
    t, g = _pair(mesh, x)
    for f in (lambda b: np.subtract.outer(b, w),
              lambda b: np.add.outer(w, b),
              lambda b: np.add.outer(b, w, dtype=np.float32),
              lambda b: np.multiply.outer(b, np.ones((2, 2)))):
        _same(f(g).toarray(), f(t).toarray())
    assert np.subtract.outer(g, w).split == 1
    assert np.add.outer(w, g).split == 0


def test_matmul_2d_keeps_row_keys(mesh):
    rs = np.random.RandomState(19)
    x, w, v, y = rs.randn(8, 5), rs.randn(5, 3), rs.randn(5), rs.randn(3, 8)
    t, g = _pair(mesh, x)
    for f, split in ((lambda b: b @ w, 1), (lambda b: b @ v, 1),
                     (lambda b: y @ b, 0)):
        out = f(g)
        assert out.split == f(t).split == split
        _same(out.toarray(), f(t).toarray())


def test_multi_output_ufuncs_unsupported():
    b = bolt.array(_x(), CPU)
    with pytest.raises(TypeError):
        np.modf(b)
    with pytest.raises(TypeError):
        np.divmod(b, 2.0)


def test_tensor_operands_no_host_roundtrip(monkeypatch):
    # a torch.Tensor operand feeds the op directly: it never passes
    # through numpy (the port's counterpart of the jax.Array operand)
    x = _x()
    b = bolt.array(x, CPU)
    seen = []
    orig = np.asarray

    def spy(a, *args, **kw):
        if isinstance(a, torch.Tensor):
            seen.append(type(a))
        return orig(a, *args, **kw)

    monkeypatch.setattr(np, "asarray", spy)
    w = torch.ones(x.shape[1:], dtype=torch.float64)
    out1 = (b + w).toarray()
    out2 = (b @ torch.ones((5, 3), dtype=torch.float64)).toarray()
    monkeypatch.undo()
    assert not seen
    assert bolt.allclose(out1, x + 1)
    assert bolt.allclose(out2, x @ np.ones((5, 3)))


def test_dot_precision_option():
    x = np.random.RandomState(70).randn(32, 16).astype(np.float32)
    w = np.random.RandomState(71).randn(16, 8).astype(np.float32)
    b = bolt.array(x, CPU)
    hi = b.dot(w)
    fast = b.dot(w, precision="default")
    want = x @ w
    assert np.allclose(hi.toarray(), want, rtol=1e-6, atol=1e-6)
    assert np.allclose(fast.toarray(), want, rtol=3e-2, atol=3e-2)
    with pytest.raises(ValueError):
        b.dot(w, precision="fastest")
    # the call restores the process's float32 matmul precision
    assert torch.get_float32_matmul_precision() == "highest"
