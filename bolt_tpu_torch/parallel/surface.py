"""The array surface and the ops library on a mesh: the cases of the
``surface`` payload.

Each case is ``fn(bolt, mesh) -> dict`` written against the surface the
two packages share (``bolt.array(x, mesh, axis=)``, the methods, the
operators, ``bolt.ops``), with its data made from a seed inside it.  A
pod of :mod:`bolt_tpu_torch.parallel.harness` runs it with
``bolt_tpu_torch`` on a mesh of ranks (``payload_surface``); the tests
run the same function with the reference package on its device mesh and
hold the two results together.  A case reports an expected error as the
exception's class name (:func:`err`), the same on every rank.

Nothing here imports jax or the reference package.
"""

import numpy as np


def err(fn):
    """The class name of the exception ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — the class is the answer
        return type(exc).__name__
    return None


def err_msg(fn):
    """``[class name, message]`` of the exception ``fn()`` raises, or
    None."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — the error is the answer
        return [type(exc).__name__, str(exc)]
    return None


def same(got, want, path="", rtol=1e-12, atol=1e-12):
    """Hold a case's result ``got`` against ``want``: the same keys and
    lengths, class names and strings equal, integer and boolean arrays
    equal, float and complex arrays within ``rtol``/``atol`` (NaN where
    ``want`` has NaN).  Raises ``AssertionError`` naming the path."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got) if isinstance(got, dict) else got,
             sorted(want))
        for k in want:
            same(got[k], want[k], "%s/%s" % (path, k), rtol, atol)
        return
    if want is None or isinstance(want, (str, bool)):
        assert got == want, (path, got, want)
        return
    if isinstance(want, (list, tuple)) and any(
            isinstance(w, (list, tuple, dict, np.ndarray)) for w in want):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, "%s/%d" % (path, i), rtol, atol)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if w.dtype.kind in "fc" or g.dtype.kind in "fc":
        assert np.allclose(g, w, rtol=rtol, atol=atol, equal_nan=True), \
            (path, g, w)
    else:
        assert np.array_equal(g, w), (path, g, w)


def arr(b):
    """A bolt array's values as a host array."""
    return np.asarray(b.toarray())


def lay(b):
    """A bolt array's values, shape and split."""
    return {"v": arr(b), "shape": list(b.shape), "split": int(b.split)}


def _ops_x(seed=12):
    return np.random.RandomState(seed).randn(8, 4, 5)


def _m_f():
    return np.random.RandomState(7).randn(8, 4, 5)


def _sx(shape=(16, 5, 4)):
    return np.random.RandomState(21).randn(*shape)


def _sh(shape=(4, 2, 3, 2)):
    return np.random.RandomState(5).randn(*shape)


def _gx(shape=(12, 4, 3), seed=80):
    return np.random.RandomState(seed).randn(*shape)


# ---------------------------------------------------------------------
# operators and ufuncs (tests/test_tpu_operators.py)
# ---------------------------------------------------------------------

def c_scalar_ops(bolt, mesh):
    b = bolt.array(_ops_x(), mesh)
    return {"add": arr(b + 1), "radd": arr(1 + b), "sub": arr(b - 2),
            "rsub": arr(2 - b), "mul": arr(b * 3), "div": arr(b / 2),
            "rdiv": arr(2 / (b + 10)), "pow": arr(b ** 2), "neg": arr(-b),
            "abs": arr(abs(b))}


def c_scalar_ops_defer(bolt, mesh):
    m = (bolt.array(_ops_x(), mesh) + 1) * 2 - 3
    return {"deferred": bool(m.deferred), "v": arr(m)}


def c_array_operand(bolt, mesh):
    x = _ops_x()
    b = bolt.array(x, mesh)
    other = np.random.RandomState(13).randn(*x.shape)
    row = np.random.RandomState(14).randn(5)
    return {"add": lay(b + other), "mul": arr(b * other),
            "row": lay(b + row),
            "bad": err(lambda: b + np.ones((9, 1, 1)))}


def c_array_operand_broadcast_outgrows_self(bolt, mesh):
    x = _ops_x()
    b = bolt.array(x, mesh)
    s = b.mean(axis=(0, 1, 2))
    col = bolt.array(x[:, :, :1], mesh)
    return {"ones": lay(np.ones(8) * s), "arange": arr(np.arange(6.0) + s),
            "grown": lay(col * np.ones(5)),
            "led": lay(b + np.ones((3, 8, 4, 5)))}


def c_bolt_operand(bolt, mesh):
    x = _ops_x()
    b = bolt.array(x, mesh)
    return {"mesh": lay(b + bolt.array(x * 2, mesh)),
            "local": arr(b + bolt.array(np.ones_like(x)))}


def c_comparisons(bolt, mesh):
    b = bolt.array(_ops_x(), mesh)
    return {"gt": arr(b > 0), "le": arr(b <= 0.5), "eq": arr(b == b),
            "ne": arr(b != b), "dtype": str(np.dtype((b > 0).dtype))}


def c_value_shaped_result_ops(bolt, mesh):
    s = bolt.array(_ops_x(), mesh).sum()
    return {"add": lay(s + 1), "abs": arr(abs(s))}


def c_mixed_expression(bolt, mesh):
    b = bolt.array(_ops_x(), mesh)
    return {"v": arr(((b + 1) * (b - 1)).mean())}


def c_numpy_left_operand_reflects(bolt, mesh):
    x = _ops_x()
    b = bolt.array(x, mesh)
    out = np.ones_like(x) + b
    out2 = np.float64(2.0) * b
    return {"ones": arr(out), "same": type(out) is type(b),
            "scalar": arr(out2), "same2": type(out2) is type(b)}


def c_eq_sentinel(bolt, mesh):
    b = bolt.array(_ops_x(), mesh)
    return {"none": (b == None) is False,   # noqa: E711
            "not_none": (b != None) is True,   # noqa: E711
            "str": (b == "nope") is False}


def c_neg_bool_parity(bolt, mesh):
    return {"err": err(lambda: -(bolt.array(_ops_x(), mesh) > 0))}


def c_scalar_ops_cache_stable(bolt, mesh):
    b = bolt.array(_ops_x(), mesh)
    return {"v": [arr((b + 1.0).sum()) for _ in range(3)]}


def c_floordiv(bolt, mesh):
    x = _ops_x() * 10
    b = bolt.array(x, mesh)
    other = np.random.RandomState(15).randn(*x.shape) + 5
    return {"a": arr(b // 3), "r": arr(100 // (abs(b) + 1)),
            "o": arr(b // other)}


def c_mod_reflected(bolt, mesh):
    b = bolt.array(abs(_ops_x()) + 1, mesh)
    return {"mod": arr(b % 2), "rmod": arr(7 % b), "rpow": arr(2.0 ** b)}


def c_matmul_batched_over_keys(bolt, mesh):
    w = np.random.RandomState(16).randn(5, 3)
    return lay(bolt.array(_ops_x(), mesh) @ w)


def c_matmul_2d_and_reflected(bolt, mesh):
    rs = np.random.RandomState(17)
    x, w = rs.randn(8, 5), rs.randn(5, 8)
    b = bolt.array(x, mesh)
    return {"mm": lay(b @ w), "r": lay(w @ b), "np": arr(np.matmul(w, b))}


def c_matmul_bolt_operand(bolt, mesh):
    rs = np.random.RandomState(18)
    x, y = rs.randn(8, 4, 5), rs.randn(8, 5, 2)
    return lay(bolt.array(x, mesh) @ bolt.array(y, mesh))


def c_matmul_bad_shapes_raise(bolt, mesh):
    b = bolt.array(_ops_x(), mesh)
    return {"err": err(lambda: b @ np.ones((7, 2)))}


def c_inplace_forms(bolt, mesh):
    x = _ops_x()
    b = bolt.array(x, mesh)
    orig = b
    b += 1
    b *= 2
    b //= 1
    return {"v": arr(b), "orig": arr(orig)}


def c_numpy_ufunc_dispatch(bolt, mesh):
    x = _ops_x()
    b = bolt.array(x, mesh)
    out = np.sin(b)
    return {"sin": arr(out), "deferred": bool(out.deferred),
            "exp": arr(np.exp(b)), "add": arr(np.add(b, 1)),
            "radd": arr(np.add(np.ones_like(x), b)),
            "max": arr(np.maximum(b, 0)),
            "nan": int(arr(np.isnan(b)).sum())}


def c_numpy_ufunc_parity_both_backends(bolt, mesh):
    tp = bolt.array(_ops_x(), mesh)
    return {u.__name__: arr(u(abs(tp) + 1))
            for u in (np.sin, np.exp, np.sqrt, np.tanh)}


def c_ufunc_unsupported_methods_raise(bolt, mesh):
    b = bolt.array(_ops_x(), mesh)
    return {"at": err(lambda: np.add.at(b, [0], 1.0)),
            "out": err(lambda: np.add.reduce(b, out=np.empty(b.shape[1:]))),
            "where": err(lambda: np.add.reduce(
                b, where=np.zeros(b.shape, bool))),
            "call_out": err(lambda: np.add(b, 1, out=np.empty(b.shape)))}


_REDUCE_CASES = [
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
    lambda b: np.subtract.reduce(b),
    lambda b: np.add.reduce(b, where=np.True_),
    lambda b: np.add.reduce(b, initial=np.array(5.0)),
]


def c_ufunc_reduce_parity(bolt, mesh):
    tp = bolt.array(_ops_x(), mesh)
    ti = bolt.array(np.arange(24).reshape(8, 3), mesh)
    out = {"r%d" % i: arr(f(tp)) for i, f in enumerate(_REDUCE_CASES)}
    out["split"] = int(np.add.reduce(tp, axis=0).split)
    out["dup"] = err(lambda: np.add.reduce(tp, axis=(0, 0)))
    out["reorder"] = err(lambda: np.subtract.reduce(tp, axis=(0, 1)))
    out["power"] = err(lambda: np.power.reduce(tp))
    out["arctan2"] = err(lambda: np.arctan2.reduce(tp))
    out["xor_keys"] = err(lambda: np.bitwise_xor.reduce(ti))
    out["xor_values"] = arr(np.bitwise_xor.reduce(ti, axis=1))
    return out


def c_ufunc_accumulate_reduceat_parity(bolt, mesh):
    tp = bolt.array(_ops_x(), mesh)
    out = {"acc0": lay(np.add.accumulate(tp)),
           "acc2": arr(np.add.accumulate(tp, axis=2)),
           "mul1": arr(np.multiply.accumulate(tp, axis=1)),
           "max": arr(np.maximum.accumulate(tp)),
           "at0": arr(np.add.reduceat(tp, [0, 2, 5], axis=0)),
           "at1": arr(np.add.reduceat(tp, [0, 3], axis=1)),
           "idx": arr(np.add.reduceat(tp, bolt.array(np.array([0, 2, 5]),
                                                     mesh))),
           "oob": err(lambda: np.add.reduceat(tp, [0, 99], axis=0)),
           "neg": err(lambda: np.add.reduceat(tp, [0, -2], axis=0)),
           "acc_none": err(lambda: np.add.accumulate(tp, axis=None)),
           "at_none": err(lambda: np.add.reduceat(tp, [0], axis=None)),
           "where1": arr(np.add.reduce(tp, where=1))}
    z = bolt.array(np.zeros((0, 3)), mesh)
    out["empty"] = err(lambda: np.add.reduceat(z, [0], axis=0))
    return out


def c_ufunc_outer_parity(bolt, mesh):
    tp = bolt.array(_ops_x()[:, 0, 0], mesh)
    w = np.linspace(-1.0, 1.0, 3)
    return {"sub": lay(np.subtract.outer(tp, w)),
            "add": lay(np.add.outer(w, tp)),
            "f32": arr(np.add.outer(tp, w, dtype=np.float32)),
            "mul": arr(np.multiply.outer(tp, np.ones((2, 2))))}


def c_matmul_2d_keeps_row_keys(bolt, mesh):
    rs = np.random.RandomState(19)
    x, w = rs.randn(8, 5), rs.randn(5, 3)
    b = bolt.array(x, mesh)
    v = rs.randn(5)
    y = rs.randn(3, 8)
    return {"w": lay(b @ w), "v": lay(b @ v), "r": lay(y @ b)}


def c_multi_output_ufuncs_unsupported(bolt, mesh):
    b = bolt.array(_ops_x(), mesh)
    return {"modf": err(lambda: np.modf(b)),
            "divmod": err(lambda: np.divmod(b, 2.0))}


def c_jax_array_operands_no_host_roundtrip(bolt, mesh):
    x = _ops_x()
    b = bolt.array(x, mesh)
    return {"add": arr(b + np.ones(x.shape[1:], np.float32)),
            "mm": arr(b @ np.ones((5, 3), np.float32)),
            "cat": lay(b.concatenate(x.astype(np.float32)))}


def c_dot_precision_option(bolt, mesh):
    x = np.random.RandomState(70).randn(32, 16).astype(np.float32)
    w = np.random.RandomState(71).randn(16, 8).astype(np.float32)
    b = bolt.array(x, mesh)
    fast = b.dot(w, precision="default")  # lint: allow(BLT103 the option under test)
    return {"hi": arr(b.dot(w)),
            "fast_close": bool(np.allclose(arr(fast), x @ w, rtol=3e-2,
                                           atol=3e-2))}


# ---------------------------------------------------------------------
# indexing (tests/test_tpu_getting.py)
# ---------------------------------------------------------------------

def _gt_x():
    return np.random.RandomState(6).randn(8, 4, 5)


def c_slices(bolt, mesh):
    b = bolt.array(_gt_x(), mesh)
    return {"all": lay(b[:]), "keys": lay(b[2:6]), "vals": lay(b[:, 1:3]),
            "step": lay(b[::2, :, ::2]), "neg": lay(b[1:7:2, ::-1])}


def c_ints_squeeze(bolt, mesh):
    b = bolt.array(_gt_x(), mesh)
    return {"k": lay(b[3]), "v": lay(b[:, 2]), "all": arr(b[-1, -2, -3])}


def c_lists_orthogonal(bolt, mesh):
    b = bolt.array(_gt_x(), mesh)
    return {"k": lay(b[[0, 3, 5]]), "ix": lay(b[[0, 1], :, [0, 2, 4]]),
            "v": arr(b[:, [3, 1]]), "neg": arr(b[[-1, 0]])}


def c_bool_arrays(bolt, mesh):
    x = _gt_x()
    b = bolt.array(x, mesh)
    return {"k": lay(b[x[:, 0, 0] > 0]),
            "v": lay(b[:, :, np.array([True, False, True, False, True])])}


def c_mixed(bolt, mesh):
    b = bolt.array(_gt_x(), mesh)
    return {"a": lay(b[2:7, [0, 3], ::2]), "b": lay(b[1, :, [0, 4]])}


def c_split_bookkeeping(bolt, mesh):
    b = bolt.array(_gt_x(), mesh, axis=(0, 1))
    return {"a": lay(b[0]), "b": lay(b[0, 0]), "c": lay(b[:, 0]),
            "d": lay(b[:, :, 0])}


def c_errors(bolt, mesh):
    b = bolt.array(_gt_x(), mesh)
    return {"many": err(lambda: b[0, 0, 0, 0]), "oob": err(lambda: b[99])}


def c_negative_and_mixed_index_forms(bolt, mesh):
    x = np.random.RandomState(50).randn(16, 6, 4)
    b = bolt.array(x, mesh)
    return {"a": arr(b[-1]), "b": arr(b[-3:]), "c": arr(b[..., -2:]),
            "d": arr(b[[-1, 0, 2]]), "e": lay(b[::-1]),
            "f": arr(b[np.array([1, 3])]), "g": arr(b[2, -1, ::2]),
            "h": list(arr(b[5:2]).shape), "i": arr(b[1, [0, 2], :])}


def c_take_parity(bolt, mesh):
    x = _gt_x()
    b = bolt.array(x, mesh)
    out = {}
    for i, kw in enumerate([dict(indices=[2, 0, 5]),
                            dict(indices=[1, -1], axis=0),
                            dict(indices=[3, 1], axis=1),
                            dict(indices=[0, 2, 4], axis=2),
                            dict(indices=[[0, 1], [2, 3]], axis=0),
                            dict(indices=7)]):
        out["t%d" % i] = lay(b.take(**kw))
    out["split_b"] = int(b.take(0, axis=0).split)
    out["oob"] = err(lambda: b.take([9999]))
    out["oob0"] = err(lambda: b.take([8], axis=0))
    out["chain"] = arr(bolt.array(x, mesh).map(lambda v: v * 2)
                       .take([1, 3], axis=0))
    return out


def c_take_numpy_dtype_and_mode_semantics(bolt, mesh):
    b = bolt.array(_gt_x(), mesh)
    out = {"a%d" % i: arr(b.take(*a)) for i, a in enumerate(
        [([True, False],), ([2.7],), (1.5,), ([-1.5],)])}
    out["farr"] = err(lambda: b.take(np.array([1.5])))
    out["fempty"] = err(lambda: b.take(np.array([], dtype=float)))
    out["clip"] = arr(b.take([9999], mode="clip"))
    out["wrap"] = arr(b.take([-3, 175], axis=None, mode="wrap"))
    out["mode"] = err(lambda: b.take([0], mode="nope"))
    return out


# ---------------------------------------------------------------------
# layout (tests/test_tpu_shaping.py)
# ---------------------------------------------------------------------

def c_transpose_within_groups(bolt, mesh):
    from itertools import permutations
    b = bolt.array(_sh(), mesh, axis=(0, 1))
    return {str(k + tuple(v + 2 for v in vp)): lay(b.transpose(
        *(tuple(k) + tuple(v + 2 for v in vp))))
        for k in permutations(range(2)) for vp in permutations(range(2))}


def c_transpose_guard(bolt, mesh):
    b = bolt.array(_sh(), mesh, axis=(0, 1))
    return {"cross": err(lambda: b.transpose(0, 2, 1, 3)),
            "perm": err(lambda: b.transpose(0, 0, 1, 2))}


def c_T(bolt, mesh):
    return lay(bolt.array(_sh(), mesh, axis=(0, 1)).T)


def c_swapaxes(bolt, mesh):
    b = bolt.array(_sh(), mesh, axis=(0, 1))
    return {"v": lay(b.swapaxes(2, 3)), "k": lay(b.swapaxes(0, 1))}


def c_reshape_within_groups(bolt, mesh):
    b = bolt.array(_sh(), mesh, axis=(0, 1))
    return {"a": lay(b.reshape(8, 3, 2)), "b": lay(b.reshape(4, 2, 6)),
            "c": lay(b.reshape((2, 2, 2, 6)))}


def c_reshape_guards(bolt, mesh):
    b = bolt.array(_sh(), mesh, axis=(0, 1))
    return {"size": err(lambda: b.reshape(4, 2, 3, 3)),
            "boundary": err(lambda: b.reshape(3, 16))}


def c_squeeze(bolt, mesh):
    b = bolt.array(_sh((4, 1, 3, 1)), mesh, axis=(0, 1))
    return {"all": lay(b.squeeze()), "v": lay(b.squeeze(axis=(3,))),
            "bad": err(lambda: b.squeeze(axis=(0,)))}


def c_keys_values_views(bolt, mesh):
    b = bolt.array(_sh(), mesh, axis=(0, 1))
    return {"kr": lay(b.keys.reshape(8)), "vr": lay(b.values.reshape(6)),
            "kt": lay(b.keys.transpose(1, 0)),
            "vt": lay(b.values.transpose(1, 0))}


def c_reshape_key_merge(bolt, mesh):
    """A reshape that merges the two key axes across box edges, and its
    inverse."""
    x = np.random.RandomState(31).randn(8, 6, 3, 2)
    b = bolt.array(x, mesh, axis=(0, 1))
    m = b.reshape(48, 3, 2)
    return {"merge": lay(m), "back": lay(m.reshape(8, 6, 3, 2)),
            "flat": lay(b.reshape(8, 6, 6)), "ravel": lay(b.ravel()),
            "ravelF": lay(b.ravel(order="F")), "flatten": lay(b.flatten())}


# ---------------------------------------------------------------------
# edges (tests/test_tpu_edges.py)
# ---------------------------------------------------------------------

def _e_x():
    return np.random.RandomState(3).randn(8, 4, 6)


def c_chunk_of_deferred(bolt, mesh):
    m = bolt.array(_e_x(), mesh).map(lambda v: v + 1)
    return {"v": arr(m.chunk((2, 3)).map(lambda c: c * 2).unchunk())}


def c_stacked_of_deferred(bolt, mesh):
    m = bolt.array(_e_x(), mesh).map(lambda v: v * 3)
    return {"v": arr(m.stacked(4).map(lambda s: s + 1).unstack())}


def c_filter_after_swap(bolt, mesh):
    s = bolt.array(_e_x(), mesh).swap((0,), (0,))
    return lay(s.filter(lambda v: v.sum() > 0))


def c_getitem_on_deferred(bolt, mesh):
    m = bolt.array(_e_x(), mesh).map(lambda v: v * 2)
    return {"a": arr(m[2:5, 1]), "b": arr(m[[0, 7]])}


def c_reduce_after_operators(bolt, mesh):
    import operator
    b = bolt.array(_e_x(), mesh)
    return {"v": arr(((b + 1) * 2).reduce(operator.add))}


def c_concatenate_deferred_operand(bolt, mesh):
    x = _e_x()
    a = bolt.array(x, mesh).map(lambda v: v - 1)
    c = bolt.array(x, mesh).map(lambda v: v * 2)
    return {"k": lay(a.concatenate(c)), "v": lay(a.concatenate(c, axis=2))}


def c_welford_on_deferred(bolt, mesh):
    st = (bolt.array(_e_x(), mesh) * 2 + 1).stats()
    return {"mean": np.asarray(st.mean()), "var": np.asarray(st.variance())}


def c_keys_view_after_swap(bolt, mesh):
    x = np.random.RandomState(50).randn(8, 6, 4)
    s = bolt.array(x, mesh, axis=(0, 1)).swap((0,), (0,))
    return {"k": lay(s.keys.reshape(24)), "t": lay(s.keys.transpose(1, 0))}


def c_empty_key_axis(bolt, mesh):
    e = bolt.array(np.zeros((0, 3)), mesh)
    return {"add": lay(e + 1), "shape": list((e * 2).shape)}


def c_one_axis_typeerror_matches_ndarray(bolt, mesh):
    b = bolt.array(_e_x(), mesh)
    return {"argmax": err(lambda: b.argmax(axis=1.0)),
            "cumsum": err(lambda: b.cumsum(axis="1")),
            "argsort": err(lambda: b.argsort(axis=0.5))}


# ---------------------------------------------------------------------
# stacking (tests/test_tpu_stacking.py)
# ---------------------------------------------------------------------

def _st_x():
    return np.random.RandomState(4).randn(16, 3, 2)


def c_stack_view(bolt, mesh):
    s = bolt.array(_st_x(), mesh).stacked(2)
    return {"shape": list(s.shape), "split": int(s.split),
            "size": int(s.size), "unstack": lay(s.unstack())}


def c_stack_map_elementwise(bolt, mesh):
    s = bolt.array(_st_x(), mesh).stacked(2)
    return lay(s.map(lambda blk: blk * 2 + 1).unstack())


def c_stack_map_blockwise(bolt, mesh):
    s = bolt.array(_st_x(), mesh).stacked(2)
    return lay(s.map(lambda blk: blk - blk.mean(0)).unstack())


def c_stack_map_value_shape_change(bolt, mesh):
    s = bolt.array(_st_x(), mesh).stacked(2)
    return lay(s.map(lambda blk: blk.sum(axis=2)).unstack())


def c_stack_map_count_guard(bolt, mesh):
    s = bolt.array(_st_x(), mesh).stacked(2)
    return {"err": err(lambda: s.map(lambda blk: blk[:1]).unstack()
                       .toarray())}


def c_stacked_map_zero_records(bolt, mesh):
    e = bolt.array(np.zeros((0, 3, 2)), mesh).stacked(4)
    return lay(e.map(lambda blk: blk * 2).unstack())


def c_stacked_map_value_shape_and_dtype_hints(bolt, mesh):
    s = bolt.array(_st_x(), mesh).stacked(2)
    out = s.map(lambda blk: blk * 2, value_shape=(3, 2),
                dtype=np.float32).unstack()
    return {"v": arr(out), "dtype": str(np.dtype(out.dtype)),
            "bad": err(lambda: s.map(lambda blk: blk * 2,
                                     value_shape=(4, 2)))}


# ---------------------------------------------------------------------
# the ndarray methods (tests/test_ndarray_methods.py)
# ---------------------------------------------------------------------

def c_sort_matches_numpy(bolt, mesh):
    x = _m_f()
    b = bolt.array(x, mesh)
    r = b.sort(axis=0)
    m = bolt.array(x, mesh).map(lambda v: v * -1)
    m.sort()
    c = bolt.array(x, mesh, axis=(0, 1))
    c.sort(axis=1)
    return {"none": r is None, "v": lay(b), "chain": arr(m), "k1": lay(c)}


def c_set_does_not_mutate(bolt, mesh):
    b = bolt.array(_m_f(), mesh)
    out = b.set(0, 0.0)
    return {"b": arr(b), "out": lay(out)}


def c_setitem_tpu_raises_pointing_to_set(bolt, mesh):
    b = bolt.array(_m_f(), mesh)

    def assign():
        b[0] = 1.0
    return {"err": err(assign)}


def c_setitem_local_orthogonal_matches_set(bolt, mesh):
    out = bolt.array(_m_f(), mesh).set(([0, 2], slice(None), [1, 3]), -5.0)
    return lay(out)


_SET_IDX = [np.s_[1:3], (2,), ([0, 1], 2), (2, [1, 3]),
            ([0, 2], slice(None), [1, 3]), (slice(None), 1, [0, 4]),
            np.s_[..., 2], ([4, 0], 1, 2), np.s_[5:1:-2, ::-1]]


def c_set_getitem_roundtrip(bolt, mesh):
    x = _m_f()
    b = bolt.array(x, mesh)
    out = {}
    for i, idx in enumerate(_SET_IDX):
        region = np.asarray(b[idx].toarray())
        s = b.set(idx, region * 0 - 1.0)
        out["s%d" % i] = arr(s)
        out["back%d" % i] = arr(s.set(idx, region))
    val = np.arange(4 * 5, dtype=float).reshape(4, 5)
    out["value"] = arr(b.set(np.s_[3:5], val))
    out["mesh_value"] = arr(b.set(np.s_[3:5], bolt.array(
        np.stack([val, val + 1]), mesh)))
    return out


def c_item_fetches_one_element_not_the_array(bolt, mesh):
    b = bolt.array(_m_f(), mesh)
    m = bolt.array(_m_f(), mesh).map(lambda v: v + 1)
    return {"flat": b.item(3), "multi": b.item(1, 2, 3), "neg": b.item(-1),
            "chain": m.item(7, 3, 4), "one": bolt.array(
                np.full((1, 1), 42.0), mesh).item(),
            "size": err(lambda: b.item()), "oob": err(lambda: b.item(999))}


def c_nonzero_two_phase_and_values(bolt, mesh):
    x = np.zeros((5, 4))
    x[1, 2] = 3.0
    x[4, 0] = -1.0
    t = bolt.array(x, mesh).nonzero()
    y = np.zeros((8, 4))
    y[1, 2] = y[6, 0] = y[7, 3] = 1.0
    m = bolt.array(y, mesh).map(lambda v: v * 0 + (v > 0.5))
    return {"t": [np.asarray(a) for a in t],
            "dtypes": [str(np.asarray(a).dtype) for a in t],
            "m": [np.asarray(a) for a in m.nonzero()]}


def c_searchsorted_sorter(bolt, mesh):
    x = np.random.RandomState(12).randn(16)
    order = np.argsort(x)
    v = np.linspace(-1, 1, 5)
    s = bolt.array(np.sort(x), mesh)
    return {"sorter": np.asarray(bolt.array(x, mesh).searchsorted(
        v, sorter=order)),
            "left": np.asarray(s.searchsorted(v)),
            "right": np.asarray(s.searchsorted(v, side="right")),
            "scalar": np.asarray(s.searchsorted(0.0)),
            "bad": err(lambda: bolt.array(x, mesh).searchsorted(
                0.0, sorter=np.arange(3)))}


def c_repeat_split_and_chain(bolt, mesh):
    x = _m_f()
    return {"flat": lay(bolt.array(x, mesh).repeat(2)),
            "k": lay(bolt.array(x, mesh).repeat(3, axis=0)),
            "arr": lay(bolt.array(x, mesh).repeat(np.arange(8) % 3, axis=0)),
            "chain": lay(bolt.array(x, mesh).map(lambda v: v + 1)
                         .repeat(2, axis=2))}


def c_ravel_and_diagonal_splits(bolt, mesh):
    b = bolt.array(_m_f(), mesh, axis=(0, 1))
    return {"ravel": lay(b.ravel()), "diag": lay(b.diagonal(0, 0, 2)),
            "diag1": lay(b.diagonal(1, 1, 2)),
            "trace": lay(b.trace(0, 0, 1))}


_METHOD_CASES = [
    ("astype", lambda b: b.astype(np.float32)),
    ("astype_int", lambda b: b.astype(np.int32)),
    ("conj", lambda b: b.conj()),
    ("conjugate", lambda b: b.conjugate()),
    ("real", lambda b: b.real),
    ("imag", lambda b: b.imag),
    ("round", lambda b: b.round(2)),
    ("clip", lambda b: b.clip(-0.5, 0.5)),
    ("argmax", lambda b: b.argmax()),
    ("argmin1", lambda b: b.argmin(axis=1)),
    ("cumprod", lambda b: b.cumprod(axis=0)),
    ("take", lambda b: b.take([7, 0, 3], axis=0)),
    ("diagonal", lambda b: b.diagonal(0, 1, 2)),
    ("trace", lambda b: b.trace(0, 1, 2)),
    ("median", lambda b: b.median()),
    ("ptp", lambda b: b.ptp()),
]


def c_method_table(bolt, mesh):
    """The reference's method table (``test_ndarray_methods.py``'s
    ``METHODS``) at the key layouts of a mesh."""
    out = {}
    for lbl, x in (("f", _m_f()), ("c", None)):
        if x is None:
            rs = np.random.RandomState(10)
            x = rs.randn(8, 4, 5) + 1j * rs.randn(8, 4, 5)
        b = bolt.array(x, mesh)
        for name, f in _METHOD_CASES:
            if lbl == "c" and name in ("argmax", "argmin1", "median", "ptp",
                                       "clip", "round"):
                continue
            out["%s_%s" % (lbl, name)] = lay(f(b))
    return out


def c_dtypes_on_mesh(bolt, mesh):
    """The methods of this slice in integer, int8, bool and f32."""
    out = {}
    ri = np.random.RandomState(8).randint(-3, 4, size=(8, 4, 5))
    for lbl, x in (("i64", ri), ("i8", ri.astype(np.int8)),
                   ("bool", ri > 0), ("f32", ri.astype(np.float32) * 0.5)):
        b = bolt.array(x, mesh)
        out[lbl] = {"add": lay(b + 1), "neg": err(lambda: -b) if lbl ==
                    "bool" else arr(-b),
                    "argmax": arr(b.argmax(axis=0)),
                    "argsort": arr(b.argsort(axis=0)),
                    "cumsum": lay(b.cumsum(axis=0)),
                    "sort": arr(_sorted(b)),
                    "getitem": arr(b[[1, 5], 1:3]),
                    "set": arr(b.set(np.s_[2:6, 0], 1)),
                    "sum": arr(np.add.reduce(b)),
                    "nonzero": [np.asarray(a) for a in b.nonzero()]}
    return out


def _sorted(b):
    c = b.astype(b.dtype)
    c.sort(axis=0)
    return c


# ---------------------------------------------------------------------
# quantiles, folds and scans (tests/test_stats_extras.py)
# ---------------------------------------------------------------------

def c_quantile_parity(bolt, mesh):
    b = bolt.array(_sx(), mesh, axis=(0,))
    return {str(q): lay(b.quantile(q)) for q in (0.0, 0.25, 0.5, 0.9, 1.0)}


def c_quantile_axes_and_median(bolt, mesh):
    x = _sx()
    b = bolt.array(x, mesh, axis=(0, 1))
    bq = bolt.array(x, mesh)
    return {"q": lay(b.quantile(0.5)), "med": arr(b.median()),
            "v": lay(b.quantile(0.75, axis=(2,))),
            "keep": lay(b.median(axis=(0,), keepdims=True)),
            "lin": [arr(bq.quantile(float(q))) for q in
                    np.linspace(0.1, 0.9, 5)],
            "chain": arr(bolt.array(x, mesh).map(lambda v: v * 2).median()),
            "methods": [arr(bq.quantile(0.3, method=m)) for m in
                        ("lower", "higher", "midpoint", "nearest")]}


def c_quantile_vector_q(bolt, mesh):
    x = _sx()
    qs = [0.1, 0.5, 0.9]
    return {"t": lay(bolt.array(x, mesh).quantile(qs)),
            "t2": lay(bolt.array(x, mesh, axis=(0, 1)).quantile(
                qs, keepdims=True)),
            "t3": lay(bolt.array(x, mesh).quantile(qs, axis=(2,))),
            "t4": lay(bolt.array(x, mesh).quantile([0.2, 0.4, 0.6, 0.8])),
            "t1": lay(bolt.array(x, mesh).quantile([0.5]))}


def c_quantile_validation(bolt, mesh):
    b = bolt.array(_sx(), mesh)
    return {str(i): err(lambda q=q: b.quantile(q)) for i, q in enumerate(
        [1.5, [0.2, 1.8], [[0.2], [0.8]], "half", float("nan"),
         [0.5, float("nan")]])}


def c_argmax_argmin_parity(bolt, mesh):
    x = _sx((12, 5, 4))
    b = bolt.array(x, mesh, axis=(0,))
    out = {}
    for axis in (None, 0, 1, 2, -1, -2):
        out["max%s" % axis] = lay(b.argmax(axis=axis))
        out["min%s" % axis] = lay(b.argmin(axis=axis))
    out["keep"] = lay(b.argmax(axis=0, keepdims=True))
    out["keepn"] = lay(b.argmin(keepdims=True))
    t = np.zeros((4, 3))
    t[1] = t[3] = 7.0
    out["ties"] = arr(bolt.array(t, mesh).argmax(axis=0))
    out["tiesn"] = arr(bolt.array(t, mesh).argmax())
    n = np.arange(16.0).reshape(8, 2)
    n[3, 1] = n[6, 0] = np.nan
    bn = bolt.array(n, mesh)
    out["nan"] = {"max": arr(bn.argmax()), "min": arr(bn.argmin()),
                  "max0": arr(bn.argmax(axis=0)),
                  "min0": arr(bn.argmin(axis=0))}
    out["bad"] = err(lambda: b.argmax(axis=9))
    out["float"] = err(lambda: b.argmax(axis=1.9))
    return out


def c_quantile_cov_2d_mesh(bolt, mesh):
    x = _sx((8, 4, 6))
    b = bolt.array(x, mesh, axis=(0, 1))
    return {"med": arr(b.median()), "q": arr(b.quantile(0.3, axis=(2,))),
            "cov": np.asarray(bolt.ops.cov(b))}


def c_ndarray_method_parity(bolt, mesh):
    x = np.abs(_sx((8, 4, 3))) + 0.5
    b = bolt.array(x, mesh, axis=(0,))
    m = b > 1.0
    xi = (x * 10).astype(np.int64)
    bi = bolt.array(xi, mesh)
    ci = bi.clip(0, 9)
    return {"prod": arr(b.prod()),
            "prodk": arr(b.prod(axis=(1,), keepdims=True)),
            "all": arr(m.all()), "any": arr(m.any(axis=(0, 2))),
            "clip": arr(b.clip(0.7, 1.2)), "cmax": arr(b.clip(max=1.0)),
            "amax": arr(b.clip(a_max=1.0)), "round": arr(b.round(1)),
            "ci": arr(ci), "cidt": str(np.dtype(ci.dtype)),
            "lo": arr(b.clip(min=np.full(x.shape[2], 0.8))),
            "full": arr(b.clip(min=np.full(x.shape, 0.9))),
            "keyed": arr(b.clip(min=np.linspace(0.6, 1.1, 8).reshape(
                -1, 1, 1))),
            "inv": arr(b.clip(1.0, 0.8)), "none": err(lambda: b.clip()),
            "both": err(lambda: b.clip(0.1, a_min=0.2)),
            "rnd": err(lambda: b.round(1.7)),
            "i2": str(np.dtype((bi * 2).dtype)),
            "f2": str(np.dtype((bi * 2.0).dtype))}


def c_cumsum_cumprod_parity(bolt, mesh):
    x = _sx((6, 4, 3))
    b = bolt.array(x, mesh, axis=(0,))
    out = {}
    for axis in (0, 1, 2, -1):
        out["s%d" % axis] = arr(b.cumsum(axis=axis))
        out["p%d" % axis] = arr(b.cumprod(axis=axis))
    out["flat"] = lay(b.cumsum())
    out["chain"] = arr(bolt.array(x, mesh).map(lambda v: v + 1)
                       .cumsum(axis=0))
    out["bad"] = err(lambda: b.cumsum(axis=1.5))
    big = bolt.array(np.random.RandomState(2).randn(16, 3), mesh)
    out["big"] = lay(big.cumsum(axis=0))
    return out


def c_argsort_parity(bolt, mesh):
    x = np.random.RandomState(60).permutation(160).reshape(8, 5, 4) \
        .astype(np.float64)
    b = bolt.array(x, mesh)
    t = np.zeros((6, 3))
    t[::2] = 1.0
    return {"last": arr(b.argsort()), "k": arr(b.argsort(axis=0)),
            "m2": arr(b.argsort(axis=-2)), "flat": lay(b.argsort(axis=None)),
            "stable": arr(bolt.array(t, mesh).argsort(axis=0,
                                                       kind="stable")),
            "bad": err(lambda: b.argsort(axis=1.5)),
            "chain": arr(bolt.array(x, mesh).map(lambda v: -v)
                         .argsort(axis=0))}


def c_dot_parity(bolt, mesh):
    rs = np.random.RandomState(61)
    a, w = rs.randn(8, 5), rs.randn(5, 3)
    b = bolt.array(a, mesh)
    v = rs.randn(5)
    bv = bolt.array(rs.randn(5), mesh)
    a3 = rs.randn(8, 4, 5)
    b3 = bolt.array(a3, mesh)
    c3 = rs.randn(2, 5, 3)
    return {"w": lay(b.dot(w)), "v": arr(bv.dot(v)), "a3": arr(b3.dot(w)),
            "c3": lay(b3.dot(c3)), "bad": err(lambda: b.dot(np.ones((7, 2)))),
            "kind": err(lambda: b.argsort(kind="bogus")),
            "merge": arr(bolt.array(np.zeros((6, 3)), mesh).argsort(
                axis=0, kind="mergesort"))}


def c_histogram_parity(bolt, mesh):
    x = _sx((8, 6))
    b = bolt.array(x, mesh)
    out = {}
    for i, kw in enumerate([{}, {"bins": 5}, {"bins": 4, "range": (-1, 1)},
                            {"bins": 3, "density": True}]):
        c, e = bolt.ops.histogram(b, **kw)
        out["c%d" % i], out["e%d" % i] = np.asarray(c), np.asarray(e)
    c, e = bolt.ops.histogram(bolt.array(np.full((8, 2), 3.0), mesh))
    out["const_c"], out["const_e"] = np.asarray(c), np.asarray(e)
    xi = np.random.RandomState(3).randint(0, 10, size=(16, 3))
    c, e = bolt.ops.histogram(bolt.array(xi, mesh).map(lambda v: v * 2),
                              bins=6)
    out["chain_c"], out["chain_e"] = np.asarray(c), np.asarray(e)
    return out


# ---------------------------------------------------------------------
# exits (tests/test_toarray_out.py)
# ---------------------------------------------------------------------

def c_toarray_out_both_backends(bolt, mesh):
    x = np.random.RandomState(1).randn(8, 3, 2)
    b = bolt.array(x, mesh)
    out = np.empty(x.shape, x.dtype)
    got = b.toarray(out=out)
    return {"same": got is out, "v": out}


def c_toarray_out_validation(bolt, mesh):
    b = bolt.array(np.random.RandomState(1).randn(8, 3, 2), mesh)
    return {"shape": err(lambda: b.toarray(out=np.empty((8, 3)))),
            "dtype": err(lambda: b.toarray(out=np.empty((8, 3, 2),
                                                        np.float32)))}


def c_toarray_out_materialises_chain_and_pending(bolt, mesh):
    x = np.random.RandomState(1).randn(8, 3, 2)
    m = bolt.array(x, mesh).map(lambda v: v * 2)
    f = bolt.array(x, mesh).filter(lambda v: v.sum() > 0)
    o1 = np.empty(x.shape, x.dtype)
    m.toarray(out=o1)
    o2 = np.empty(f.shape, x.dtype)
    f.toarray(out=o2)
    return {"m": o1, "f": o2}


def c_iter_shards(bolt, mesh):
    """Every ``(index, block)`` this process addresses, written into a
    host array, and which elements they covered."""
    x = np.random.RandomState(2).randn(8, 3, 4)
    b = bolt.array(x, mesh)
    walked = np.zeros(x.shape)
    seen = np.zeros(x.shape, bool)
    for idx, blk in b.iter_shards():
        blk = np.asarray(blk)
        walked[idx] = blk
        seen[idx] = True
        blk *= 0.0
    return {"walked": walked, "seen": seen, "intact": arr(b)}


def c_exits(bolt, mesh):
    x = np.random.RandomState(2).randn(8, 3)
    b = bolt.array(x, mesh)
    return {"asarray": np.asarray(b), "tolist": b.tolist(),
            "first": np.asarray(b.first()),
            "first_chain": np.asarray(b.map(lambda v: v + 3).first()),
            "tolocal": np.asarray(b.tolocal()),
            "repartition": arr(b.repartition(4)),
            "unpersist": arr(b.unpersist()),
            "dtype": str(np.asarray(b, dtype=np.float32).dtype)}


# ---------------------------------------------------------------------
# concatenate (tests/test_tpu_construct.py)
# ---------------------------------------------------------------------

def c_concatenate(bolt, mesh):
    rs = np.random.RandomState(8)
    x, y = rs.randn(8, 3, 2), rs.randn(4, 3, 2)
    b, c = bolt.array(x, mesh), bolt.array(y, mesh)
    i = bolt.array(np.arange(6 * 3 * 2).reshape(6, 3, 2), mesh)
    return {"k": lay(bolt.concatenate((b, c))),
            "v": lay(bolt.concatenate((b, b), axis=1)),
            "host": lay(bolt.concatenate((b, y))),
            "host_first": arr(bolt.concatenate((y, b))),
            "method": lay(b.concatenate(c)),
            "three": lay(bolt.concatenate((b, c, b), axis=0)),
            "dtype": lay(bolt.concatenate((b, i))),
            "neg": lay(b.concatenate(b, axis=-1)),
            "bad": err(lambda: bolt.concatenate((b, np.ones((4, 2, 2)))))}


# ---------------------------------------------------------------------
# the ops library (tests/test_ops_pca.py, test_ops_group.py,
# test_ops_series.py, test_hbm_guards.py)
# ---------------------------------------------------------------------

def _pca(bolt, b, **kw):
    s, comps, sv = bolt.ops.pca(b, **kw)[:3]
    sc = lay(s)
    sc["v"] = np.abs(sc["v"])
    return {"scores": sc, "comps": np.abs(np.asarray(comps)),
            "sv": np.asarray(sv)}


def c_pca_matches_numpy_oracle(bolt, mesh):
    x = np.random.RandomState(0).randn(64, 6)
    return _pca(bolt, bolt.array(x, mesh), k=3)


def c_pca_centering(bolt, mesh):
    x = np.random.RandomState(1).randn(48, 5) + 3.0
    return _pca(bolt, bolt.array(x, mesh), k=2, center=True)


def c_pca_multi_key_axes_keep_shape(bolt, mesh):
    x = np.random.RandomState(2).randn(8, 6, 4)
    return _pca(bolt, bolt.array(x, mesh, axis=(0, 1)), k=2)


def c_pca_value_axes_flatten(bolt, mesh):
    x = np.random.RandomState(3).randn(32, 3, 2)
    return _pca(bolt, bolt.array(x, mesh), k=4)


def c_pca_default_k_and_errors(bolt, mesh):
    b = bolt.array(np.random.RandomState(4).randn(16, 5), mesh)
    out = _pca(bolt, b)
    out["k0"] = err(lambda: bolt.ops.pca(b, k=0))
    out["k9"] = err(lambda: bolt.ops.pca(b, k=9))
    out["wide"] = err(lambda: bolt.ops.pca(bolt.array(
        np.ones((8, 12)), mesh)))
    return out


def c_pca_integer_input_widens(bolt, mesh):
    x = np.random.RandomState(5).randint(-5, 6, size=(24, 4))
    return _pca(bolt, bolt.array(x, mesh), k=2)


def c_pca_axis_parameter_matches_across_backends(bolt, mesh):
    x = np.random.RandomState(6).randn(4, 16, 3)
    return _pca(bolt, bolt.array(x, mesh), k=2, axis=(1,))


def c_pca_composes_with_map_chain(bolt, mesh):
    x = np.random.RandomState(7).randn(32, 4)
    m = bolt.array(x, mesh).map(lambda v: v * 2 + 1)
    out = _pca(bolt, m, k=3, center=True)
    s, c, sv, mu = bolt.ops.pca(m, k=3, center=True, return_mean=True)
    out["mean"] = np.asarray(mu)
    return out


def c_pca_return_mean_projects_new_data(bolt, mesh):
    x = np.random.RandomState(8).randn(40, 5) + 2.0
    s, c, sv, mu = bolt.ops.pca(bolt.array(x, mesh), k=2, center=True,
                                return_mean=True)
    return {"mean": np.asarray(mu), "sv": np.asarray(sv),
            "proj": np.abs(np.asarray(arr(s)))}


def c_pca_centering_fold_large_offset(bolt, mesh):
    x = (np.random.RandomState(7).randn(96, 5) + 200.0).astype(np.float32)
    return _pca(bolt, bolt.array(x, mesh, axis=(0,)), k=2, center=True)


def c_cov_centering_fold_large_offset(bolt, mesh):
    x = (np.random.RandomState(8).randn(80, 4) + 200.0).astype(np.float32)
    return {"cov": np.asarray(bolt.ops.cov(bolt.array(x, mesh,
                                                      axis=(0,))))}


def c_pca_complex_centered(bolt, mesh):
    rs = np.random.RandomState(11)
    x = rs.randn(32, 3) + 1j * rs.randn(32, 3)
    s, c, sv = bolt.ops.pca(bolt.array(x, mesh), k=2, center=True)
    return {"sv": np.asarray(sv), "abs_scores": np.abs(arr(s))}


def c_cov_complex_centered(bolt, mesh):
    rs = np.random.RandomState(12)
    x = rs.randn(32, 3) + 1j * rs.randn(32, 3)
    return {"cov": np.asarray(bolt.ops.cov(bolt.array(x, mesh)))}


def c_cov_fold_diagonal_never_negative(bolt, mesh):
    x = np.full((32, 3), 7.0)
    x[:, 1] += np.random.RandomState(13).randn(32) * 1e-9
    c = np.asarray(bolt.ops.cov(bolt.array(x.astype(np.float32), mesh)))
    return {"nonneg": bool((np.diag(c) >= 0).all())}


def c_cov_parity(bolt, mesh):
    x = _sx((32, 6))
    y = _sx((8, 4, 3))
    c, mu = bolt.ops.cov(bolt.array(x, mesh).map(lambda v: v + 1),
                         return_mean=True)
    return {"cov": np.asarray(bolt.ops.cov(bolt.array(x, mesh, axis=(0,)))),
            "y": np.asarray(bolt.ops.cov(bolt.array(y, mesh, axis=(0,)))),
            "raw": np.asarray(bolt.ops.cov(bolt.array(x, mesh),
                                           center=False, ddof=0)),
            "chain": np.asarray(c), "mu": np.asarray(mu),
            "corr": np.asarray(bolt.ops.corrcoef(bolt.array(x, mesh)))}


def c_cov_complex(bolt, mesh):
    rs = np.random.RandomState(13)
    xc = rs.randn(32, 4) + 1j * rs.randn(32, 4)
    return {"cov": np.asarray(bolt.ops.cov(bolt.array(xc, mesh)))}


def _mirror_labels():
    return np.array([0, 2, 1, 0, 2, 2, 1, 0, 3, 3, 0, 2])


def c_segment_reduce_parity(bolt, mesh):
    x = _gx()
    out = {}
    for op in ("sum", "mean", "max", "min"):
        out[op] = lay(bolt.ops.segment_reduce(bolt.array(x, mesh),
                                              _mirror_labels(), op=op))
    return out


def c_segment_reduce_empty_group_and_num_segments(bolt, mesh):
    x = _gx((6, 2))
    labels = np.array([0, 0, 3, 3, 3, 0])
    return lay(bolt.ops.segment_reduce(bolt.array(x, mesh), labels,
                                       num_segments=5))


def c_segment_reduce_deferred_chain(bolt, mesh):
    b = bolt.array(_gx(), mesh).map(lambda v: v * 2)
    return lay(bolt.ops.segment_reduce(b, np.arange(12) % 3, op="sum"))


def c_segment_reduce_int_mean(bolt, mesh):
    x = np.arange(24, dtype=np.int64).reshape(8, 3)
    out = bolt.ops.segment_reduce(bolt.array(x, mesh),
                                  np.array([0, 1] * 4), op="mean")
    return {"v": lay(out), "dtype": str(np.dtype(out.dtype))}


def c_segment_reduce_errors(bolt, mesh):
    b = bolt.array(_gx(), mesh)
    sr = bolt.ops.segment_reduce
    return {"len": err(lambda: sr(b, np.arange(5))),
            "op": err(lambda: sr(b, np.arange(12), op="prod")),
            "neg": err(lambda: sr(b, np.arange(12) - 1)),
            "nseg": err(lambda: sr(b, np.arange(12), num_segments=5)),
            "float": err(lambda: sr(b, np.arange(12.0)))}


def c_bincount_parity(bolt, mesh):
    x = np.random.RandomState(81).randint(0, 9, size=(16, 5))
    b = bolt.array(x, mesh)
    return {"a": bolt.ops.bincount(b), "m": bolt.ops.bincount(b,
                                                            minlength=20),
            "chain": bolt.ops.bincount(b.map(lambda v: v * 3)),
            "float": err(lambda: bolt.ops.bincount(bolt.array(_gx(), mesh))),
            "neg": err(lambda: bolt.ops.bincount(bolt.array(x - 5, mesh)))}


def c_segment_reduce_multi_key_axes(bolt, mesh):
    x = _gx((4, 2, 3, 2))
    return lay(bolt.ops.segment_reduce(bolt.array(x, mesh, axis=(0, 1)),
                                       np.array([0, 1, 0, 1]), op="sum"))


def c_segment_reduce_device_labels(bolt, mesh):
    x = _gx((16, 3))
    lab = np.arange(16) % 4
    out = bolt.ops.segment_reduce(bolt.array(x, mesh),
                                  bolt.array(lab, mesh), op="sum")
    return lay(out)


def c_bincount_empty(bolt, mesh):
    e = bolt.array(np.zeros((0, 3), np.int64), mesh)
    return {"v": bolt.ops.bincount(e, minlength=4)}


def c_unique_parity(bolt, mesh):
    x = np.random.RandomState(82).randint(0, 7, size=(9, 4)).astype(float)
    b = bolt.array(x, mesh)
    u, c = bolt.ops.unique(b, return_counts=True)
    iu, ic = bolt.ops.unique(bolt.array(np.full((4, 3), 5), mesh),
                             return_counts=True)
    eu, ec = bolt.ops.unique(bolt.array(np.zeros((0, 3)), mesh),
                             return_counts=True)
    return {"u": bolt.ops.unique(b), "uc": u, "c": c, "iu": iu, "ic": ic,
            "m": bolt.ops.unique(bolt.array(x, mesh).map(
                lambda v: v * 0 + 2.0)),
            "esize": [int(np.size(eu)), int(np.size(ec))]}


def c_unique_nan_semantics(bolt, mesh):
    x = np.array([[1.0, np.nan], [np.nan, 1.0]] * 4)
    u, c = bolt.ops.unique(bolt.array(x, mesh), return_counts=True)
    return {"u": u, "c": c}


def c_unique_sharded_path_parity(bolt, mesh):
    x = np.random.RandomState(45).randint(0, 9, size=(16, 6)).astype(float)
    x[3, 2] = np.nan
    x[9, 1] = np.nan
    ax = (0, 1) if len(getattr(mesh, "axis_names", ())) > 1 else (0,)
    u, c = bolt.ops.unique(bolt.array(x, mesh, axis=ax), return_counts=True)
    mch = bolt.array(np.full((8, 4), 2.0), mesh).map(lambda v: v + 1)
    return {"u": u, "c": c, "chain": bolt.ops.unique(mch)}


def c_unique_sharded_declines_ineligible_layouts(bolt, mesh):
    x = np.random.RandomState(46).randint(0, 5, size=(6, 4)).astype(float)
    u, c = bolt.ops.unique(bolt.array(x, mesh), return_counts=True)
    return {"u": u, "c": c}


def c_topk_parity(bolt, mesh):
    x = np.random.RandomState(83).randn(8, 6, 5)
    b = bolt.array(x, mesh)
    out = {}
    for axis in (-1, 0, 1):
        v, i = bolt.ops.topk(b, 3, axis=axis)
        out["v%d" % axis], out["i%d" % axis] = lay(v), lay(i)
    _, i = bolt.ops.topk(bolt.array(np.zeros((4, 4)), mesh), 2)
    out["ties"] = arr(i)
    return out


def c_topk_errors(bolt, mesh):
    b = bolt.array(_gx(), mesh)
    tk = bolt.ops.topk
    v, _ = tk(bolt.array(_gx(), mesh).map(lambda r: -r), 2, axis=0)
    return {"k0": err(lambda: tk(b, 0)), "k99": err(lambda: tk(b, 99, 0)),
            "ax": err(lambda: tk(b, 1, axis=9)),
            "axf": err(lambda: tk(b, 1, axis=1.5)), "chain": arr(v)}


def c_topk_dtype_and_nan_parity(bolt, mesh):
    out = {}
    for i, x in enumerate([np.array([[5, 0, 3]] * 8, dtype=np.uint32),
                           np.array([[-(2 ** 31), 4, -2]] * 8,
                                    dtype=np.int32),
                           np.array([[True, False, True]] * 8),
                           np.array([[1.0, np.nan, 3.0, 2.0]] * 8)]):
        v, idx = bolt.ops.topk(bolt.array(x, mesh), 2)
        out["v%d" % i], out["i%d" % i] = arr(v), arr(idx)
    return out


def c_segment_reduce_matmul_path(bolt, mesh):
    rs = np.random.RandomState(33)
    x = rs.randn(32, 6, 4)
    lab = rs.randint(0, 5, 32)
    b = bolt.array(x, mesh)
    sr = bolt.ops.segment_reduce
    return {m: arr(sr(b, lab, num_segments=5, op="sum", method=m))
            for m in ("matmul", "scatter", "auto")}


def c_segment_reduce_matmul_nonfinite_fallback(bolt, mesh):
    rs = np.random.RandomState(34)
    x = rs.randn(16, 3)
    x[5, 1] = np.inf
    x[9, 0] = np.nan
    lab = rs.randint(0, 3, 16)
    return {"v": arr(bolt.ops.segment_reduce(bolt.array(x, mesh), lab,
                                             num_segments=3, op="mean",
                                             method="matmul"))}


def c_segment_reduce_method_validation(bolt, mesh):
    b = bolt.array(_gx(), mesh)
    sr = bolt.ops.segment_reduce
    return {"method": err(lambda: sr(b, np.arange(12), method="bogus")),
            "max": err(lambda: sr(b, np.arange(12), op="max",
                                  method="matmul"))}


def _series_x():
    return np.random.RandomState(90).randn(8, 32)


def c_detrend_parity(bolt, mesh):
    b = bolt.array(_series_x(), mesh)
    return {str(o): arr(bolt.ops.detrend(b, order=o)) for o in (0, 1, 2)}


def c_zscore_center_parity(bolt, mesh):
    b = bolt.array(_series_x(), mesh)
    return {"z": arr(bolt.ops.zscore(b)), "z1": arr(bolt.ops.zscore(b,
                                                                   ddof=1)),
            "c": arr(bolt.ops.center(b))}


def c_crosscorr_parity(bolt, mesh):
    x = _series_x()
    sig = np.random.RandomState(91).randn(32)
    b = bolt.array(x, mesh)
    return {"0": arr(bolt.ops.crosscorr(b, sig)),
            "3": arr(bolt.ops.crosscorr(b, sig, lag=3))}


def c_crosscorr_multiaxis(bolt, mesh):
    x = np.random.RandomState(92).randn(4, 2, 16)
    sig = np.random.RandomState(93).randn(16)
    return lay(bolt.ops.crosscorr(bolt.array(x, mesh, axis=(0, 1)), sig,
                                  lag=2))


def c_fourier_parity(bolt, mesh):
    co, ph = bolt.ops.fourier(bolt.array(_series_x(), mesh), 4)
    return {"co": arr(co), "ph": arr(ph)}


def c_normalize_parity(bolt, mesh):
    b = bolt.array(np.abs(_series_x()) + 1, mesh)
    return {"p": arr(bolt.ops.normalize(b)),
            "m": arr(bolt.ops.normalize(b, baseline="mean"))}


def c_median_filter_on_mesh(bolt, mesh):
    b = bolt.array(np.random.RandomState(94).randn(8, 16, 4), mesh)
    return {"v": arr(bolt.ops.median_filter(b, 3))}


# ---------------------------------------------------------------------
# meshes that do not match (test_mesh_mismatch_raises,
# test_cross_mesh_operands_rejected): two meshes of the same pod
# ---------------------------------------------------------------------

def mismatch_cases(bolt, mesh, other):
    """The operations that refuse an operand on ``other`` (another mesh
    of the pod), and the explicit move that works."""
    x = _ops_x()
    b = bolt.array(x, mesh)
    c = bolt.array(x, other)
    f = _m_f()
    s = bolt.array(np.sort(f.ravel()), mesh)
    return {"add": err_msg(lambda: b + c),
            "cat": err_msg(lambda: b.concatenate(c)),
            "mm": err_msg(lambda: b @ c.values.reshape(5, 4)),
            "set": err_msg(lambda: bolt.array(f, mesh).set(
                np.s_[0:1, 0:4], bolt.array(np.zeros((4, 5)), other))),
            "search": err_msg(lambda: s.searchsorted(
                bolt.array(np.zeros(3), other))),
            "moved": arr(b + c.tolocal().togpu(context=mesh)
                         if hasattr(c, "togpu")
                         else b + c.tolocal().totpu(context=mesh))}


CASES = {name[2:]: fn for name, fn in list(globals().items())
         if name.startswith("c_") and callable(fn)}

# the ops library's cases (tests/test_torch_mesh_ops.py); the rest are
# the array's own surface (tests/test_torch_mesh_surface.py)
_OPS_PREFIXES = ("pca", "cov", "segment", "bincount", "unique", "topk",
                 "histogram", "detrend", "zscore", "crosscorr", "fourier",
                 "normalize", "median_filter", "quantile_cov")
OPS_CASES = tuple(n for n in CASES if n.startswith(_OPS_PREFIXES))
SURFACE_CASES = tuple(n for n in CASES if n not in OPS_CASES)
# the cases whose data moves between layouts (relayouts, routes, folds
# over several mesh axes): run on a third mesh shape too
LAYOUT_CASES = (
    "slices", "lists_orthogonal", "mixed", "split_bookkeeping",
    "transpose_within_groups", "T", "reshape_within_groups", "squeeze",
    "keys_values_views", "reshape_key_merge", "sort_matches_numpy",
    "set_getitem_roundtrip", "argmax_argmin_parity", "quantile_vector_q",
    "cumsum_cumprod_parity", "argsort_parity", "concatenate",
    "take_parity", "repeat_split_and_chain", "ravel_and_diagonal_splits",
    "ufunc_reduce_parity", "matmul_bolt_operand", "nonzero_two_phase_and_values",
    "item_fetches_one_element_not_the_array", "exits", "dtypes_on_mesh",
    "pca_multi_key_axes_keep_shape", "quantile_cov_2d_mesh",
    "segment_reduce_multi_key_axes", "unique_sharded_path_parity",
    "topk_parity", "histogram_parity", "bincount_parity",
    "crosscorr_multiaxis")


def payload_surface(rank, args, inputs):
    """For each entry of ``args["meshes"]`` (``{"label", "mesh",
    "names", "cases"}``), build the mesh and run its named cases; a
    ``"mismatch"`` entry names a second mesh shape for
    :func:`mismatch_cases`."""
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch.parallel.mesh import make_mesh
    out = {"rank": rank}
    for run in args["meshes"]:
        mesh = make_mesh(tuple(run["mesh"]), tuple(run["names"]))
        res = out[run["label"]] = {"coords": list(mesh.coords().values())}
        for name in run.get("cases", ()):
            res[name] = CASES[name](bolt, mesh)
        if "mismatch" in run:
            m = run["mismatch"]
            res["mismatch"] = mismatch_cases(
                bolt, mesh, make_mesh(tuple(m["mesh"]), tuple(m["names"])))
    return out
