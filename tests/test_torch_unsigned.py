"""Arrays of ``uint16``, ``uint32`` and ``uint64`` on the port against the
reference (ROADMAP C5).

torch leaves most kernels of those dtypes out (``add``, the comparisons,
``amax``, ``cumsum``, ...), so the port computes them in signed carriers
(``bolt_tpu_torch/gpu/dtypes.py :: carry``).  Each call below goes
through ``bolt_tpu`` (the 8-device CPU mesh, x64 on) and the port
(``context=torch.device("cpu")``) on the same seeded integers; values
are compared exactly and dtypes equal (a float result, of ``/``, ``mean``
or ``var``, within ``rtol=1e-6`` in f32 and ``1e-12`` in f64: XLA divides
by a constant through its reciprocal).  The ``uint64`` records include
values of 2**63 and more, whose int64 carrier is negative, so the
operators' orderings and divisions are held where the signed and the
unsigned answers part.  A user callable torch has no kernel for runs
on the carriers under ``dtypes.CarrierMode``: ``CALLABLES`` holds
wraps, orderings and divisions inside callables against the reference,
and a uint64 callable that divides refuses with ``TypeError`` (ROADMAP
"Differences").
"""

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt

CPU = torch.device("cpu")
UNSIGNED = [np.uint16, np.uint32, np.uint64]


def _x(dtype, shape=(16, 3, 4), seed=0):
    x = np.random.RandomState(seed).randint(0, 20, shape).astype(dtype)
    if dtype == np.uint64:
        x.reshape(-1)[::7] += np.uint64(2 ** 63)
    return x


def _a(r):
    if isinstance(r, (list, tuple)):
        return [_a(v) for v in r]
    return np.asarray(r.toarray() if hasattr(r, "toarray") else r)


def _same(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    if got.dtype.kind == "f":
        rtol = 1e-6 if got.dtype == np.float32 else 1e-12
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    else:
        assert np.array_equal(got, want)


CALLS = {
    "add": lambda b: b + 1,
    "sub": lambda b: b - b,
    "rsub": lambda b: 100 - (b % 50),
    "mul": lambda b: b * 3,
    "floordiv": lambda b: b // 2,
    "floordiv_array": lambda b: b // (b % 5),
    "mod": lambda b: b % 3,
    "truediv": lambda b: b / 3,
    "gt": lambda b: b > 3,
    "le": lambda b: b <= 9,
    "eq": lambda b: b == 3,
    "neg": lambda b: -b,
    "abs": lambda b: abs(b),
    "square": lambda b: b ** 2,
    "rshift": lambda b: np.right_shift(b, 1),
    "lshift": lambda b: np.left_shift(b, 2),
    "invert": lambda b: np.invert(b),
    "maximum": lambda b: np.maximum(b, 7),
    "minimum": lambda b: np.minimum(b, 7),
    "sign": lambda b: np.sign(b),
    "map": lambda b: b.map(lambda v: v + 1),
    "map_sum": lambda b: b.map(lambda v: v + 1).sum(),
    "sum": lambda b: b.sum(),
    "min": lambda b: b.min(),
    "max": lambda b: b.max(),
    "max_value_axis": lambda b: b.max(axis=1),
    "ptp": lambda b: b.ptp(),
    "np_max": lambda b: np.max(b),
    "mean": lambda b: b.mean(),
    "var": lambda b: b.var(),
    "reduce_add": lambda b: b.reduce(np.add),
    "reduce_max": lambda b: b.reduce(np.maximum),
    "reduce_min": lambda b: b.reduce(np.minimum),
    "cumsum": lambda b: b.cumsum(),
    "cumsum_axis": lambda b: b.cumsum(axis=0),
    "clip": lambda b: b.clip(2, 9),
    "argmax": lambda b: b.argmax(),
    "argmin": lambda b: b.argmin(axis=0),
    "sort": lambda b: np.sort(b, axis=0),
    "argsort": lambda b: np.argsort(b, axis=0),
    "filter_sum": lambda b: b.filter(lambda v: v[0, 0] != 3).sum(),
}


@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", sorted(CALLS))
def test_unsigned_call_matches_reference(mesh, dtype, name):
    x = _x(dtype)
    want = _a(CALLS[name](ref.array(x, mesh)))
    got = _a(CALLS[name](bolt.array(x, CPU)))
    _same(got, want)


@pytest.mark.parametrize("dtype", UNSIGNED)
def test_unsigned_stats_matches_reference(mesh, dtype):
    x = _x(dtype)
    want = ref.array(x, mesh).stats()
    got = bolt.array(x, CPU).stats()
    for f in ("min", "max"):
        _same(np.asarray(getattr(got, f)()), np.asarray(getattr(want, f)()))
    for f in ("mean", "variance"):
        np.testing.assert_allclose(getattr(got, f)(), getattr(want, f)(),
                                   rtol=1e-12)


@pytest.mark.parametrize("dtype", UNSIGNED)
def test_unsigned_group_matches_reference(mesh, dtype):
    x = _x(dtype)
    r = ref.array(x, mesh)
    b = bolt.array(x, CPU)
    want = _a(ref.compute(r.sum(), r.mean(), r.max()))
    got = _a(bolt.compute(b.sum(), b.mean(), b.max()))
    _same(got, want)
    # the fluent group, ptp among its members
    want = {k: _a(v) for k, v in r.stats("sum", "min", "ptp").items()}
    got = {k: _a(v) for k, v in b.stats("sum", "min", "ptp").items()}
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k])


@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", ["sum", "min", "max", "mean", "var"])
def test_unsigned_streamed_terminal_matches_reference(mesh, dtype, name):
    x = _x(dtype, shape=(32, 3, 4))
    want = _a(getattr(ref.fromcallback(lambda i: x[i], x.shape, mesh,
                                       dtype=dtype, chunks=4), name)())
    got = _a(getattr(bolt.fromcallback(lambda i: x[i], x.shape, CPU,
                                       dtype=dtype, chunks=4), name)())
    _same(got, want)


@pytest.mark.parametrize("dtype", UNSIGNED)
def test_unsigned_streamed_group_and_reduce(mesh, dtype):
    x = _x(dtype, shape=(32, 3, 4))

    def src(pkg, ctx):
        return pkg.fromcallback(lambda i: x[i], x.shape, ctx, dtype=dtype,
                                chunks=4)

    r, b = src(ref, mesh), src(bolt, CPU)
    want = _a(ref.compute(r.sum(), r.mean(), r.max(), r.min()))
    got = _a(bolt.compute(b.sum(), b.mean(), b.max(), b.min()))
    _same(got, want)
    for fn in (np.add, np.maximum):
        _same(_a(src(bolt, CPU).reduce(fn)),
              _a(src(ref, mesh).reduce(fn)))


def _max_by_order(a, c):
    # the larger of two records by comparisons alone: associative, so a
    # streamed fold in any order gives the reference's value
    return a * (a > c) + c * (a <= c)


CALLABLES = {
    "map_wrap_floordiv": lambda b: b.map(lambda v: (v - 5) // 2),
    "map_wrap_gt": lambda b: b.map(lambda v: (v - 5) > 3),
    "map_gt": lambda b: b.map(lambda v: v > 5),
    "map_wrap_mul_eq": lambda b: b.map(lambda v: (v - 7) * 3 == v),
    "filter_wrap_gt": lambda b: b.filter(lambda v: (v[0, 0] - 5) > 3),
    "filter_wrap_sum": lambda b: b.filter(
        lambda v: (v[0, 0] - 5) > 3).sum(),
    "reduce_wrap_floordiv": lambda b: b.reduce(lambda a, c: (a - c) // 2),
    "reduce_by_order": lambda b: b.reduce(_max_by_order),
    "filter_reduce_by_order": lambda b: b.filter(
        lambda v: (v[0, 0] - 5) > 3).reduce(_max_by_order),
    "filter_max": lambda b: b.filter(lambda v: (v[0, 0] - 5) > 3).max(),
    "filter_mean": lambda b: b.filter(lambda v: (v[0, 0] - 5) > 3).mean(),
}
# a uint64 record in a callable divides only through a refusal
_U64_REFUSED = {"map_wrap_floordiv", "reduce_wrap_floordiv"}


@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", sorted(CALLABLES))
def test_unsigned_callable_matches_reference(mesh, dtype, name):
    # a wrap, an ordering or a division inside a callable sees the
    # unsigned value where torch runs it on the carrier
    x = _x(dtype)
    if dtype == np.uint64 and name in _U64_REFUSED:
        with pytest.raises(TypeError, match="uint64"):
            _a(CALLABLES[name](bolt.array(x, CPU)))
        return
    want = _a(CALLABLES[name](ref.array(x, mesh)))
    got = _a(CALLABLES[name](bolt.array(x, CPU)))
    _same(got, want)


@pytest.mark.parametrize("dtype", UNSIGNED)
def test_unsigned_streamed_user_reduce_matches_reference(mesh, dtype):
    # the streamed fold merges slab partials with the user function
    x = _x(dtype, shape=(32, 3, 4))

    def src(pkg, ctx):
        return pkg.fromcallback(lambda i: x[i], x.shape, ctx, dtype=dtype,
                                chunks=4)

    _same(_a(src(bolt, CPU).reduce(_max_by_order)),
          _a(src(ref, mesh).reduce(_max_by_order)))


@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", ["sum", "mean", "max"])
def test_unsigned_streamed_filter_matches_reference(mesh, dtype, name):
    # a streamed filter drops records by selecting in the carrier
    x = _x(dtype, shape=(32, 3, 4))

    def src(pkg, ctx):
        return pkg.fromcallback(lambda i: x[i], x.shape, ctx, dtype=dtype,
                                chunks=4).filter(lambda v: v[0, 0] > 9)

    _same(_a(getattr(src(bolt, CPU), name)()),
          _a(getattr(src(ref, mesh), name)()))


def test_carried_callable_runs_once_per_application_after_the_first():
    # which of the two runs a callable takes is found once: later
    # applications run it once, on the carriers
    x = _x(np.uint16)
    b = bolt.array(x, CPU)
    runs = []

    def g(v):
        runs.append(v.dtype)
        return v + 1                     # no uint16 add: the carrier
    assert np.array_equal(b.map(g).toarray(), x + 1)
    runs.clear()
    assert np.array_equal(b.map(g).toarray(), x + 1)
    assert runs == [torch.uint16]


def test_uint64_carrier_orders_and_divides_unsigned():
    # the values where int64 bits and uint64 part: 2**63 and more
    from bolt_tpu_torch.gpu import dtypes, ufuncs
    vals = np.array([0, 1, 7, 2 ** 63 - 1, 2 ** 63, 2 ** 63 + 5,
                     2 ** 64 - 1], dtype=np.uint64)
    divs = np.array([1, 3, 2 ** 63, 2 ** 64 - 1, 7, 2, 0], dtype=np.uint64)
    a, d = torch.from_numpy(vals), torch.from_numpy(divs)
    q = ufuncs.binary("floor_divide", a, d).numpy()
    r = ufuncs.binary("remainder", a, d).numpy()
    nz = divs != 0
    assert np.array_equal(q[nz], vals[nz] // divs[nz])
    assert np.array_equal(r[nz], vals[nz] % divs[nz])
    # jnp's answers for a zero divisor: all ones and zero
    assert q[~nz].tolist() == [2 ** 64 - 1] and r[~nz].tolist() == [0]
    assert np.array_equal(ufuncs.binary("greater", a, d).numpy(),
                          vals > divs)
    assert np.array_equal(ufuncs.binary("maximum", a, d).numpy(),
                          np.maximum(vals, divs))
    assert np.array_equal(ufuncs.binary("right_shift", a, 3).numpy(),
                          vals >> np.uint64(3))
    # carry/uncarry round trips, ordered or not
    for ordered in (False, True):
        back = dtypes.uncarry(dtypes.carry(a, ordered), torch.uint64,
                              ordered)
        assert np.array_equal(back.numpy(), vals)
    s = torch.sort(dtypes.carry(a, ordered=True)).values
    assert np.array_equal(dtypes.uncarry(s, torch.uint64, True).numpy(),
                          np.sort(vals))


def test_unsigned_callable_keeps_its_own_dtype_where_torch_allows():
    # a callable torch runs on uint16 sees uint16 records; one it has no
    # kernel for runs on the carrier and its result takes the dtype
    # torch infers for uint16 (jnp's for these)
    seen = []
    x = _x(np.uint16)
    b = bolt.array(x, CPU)

    def f(v):
        seen.append(v.dtype)
        return v * 2                     # torch multiplies uint16
    out = b.map(f).toarray()
    assert out.dtype == np.uint16 and np.array_equal(out, x * 2)
    assert torch.uint16 in seen and torch.int32 not in seen
    seen.clear()

    def g(v):
        seen.append(v.dtype)
        return v + 1                     # no uint16 add: the carrier
    out = b.map(g).toarray()
    assert out.dtype == np.uint16 and np.array_equal(out, x + 1)
    # the carrier's record reports its own dtype too
    assert set(seen) == {torch.uint16}


def test_uint64_callable_reads_the_carrier_signed():
    # torch has no uint64 comparison, so a callable comparing a uint64
    # record runs on its int64 carrier, where 2**63 and more read as
    # negative; the carrier mode orders on sign-flipped bits, so the
    # callable orders unsigned, as the operators do
    x = np.array([[1], [2 ** 63 + 1]], dtype=np.uint64)
    b = bolt.array(x, CPU)
    got = np.asarray(b.map(lambda v: v > 5).toarray()).ravel()
    assert got.tolist() == [False, True]
    assert np.asarray((b > 5).toarray()).ravel().tolist() == [False, True]
    got = np.asarray(b.map(lambda v: (v - 2) < 3).toarray()).ravel()
    assert got.tolist() == [False, False]        # 1 - 2 wraps to 2**64 - 1
    # torch divides uint64 by itself, but not after an add it lacks
    assert np.array_equal(b.map(lambda v: v / 2).toarray(), x / 2)
    with pytest.raises(TypeError, match="uint64"):
        b.map(lambda v: (v + 1) / 2).toarray()
