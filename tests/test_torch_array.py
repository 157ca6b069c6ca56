"""The port's array against the reference's: map, reduce, the deferred
chain and its operators, host fallback, swap, chunk, conversions, and the
BASELINE configs end to end at a small size.  Seeded numpy inputs go
through ``bolt_tpu`` (on the conftest CPU mesh) and ``bolt_tpu_torch`` (on
the CPU device); data movement and integral reductions are compared
exactly, arithmetic in f64 at ``rtol=1e-10`` (summation order differs).
Follows ``test_tpu_functional.py``, ``test_tpu_swap_enumeration.py`` and
``test_tpu_chunking.py``."""

import warnings
from itertools import combinations
from operator import add

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch import convert
from tests.generic import map_suite, reduce_suite

CPU = torch.device("cpu")


def _x(shape=(8, 4, 5), seed=3):
    return np.random.RandomState(seed).randn(*shape)


def _same(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


# ---------------------------------------------------------------------------
# map / reduce: the backend-agnostic suites
# ---------------------------------------------------------------------------

def test_map_suite():
    x = _x()
    map_suite(x, bolt.array(x, CPU))


def test_reduce_suite():
    x = _x()
    reduce_suite(x, bolt.array(x, CPU))


def test_suites_on_integers():
    x = np.arange(8 * 4 * 5, dtype=np.int32).reshape(8, 4, 5)
    b = bolt.array(x, CPU)
    map_suite(x, b)
    reduce_suite(x, b)


@pytest.mark.parametrize("axis", [(0,), (0, 1), (1,), (2,), (1, 2)])
def test_map_matches_reference(mesh, axis):
    x = _x()
    t = ref.array(x, mesh).map(lambda v: v * 2 + v.sum(), axis=axis)
    g = bolt.array(x, CPU).map(lambda v: v * 2 + v.sum(), axis=axis)
    assert g.split == t.split and g.shape == t.shape
    _same(g.toarray(), t.toarray())


def test_map_with_keys_matches_reference(mesh):
    x = _x()
    f = lambda kv: kv[1] * kv[0][0] + kv[0][1]      # noqa: E731
    t = ref.array(x, mesh, axis=(0, 1)).map(f, axis=(0, 1), with_keys=True)
    g = bolt.array(x, CPU, axis=(0, 1)).map(f, axis=(0, 1), with_keys=True)
    _same(g.toarray(), t.toarray())


def test_map_value_shape_and_dtype(mesh):
    x = _x()
    b = bolt.array(x, CPU)
    out = b.map(lambda v: v.sum(axis=0), value_shape=(5,))
    assert out.shape == (8, 5)
    with pytest.raises(ValueError):
        b.map(lambda v: v.sum(axis=0), value_shape=(3,))
    out = b.map(lambda v: v, dtype=np.float32)
    assert out.dtype == np.float32 == ref.array(x, mesh).map(
        lambda v: v, dtype=np.float32).dtype


@pytest.mark.parametrize("axis,keepdims", [((0,), False), ((0, 1), False),
                                           ((0,), True), ((1,), False)])
def test_reduce_matches_reference_bit_exact(mesh, axis, keepdims):
    # integral values: the fixed-order tree must give identical bits
    x = np.random.RandomState(5).randint(-9, 9, (7, 6, 5)).astype(np.float32)
    t = ref.array(x, mesh, axis=(0, 1)).reduce(add, axis=axis,
                                                keepdims=keepdims)
    g = bolt.array(x, CPU, axis=(0, 1)).reduce(add, axis=axis,
                                               keepdims=keepdims)
    assert g.split == t.split
    assert np.array_equal(g.toarray(), t.toarray())
    assert g.toarray().dtype == t.toarray().dtype


def test_reduce_tree_order_matches_oracle():
    # a non-associative reducer exposes the combine order: the port folds
    # exactly like the local oracle's pairwise tree
    x = _x((7, 3))
    f = lambda a, b: a * 0.5 - b          # noqa: E731
    got = bolt.array(x, CPU).reduce(f).toarray()
    assert np.array_equal(got, bolt.array(x).reduce(f).toarray())


def test_reduce_maximum_and_errors(mesh):
    x = _x()
    _same(bolt.array(x, CPU).reduce(np.maximum).toarray(),
          ref.array(x, mesh).reduce(np.maximum).toarray())
    b = bolt.array(x, CPU)
    with pytest.raises(ValueError):
        b.reduce(lambda a, c: a.sum(axis=0))     # wrong value shape
    with pytest.raises(TypeError):
        bolt.array(np.zeros((0, 3)), CPU).reduce(add)


# ---------------------------------------------------------------------------
# the deferred chain and its operators
# ---------------------------------------------------------------------------

def test_deferred_chain_with_operators_matches_reference(mesh):
    x = _x()
    t = ((ref.array(x, mesh).map(lambda v: v * 2) + 1) * 3 / 4 - 0.5)
    g = ((bolt.array(x, CPU).map(lambda v: v * 2) + 1) * 3 / 4 - 0.5)
    assert g.deferred
    assert len(g._chain[1]) == 5
    _same(g.toarray(), t.toarray())
    _same((2 - bolt.array(x, CPU)).toarray(), (2 - ref.array(x, mesh)).toarray())
    _same((1 / (bolt.array(x, CPU) + 10)).toarray(),
          (1 / (ref.array(x, mesh) + 10)).toarray())


@pytest.mark.parametrize("dtype", [np.int32, np.int8, np.int16, np.uint8,
                                   np.bool_])
@pytest.mark.parametrize("op", ["add", "sub", "mul", "truediv"])
@pytest.mark.parametrize("other", [2, 2.5, np.float32(1.5)])
def test_scalar_operator_dtypes_match_reference(mesh, op, other, dtype):
    # result dtypes follow the reference's jnp promotion (a Python scalar
    # is weak, a numpy scalar strong): int32 / 2 and int32 + np.float32
    # are f32, int32 * 2.5 is f64; the values agree with numpy's
    x = np.arange(1, 8 * 3 + 1).reshape(8, 3)
    x = x % 2 == 0 if dtype == np.bool_ else x.astype(dtype)
    f = getattr(__import__("operator"), op)
    for fn in (lambda a: f(a, other), lambda a: f(other, a)):
        t = fn(ref.array(x, mesh))
        g = fn(bolt.array(x, CPU))
        assert g.dtype == t.dtype
        np.testing.assert_allclose(g.toarray(), t.toarray(), rtol=1e-6)
        with np.errstate(all="ignore"):
            want = fn(x)
        if np.issubdtype(g.dtype, np.floating):
            np.testing.assert_allclose(g.toarray(), want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(g.toarray(), want)


def test_array_operands_match_reference(mesh):
    x, y = _x(), _x(seed=9)
    _same((bolt.array(x, CPU) + bolt.array(y, CPU)).toarray(),
          (ref.array(x, mesh) + ref.array(y, mesh)).toarray())
    _same((bolt.array(x, CPU) * y[0]).toarray(),
          (ref.array(x, mesh) * y[0]).toarray())
    _same((y[0] * bolt.array(x, CPU)).toarray(), x * y[0])
    s = bolt.array(x, CPU).sum()                   # split 0
    _same((s + 1).toarray(), (ref.array(x, mesh).sum() + 1).toarray())


def test_first_runs_the_chain_on_one_record(mesh):
    x = _x()
    g = bolt.array(x, CPU).map(lambda v: v + 1)
    _same(g.first(), ref.array(x, mesh).map(lambda v: v + 1).first())
    assert g.deferred                    # first() did not materialise
    g.cache()
    assert not g.deferred
    _same(g.first(), x[0] + 1)


# ---------------------------------------------------------------------------
# host fallback
# ---------------------------------------------------------------------------

def test_map_nontraceable_fallback_warns():
    x = _x()
    b = bolt.array(x, CPU)

    def hostile(v):
        # numpy coercion of the record: not batchable by vmap
        return np.full((2,), float(np.asarray(v).sum()))

    with pytest.warns(bolt.HostFallbackWarning, match="hostile"):
        out = b.map(hostile)
    assert isinstance(out, bolt.BoltArrayGPU)
    _same(out.toarray(), np.asarray([hostile(v) for v in x]))


def test_data_dependent_control_flow_falls_back():
    x = _x()
    with pytest.warns(bolt.HostFallbackWarning, match="data-dependent"):
        out = bolt.array(x, CPU).map(lambda v: v if v.sum() > 0 else -v)
    _same(out.toarray(), np.asarray([v if v.sum() > 0 else -v for v in x]))


def test_reduce_nontraceable_fallback_warns():
    x = _x()

    def hostile(a, c):
        return np.asarray(a) + np.asarray(c)

    with pytest.warns(bolt.HostFallbackWarning, match="reduce"):
        out = bolt.array(x, CPU).reduce(hostile)
    np.testing.assert_allclose(out.toarray(), x.sum(axis=0), rtol=1e-12)


def test_buggy_callables_raise_not_fallback():
    b = bolt.array(_x(), CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error", bolt.HostFallbackWarning)
        with pytest.raises(AttributeError):
            b.map(lambda v: v.nonexistent_attr)
        with pytest.raises(TypeError):
            b.map(lambda v: v.reshape(3))
        with pytest.raises(TypeError):
            b.reduce(lambda a, c: a @ torch.ones((99, 2), dtype=a.dtype))


# ---------------------------------------------------------------------------
# swap (test_tpu_swap_enumeration.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [1, 2, 3])
def test_swap_exhaustive_matches_reference(mesh, split):
    x = _x((4, 2, 3, 2), seed=40)
    t = ref.array(x, mesh, axis=tuple(range(split)))
    g = bolt.array(x, CPU, axis=tuple(range(split)))
    nv = x.ndim - split
    for nk in range(split + 1):
        for kaxes in combinations(range(split), nk):
            for nvx in range(nv + 1):
                for vaxes in combinations(range(nv), nvx):
                    if len(kaxes) == split and len(vaxes) == 0:
                        with pytest.raises(ValueError):
                            g.swap(kaxes, vaxes)
                        continue
                    a, b = t.swap(kaxes, vaxes), g.swap(kaxes, vaxes)
                    assert (b.split, b.shape) == (a.split, a.shape)
                    assert np.array_equal(b.toarray(), a.toarray())
                    assert b._data.is_contiguous()


def test_swap_roundtrip_errors_and_donate():
    x = _x((4, 2, 3, 2), seed=40)
    b = bolt.array(x, CPU, axis=(0, 1))
    back = b.swap((1,), (0,)).swap((1,), (0,))
    assert back.shape == b.shape and np.array_equal(back.toarray(), x)
    for bad in [((5,), ()), ((), (7,)), ((0, 0), ())]:
        with pytest.raises(ValueError):
            b.swap(*bad)
    src = bolt.array(x, CPU, axis=(0, 1))
    out = src.swap((0,), (0,), donate=True)
    assert np.array_equal(out.toarray(), np.transpose(x, (1, 2, 0, 3)))
    with pytest.raises(RuntimeError, match="donated"):
        src.toarray()
    assert "donated" in repr(src)


def test_swap_of_deferred_chain(mesh):
    x = _x()
    t = ref.array(x, mesh).map(lambda v: v * 3).swap((0,), (1,))
    g = bolt.array(x, CPU).map(lambda v: v * 3).swap((0,), (1,))
    _same(g.toarray(), t.toarray())


# ---------------------------------------------------------------------------
# chunk (test_tpu_chunking.py)
# ---------------------------------------------------------------------------

def _chunk_pair(mesh, x, **kw):
    return (ref.array(x, mesh).chunk(**kw), bolt.array(x, CPU).chunk(**kw))


@pytest.mark.parametrize("shape,kw,func", [
    ((8, 6, 4), dict(size=(3, 2), axis=(0, 1)), lambda blk: blk * 2),
    ((4, 6, 4), dict(size=(3,), axis=(0,)),
     lambda blk: blk.T @ blk),                               # shape change
    ((8, 5, 4), dict(size=(2,), axis=(0,)),
     lambda blk: blk * 2 + 1),                               # ragged 2+2+1
    ((8, 6, 4), dict(size=(2,), axis=(0,), padding=1), lambda blk: blk * 3),
    ((2, 6), dict(size=(2,), axis=(0,), padding=1),
     lambda blk: blk * 0 + blk.max()),                       # halo visible
    ((4, 6, 7), dict(size=(2, 3), axis=(0, 1), padding=(1, 1)),
     lambda blk: blk - blk.mean()),                          # 2-d halo
], ids=["uniform", "shape_changing", "ragged", "padding", "halo", "halo2d"])
def test_chunk_map_matches_reference(mesh, shape, kw, func):
    x = _x(shape, seed=9)
    t, g = _chunk_pair(mesh, x, **kw)
    assert (g.plan, g.padding, g.grid, g.uniform) == \
        (t.plan, t.padding, t.grid, t.uniform)
    a, b = t.map(func), g.map(func)
    assert b.plan == a.plan
    _same(b.unchunk().toarray(), a.unchunk().toarray())


def test_chunk_map_many_categories(mesh):
    # interior, penultimate and ragged last blocks on both value axes
    x = _x((2, 11, 9), seed=4)
    t, g = _chunk_pair(mesh, x, size=(3, 2), axis=(0, 1), padding=(1, 1))
    f = lambda blk: blk * 0 + blk.sum()        # noqa: E731
    _same(g.map(f).unchunk().toarray(), t.map(f).unchunk().toarray())


def test_chunk_map_errors_and_hints(mesh):
    x = _x((8, 6, 4), seed=80)
    c = bolt.array(x, CPU).chunk(size=(2,), axis=(0,), padding=1)
    with pytest.raises(ValueError):
        c.map(lambda blk: blk[:1])
    c = bolt.array(x, CPU).chunk(size=(3,), axis=(0,))
    out = c.map(lambda blk: blk * 2, dtype=np.float32).unchunk()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out.toarray(), (x * 2).astype(np.float32))
    with pytest.raises(ValueError):
        c.map(lambda blk: blk * 2, value_shape=(9, 9))
    c.map(lambda blk: blk * 2, value_shape=(3, 4))
    with pytest.raises(ValueError):
        bolt.array(x, CPU).chunk(size=(2,), axis=(5,))
    assert "plan" in repr(c) and c.mode == "gpu"


def test_per_chunk_svd_config5_matches_reference(mesh):
    import jax.numpy as jnp
    x = _x((4, 20, 3), seed=9)
    t, g = _chunk_pair(mesh, x, size=(10,), axis=(0,))
    a = t.map(lambda blk: jnp.linalg.svd(blk, compute_uv=False)[None, :])
    b = g.map(lambda blk: torch.linalg.svd(blk, full_matrices=False)[1][None, :])
    assert b.unchunk().shape == (4, 2, 3)
    np.testing.assert_allclose(b.unchunk().toarray(), a.unchunk().toarray(),
                               rtol=1e-10)


def test_keys_values_exchange_matches_reference(mesh):
    x = _x((4, 2, 3, 5), seed=9)
    t = ref.array(x, mesh, axis=(0, 1, 2)).chunk(size=(5,), axis=(0,))
    g = bolt.array(x, CPU, axis=(0, 1, 2)).chunk(size=(5,), axis=(0,))
    a, b = t.keys_to_values((2, 1)), g.keys_to_values((2, 1))
    assert (b.kshape, b.vshape, b.plan) == (a.kshape, a.vshape, a.plan)
    assert np.array_equal(b.unchunk().toarray(), a.unchunk().toarray())
    a, b = a.values_to_keys((1,)), b.values_to_keys((1,))
    assert (b.kshape, b.vshape, b.plan) == (a.kshape, a.vshape, a.plan)
    assert np.array_equal(b.unchunk().toarray(), a.unchunk().toarray())
    assert g.keys_to_values((0,), size=(2,)).plan == (2, 5)
    with pytest.raises(ValueError):
        g.keys_to_values((3,))
    with pytest.raises(ValueError):
        g.values_to_keys((9,))
    allk = bolt.array(x, CPU).chunk().keys_to_values((0,))
    assert allk.split == 0
    assert np.array_equal(allk.values_to_keys((0,)).unchunk().toarray(), x)


def test_chunk_terminals_delegate(mesh):
    x = _x()
    g = bolt.array(x, CPU).chunk(size=(2,), axis=(0,))
    _same(g.sum().toarray(), x.sum(axis=0))
    _same(g.var(ddof=1).toarray(), x.var(axis=0, ddof=1))
    _same(g.reduce(add).toarray(), ref.array(x, mesh).reduce(add).toarray())
    assert g.unchunk().chunk().plan == (4, 5)


# ---------------------------------------------------------------------------
# conversions, indexing, shaping, construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", [
    (1,), (slice(1, 6, 2),), (slice(None, None, -1),), ([0, 3, 5],),
    (Ellipsis, 2), (slice(None), [0, 2], slice(1, 4)), (-1, [1, 3], 0),
    ([1, 4], [0, 2], [4, 3]), (np.array([True, False] * 4),),
    (slice(2, 7), slice(None, None, -2)),
], ids=lambda i: repr(i)[:40])
def test_getitem_matches_reference(mesh, index):
    x = _x()
    t = ref.array(x, mesh)[index]
    g = bolt.array(x, CPU)[index]
    assert (g.split, g.shape) == (t.split, t.shape)
    assert np.array_equal(g.toarray(), t.toarray())


def test_shaping_matches_reference(mesh):
    x = _x((4, 2, 3, 5))
    t = ref.array(x, mesh, axis=(0, 1))
    g = bolt.array(x, CPU, axis=(0, 1))
    for fn in (lambda b: b.reshape(8, 15), lambda b: b.reshape(4, 2, 5, 3),
               lambda b: b.transpose(1, 0, 3, 2), lambda b: b.T,
               lambda b: b.swapaxes(2, 3), lambda b: b.keys.reshape(8),
               lambda b: b.values.reshape(15), lambda b: b.keys.transpose(),
               lambda b: b.values.transpose(1, 0),
               lambda b: b[:, :1].squeeze(), lambda b: b.astype(np.float32)):
        a, b = fn(t), fn(g)
        assert (b.split, b.shape, b.dtype) == (a.split, a.shape, a.dtype)
        assert np.array_equal(b.toarray(), a.toarray())
    with pytest.raises(ValueError):
        g.transpose(2, 0, 1, 3)          # would cross the key boundary
    with pytest.raises(ValueError):
        g.reshape(7, 1)
    with pytest.raises(ValueError):
        g.squeeze(0)
    assert g.keys.shape == (4, 2) and g.values.shape == (3, 5)
    assert len(g) == 4


def test_toarray_is_a_copy_and_out():
    x = _x()
    b = bolt.array(x, CPU)
    a = b.toarray()
    a[...] = 0
    x[...] = 0                       # neither aliases the bolt array
    assert np.abs(b.toarray()).sum() > 0
    out = np.empty(b.shape)
    assert b.toarray(out=out) is out
    with pytest.raises(ValueError):
        b.toarray(out=np.empty((3,)))
    ((idx, block),) = list(b.iter_shards())
    assert np.array_equal(block, b.toarray())
    assert np.array_equal(b.tolocal(), b.toarray())
    assert b.togpu(CPU) is b
    assert isinstance(b.totorch(), torch.Tensor)


def test_construct_matches_local_and_dispatch():
    cpu = CPU
    for name in ("ones", "zeros"):
        g = getattr(bolt, name)((4, 3, 2), context=cpu, axis=(0, 1))
        assert (g.split, g.shape, g.dtype) == (2, (4, 3, 2), np.float64)
        assert np.array_equal(g.toarray(), getattr(np, name)((4, 3, 2)))
    g = bolt.full((4, 3), 2, context=cpu)
    assert g.dtype == np.int64 and np.all(g.toarray() == 2)
    g = bolt.full((4, 3), [1.0, 2.0, 3.0], context=cpu)   # broadcast fill
    assert np.array_equal(g.toarray(), np.full((4, 3), [1.0, 2.0, 3.0]))
    g = bolt.ones((4, 3, 2), context=cpu, axis=(1,), dtype=np.int32)
    assert g.shape == (3, 4, 2) and g.dtype == np.int32
    for name in ("rand", "randn"):
        a = getattr(bolt, name)((6, 5), context=cpu, seed=3)
        b = getattr(bolt, name)((6, 5), context=cpu, seed=3)
        assert np.array_equal(a.toarray(), b.toarray())
        with pytest.raises(ValueError):
            getattr(bolt, name)((6, 5), context=cpu, dtype=np.int32)
    r = bolt.rand((200, 50), context=cpu, dtype=np.float32).toarray()
    assert r.dtype == np.float32 and 0 <= r.min() and r.max() < 1
    assert isinstance(bolt.ones((2, 3)), bolt.BoltArrayLocal)
    with pytest.raises(ValueError):
        bolt.ones((2, 3), mode="tpu")
    with pytest.raises(ValueError):
        bolt.ones((2, 3), context="cpu", mode="gpu")
    t = torch.arange(12.).reshape(3, 4)
    g = bolt.array(t, cpu, axis=(1,))
    t += 1                               # the tensor input is copied
    assert np.array_equal(g.toarray(), np.arange(12.).reshape(3, 4).T)


def test_concatenate_matches_reference(mesh):
    x, y = _x(), _x(seed=8)
    t = ref.concatenate((ref.array(x, mesh), ref.array(y, mesh)), axis=1)
    g = bolt.concatenate((bolt.array(x, CPU), bolt.array(y, CPU)), axis=1)
    assert (g.split, g.shape) == (t.split, t.shape)
    _same(g.toarray(), t.toarray())
    g = bolt.concatenate((x, y), context=CPU)
    _same(g.toarray(), np.concatenate((x, y)))


def test_convert_from_reference(mesh):
    x = _x((4, 2, 3))
    t = ref.array(x, mesh, axis=(0, 1))
    g = convert.from_reference(t.toarray(), t.split, CPU)
    assert (g.split, g.shape) == (2, (4, 2, 3))
    assert np.array_equal(g.toarray(), t.toarray())
    st = t.stats()
    mom = convert.moments_from_reference(st.mu, st.m2, st.minValue,
                                         st.maxValue, device=CPU)
    got = bolt.array(x, CPU, axis=(0, 1)).stats()
    for m, v in zip(mom, (got.mu, got.m2, got.minValue, got.maxValue)):
        torch.testing.assert_close(torch.from_numpy(v), m, rtol=1e-10,
                                   atol=0)


# ---------------------------------------------------------------------------
# the slice as a whole: BASELINE configs 1, 2, 3 and 5 at a small size,
# the reference array carried across with convert.from_reference
# ---------------------------------------------------------------------------

def test_baseline_config1_map_sum_bit_exact(mesh):
    # ones(...).map(x + 1).sum(): bit-exact against the reference and
    # the local oracle
    shape = (20, 20, 8, 8)
    t = ref.ones(shape, mesh, dtype=np.float32)
    g = convert.from_reference(t.toarray(), t.split, CPU)
    got = g.map(lambda v: v + 1).sum()
    want = t.map(lambda v: v + 1).sum()
    assert np.array_equal(got.toarray(), want.toarray())
    lo = bolt.ones(shape, dtype=np.float32).map(lambda v: v + 1).sum(axis=0)
    assert np.array_equal(got.toarray(), lo)
    assert float(g.map(lambda v: v + 1).sum(axis=(0, 1, 2, 3)).toarray()) \
        == 2.0 * np.prod(shape)


def test_baseline_config2_ufuncs_and_reductions(mesh):
    x = _x((16, 6, 5), seed=21)
    t = ref.array(x, mesh)
    g = convert.from_reference(t.toarray(), t.split, CPU)
    for name in ("mean", "std", "var", "max"):
        _same(getattr(g.map(lambda v: v * v + 1), name)().toarray(),
              getattr(t.map(lambda v: v * v + 1), name)().toarray())
    _same(g.map(torch.exp).mean(axis=(0, 1)).toarray(),
          t.map(__import__("jax").numpy.exp).mean(axis=(0, 1)).toarray())
    st_g, st_t = g.stats(), t.stats()
    _same(st_g.stdev(), st_t.stdev())


def test_baseline_config3_swap(mesh):
    x = _x((6, 4, 5, 3), seed=22)
    t = ref.array(x, mesh, axis=(0, 1))
    g = convert.from_reference(t.toarray(), t.split, CPU)
    a, b = t.swap((1,), (0, 1)), g.swap((1,), (0, 1))
    assert (b.split, b.shape) == (a.split, a.shape)
    assert np.array_equal(b.toarray(), a.toarray())
    _same(b.sum().toarray(), a.sum().toarray())


def test_baseline_config5_chunk_svd_pipeline(mesh):
    import jax.numpy as jnp
    x = _x((3, 40, 6), seed=23)
    t = ref.array(x, mesh)
    g = convert.from_reference(t.toarray(), t.split, CPU)
    a = t.chunk(size=(10,), axis=(0,)).map(
        lambda blk: jnp.linalg.svd(blk, compute_uv=False)[None, :])
    b = g.chunk(size=(10,), axis=(0,)).map(
        lambda blk: torch.linalg.svdvals(blk)[None, :])
    np.testing.assert_allclose(b.unchunk().toarray(), a.unchunk().toarray(),
                               rtol=1e-10)
    np.testing.assert_allclose(b.unchunk().mean().toarray(),
                               a.unchunk().mean().toarray(), rtol=1e-10)


_KINDS = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
          "uint32", "uint64", "float16", "bfloat16", "float32", "float64"]


@pytest.mark.parametrize("kind", _KINDS)
def test_promotion_table_matches_jnp(kind):
    # the port's table of jnp's rule (gpu/dtypes.py) against jnp itself,
    # under the x64 setting the reference's tests run with
    import jax.numpy as jnp
    from bolt_tpu_torch.gpu import dtypes

    def tdt(k):
        return getattr(torch, {"bool": "bool"}.get(k, k))

    a = jnp.zeros(2, dtype=kind)
    others = [2, 2.5, True, np.float32(1.5), np.int32(2), np.int64(3),
              np.uint8(1), np.float64(1.5)] + [jnp.zeros(2, dtype=k)
                                               for k in _KINDS]
    for o in others:
        oper = tdt(str(o.dtype)) if isinstance(o, jnp.ndarray) else o
        assert dtypes.promote(tdt(kind), oper) == tdt(str((a + o).dtype))
        assert dtypes.true_divide(tdt(kind), oper) == \
            tdt(str((a / o).dtype)), o
    for name in ("mean", "var", "std", "sum", "prod", "min", "max"):
        want = getattr(jnp, name)(a).dtype
        assert dtypes.stat_dtype(name, tdt(kind)) == tdt(str(want)), name


# ---------------------------------------------------------------------------
# == and the numpy protocol (the port's open faults C1 and C2): == is
# elementwise, the array is unhashable, and numpy reads it as its values
# ---------------------------------------------------------------------------

def test_eq_ne_are_elementwise_like_the_reference(mesh):
    x = np.round(_x() * 2)
    t, g = ref.array(x, mesh), bolt.array(x, CPU)
    y = np.round(_x(seed=4) * 2)
    for f in (lambda b: b == 1, lambda b: b == b, lambda b: b != y,
              lambda b: b == y, lambda b: 1 != b):
        got, want = f(g), f(t)
        assert isinstance(got, bolt.BoltArrayGPU)
        assert got.dtype == want.dtype == np.bool_
        assert np.array_equal(got.toarray(), want.toarray())
    assert (g == g).toarray().all()
    assert (g == None) is False and (g != None) is True  # noqa: E711


def test_array_is_unhashable():
    b = bolt.array(_x(), CPU)
    with pytest.raises(TypeError):
        hash(b)
    with pytest.raises(TypeError):
        {b}


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32,
                                   np.bool_])
def test_numpy_reads_the_values(dtype):
    x = _x((20, 5, 4))
    x = (x > 0) if dtype == np.bool_ else x.astype(dtype)
    b = bolt.array(x, CPU).map(lambda v: v)
    a = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b.toarray())
    assert np.asarray(b, dtype=np.float64).dtype == np.float64
    assert np.allclose(b, x)
    assert np.array(b).dtype == b.dtype


def test_array_protocol_takes_numpy2_copy_keyword():
    import warnings
    b = bolt.array(_x(), CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        assert np.array_equal(b.__array__(copy=True), _x())
        assert np.array_equal(np.asarray(b, copy=True), _x())
    with pytest.raises(ValueError):
        b.__array__(copy=False)


def test_implicit_copy_to_host_warns_once(monkeypatch):
    from bolt_tpu_torch.gpu import array as garray
    monkeypatch.setattr(garray, "IMPLICIT_GATHER_WARN_BYTES", 1000)
    monkeypatch.setattr(garray, "_gather_warned", [])
    b = bolt.array(_x(), CPU)
    with pytest.warns(UserWarning, match="implicitly copied"):
        np.asarray(b)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.asarray(b)                    # once a process
