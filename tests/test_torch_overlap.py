"""The port's halo-overlap filters against the reference's:
``smooth``/``convolve``/``gaussian``/``median_filter``/``map_overlap`` on
the same seeded numpy inputs, the reference on the conftest CPU mesh (its
window kernels in interpret mode on 128-aligned shapes, its chunked path
on unaligned ones), the port on the CPU device (the window kernels' plain
versions).  Tolerances: f64 ``rtol=atol=1e-12``; f32 ``rtol=1e-5,
atol=1e-6`` (the reference's own); dtypes equal.  Follows
``test_ops_overlap.py``."""

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu.ops as rops
import bolt_tpu_torch as bolt
from bolt_tpu_torch import ops
from bolt_tpu_torch.ops import kernels as K
from bolt_tpu_torch.ops import overlap as ov

CPU = torch.device("cpu")
MODES = ["constant", "reflect", "edge", "symmetric"]
_TOL = {np.dtype(np.float64): dict(rtol=1e-12, atol=1e-12),
        np.dtype(np.float32): dict(rtol=1e-5, atol=1e-6)}

# (label, call) pairs: the same call on either package's ops module
FILTERS = [
    ("smooth3", lambda m, b, **kw: m.smooth(b, 3, **kw)),
    ("convolve_asym", lambda m, b, **kw: m.convolve(
        b, [0.5, 0.25, 0.0, -0.5, 0.125], **kw)),
    ("gaussian1.5", lambda m, b, **kw: m.gaussian(b, 1.5, **kw)),
]


def _x(shape, dtype=np.float64, seed=11):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _same(g, t, tol=None):
    """Shape, dtype and values of a port result against the reference's."""
    gv, tv = g.toarray(), t.toarray()
    assert gv.shape == tv.shape and gv.dtype == tv.dtype, \
        (gv.shape, tv.shape, gv.dtype, tv.dtype)
    np.testing.assert_allclose(gv, tv, **(tol or _TOL[gv.dtype]))


# a 128-aligned minor axis (the reference runs its Pallas window kernels)
# in f32, and an unaligned one (its chunked path) in f64
@pytest.mark.parametrize("shape,dtype", [((2, 8, 128), np.float32),
                                         ((3, 20, 12), np.float64)],
                         ids=["aligned_f32", "unaligned_f64"])
@pytest.mark.parametrize("axis", [(0,), (1,), (0, 1)])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("label,call", FILTERS, ids=[f[0] for f in FILTERS])
def test_filters_match_reference(mesh, label, call, mode, axis, shape,
                                 dtype):
    # chunks wider than the widest halo (gaussian 1.5: radius 6), so the
    # reference's chunked path takes this plan
    x = _x(shape, dtype)
    size = (8, 7)[:len(axis)]
    t = call(rops, ref.array(x, mesh), axis=axis, mode=mode, size=size)
    g = call(ops, bolt.array(x, CPU), axis=axis, mode=mode, size=size)
    assert g.split == t.split
    _same(g, t)


@pytest.mark.parametrize("axis", [(0,), (1,), (0, 1)])
@pytest.mark.parametrize("mode", MODES)
def test_median_filter_matches_reference(mesh, mode, axis):
    x = _x((3, 12, 10))
    widths = (3, 5)[:len(axis)]
    t = rops.median_filter(ref.array(x, mesh), widths, axis=axis,
                           size=(6, 5)[:len(axis)], mode=mode)
    g = ops.median_filter(bolt.array(x, CPU), widths, axis=axis,
                          size=(6, 5)[:len(axis)], mode=mode)
    _same(g, t)


def test_median_filter_propagates_nan(mesh):
    x = _x((2, 12, 10))
    x[0, 5, 4] = np.nan
    t = rops.median_filter(ref.array(x, mesh), 3, axis=(0, 1))
    g = ops.median_filter(bolt.array(x, CPU), 3, axis=(0, 1))
    np.testing.assert_array_equal(np.isnan(g.toarray()),
                                  np.isnan(t.toarray()))
    assert np.isnan(g.toarray()).sum() == 9
    _same(g, t, dict(rtol=1e-12, atol=1e-12, equal_nan=True))


@pytest.mark.parametrize("label,call", FILTERS + [
    ("median3", lambda m, b, **kw: m.median_filter(b, 3, **kw))],
    ids=[f[0] for f in FILTERS] + ["median3"])
def test_deferred_chain_input(mesh, label, call):
    # a deferred map chain is applied before the filter, on both packages
    x = _x((3, 16, 128), np.float32)
    t = call(rops, ref.array(x, mesh).map(lambda v: v * 2 + 1),
             axis=(0, 1))
    gb = bolt.array(x, CPU).map(lambda v: v * 2 + 1)
    assert gb.deferred
    g = call(ops, gb, axis=(0, 1))
    _same(g, t)


def test_unsorted_axis_binding(mesh):
    # widths pair with the axes in the ORDER GIVEN: (3, 5) on axis (1, 0)
    # is width 3 on value axis 1 and width 5 on value axis 0
    x = _x((2, 16, 10))
    t = rops.smooth(ref.array(x, mesh), (3, 5), axis=(1, 0), size=(4, 5))
    g = ops.smooth(bolt.array(x, CPU), (3, 5), axis=(1, 0), size=(4, 5))
    _same(g, t)
    s = ops.smooth(bolt.array(x, CPU), (5, 3), axis=(0, 1))
    np.testing.assert_allclose(g.toarray(), s.toarray(), rtol=1e-12,
                               atol=1e-12)
    tg = rops.gaussian(ref.array(x, mesh), (1.0, 2.0), axis=(1, 0))
    gg = ops.gaussian(bolt.array(x, CPU), (1.0, 2.0), axis=(1, 0))
    _same(gg, tg)


@pytest.mark.parametrize("label,call", [
    ("gaussian_sigma0", lambda m, b: m.gaussian(b, 0.0, axis=(0, 1))),
    ("smooth_width1", lambda m, b: m.smooth(b, 1)),
    ("convolve_one", lambda m, b: m.convolve(b, [1.0], axis=(0,)))],
    ids=["gaussian_sigma0", "smooth_width1", "convolve_one"])
def test_identity_filters_return_a_new_wrapper(mesh, label, call):
    x = _x((3, 8, 6))
    b = bolt.array(x, CPU)
    g = call(ops, b)
    assert g is not b
    _same(g, call(rops, ref.array(x, mesh)))
    np.testing.assert_array_equal(g.toarray(), x)


def test_single_tap_scales(mesh):
    x = _x((2, 12, 10))
    t = rops.convolve(ref.array(x, mesh), [2.0], axis=(0,))
    g = ops.convolve(bolt.array(x, CPU), [2.0], axis=(0,))
    _same(g, t)
    np.testing.assert_allclose(g.toarray(), x * 2.0, rtol=1e-12)


@pytest.mark.parametrize("label,call", FILTERS + [
    ("median3", lambda m, b, **kw: m.median_filter(b, 3, **kw))],
    ids=[f[0] for f in FILTERS] + ["median3"])
@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.bool_])
def test_integer_input_dtype_matches_reference(mesh, label, call, dtype):
    # integer inputs take the chunked path on both; their result dtype is
    # the reference's jnp rule (int32 * a Python float is f64 under x64;
    # the median of int32 is f32)
    x = _x((3, 12, 10)) * 5
    x = x > 0 if dtype == np.bool_ else x.astype(dtype)
    t = call(rops, ref.array(x, mesh), axis=(0, 1), size=(7, 7))
    g = call(ops, bolt.array(x, CPU), axis=(0, 1), size=(7, 7))
    _same(g, t, dict(rtol=1e-12, atol=1e-12))


@pytest.mark.parametrize("label,call", FILTERS + [
    ("median3", lambda m, b, **kw: m.median_filter(b, 3, **kw))],
    ids=[f[0] for f in FILTERS] + ["median3"])
def test_local_mode_matches_reference_local(label, call):
    x = _x((3, 14, 9))
    t = call(rops, ref.array(x), axis=(0, 1), size=(7, 7), mode="reflect")
    g = call(ops, bolt.array(x), axis=(0, 1), size=(7, 7), mode="reflect")
    assert g.mode == "local"
    _same(g, t)


def test_chunking_invariance(mesh):
    # the chunked path's answer does not depend on the chunk plan
    x = _x((2, 23, 8)).astype(np.int32)
    full = ops.smooth(bolt.array(x, CPU), 7, axis=(0,)).toarray()
    for size in [(23,), (12,), (7,), (5,)]:
        out = ops.smooth(bolt.array(x, CPU), 7, axis=(0,), size=size)
        np.testing.assert_allclose(out.toarray(), full, rtol=1e-12)
        t = rops.smooth(ref.array(x, mesh), 7, axis=(0,), size=size)
        _same(out, t, dict(rtol=1e-12, atol=1e-12))


def test_scipy_mode_aliases():
    x = _x((2, 16, 6))
    b = bolt.array(x, CPU)
    for alias, name in (("mirror", "reflect"), ("nearest", "edge")):
        np.testing.assert_array_equal(
            ops.gaussian(b, 1.0, axis=(0,), mode=alias).toarray(),
            ops.gaussian(b, 1.0, axis=(0,), mode=name).toarray())


def _grad_torch(blk):
    d = torch.zeros_like(blk)
    d[:-1] = blk[1:] - blk[:-1]
    return d


def _grad_jnp(blk):
    import jax.numpy as jnp
    return jnp.zeros_like(blk).at[:-1].set(blk[1:] - blk[:-1])


def test_map_overlap_generic(mesh):
    # a custom stencil: forward difference needing one neighbour
    x = _x((2, 12, 4))
    t = rops.map_overlap(ref.array(x, mesh), _grad_jnp, 1, axis=(0,),
                         size=(4,))

    def grad(blk):
        return torch.cat([blk[1:] - blk[:-1], torch.zeros_like(blk[:1])])

    g = ops.map_overlap(bolt.array(x, CPU), grad, 1, axis=(0,), size=(4,))
    _same(g, t)
    expect = np.zeros_like(x)
    expect[:, :-1] = x[:, 1:] - x[:, :-1]
    np.testing.assert_allclose(g.toarray()[:, :-1], expect[:, :-1],
                               rtol=1e-12)


@pytest.mark.parametrize("call", [
    lambda m, b: m.smooth(b, 4),                          # even width
    lambda m, b: m.smooth(b, 3, mode="wrap"),             # unknown mode
    lambda m, b: m.gaussian(b, -1.0, axis=(0,)),          # negative sigma
    lambda m, b: m.convolve(b, [[0.25, 0.5, 0.25]], axis=(0, 1)),
    lambda m, b: m.convolve(b, [0.5, 0.5]),               # even kernel
    lambda m, b: m.median_filter(b, 2),                   # even width
    lambda m, b: m.smooth(b, 3, axis=(5,)),               # no such axis
    lambda m, b: m.smooth(b, 3, shard="b"),               # no mesh here
], ids=["even_width", "mode", "sigma", "kernel_count", "even_kernel",
        "median_even", "axis", "shard"])
def test_errors_match_reference(call):
    x = _x((3, 8, 6))
    with pytest.raises(ValueError):
        call(rops, ref.array(x))
    with pytest.raises(ValueError):
        call(ops, bolt.array(x, CPU))
    with pytest.raises(ValueError):
        call(ops, bolt.array(x))


def test_whole_array_path_one_kernel_call_per_axis(monkeypatch):
    # a floating gpu-mode array: one sepfilter1d call per active axis, in
    # the caller's order, on the full tensor; integers never reach it
    calls = []
    real = K.sepfilter1d

    def spy(x, taps, ax, mode="constant", precision=None):
        calls.append((tuple(x.shape), len(taps), ax, mode, precision))
        return real(x, taps, ax, mode=mode, precision=precision)

    monkeypatch.setattr(K, "sepfilter1d", spy)
    x = _x((2, 8, 128), np.float32)
    ops.gaussian(bolt.array(x, CPU), (2.0, 1.0), axis=(1, 0), mode="edge")
    assert calls == [((2, 8, 128), 17, 2, "edge", "highest"),
                     ((2, 8, 128), 9, 1, "edge", "highest")]
    with bolt.precision("default"):
        ops.smooth(bolt.array(x, CPU), 3, axis=(0,))
    assert calls[-1] == ((2, 8, 128), 3, 1, "constant", "default")
    del calls[:]
    ops.smooth(bolt.array(x.astype(np.int32), CPU), 3)
    ops.smooth(bolt.array(x), 3)                 # local mode
    assert calls == []


def test_kernel_failure_raises(monkeypatch):
    # a failing kernel surfaces: no quiet retry on the chunked path
    def boom(*args, **kwargs):
        raise RuntimeError("simulated window kernel failure")

    monkeypatch.setattr(K, "sepfilter1d", boom)
    b = bolt.array(_x((2, 8, 128), np.float32), CPU)
    with pytest.raises(RuntimeError, match="simulated"):
        ops.gaussian(b, 2.0, axis=(0, 1))
    with pytest.raises(RuntimeError, match="simulated"):
        ops.smooth(b, 3)


def test_block_functions_are_memoised():
    assert ov._sepfilter_fn(((0.5, 0.5, 0.5),), (0,), "edge") is \
        ov._sepfilter_fn(((0.5, 0.5, 0.5),), (0,), "edge")
    assert ov._medfilt_fn((0,), (3,), "reflect") is \
        ov._medfilt_fn((0,), (3,), "reflect")


def test_filters_under_every_precision_mode(mesh):
    x = _x((4, 16, 128), np.float32)
    t = rops.gaussian(ref.array(x, mesh), 2.0, axis=(0,))
    for mode in ("default", "high", "highest"):
        with bolt.precision(mode):
            _same(ops.gaussian(bolt.array(x, CPU), 2.0, axis=(0,)), t)
        _same(ops.gaussian(bolt.array(x, CPU), 2.0, axis=(0,),
                           precision=mode), t)
    with pytest.raises(ValueError, match="precision mode"):
        ops.smooth(bolt.array(x, CPU), 3, precision="bf16")
