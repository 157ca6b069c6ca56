"""The rest of the numpy function surface on the port: stacking and
layout, contractions, the nan family, ``np.linalg``, ``np.fft``,
``apply_along_axis`` and the tails of ``bolt_tpu_torch/gpu/npdispatch.py``.

Each case of the reference's lists (``tests/test_array_function.py``:
``TAIL_CASES``, ``TAIL2_CASES`` with ``TAIL2_CLEAN``, ``LINALG_CASES``,
``TAIL4_CASES``, ``FFT_CASES``, ``TAIL8_CASES``, ``TAIL9_CASES``) runs at
the reference's layouts (one key axis; two key axes where the reference
runs them) on ``bolt_tpu_torch`` with ``context=torch.device("cpu")``,
held against numpy on the host array (``allclose``: rtol 1e-5, atol 1e-8,
NaN equal) and against ``bolt_tpu`` on the 8-device CPU mesh (x64) with
the same inputs (``allclose`` at rtol 1e-6, atol 1e-8, the same dtype and
the same split).  The reference's detail tests of these families follow
with its assertions, then the port's own: every reference table entry is
in the port's table and in ``docs/API.md``, no served call copies an
operand to the host, a repeated call builds no new program, and the nan
reductions of a chain fold block partials equal to the whole-tensor
answer.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu.tpu import npdispatch as ref_npdispatch
from bolt_tpu_torch import engine
from bolt_tpu_torch.gpu import array as garray
from bolt_tpu_torch.gpu import npdispatch
from tests.test_array_function import (FFT_CASES, LINALG_CASES, TAIL2_CASES,
                                       TAIL2_CLEAN, TAIL4_CASES, TAIL8_CASES,
                                       TAIL9_CASES, TAIL_CASES, _spd, _tall,
                                       _x2, _xnan)

CPU = torch.device("cpu")


def _val(v):
    return np.asarray(v.toarray() if hasattr(v, "toarray") else v)


def _first(v):
    return v[0] if isinstance(v, (list, tuple)) else v


def _parity(request, layout, call, x, ref_too=True):
    """``call`` on the port against numpy and (``ref_too``) the
    reference, at ``layout``."""
    if layout == "keys1d":
        axis, m = (0,), request.getfixturevalue("mesh")
    else:
        axis, m = (0, 1), request.getfixturevalue("mesh2d")
    with warnings.catch_warnings():
        # numpy's own deprecations (irfftn's s without axes) and the host
        # fallbacks the reference also takes
        warnings.simplefilter("ignore")
        expect = call(x)
        got = call(bolt.array(x, CPU, axis=axis))
        want = call(ref.array(x, m, axis=axis)) if ref_too else None
    g, e = _val(_first(got)), np.asarray(_first(expect))
    assert g.shape == e.shape, (g.shape, e.shape)
    assert np.allclose(g, e, rtol=1e-5, atol=1e-8, equal_nan=True)
    if want is not None:
        w = _val(_first(want))
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert np.allclose(g, w, rtol=1e-6, atol=1e-8, equal_nan=True)
        assert getattr(_first(got), "split", None) == \
            getattr(_first(want), "split", None)
    return got


def _cases(cases, layouts=("keys1d", "keys2d"), skip=()):
    return [pytest.param(layout, c[0], c[1], id="%s-%s" % (c[0], layout))
            for c in cases for layout in layouts
            if (c[0], layout) not in skip]


# ---------------------------------------------------------------------
# the reference's case lists
# ---------------------------------------------------------------------

@pytest.mark.parametrize(
    "layout,name,call",
    _cases(TAIL_CASES, skip={("rot90-values", "keys2d")}))
def test_dispatch_tail_parity(request, layout, name, call):
    _parity(request, layout, call, _x2())


def test_rot90_across_the_boundary_rejects():
    # on the split=2 layout axes (1, 2) straddle the key/value boundary:
    # the odd rotation rejects like transpose does
    b = bolt.array(_x2(), CPU, axis=(0, 1))
    with pytest.raises(ValueError, match="swap"):
        np.rot90(b, 1, axes=(1, 2))


@pytest.mark.parametrize("layout,name,call",
                         _cases(TAIL2_CASES + TAIL2_CLEAN))
def test_dispatch_tail2_parity(request, layout, name, call):
    x = _xnan() if name.startswith("nan") else _x2()[:8]
    _parity(request, layout, call, x)


@pytest.mark.parametrize("name,call,make", LINALG_CASES,
                         ids=[c[0] for c in LINALG_CASES])
def test_linalg_parity(request, name, call, make):
    x = make()
    mesh = request.getfixturevalue("mesh")
    got = call(bolt.array(x, CPU))
    g = _val(got)
    e = call(x)
    assert g.shape == np.shape(e), (name, g.shape, np.shape(e))
    assert np.allclose(g, e, rtol=1e-6, atol=1e-8), name
    w = _val(call(ref.array(x, mesh)))
    assert g.dtype == w.dtype and np.allclose(g, w, rtol=1e-6, atol=1e-8)


# the reference skips its 1-d slices on the two-key layout
_ONE_D = {(n, "keys2d") for n in ("diag-1d", "vander", "convolve",
                                  "correlate-full")}


@pytest.mark.parametrize("layout,name,call", _cases(TAIL4_CASES,
                                                    skip=_ONE_D))
def test_dispatch_tail4_parity(request, layout, name, call):
    _parity(request, layout, call, _x2()[:8])


@pytest.mark.parametrize("layout,name,call", _cases(FFT_CASES))
def test_dispatch_tail5_parity(request, layout, name, call):
    _parity(request, layout, call, _x2()[:8])


@pytest.mark.parametrize("layout,name,call",
                         _cases(TAIL8_CASES, layouts=("keys1d",)))
def test_dispatch_tail8_parity(request, layout, name, call):
    x = _xnan() if "nan" in name else _x2()[:8]
    if name in ("ediff1d", "ediff1d-ends"):
        x = x[:, 0, 0].copy()
    _parity(request, layout, call, x)


@pytest.mark.parametrize("layout,name,call", _cases(TAIL9_CASES))
def test_dispatch_tail9_parity(request, layout, name, call):
    _parity(request, layout, call, _x2())


# ---------------------------------------------------------------------
# stacking and layout: the reference's detail tests
# ---------------------------------------------------------------------

def test_dispatch_tail_deferred_chains_fuse():
    # a deferred map runs inside the tail's one program and the original
    # chain stays intact
    x = _x2()
    b = bolt.array(x, CPU).map(lambda v: v * 2.0)
    out = np.stack([b, b], axis=0)
    assert np.allclose(out.toarray(), np.stack([x * 2, x * 2], axis=0))
    s = np.roll(b, 2, axis=0)
    assert np.allclose(s.toarray(), np.roll(x * 2, 2, axis=0))
    assert b.deferred
    assert np.allclose(b.toarray(), x * 2)


def test_dispatch_tail_rejections():
    x = _x2()
    b = bolt.array(x, CPU)
    with pytest.raises(ValueError, match="repeated axis"):
        np.expand_dims(b, (0, 0))
    with pytest.raises(np.exceptions.AxisError):
        np.expand_dims(b, 9)
    with pytest.raises(ValueError):
        np.broadcast_to(b, (2, 2, 2))
    with pytest.raises(np.exceptions.AxisError):
        np.roll(b, 1, axis=5)
    with pytest.raises(ValueError, match="must be different"):
        np.rot90(b, axes=(1, 1))
    with pytest.raises(ValueError, match="len\\(axes\\)"):
        np.rot90(b, axes=(0, 1, 2))
    with pytest.raises(ValueError, match="out of range"):
        np.rot90(b, axes=(0, 5))
    with pytest.raises(ValueError, match="swap"):
        np.rot90(b, 1, axes=(0, 1))
    # even rotations are pure flips: allowed across the boundary
    assert np.allclose(np.rot90(b, 2, axes=(0, 1)).toarray(),
                       np.rot90(x, 2, axes=(0, 1)))
    with pytest.raises(ValueError, match="negative"):
        np.pad(b, -1)
    with pytest.raises(TypeError, match="integral"):
        np.pad(b, 1.5)
    with pytest.raises(ValueError, match="unsupported keyword"):
        np.pad(b, 1, mode="edge", constant_values=3)
    with pytest.raises(ValueError, match="same shape"):
        np.stack([b, bolt.array(x[:4], CPU)])
    with pytest.raises(np.exceptions.AxisError):
        np.stack([b, b], axis=7)


def test_dispatch_tail_fallbacks_stay_correct():
    # unsupported forms take the warned host path but remain numpy-correct
    x = _x2()
    b = bolt.array(x, CPU)
    out = np.einsum("i...,i...->...", b, b)     # ellipsis: on the card
    assert getattr(out, "mode", None) == "gpu"
    assert np.allclose(out.toarray(), np.einsum("i...,i...->...", x, x))
    out2 = np.pad(b, 1, mode="mean")                 # stat mode: host
    assert np.allclose(out2, np.pad(x, 1, mode="mean"))
    out3 = np.pad(b, 1, mode="linear_ramp", end_values=2.0)
    assert np.allclose(out3, np.pad(x, 1, mode="linear_ramp",
                                    end_values=2.0))


def test_stack_family_split_bookkeeping():
    x = _x2()
    b = bolt.array(x, CPU)
    assert np.stack([b, b], axis=0).split == 2     # new leading key axis
    assert np.stack([b, b], axis=1).split == 1     # value-side insert
    assert np.expand_dims(b, 0).split == 2
    assert np.expand_dims(b, 1).split == 1         # at the boundary: value
    assert np.broadcast_to(b, (2,) + x.shape).split == 2
    assert np.tile(b, (3, 1, 1, 1)).split == 2
    b2 = bolt.array(x, CPU, axis=(0, 1))
    assert np.stack([b2, b2], axis=1).split == 3   # inserted among keys
    assert np.roll(b2, 1, axis=0).split == 2


def test_dispatch_tail_review_edges():
    x = _x2()
    b = bolt.array(x, CPU)
    # empty shift/axis tuples broadcast to zero rolls: an unchanged copy
    assert np.allclose(np.roll(b, 1, axis=()).toarray(),
                       np.roll(x, 1, axis=()))
    assert np.allclose(np.roll(b, (), axis=()).toarray(), x)
    assert np.allclose(np.roll(b, (), axis=0).toarray(), x)
    # shape clashes are numpy's ValueError, not a torch error
    with pytest.raises(ValueError, match="must match exactly"):
        np.vstack([b, np.ones((3, 6, 4))[..., :3]])
    with pytest.raises(ValueError, match="same number of dimensions"):
        np.hstack([b, np.ones(3)])
    # non-default casting routes to the host so numpy's TypeError stays
    with pytest.raises(TypeError, match="Cannot cast"):
        np.stack([b.astype(np.float32), b], casting="no", dtype=np.float64)


def test_advice_r4_edges():
    rs = np.random.RandomState(61)
    b16 = bolt.array(rs.randn(16), CPU)
    # hstack with a 1-d first operand and a 2-d second: numpy's error
    # (decided from the FIRST array alone)
    with pytest.raises(ValueError):
        np.hstack([b16, rs.randn(2, 2)])
    with pytest.raises(ValueError):
        np.hstack([np.asarray(b16), rs.randn(2, 2)])


def test_pad_wide_reflections_and_constants():
    # pads wider than the axis reflect in rounds (jnp's algorithm), odd
    # reflections about the moving edge; per-axis constants in order
    x = np.random.RandomState(3).randn(5, 3, 4)
    b = bolt.array(x, CPU)
    for mode, kw in (("reflect", {}), ("symmetric", {}),
                     ("reflect", {"reflect_type": "odd"}),
                     ("symmetric", {"reflect_type": "odd"}),
                     ("wrap", {}), ("edge", {})):
        got = np.pad(b, ((0, 0), (7, 5), (9, 2)), mode=mode, **kw)
        assert np.allclose(got.toarray(), np.pad(
            x, ((0, 0), (7, 5), (9, 2)), mode=mode, **kw)), (mode, kw)
    cv = ((1.0, 2.0), (3.0, 4.0), (5.0, 6.0))
    assert np.allclose(np.pad(b, 2, constant_values=cv).toarray(),
                       np.pad(x, 2, constant_values=cv))
    xi = np.arange(24).reshape(2, 3, 4)
    gi = np.pad(bolt.array(xi, CPU), 1, constant_values=7.5)
    assert gi.dtype == xi.dtype
    assert np.array_equal(gi.toarray(), np.pad(xi, 1, constant_values=7.5))


# ---------------------------------------------------------------------
# contractions
# ---------------------------------------------------------------------

def test_einsum_key_survival_and_mxu_policy():
    x = _x2()
    b = bolt.array(x, CPU)
    out = np.einsum("ijk,kl->ijl", b, np.ones((4, 3)))
    assert out.split == 1
    assert np.allclose(out.toarray(),
                       np.einsum("ijk,kl->ijl", x, np.ones((4, 3))))
    out2 = np.einsum("ijk->jk", b)
    assert out2.split == 0
    b2 = bolt.array(x, CPU, axis=(0, 1))
    out3 = np.einsum("ijk,k->ij", b2, np.arange(4.0))
    assert out3.split == 2
    assert np.allclose(out3.toarray(),
                       np.einsum("ijk,k->ij", x, np.arange(4.0)))
    # the precision mode is part of the program key: a "default" scope
    # builds its own program
    b32 = bolt.array(x.astype(np.float32), CPU)
    w = np.ones((4, 3), np.float32)
    np.einsum("ijk,kl->ijl", b32, w)
    fams = [k for k in engine._CACHE if k[0] == "einsum"]
    with bolt.precision("default"):
        np.einsum("ijk,kl->ijl", b32, w)
    modes = {k[3][1] for k in engine._CACHE if k[0] == "einsum"}
    assert {"highest", "default"} <= modes
    assert len([k for k in engine._CACHE if k[0] == "einsum"]) > len(fams)


def test_contraction_errors_are_numpys():
    b = bolt.array(_x2(), CPU)
    with pytest.raises(ValueError):
        np.einsum("ijk,kl->ijl", b, np.ones((5, 3)))
    with pytest.raises(ValueError):
        np.tensordot(b, np.ones((5, 4)), axes=([1], [0]))
    with pytest.raises(ValueError):
        np.inner(b, np.ones(5))
    # list operands take numpy's dtype
    x = _x2()
    assert np.allclose(_val(np.inner(b, [1.0, 2.0, 3.0, 4.0])),
                       np.inner(x, [1.0, 2.0, 3.0, 4.0]))
    assert np.allclose(_val(np.einsum("ijk,k->ij", b, [1, 2, 3, 4])),
                       np.einsum("ijk,k->ij", x, [1, 2, 3, 4]))
    # integer contractions stay integer (jnp's dtypes)
    xi = np.arange(24).reshape(2, 3, 4)
    gi = np.einsum("ijk,k->ij", bolt.array(xi, CPU), np.arange(4))
    assert gi.dtype == np.int64
    assert np.array_equal(gi.toarray(), np.einsum("ijk,k->ij", xi,
                                                  np.arange(4)))


# ---------------------------------------------------------------------
# the nan family and sample statistics
# ---------------------------------------------------------------------

def test_dispatch_tail2_details():
    x = _x2()[:8]
    b = bolt.array(x, CPU)
    outs = np.gradient(b)
    expects = np.gradient(x)
    assert isinstance(outs, list) and len(outs) == 3
    for o, e in zip(outs, expects):
        assert o.mode == "gpu" and o.split == 1
        assert np.allclose(o.toarray(), e)
    avg, scl = np.average(b, axis=0, returned=True)
    ea, es = np.average(x, axis=0, returned=True)
    assert np.allclose(avg.toarray(), ea) and np.allclose(scl, es)
    w = np.arange(1.0, 7.0)
    avg2, scl2 = np.average(b, axis=1, weights=w, returned=True)
    ea2, es2 = np.average(x, axis=1, weights=w, returned=True)
    assert np.allclose(avg2.toarray(), ea2) and np.allclose(scl2, es2)
    assert np.nansum(bolt.array(_xnan(), CPU), axis=2).split == 1
    assert np.nansum(bolt.array(_xnan(), CPU), axis=0).split == 0
    assert np.linalg.norm(b, axis=2).split == 1
    with pytest.raises(ValueError, match="Length of weights"):
        np.average(b, axis=1, weights=np.arange(5.0))
    with pytest.raises(ZeroDivisionError):
        np.average(b, axis=1, weights=np.zeros(6))
    with pytest.raises(ValueError, match="at least 2 elements"):
        np.gradient(bolt.array(x[:1], CPU), axis=0)
    with pytest.raises(ValueError, match="same length"):
        np.interp(b, np.arange(4.0), np.arange(5.0))
    with pytest.raises(ValueError, match="1-D"):
        np.interp(b, np.ones((2, 2)), np.ones((2, 2)))
    xb = bolt.array(_xnan(), CPU)
    assert np.isnan(float(np.asarray(np.sum(xb).toarray())))
    assert not np.isnan(float(np.asarray(np.nansum(xb).toarray())))


def test_dispatch_tail2_split_matches_method_convention():
    x = np.random.RandomState(44).randn(8, 8, 4)   # square leading dims
    b = bolt.array(x, CPU)
    assert np.nansum(b, axis=0).split == b.sum(axis=0).split == 0
    assert np.nansum(b, axis=1).split == b.sum(axis=1).split == 1
    assert np.nanmean(b, axis=0, keepdims=True).split == \
        b.mean(axis=0, keepdims=True).split == 1
    assert np.linalg.norm(b, axis=0).split == 0
    assert np.linalg.norm(b, axis=2).split == 1
    assert np.average(b, axis=0).split == 0
    b2 = bolt.array(x, CPU, axis=(0, 1))
    assert np.nansum(b2, axis=0).split == 1
    assert np.nansum(b2, axis=(0, 1)).split == 0
    assert np.nanvar(b2, axis=2).split == 2
    assert np.nanquantile(b, [0.2, 0.8], axis=1).split == \
        b.quantile([0.2, 0.8], axis=1).split == 2
    xi = np.arange(24).reshape(4, 6)
    ib = bolt.array(xi, CPU)
    assert np.allclose(np.asarray(np.nanquantile(ib, 0.3).toarray()),
                       np.nanquantile(xi, 0.3))
    assert np.allclose(np.asarray(np.nanmedian(ib).toarray()),
                       np.median(xi))
    with pytest.raises(ValueError, match="monotonically"):
        np.digitize(b, np.array([3.0, 1.0, 2.0]))
    bins = np.array([2.0, 1.0, -1.0, -2.0])
    assert np.array_equal(np.asarray(np.digitize(b, bins).toarray()),
                          np.digitize(x, bins))


def test_batch23_review_edges():
    x = np.random.RandomState(50).randn(8, 6, 4)
    b = bolt.array(x, CPU)
    assert np.allclose(np.asarray(np.nanvar(b, 0, None, None, 1).toarray()),
                       np.nanvar(x, 0, None, None, 1))
    assert np.allclose(np.asarray(np.nanstd(b, 1, None, None, 1).toarray()),
                       np.nanstd(x, 1, None, None, 1))
    bins = np.array([1.0, 1.0, 2.0])
    assert np.array_equal(np.asarray(np.digitize(b, bins).toarray()),
                          np.digitize(x, bins))
    with pytest.raises(ValueError, match="non-zero"):
        np.interp(b, np.arange(4.0), np.arange(4.0), period=0)
    # q is an operand: sweeping quantiles reuses ONE program
    bq = bolt.array(np.random.RandomState(54).randn(8, 5, 3), CPU)
    n0 = sum(1 for k in engine._CACHE if k[0] == "nanquantile")
    for qv in (0.1, 0.4, 0.9):
        np.nanquantile(bq, qv)
    assert sum(1 for k in engine._CACHE if k[0] == "nanquantile") == n0 + 1
    d = np.diag([10.0, 1.0, 0.1])
    bd = bolt.array(d, CPU)
    assert int(np.asarray(np.linalg.matrix_rank(bd, rtol=0.05).toarray())) \
        == np.linalg.matrix_rank(d, rtol=0.05) == 2
    assert int(np.asarray(np.linalg.matrix_rank(bd, tol=0.05).toarray())) \
        == np.linalg.matrix_rank(d, tol=0.05) == 3
    h = np.diag([2.0, -1.0, 1e-12])
    bh = bolt.array(h, CPU)
    assert int(np.asarray(
        np.linalg.matrix_rank(bh, hermitian=True).toarray())) \
        == np.linalg.matrix_rank(h, hermitian=True)
    u = np.random.RandomState(51).randn(3, 5)
    bu = bolt.array(u, CPU)
    rhs = np.random.RandomState(52).randn(3)
    _, res_g, _, _ = np.linalg.lstsq(bu, rhs, rcond=None)
    _, res_e, _, _ = np.linalg.lstsq(u, rhs, rcond=None)
    assert np.shape(np.asarray(res_g.toarray())) == np.shape(res_e) == (0,)
    sq = _spd()
    bs = bolt.array(sq, CPU)
    rhs2 = np.random.RandomState(53).randn(2, 16, 5, 5)
    out = np.linalg.solve(bs, rhs2)
    assert out.split == 0
    assert np.allclose(out.toarray(), np.linalg.solve(sq, rhs2))
    np.linalg.eigvalsh(bs)
    assert any(k[0] == "linalg_eigvalsh" for k in engine._CACHE)


def test_nan_reductions_of_a_chain_fold_blocks(monkeypatch):
    # a chain longer than one block: the nan reductions over the key
    # axis fold block partials, equal to the whole-tensor answer, and
    # the chain is never materialised
    x = np.random.RandomState(71).randn(37, 6, 5)

    def chain():
        return bolt.array(x, CPU).map(
            lambda v: torch.where(v > 1.2, float("nan"), v * 2.0))

    xm = np.where(x > 1.2, np.nan, x * 2.0)
    whole = {}
    for name, kw in (("nansum", {}), ("nanmean", {"axis": 0}),
                     ("nanstd", {"axis": 0}), ("nanvar", {"axis": (0, 2),
                                                          "ddof": 1}),
                     ("nanmax", {}), ("nanmin", {"axis": 0,
                                                 "keepdims": True}),
                     ("nanprod", {"axis": 0})):
        whole[name] = _val(getattr(np, name)(chain(), **kw))
    # records of 240 bytes: blocks of 4 records
    monkeypatch.setattr(garray, "_BLOCK_BYTES", 4 * 4 * 240)
    for name, kw in (("nansum", {}), ("nanmean", {"axis": 0}),
                     ("nanstd", {"axis": 0}), ("nanvar", {"axis": (0, 2),
                                                          "ddof": 1}),
                     ("nanmax", {}), ("nanmin", {"axis": 0,
                                                 "keepdims": True}),
                     ("nanprod", {"axis": 0})):
        c = chain()
        got = getattr(np, name)(c, **kw)
        assert c.deferred, name
        e = getattr(np, name)(xm, **kw)
        g = _val(got)
        assert g.shape == np.shape(e), name
        assert np.allclose(g, e, rtol=1e-10, atol=1e-12, equal_nan=True), \
            name
        assert np.allclose(g, whole[name], rtol=1e-10, atol=1e-12,
                           equal_nan=True), name
    keys = [k for k in engine._CACHE if k[0] == "nanstd"]
    assert any("blocks" in k[3] for k in keys)
    # an all-NaN column over every block: NaN, as numpy (with its warning)
    y = x.copy()
    y[:, 0, 0] = 5.0
    b = bolt.array(y, CPU).map(lambda v: torch.where(v > 4.0,
                                                     float("nan"), v))
    g = _val(np.nanmean(b, axis=0))
    assert np.isnan(g[0, 0]) and np.isfinite(g[1:, :]).all()
    g = _val(np.nanmax(b, axis=0))
    assert np.isnan(g[0, 0]) and np.isfinite(g[1:, :]).all()


def test_nan_family_integer_and_dtypes(mesh):
    # integer data holds no NaN: the plain reductions with jnp's dtypes
    xi = np.arange(48, dtype=np.int32).reshape(4, 3, 4)
    bi, ri = bolt.array(xi, CPU), ref.array(xi, mesh)
    for fn in (np.nansum, np.nanmean, np.nanvar, np.nanmax, np.nanmedian,
               np.nancumsum, np.nanargmax):
        g, w = _val(fn(bi)), _val(fn(ri))
        assert g.dtype == w.dtype, fn.__name__
        assert np.allclose(g, w) and np.allclose(g, fn(xi)), fn.__name__


# ---------------------------------------------------------------------
# np.linalg
# ---------------------------------------------------------------------

def test_linalg_multi_output_and_batch_split():
    sq, m = _spd(), _tall()
    b = bolt.array(sq, CPU)
    bm = bolt.array(m, CPU)
    sgn, ld = np.linalg.slogdet(b)
    esgn, eld = np.linalg.slogdet(sq)
    assert sgn.mode == ld.mode == "gpu"
    assert np.allclose(sgn.toarray(), esgn)
    assert np.allclose(ld.toarray(), eld)
    w, v = np.linalg.eigh(b)
    assert np.allclose(w.toarray(), np.linalg.eigh(sq)[0])
    recon = np.einsum("bij,bj,bkj->bik", np.asarray(v.toarray()),
                      np.asarray(w.toarray()), np.asarray(v.toarray()))
    assert np.allclose(recon, sq)
    u, s, vh = np.linalg.svd(bm)
    assert np.allclose(s.toarray(), np.linalg.svd(m, compute_uv=False))
    assert np.allclose(
        np.asarray(u.toarray())[:, :5] * np.asarray(s.toarray())
        @ np.asarray(vh.toarray()), m)
    q, r = np.linalg.qr(bm)
    assert np.allclose(np.asarray(q.toarray()) @ np.asarray(r.toarray()), m)
    assert np.linalg.inv(b).split == 1
    assert np.linalg.eigh(b)[0].split == 1
    rhs = np.random.RandomState(47).randn(16, 5, 2)
    assert np.allclose(np.linalg.solve(b, rhs).toarray(),
                       np.linalg.solve(sq, rhs))
    vec = np.random.RandomState(48).randn(12)
    x_, res, rank, sv = np.linalg.lstsq(bm, vec, rcond=None)
    ex, eres, erank, esv = np.linalg.lstsq(m, vec, rcond=None)
    assert np.allclose(x_.toarray(), ex) and rank == erank
    assert isinstance(rank, int)
    assert np.allclose(res.toarray(), eres)
    assert np.allclose(sv.toarray(), esv)
    b2 = bolt.array(sq, CPU, axis=(0,))
    assert np.linalg.det(b2).split == 1


def test_linalg_rejections_and_uplo():
    m = _tall()
    bm = bolt.array(m, CPU)
    with pytest.raises(np.linalg.LinAlgError, match="square"):
        np.linalg.inv(bm)
    with pytest.raises(np.linalg.LinAlgError, match="square"):
        np.linalg.det(bm)
    with pytest.raises(np.linalg.LinAlgError, match="two-dimensional"):
        np.linalg.svd(bolt.array(m[:, 0], CPU))
    with pytest.raises(ValueError, match="UPLO"):
        np.linalg.eigh(bolt.array(_spd(), CPU), UPLO="X")
    with pytest.raises(ValueError, match="mismatch"):
        np.linalg.solve(bolt.array(_spd(), CPU), np.ones((16, 4)))
    asym = np.random.RandomState(49).randn(5, 5)
    ba = bolt.array(asym, CPU)
    for uplo in ("L", "U"):
        assert np.allclose(
            np.asarray(np.linalg.eigvalsh(ba, UPLO=uplo).toarray()),
            np.linalg.eigvalsh(asym, UPLO=uplo)), uplo
        w, v = np.linalg.eigh(ba, UPLO=uplo)
        assert np.allclose(w.toarray(), np.linalg.eigh(asym, UPLO=uplo)[0])
    assert np.linalg.matrix_rank(bolt.array(np.zeros(5), CPU)) == 0
    assert np.linalg.matrix_rank(bolt.array(np.ones(5), CPU)) == 1


def test_batch4_review_edges():
    x = _x2()[:8]
    b = bolt.array(x, CPU)
    cond = np.array([True, False] * 4 + [False, False])
    assert np.allclose(np.compress(cond, b, axis=0).toarray(),
                       np.compress(cond, x, axis=0))
    with pytest.raises(IndexError, match="out of bounds"):
        np.compress(np.array([False] * 9 + [True]), b, axis=0)
    iv = bolt.array(np.arange(8), CPU)
    o_int = np.select([iv > 3], [iv], default=0)
    o_flt = np.select([iv > 3], [iv], default=0.0)
    assert np.asarray(o_int.toarray()).dtype.kind == "i"
    assert np.asarray(o_flt.toarray()).dtype.kind == "f"
    v = bolt.array(np.arange(6.0), CPU)
    assert np.allclose(np.asarray(np.convolve(v, 2.0).toarray()),
                       np.convolve(np.arange(6.0), 2.0))
    sq = _spd()
    bs = bolt.array(sq, CPU)
    r = np.linalg.slogdet(bs)
    assert np.allclose(np.asarray(r.sign.toarray()),
                       np.linalg.slogdet(sq).sign)
    e = np.linalg.eigh(bs)
    assert np.allclose(np.asarray(e.eigenvalues.toarray()),
                       np.linalg.eigh(sq).eigenvalues)
    s = np.linalg.svd(bolt.array(_tall(), CPU))
    assert hasattr(s, "S") and hasattr(s, "Vh")
    q = np.linalg.qr(bolt.array(_tall(), CPU))
    assert hasattr(q, "Q") and hasattr(q, "R")
    with pytest.raises(np.linalg.LinAlgError, match="two-dimensional"):
        np.linalg.inv(bolt.array(np.arange(4.0), CPU))


def test_tail9_linalg_details():
    rs = np.random.RandomState(47)
    A = rs.randn(6, 4, 6, 4) + 5 * np.eye(24).reshape(6, 4, 6, 4)
    bA = bolt.array(A, CPU, axis=(0,))
    got = np.linalg.tensorinv(bA, ind=2)
    assert np.allclose(np.asarray(got.toarray()),
                       np.linalg.tensorinv(A, ind=2), atol=1e-8)
    bvec = rs.randn(6, 4)
    gs = np.linalg.tensorsolve(bA, bolt.array(bvec, CPU))
    assert np.allclose(np.asarray(gs.toarray()),
                       np.linalg.tensorsolve(A, bvec), atol=1e-8)
    with pytest.raises(ValueError, match="Invalid ind"):
        np.linalg.tensorinv(bA, ind=0)
    sq = bolt.array(rs.randn(4, 4), CPU)
    with pytest.raises(NotImplementedError, match="nonsymmetric"):
        np.linalg.eig(sq)
    with pytest.raises(NotImplementedError, match="nonsymmetric"):
        np.linalg.eigvals(sq)
    with pytest.raises(np.linalg.LinAlgError):
        np.linalg.cond(bolt.array(rs.randn(5), CPU))


def test_linalg_singular_and_hermitian_answers_like_jnp(mesh):
    # a singular or non-positive matrix answers with inf/NaN as jnp does;
    # nothing raises
    s = np.zeros((3, 4, 4))
    s[:, 0, 0] = 1.0
    bs, rs = bolt.array(s, CPU), ref.array(s, mesh)
    for fn in (np.linalg.inv, np.linalg.cholesky,
               lambda a: np.linalg.solve(a, np.ones((3, 4, 1)))):
        g, w = _val(fn(bs)), _val(fn(rs))
        assert not np.isfinite(g).all()
        assert np.array_equal(np.isfinite(g), np.isfinite(w))
    neg = -np.eye(3)[None].repeat(2, 0)
    g = _val(np.linalg.cholesky(bolt.array(neg, CPU)))
    w = _val(np.linalg.cholesky(ref.array(neg, mesh)))
    assert np.isnan(g).any()
    assert np.array_equal(np.isnan(g), np.isnan(w))
    # hermitian SVD and pinv through eigh
    h = np.random.RandomState(9).randn(5, 5)
    h = h + h.T
    bh = bolt.array(h, CPU)
    u, sv, vh = np.linalg.svd(bh, hermitian=True)
    assert np.allclose(sv.toarray(), np.linalg.svd(h, compute_uv=False))
    assert np.allclose((_val(u) * _val(sv)) @ _val(vh), h)
    assert np.allclose(np.linalg.pinv(bh, hermitian=True).toarray(),
                       np.linalg.pinv(h, hermitian=True))
    for p in (None, 1, -1, 2, -2, np.inf, "fro"):
        assert np.allclose(_val(np.linalg.cond(bh, p)),
                           np.linalg.cond(h, p)), p
    assert np.allclose(_val(np.linalg.matrix_power(bh, -3)),
                       np.linalg.matrix_power(h, -3))
    assert np.allclose(_val(np.linalg.matrix_power(bh, 0)), np.eye(5))


def test_qr_modes_match_numpy(mesh):
    # Q is formed from geqrf's reflectors by batched rank-1 updates: equal
    # to numpy's (LAPACK's) Q and R, tall, wide, square, batched, complex
    rs = np.random.RandomState(21)
    for shape in ((12, 5), (5, 12), (7, 7), (16, 6, 4), (3, 4, 6)):
        for cplx in (False, True):
            x = rs.randn(*shape) + (1j * rs.randn(*shape) if cplx else 0)
            b = bolt.array(x, CPU)
            for mode in ("reduced", "complete"):
                q, r = np.linalg.qr(b, mode=mode)
                qn, rn = np.linalg.qr(x, mode=mode)
                assert q.shape == qn.shape and r.shape == rn.shape
                assert np.allclose(q.toarray(), qn, atol=1e-12), mode
                assert np.allclose(r.toarray(), rn, atol=1e-12), mode
    x = rs.randn(16, 6, 4)
    q, r = np.linalg.qr(bolt.array(x, CPU))
    qr_, rr = np.linalg.qr(ref.array(x, mesh))
    assert np.allclose(_val(q), _val(qr_)) and np.allclose(_val(r), _val(rr))
    assert q.split == qr_.split == 1


# ---------------------------------------------------------------------
# np.fft and apply_along_axis
# ---------------------------------------------------------------------

def test_dispatch_tail5_details():
    x = _x2()[:8]
    b = bolt.array(x, CPU)
    assert np.fft.fft(b, axis=2).split == 1
    assert np.apply_along_axis(lambda v: v.sum(), 2, b).split == 1
    assert np.apply_along_axis(lambda v: v.sum(), 0, b).split == 0
    assert np.fft.fft(b).mode == "gpu"
    # a func1d torch cannot trace takes the warned host path, same answer
    with pytest.warns(bolt.HostFallbackWarning):
        out = np.apply_along_axis(
            lambda v: float(np.asarray(v).sum()), 1, b)
    assert np.allclose(out, np.apply_along_axis(lambda v: v.sum(), 1, x))
    with pytest.raises(ValueError, match="ellipsis"):
        np.einsum("i...,...->i", b, bolt.array(x[0], CPU))
    assert np.einsum("i...,i...->...", b, b).split == 0
    assert np.einsum("...k,kj->...j", b, np.ones((4, 3))).split == 1


def test_batch5_review_edges():
    x = _x2()[:8]
    b = bolt.array(x, CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = np.apply_along_axis(
            lambda v, w=None: v * w[0], 1, b, w=[2.0, 3.0])
    assert np.allclose(np.asarray(out), np.apply_along_axis(
        lambda v, w=None: v * w[0], 1, x, w=[2.0, 3.0]))
    b2 = bolt.array(x[:, :, 0], CPU)
    with pytest.raises(ValueError, match="ellipsis"):
        np.einsum("i...->", b2)


def test_tail9_fftfreq():
    # a 0-d card scalar arises from a full reduction; numpy's fftfreq
    # composes it through __array_ufunc__ into a card array
    d = bolt.array(np.full(4, 0.25), CPU).mean()
    assert d.ndim == 0
    got = np.fft.fftfreq(8, d)
    assert got.mode == "gpu"
    assert np.allclose(np.asarray(got.toarray()), np.fft.fftfreq(8, 0.25))
    got = np.fft.rfftfreq(9, d)
    assert np.allclose(np.asarray(got.toarray()), np.fft.rfftfreq(9, 0.25))


def test_fft_dtypes_follow_jnp(mesh):
    # torch.fft takes no integer: int32 widens to float32 first, as jnp's
    # promotion does, so the transform is complex64; float64 complex128
    for dt, want in ((np.int32, np.complex64), (np.float32, np.complex64),
                     (np.float64, np.complex128), (np.int64, np.complex128)):
        x = (np.arange(48) % 7).astype(dt).reshape(4, 12)
        g = np.fft.rfft(bolt.array(x, CPU))
        w = np.fft.rfft(ref.array(x, mesh))
        assert g.dtype == want == _val(w).dtype, dt
        assert np.allclose(_val(g), np.fft.rfft(x), rtol=1e-5, atol=1e-4)
    back = np.fft.irfft(np.fft.rfft(bolt.array(x, CPU)), n=12)
    assert back.dtype == np.float64 and np.allclose(_val(back), x)


# ---------------------------------------------------------------------
# the tails
# ---------------------------------------------------------------------

def test_dispatch_tail4_details():
    x = _x2()[:8]
    b = bolt.array(x, CPU)
    cond = np.asarray(x[:, 0, 0]) > 0
    out = np.compress(cond, b, axis=0)
    assert out.mode == "gpu"
    assert np.allclose(out.toarray(), np.compress(cond, x, axis=0))
    dev_cond = (b[:, 0, 0] > 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out2 = np.extract(dev_cond, b)
    assert np.allclose(np.asarray(out2), np.extract(cond, x))
    with pytest.raises(ValueError, match="same length"):
        np.select([b > 0], [b, b])
    with pytest.raises(ValueError, match="one-dimensional"):
        np.vander(b)
    with pytest.raises(ValueError, match="1- or 2-d"):
        np.diag(b)
    with pytest.raises(ValueError, match="mode"):
        np.convolve(b[:, 0, 0], np.ones(3), mode="bogus")
    assert np.tril(b[:, :, 0]).split == 1
    assert np.diag(b[:, 0, 0]).split == 1
    assert np.diag(b[:, :, 0]).split == 0


def test_convolve_correlate_every_mode_and_order():
    rs = np.random.RandomState(12)
    for na, nv in ((9, 3), (3, 9), (8, 4), (4, 8), (5, 5)):
        a, v = rs.randn(na), rs.randn(nv)
        ba = bolt.array(a, CPU)
        for mode in ("full", "same", "valid"):
            assert np.allclose(_val(np.convolve(ba, v, mode)),
                               np.convolve(a, v, mode)), (na, nv, mode)
            assert np.allclose(_val(np.correlate(ba, v, mode)),
                               np.correlate(a, v, mode)), (na, nv, mode)
    z = rs.randn(6) + 1j * rs.randn(6)
    w = rs.randn(3) + 1j * rs.randn(3)
    assert np.allclose(_val(np.correlate(bolt.array(z, CPU), w, "full")),
                       np.correlate(z, w, "full"))


def test_complex_and_cleanup_parity():
    x = _x2()[:8]
    for axis in ((0,), (0, 1)):
        b = bolt.array(x, CPU, axis=axis)
        assert np.allclose(np.asarray(np.sinc(b).toarray()), np.sinc(x))
        assert np.allclose(np.asarray(np.i0(b).toarray()), np.i0(x))
        p = np.cumsum(np.abs(x), axis=2)
        bp = bolt.array(p, CPU, axis=axis)
        assert np.allclose(np.asarray(np.unwrap(bp).toarray()), np.unwrap(p))
        assert np.allclose(
            np.asarray(np.unwrap(bp, period=3.0, axis=1).toarray()),
            np.unwrap(p, period=3.0, axis=1))
        y = x.copy()
        y[0, 0, 0], y[1, 1, 1], y[2, 2, 2] = np.nan, np.inf, -np.inf
        by = bolt.array(y, CPU, axis=axis)
        assert np.allclose(np.asarray(np.nan_to_num(by).toarray()),
                           np.nan_to_num(y))
        assert np.allclose(
            np.asarray(np.nan_to_num(by, nan=-1, posinf=9).toarray()),
            np.nan_to_num(y, nan=-1, posinf=9))
        assert np.array_equal(np.asarray(np.isposinf(by).toarray()),
                              np.isposinf(y))
        assert np.array_equal(np.asarray(np.isneginf(by).toarray()),
                              np.isneginf(y))
        z = x[:, :, 0] + 1j * x[:, :, 1]
        bz = bolt.array(z, CPU, axis=axis)
        assert np.allclose(np.asarray(np.angle(bz).toarray()), np.angle(z))
        assert np.allclose(np.asarray(np.angle(bz, deg=True).toarray()),
                           np.angle(z, deg=True))
        assert np.angle(bz).split == b.split
        zz = z.copy()
        zz[0, 0] = complex(np.nan, np.inf)
        assert np.allclose(_val(np.nan_to_num(bolt.array(zz, CPU))),
                           np.nan_to_num(zz))


def test_cross_parity():
    v3 = np.random.RandomState(57).randn(16, 3)
    b3 = bolt.array(v3, CPU)
    w = np.array([1.0, 0.5, 0.25])
    assert np.allclose(np.asarray(np.cross(b3, w).toarray()),
                       np.cross(v3, w))
    assert np.cross(b3, w).split == 1
    other = np.random.RandomState(58).randn(16, 3)
    assert np.allclose(np.asarray(np.cross(b3, other).toarray()),
                       np.cross(v3, other))
    v2 = v3[:, :2]
    b2 = bolt.array(v2, CPU)
    assert np.allclose(np.asarray(np.cross(b2, v2[::-1]).toarray()),
                       np.cross(v2, v2[::-1]))


def test_tail8_split_bookkeeping():
    b = bolt.array(_xnan(), CPU)
    assert np.nancumsum(b, axis=2).split == 1
    assert np.nancumsum(b).split == 1
    assert np.nanargmax(b, axis=1).split == 1
    assert np.nanargmax(b, axis=0).split == 0
    assert np.trapezoid(b, axis=2).split == 1
    assert np.flipud(b).split == 1
    # an all-NaN slice: jnp's -1 sentinel, no sync to detect it
    y = _xnan()
    y[:, 0, 0] = np.nan
    g = _val(np.nanargmax(bolt.array(y, CPU), axis=0))
    assert g[0, 0] == -1 and (g[1:] >= 0).all()


def test_batch8_review_edges():
    v3 = np.random.RandomState(59).randn(16, 3)
    b3 = bolt.array(v3, CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = np.cross(b3, v3[::-1], axisc=0)
    assert np.allclose(out, np.cross(v3, v3[::-1], axisc=0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mixed = np.cross(bolt.array(v3[:, :2], CPU), np.ones(3))
        expect = np.cross(v3[:, :2], np.ones(3))
    assert np.allclose(np.asarray(mixed), expect)


def test_tail9_partition_invariants():
    """partition's within-partition order is unspecified, so parity is the
    INVARIANT (kth element in sorted place, partitions as sets)."""
    x = _x2()
    b = bolt.array(x, CPU)
    for kth in (0, 3, -1):
        got = np.asarray(np.partition(b, kth, axis=2).toarray())
        k = kth + 4 if kth < 0 else kth
        srt = np.sort(x, axis=2)
        assert np.allclose(got[..., k], srt[..., k])
        assert np.allclose(np.sort(got, axis=2), srt)
        assert (got[..., :k] <= got[..., k:k + 1]).all()
        assert (got[..., k + 1:] >= got[..., k:k + 1]).all()
    gf = np.asarray(np.partition(b, 10, axis=None).toarray())
    assert np.allclose(np.sort(gf), np.sort(x, axis=None))
    assert (gf[:10] <= gf[10]).all()
    g0 = np.asarray(np.partition(b, 2, axis=0).toarray())
    assert np.allclose(g0[2], np.sort(x, axis=0)[2])
    ai = np.asarray(np.argpartition(b, 3, axis=2).toarray())
    vals = np.take_along_axis(x, ai, axis=2)
    assert np.allclose(vals[..., 3], np.sort(x, axis=2)[..., 3])
    for t in (bolt.array(x), b):
        with pytest.raises(ValueError, match="out of bounds"):
            np.partition(t, 99, axis=2)


def test_tail9_put_along_axis_policy():
    b = bolt.array(_x2(), CPU)
    with pytest.raises(TypeError, match="immutable"):
        np.put_along_axis(b, np.zeros((8, 6, 1), dtype=int), 0.0, axis=2)
    host = _x2()
    idx = bolt.array(np.zeros((8, 6, 1)).astype(int), CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.put_along_axis(host, idx, 7.0, axis=2)
    assert (host[:, :, 0] == 7.0).all()


def test_tail9_validation_parity(mesh):
    x = _x2()
    lo, tp = bolt.array(x), bolt.array(x, CPU)
    for b in (lo, tp):
        with pytest.raises(ValueError):
            np.take_along_axis(b, np.zeros((8, 6), dtype=int), axis=2)
        with pytest.raises(IndexError):
            np.take_along_axis(b, np.full((8, 6, 1), 9), axis=2)
        with pytest.raises(IndexError):
            np.delete(b, 99, axis=0)
        with pytest.raises(IndexError):
            np.insert(b, 99, 0.0, axis=0)
        with pytest.raises(IndexError):
            np.insert(b, [99], 0.0, axis=0)
        with pytest.raises(ValueError):
            np.meshgrid(b[:, 0, 0], np.arange(3.0), indexing="bogus")
    k1 = np.array([3, 1, 3, 1, 2, 2, 0, 0], dtype=float)
    k2 = np.array([1, 1, 0, 0, 1, 1, 0, 0], dtype=float)
    got = np.lexsort((bolt.array(k1, CPU), bolt.array(k2, CPU)))
    assert np.array_equal(np.asarray(got.toarray()), np.lexsort((k1, k2)))
    karr = np.stack([k1, k2])
    g2 = np.lexsort(bolt.array(karr, CPU))
    assert np.array_equal(np.asarray(g2.toarray()), np.lexsort(karr))
    assert np.array_equal(_val(g2), _val(np.lexsort(ref.array(karr, mesh))))


def test_tail9_split_bookkeeping():
    x = _x2()
    b = bolt.array(x, CPU)
    assert np.take_along_axis(
        b, np.argsort(np.asarray(x), axis=2), axis=2).split == 1
    assert np.partition(b, 2, axis=2).split == 1
    assert np.delete(b, 1, axis=1).split == 1
    assert np.insert(b, 1, 0.0, axis=1).split == 1
    assert np.resize(b, (10, 6, 4)).split == 1
    assert np.linalg.multi_dot([b[:, :, 0], np.ones((6, 2))]).split == 1
    assert np.linalg.multi_dot(
        [b[:, 0, 0], np.ones((8, 6)), np.ones((6, 2))]).split == 0
    outs = np.broadcast_arrays(b, np.ones(4))
    assert isinstance(outs, tuple) and outs[0].split == 1
    grids = np.meshgrid(b[:, 0, 0], np.arange(3.0))
    assert isinstance(grids, list)


def test_take_along_axis_card_indices_and_inserts():
    x = _x2()
    b = bolt.array(x, CPU)
    # card indices: no host check; in bounds they gather like numpy
    idx = np.argsort(x, axis=2)
    got = np.take_along_axis(b, bolt.array(idx, CPU), axis=2)
    assert np.allclose(got.toarray(), np.take_along_axis(x, idx, axis=2))
    # an out-of-bounds card index reads jnp's fill value, never a fault
    bad = bolt.array(np.full((8, 6, 1), 9), CPU)
    assert np.isnan(_val(np.take_along_axis(b, bad, axis=2))).all()
    for obj, vals, axis in ((slice(1, 4), 0.5, 1), ([0, 0, 2], [[7], [8], [9]], 1),
                            (np.array([1]), np.arange(6.0)[:, None], 2),
                            (-1, np.arange(4.0), 1), (2, 3.0, None)):
        assert np.allclose(_val(np.insert(b, obj, vals, axis=axis)),
                           np.insert(x, obj, vals, axis=axis)), obj
    for obj, axis in ((slice(None, None, 2), 2), ([True, False] * 3, 1),
                      ([0, 0, 3], 1), ([], 0)):
        assert np.allclose(_val(np.delete(b, obj, axis=axis)),
                           np.delete(x, obj, axis=axis)), obj


def test_block_and_meshgrid_forms():
    rs = np.random.RandomState(4)
    a, c = rs.randn(3, 2), rs.randn(3, 3)
    ba = bolt.array(a, CPU)
    assert np.allclose(_val(np.block([[ba, c], [c, ba]])),
                       np.block([[a, c], [c, a]]))
    assert np.allclose(_val(np.block([[ba]])), np.block([[a]]))
    with pytest.raises(ValueError, match="depths"):
        np.block([ba, [c]])
    v = rs.randn(5)
    bv = bolt.array(v, CPU)
    for kw in ({"indexing": "xy"}, {"indexing": "ij"}, {"sparse": True}):
        got = np.meshgrid(bv, np.arange(3.0), np.arange(2.0), **kw)
        want = np.meshgrid(v, np.arange(3.0), np.arange(2.0), **kw)
        assert len(got) == 3
        for g, w in zip(got, want):
            assert np.allclose(_val(g), w), kw


# ---------------------------------------------------------------------
# the port's own: the table, no copies, one program
# ---------------------------------------------------------------------

def test_every_reference_table_entry_is_in_the_port_and_documented():
    """The port's table holds every function of the reference's, and each
    name appears in ``docs/API.md``'s inventory (the counterpart of
    ``test_every_table_entry_documented``)."""
    missing = sorted(f.__name__ for f in ref_npdispatch._TABLE
                     if f not in npdispatch._TABLE)
    assert not missing, missing
    assert len(npdispatch._TABLE) >= len(ref_npdispatch._TABLE) == 171
    api_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "API.md")
    with open(api_path) as f:
        api = f.read()
    undocumented = sorted({f.__name__ for f in npdispatch._TABLE
                           if f.__name__ not in api})
    assert not undocumented, undocumented


def test_dispatch_tail_stays_on_card(monkeypatch):
    # every family served with toarray/__array__ made to raise: no copy of
    # an operand to the host
    x = _x2()
    b = bolt.array(x, CPU)
    bn = bolt.array(_xnan(), CPU)
    sq = bolt.array(_spd(), CPU)
    tall = bolt.array(_tall(), CPU)
    v = bolt.array(x[:, 0, 0].copy(), CPU)

    def gathered(*args, **kwargs):
        raise AssertionError("copied to the host")

    monkeypatch.setattr(type(b), "toarray", gathered)
    monkeypatch.setattr(type(b), "__array__", gathered)
    outs = [
        np.expand_dims(b, 0), np.broadcast_to(b, (2, 8, 6, 4)),
        np.tile(b, (2, 1, 1)), np.roll(b, 3, axis=1),
        np.rot90(b, axes=(1, 2)), np.pad(b, 1), np.pad(b, 2, mode="reflect"),
        np.stack([b, b], axis=1), np.vstack([b, b]), np.hstack([b, b]),
        np.dstack([b, b]), np.column_stack([v, v]), np.append(b, b, axis=0),
        np.copy(b), np.atleast_3d(b),
        np.einsum("ijk,ijk->i", b, b),
        np.tensordot(b, np.ones((4, 2)), axes=([2], [0])),
        np.inner(b, np.ones(4)), np.outer(b, np.ones(3)),
        np.nansum(bn), np.nanmean(bn, axis=0), np.nanstd(bn, axis=0),
        np.nanmax(bn), np.nanmedian(bn, axis=0),
        np.nanquantile(bn, [0.2, 0.8], axis=0), np.nancumsum(bn, axis=1),
        np.nanargmin(bn, axis=0), np.linalg.norm(b, axis=2),
        np.average(b, axis=1, weights=np.arange(1.0, 7.0)),
        np.isin(b, [0.0]), np.digitize(b, [0.0, 1.0]),
        np.interp(b, [0.0, 1.0], [1.0, 2.0]), np.gradient(b, axis=1),
        np.linalg.inv(sq), np.linalg.det(sq), np.linalg.cholesky(sq),
        np.linalg.eigvalsh(sq), np.linalg.pinv(tall),
        np.linalg.svd(tall, compute_uv=False), np.linalg.qr(tall, mode="r"),
        np.linalg.solve(sq, np.ones((16, 5, 1))),
        np.linalg.matrix_power(sq, 2), np.linalg.matrix_rank(tall),
        np.linalg.cond(sq), np.linalg.multi_dot([tall, np.ones((5, 2))]),
        np.fft.fft(b), np.fft.rfft2(b), np.fft.irfftn(np.fft.rfftn(b)),
        np.fft.fftshift(b), np.apply_along_axis(lambda r: r * 2.0, 2, b),
        np.flipud(b), np.trapezoid(b), np.cross(b[..., :3], np.ones(3)),
        np.ediff1d(v), np.fix(b), np.angle(b), np.unwrap(b), np.sinc(b),
        np.i0(b), np.nan_to_num(bn), np.isposinf(b),
        np.tril(b[:, :, 0]), np.diag(v), np.diagflat(v), np.vander(v, 3),
        np.kron(b, np.ones((1, 2, 1))), np.select([b > 0], [b]),
        np.compress([True, False] * 4, b, axis=0),
        np.convolve(v, np.ones(3)),
        np.take_along_axis(b, np.zeros((8, 6, 1), int), axis=2),
        np.partition(b, 2, axis=2), np.argpartition(b, 2, axis=2),
        np.lexsort((v, v)), np.meshgrid(v, np.arange(3.0))[0],
        np.block([[b[:, :, 0], b[:, :, 1]]]),
        np.broadcast_arrays(b, np.ones(4))[1], np.delete(b, 1, axis=1),
        np.insert(b, 1, 0.0, axis=1), np.resize(b, (10, 6, 4)),
        np.linalg.tensorinv(bolt.array(np.eye(4).reshape(2, 2, 2, 2)
                                       + 0.0, CPU)),
    ]
    for o in outs:
        o = _first(o)
        assert getattr(o, "mode", None) == "gpu", type(o)
        o.totorch()
    w, vv = np.linalg.eigh(sq)
    u, s, vh = np.linalg.svd(tall)
    sign, logdet = np.linalg.slogdet(sq)
    xs, res, rank, sv = np.linalg.lstsq(tall, np.ones(12))
    for o in (w, vv, u, s, vh, sign, logdet, xs, res, sv):
        assert o.mode == "gpu"


def test_repeated_call_builds_no_new_program():
    x = np.random.RandomState(81).randn(9, 5, 4)
    calls = (lambda b: np.stack([b, b], axis=1),
             lambda b: np.einsum("ijk,kl->ijl", b, np.ones((4, 2))),
             lambda b: np.nanmean(b, axis=0),
             lambda b: np.fft.rfft2(b),
             lambda b: np.linalg.norm(b, axis=(1, 2)),
             lambda b: np.pad(b, 1, mode="wrap"))
    for call in calls:
        call(bolt.array(x, CPU)).totorch()
        before = engine.counters()
        call(bolt.array(x, CPU)).totorch()
        after = engine.counters()
        assert after["misses"] == before["misses"]
        assert after["hits"] >= before["hits"] + 1
        assert after["aot_compiles"] == before["aot_compiles"]
