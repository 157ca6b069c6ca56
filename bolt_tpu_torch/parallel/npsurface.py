"""numpy's function table on a mesh: the cases of the ``npsurface``
payload.

The case tables below are the reference's (``tests/test_array_function.py``:
``DEVICE_CASES``, ``TAIL_CASES``, ``TAIL2_CASES`` with ``TAIL2_CLEAN``,
``LINALG_CASES``, ``TAIL4_CASES``, ``FFT_CASES``, ``TAIL8_CASES``,
``TAIL9_CASES``, with their data), kept here because a pod's worker
imports no test module.  :func:`table_case` runs one entry at one key
layout, and each detail case (``c_<reference test>``) is ``fn(bolt, mesh)
-> dict`` written against the surface both packages share, as in
:mod:`bolt_tpu_torch.parallel.surface`.  A pod of
:mod:`bolt_tpu_torch.parallel.harness` runs them with ``bolt_tpu_torch``
on a mesh of ranks (:func:`payload_npsurface`); the tests run the same
functions with the reference package on its device mesh and hold the two
results together.  An expected error is reported as its class name and
whether its message matches the reference test's pattern.

Nothing here imports jax or the reference package.
"""

import importlib
import re
import warnings

import numpy as np

from bolt_tpu_torch.parallel.surface import arr


# ---------------------------------------------------------------------
# the reference's case tables and their data
# ---------------------------------------------------------------------

def _x():
    return np.random.RandomState(31).randn(16, 6, 4)


DEVICE_CASES = [
    ("sum", lambda a: np.sum(a)),
    ("sum-axis", lambda a: np.sum(a, axis=1)),
    ("sum-keepdims", lambda a: np.sum(a, axis=(0, 2), keepdims=True)),
    ("prod", lambda a: np.prod(a / 2)),
    ("mean", lambda a: np.mean(a)),
    ("var", lambda a: np.var(a)),
    ("var-ddof", lambda a: np.var(a, ddof=1)),
    ("std-axis", lambda a: np.std(a, axis=0)),
    ("min", lambda a: np.min(a)),
    ("amax", lambda a: np.amax(a, axis=2)),
    ("ptp", lambda a: np.ptp(a, axis=1)),
    ("all", lambda a: np.all(a > -99)),
    ("any", lambda a: np.any(a > 1, axis=0)),
    ("cumsum", lambda a: np.cumsum(a)),
    ("cumsum-axis", lambda a: np.cumsum(a, axis=1)),
    ("cumprod-axis", lambda a: np.cumprod(a, axis=2)),
    ("argmax", lambda a: np.argmax(a)),
    ("argmin-axis", lambda a: np.argmin(a, axis=1)),
    ("quantile", lambda a: np.quantile(a, 0.3)),
    ("quantile-vector", lambda a: np.quantile(a, [0.2, 0.8], axis=0)),
    ("percentile", lambda a: np.percentile(a, 75)),
    ("median", lambda a: np.median(a)),
    ("median-axis", lambda a: np.median(a, axis=1)),
    ("sort", lambda a: np.sort(a, axis=0)),
    ("sort-flat", lambda a: np.sort(a, axis=None)),
    ("argsort", lambda a: np.argsort(a, axis=2, kind="stable")),
    ("take", lambda a: np.take(a, [3, 1], axis=0)),
    ("take-flat", lambda a: np.take(a, [5, 0, 17])),
    ("repeat", lambda a: np.repeat(a, 2, axis=1)),
    ("nonzero", lambda a: np.nonzero(a > 1.5)),
    ("ravel", lambda a: np.ravel(a)),
    ("transpose", lambda a: np.transpose(a, (0, 2, 1))),
    ("squeeze", lambda a: np.squeeze(a[0:1])),
    ("swapaxes", lambda a: np.swapaxes(a, 1, 2)),
    ("count_nonzero", lambda a: np.count_nonzero(np.round(a))),
    ("count_nonzero-axis", lambda a: np.count_nonzero(np.round(a), axis=1)),
    ("diff", lambda a: np.diff(a)),
    ("diff-axis0-n2", lambda a: np.diff(a, n=2, axis=0)),
    ("diff-n0", lambda a: np.diff(a, n=0)),
    ("flip", lambda a: np.flip(a)),
    ("flip-axis", lambda a: np.flip(a, 1)),
    ("flip-neg-axis", lambda a: np.flip(a, (-1, 0))),
    ("moveaxis", lambda a: np.moveaxis(a, 1, 2)),
    ("moveaxis-neg", lambda a: np.moveaxis(a, -1, 1)),
    ("moveaxis-multi", lambda a: np.moveaxis(a, (1, 2), (2, 1))),
    ("clip", lambda a: np.clip(a, -0.5, 0.5)),
    ("round", lambda a: np.round(a, 1)),
    ("real", lambda a: np.real(a)),
    ("imag", lambda a: np.imag(a)),
    ("diagonal", lambda a: np.diagonal(a, 0, 1, 2)),
    ("trace", lambda a: np.trace(a, 0, 1, 2)),
    ("searchsorted", lambda a: np.searchsorted(a, [0.0, 0.5])),
]


def _x2():
    return np.random.RandomState(41).randn(8, 6, 4)


TAIL_CASES = [
    ("expand_dims", lambda a: np.expand_dims(a, 1)),
    ("expand_dims-multi", lambda a: np.expand_dims(a, (0, -1))),
    ("expand_dims-boundary", lambda a: np.expand_dims(a, 2)),
    ("broadcast_to-prepend", lambda a: np.broadcast_to(a, (3,) + np.shape(a))),
    ("broadcast_to-same", lambda a: np.broadcast_to(a, np.shape(a))),
    ("tile-scalar", lambda a: np.tile(a, 2)),
    ("tile-tuple", lambda a: np.tile(a, (2, 1, 3))),
    ("tile-longer", lambda a: np.tile(a, (2, 1, 1, 2))),
    ("roll-flat", lambda a: np.roll(a, 5)),
    ("roll-axis", lambda a: np.roll(a, 3, axis=0)),
    ("roll-multi", lambda a: np.roll(a, (1, -2), axis=(0, 2))),
    ("roll-neg-axis", lambda a: np.roll(a, 2, axis=-1)),
    ("rot90-values", lambda a: np.rot90(a, 1, axes=(1, 2))),
    ("rot90-k2-cross", lambda a: np.rot90(a, 2, axes=(0, 2))),
    ("rot90-k0", lambda a: np.rot90(a, 4, axes=(1, 2))),
    ("pad-scalar", lambda a: np.pad(a, 2)),
    ("pad-pairs", lambda a: np.pad(a, ((1, 2), (0, 1), (2, 0)))),
    ("pad-const", lambda a: np.pad(a, 1, constant_values=7.5)),
    ("pad-reflect", lambda a: np.pad(a, 2, mode="reflect")),
    ("pad-reflect-odd", lambda a: np.pad(a, 2, mode="reflect",
                                         reflect_type="odd")),
    ("pad-symmetric", lambda a: np.pad(a, 1, mode="symmetric")),
    ("pad-wrap", lambda a: np.pad(a, 3, mode="wrap")),
    ("pad-edge", lambda a: np.pad(a, 2, mode="edge")),
    ("stack-0", lambda a: np.stack([a, a])),
    ("stack-mid", lambda a: np.stack([a, a, a], axis=2)),
    ("stack-neg", lambda a: np.stack([a, a], axis=-1)),
    ("vstack", lambda a: np.vstack([a, a])),
    ("hstack", lambda a: np.hstack([a, a])),
    ("dstack", lambda a: np.dstack([a, a])),
    ("append-axis", lambda a: np.append(a, np.ones_like(np.asarray(a)),
                                        axis=1)),
    ("append-flat", lambda a: np.append(a, [1.0, 2.0])),
    ("einsum-explicit", lambda a: np.einsum("ijk,ijk->ij", a, a)),
    ("einsum-contract-keys", lambda a: np.einsum("ijk->k", a)),
    ("einsum-implicit", lambda a: np.einsum("ijk,kl", a,
                                            np.ones((4, 5)))),
    ("einsum-transpose-out", lambda a: np.einsum("ijk->kji", a)),
    ("tensordot-axes", lambda a: np.tensordot(
        a, np.ones((6, 4, 3)), axes=([1, 2], [0, 1]))),
    ("tensordot-int", lambda a: np.tensordot(a, np.ones((6, 4)), axes=2)),
    ("inner-vec", lambda a: np.inner(a, np.arange(4.0))),
    ("outer", lambda a: np.outer(a, np.arange(3.0))),
    ("atleast-1d", lambda a: np.atleast_1d(a)),
    ("atleast-3d", lambda a: np.atleast_3d(a)),
    ("copy", lambda a: np.copy(a)),
]


def _xnan():
    x = np.random.RandomState(43).randn(8, 6, 4)
    x.ravel()[::17] = np.nan
    return x


TAIL2_CASES = [
    ("nansum", lambda a: np.nansum(a)),
    ("nansum-axis", lambda a: np.nansum(a, axis=1)),
    ("nanmean-keepdims", lambda a: np.nanmean(a, axis=(0, 2),
                                              keepdims=True)),
    ("nanvar-ddof", lambda a: np.nanvar(a, axis=0, ddof=1)),
    ("nanstd", lambda a: np.nanstd(a)),
    ("nanmin-axis", lambda a: np.nanmin(a, axis=2)),
    ("nanmax", lambda a: np.nanmax(a)),
    ("nanprod-axis", lambda a: np.nanprod(a / 2, axis=1)),
    ("nanmedian-axis", lambda a: np.nanmedian(a, axis=0)),
    ("nanquantile", lambda a: np.nanquantile(a, 0.3)),
    ("nanquantile-vector", lambda a: np.nanquantile(a, [0.2, 0.8],
                                                    axis=0)),
]


TAIL2_CLEAN = [
    ("norm-fro-all", lambda a: np.linalg.norm(a)),
    ("norm-axis", lambda a: np.linalg.norm(a, axis=2)),
    ("norm-ord1", lambda a: np.linalg.norm(a, ord=1, axis=1)),
    ("norm-inf", lambda a: np.linalg.norm(a, ord=np.inf, axis=0)),
    ("average", lambda a: np.average(a)),
    ("average-axis", lambda a: np.average(a, axis=1)),
    ("average-weights", lambda a: np.average(
        a, axis=1, weights=np.arange(1.0, 7.0))),
    ("average-full-weights", lambda a: np.average(
        a, weights=np.abs(np.asarray(a)) + 1.0)),
    ("isin", lambda a: np.isin(np.round(a), [0.0, 1.0, -1.0])),
    ("isin-invert", lambda a: np.isin(np.round(a), [0.0], invert=True)),
    ("digitize", lambda a: np.digitize(a, np.linspace(-2, 2, 9))),
    ("digitize-right", lambda a: np.digitize(a, np.linspace(-2, 2, 9),
                                             right=True)),
    ("interp", lambda a: np.interp(a, np.linspace(-3, 3, 11),
                                   np.linspace(0.0, 1.0, 11))),
    ("gradient-axis", lambda a: np.gradient(a, axis=1)),
    ("gradient-spacing", lambda a: np.gradient(a, 0.5, axis=2)),
]


def _spd():
    g = np.random.RandomState(45).randn(16, 5, 5)
    return np.einsum("bij,bkj->bik", g, g) + np.eye(5)


def _tall():
    return np.random.RandomState(46).randn(12, 5)


LINALG_CASES = [
    ("inv", lambda a: np.linalg.inv(a), _spd),
    ("det", lambda a: np.linalg.det(a), _spd),
    ("cholesky", lambda a: np.linalg.cholesky(a), _spd),
    ("cholesky-upper", lambda a: np.linalg.cholesky(a, upper=True), _spd),
    ("eigvalsh", lambda a: np.linalg.eigvalsh(a), _spd),
    ("matrix_power", lambda a: np.linalg.matrix_power(a, 3), _spd),
    ("matrix_power-neg", lambda a: np.linalg.matrix_power(a, -1), _spd),
    ("svd-vals", lambda a: np.linalg.svd(a, compute_uv=False), _tall),
    ("qr-r", lambda a: np.abs(np.linalg.qr(a, mode="r")), _tall),
    ("matrix_rank", lambda a: np.linalg.matrix_rank(a), _tall),
    ("pinv", lambda a: np.linalg.pinv(a), _tall),
    ("norm-nuc", lambda a: np.linalg.norm(a, ord="nuc", axis=(0, 1)),
     _tall),
]


TAIL4_CASES = [
    ("tril", lambda a: np.tril(a[:, :, 0])),
    ("tril-k", lambda a: np.tril(a[:, :, 0], -1)),
    ("triu-k", lambda a: np.triu(a[:, :, 0], 2)),
    ("diag-2d", lambda a: np.diag(a[:, :, 0], 1)),
    ("diag-1d", lambda a: np.diag(a[:, 0, 0])),
    ("diagflat", lambda a: np.diagflat(a[:, :2, 0])),
    ("vander", lambda a: np.vander(a[:, 0, 0], 4)),
    ("kron", lambda a: np.kron(a, np.ones((1, 2, 2)))),
    ("select", lambda a: np.select([a > 0.5, a < -0.5], [a, -a],
                                   default=7.0)),
    ("compress", lambda a: np.compress(
        np.array([True, False] * 4), a, axis=0)),
    ("extract", lambda a: np.extract(np.asarray(a) > 0, a)),
    ("convolve", lambda a: np.convolve(a[:, 0, 0],
                                       np.array([0.5, 1.0, 0.5]))),
    ("correlate-full", lambda a: np.correlate(
        a[:, 0, 0], np.array([0.5, 1.0, 0.5]), "full")),
]


FFT_CASES = [
    ("fft", lambda a: np.fft.fft(a)),
    ("fft-n-axis", lambda a: np.fft.fft(a, n=10, axis=1)),
    ("ifft", lambda a: np.fft.ifft(a, axis=0)),
    ("rfft", lambda a: np.fft.rfft(a)),
    ("irfft-roundtrip", lambda a: np.fft.irfft(np.fft.rfft(a), n=4)),
    ("hfft", lambda a: np.fft.hfft(a)),
    ("ihfft", lambda a: np.fft.ihfft(a)),
    ("fft2", lambda a: np.fft.fft2(a)),
    ("ifft2", lambda a: np.fft.ifft2(a)),
    ("rfft2", lambda a: np.fft.rfft2(a)),
    ("fftn-axes", lambda a: np.fft.fftn(a, axes=(0, 2))),
    ("fftn-s", lambda a: np.fft.fftn(a, s=(6, 3), axes=(1, 2))),
    ("rfftn", lambda a: np.fft.rfftn(a)),
    ("irfftn-roundtrip", lambda a: np.fft.irfftn(np.fft.rfftn(a),
                                                 s=np.shape(a))),
    ("fft-ortho", lambda a: np.fft.fft(a, norm="ortho")),
    ("fft-forward", lambda a: np.fft.fft(a, norm="forward")),
    ("fftshift", lambda a: np.fft.fftshift(a)),
    ("fftshift-axis", lambda a: np.fft.fftshift(a, axes=1)),
    ("ifftshift", lambda a: np.fft.ifftshift(a, axes=(0, 2))),
    ("apply-scalar", lambda a: np.apply_along_axis(
        lambda v: v.sum(), 1, a)),
    ("apply-vector", lambda a: np.apply_along_axis(
        lambda v: v[:2] * 2.0, 2, a)),
    ("apply-matrix", lambda a: np.apply_along_axis(
        lambda v: np.outer(v[:2], v[:2]), 0, a)),
    ("einsum-ellipsis", lambda a: np.einsum("i...,i...->...", a, a)),
    ("einsum-ellipsis-keep", lambda a: np.einsum("...j->...", a)),
    ("einsum-ellipsis-implicit", lambda a: np.einsum("...ij", a)),
    ("einsum-ellipsis-mixed", lambda a: np.einsum(
        "...i,ij->...j", a, np.ones((4, 2)))),
]


TAIL8_CASES = [
    ("flipud", lambda a: np.flipud(a)),
    ("fliplr", lambda a: np.fliplr(a)),
    ("trapezoid", lambda a: np.trapezoid(a)),
    ("trapezoid-dx-axis", lambda a: np.trapezoid(a, dx=0.5, axis=1)),
    ("trapezoid-x", lambda a: np.trapezoid(a, np.linspace(0, 1, 4),
                                           axis=2)),
    ("ediff1d", lambda a: np.ediff1d(a)),
    ("ediff1d-ends", lambda a: np.ediff1d(a, to_end=[9.0],
                                          to_begin=[-1.0, -2.0])),
    ("nancumsum-flat", lambda a: np.nancumsum(a)),
    ("nancumsum-axis", lambda a: np.nancumsum(a, axis=1)),
    ("nancumprod-axis", lambda a: np.nancumprod(a, axis=2)),
    ("nanargmax-flat", lambda a: np.nanargmax(a)),
    ("nanargmax-axis", lambda a: np.nanargmax(a, axis=1)),
    ("nanargmin-axis", lambda a: np.nanargmin(a, axis=0)),
    ("fix", lambda a: np.fix(a * 3)),
]


TAIL9_CASES = [
    ("take_along_axis", lambda a: np.take_along_axis(
        a, np.argsort(np.asarray(a), axis=2), axis=2)),
    ("take_along_axis-key", lambda a: np.take_along_axis(
        a, np.zeros((1, 6, 4), dtype=int), axis=0)),
    ("take_along_axis-neg", lambda a: np.take_along_axis(
        a, np.full((8, 6, 1), -1), axis=2)),
    ("take_along_axis-flat", lambda a: np.take_along_axis(
        a, np.array([0, 17, 5]), axis=None)),
    ("lexsort-seq", lambda a: np.lexsort(
        (np.round(a[:, 0, 0]), np.round(a[:, 1, 0])))),
    ("meshgrid-ij", lambda a: np.meshgrid(
        a[:, 0, 0], np.arange(3.0), indexing="ij")[0]),
    ("meshgrid-xy", lambda a: np.meshgrid(
        a[:, 0, 0], np.arange(3.0), indexing="xy")[1]),
    ("block-flat", lambda a: np.block([a[:, 0, 0], a[:, 1, 1]])),
    ("block-2d", lambda a: np.block(
        [[a[:, :, 0], a[:, :, 1]], [a[:, :, 2], a[:, :, 3]]])),
    ("broadcast_arrays", lambda a: np.broadcast_arrays(
        a, np.ones((1, 6, 1)))[1]),
    ("broadcast_arrays-self", lambda a: np.broadcast_arrays(
        a, np.ones(4))[0]),
    ("insert-int", lambda a: np.insert(a, 2, 5.0, axis=1)),
    ("insert-flat", lambda a: np.insert(a, 3, [1.0, 2.0])),
    ("insert-arr", lambda a: np.insert(a, [1, 3], 0.0, axis=2)),
    ("delete-int", lambda a: np.delete(a, 2, axis=1)),
    ("delete-neg", lambda a: np.delete(a, -1, axis=0)),
    ("delete-slice", lambda a: np.delete(a, slice(1, 4), axis=1)),
    ("delete-arr", lambda a: np.delete(a, [0, 2], axis=2)),
    ("delete-flat", lambda a: np.delete(a, [0, 5, 7])),
    ("resize-up", lambda a: np.resize(a, (10, 6, 4))),
    ("resize-reshape", lambda a: np.resize(a, (4, 12, 4))),
    ("resize-flat", lambda a: np.resize(a, 100)),
    ("linalg-cond", lambda a: np.linalg.cond(
        a[:4, :4, 0] + 3 * np.eye(4))),
    ("linalg-cond-1", lambda a: np.linalg.cond(
        a[:4, :4, 0] + 3 * np.eye(4), p=1)),
    ("linalg-multi_dot", lambda a: np.linalg.multi_dot(
        [a[:, :, 0], np.ones((6, 5)), np.linspace(0, 1, 5)])),
]


# ---------------------------------------------------------------------
# one table entry at one key layout
# ---------------------------------------------------------------------

# table -> (cases, its key layouts, the reference test it mirrors)
TABLES = {
    "device": (DEVICE_CASES, ("keys1d",), "test_numpy_semantics_parity"),
    "tail": (TAIL_CASES, ("keys1d", "keys2d"), "test_dispatch_tail_parity"),
    "tail2": (TAIL2_CASES + TAIL2_CLEAN, ("keys1d", "keys2d"),
              "test_dispatch_tail2_parity"),
    "linalg": (LINALG_CASES, ("keys1d",), "test_linalg_parity"),
    "tail4": (TAIL4_CASES, ("keys1d", "keys2d"),
              "test_dispatch_tail4_parity"),
    "fft": (FFT_CASES, ("keys1d", "keys2d"), "test_dispatch_tail5_parity"),
    "tail8": (TAIL8_CASES, ("keys1d",), "test_dispatch_tail8_parity"),
    "tail9": (TAIL9_CASES, ("keys1d", "keys2d"),
              "test_dispatch_tail9_parity"),
}

# the entries the reference skips at two key axes (a 1-d slice of a
# 2-d-keys array has a single key axis)
_SKIP2 = {("tail4", n) for n in ("diag-1d", "vander", "convolve",
                                 "correlate-full")}


def table_ids(table, layouts=None):
    """``"table:name:layout"`` of every entry of ``table`` at the
    reference's layouts (or those of ``layouts`` among them)."""
    cases, lays, _ = TABLES[table]
    return ["%s:%s:%s" % (table, c[0], lay) for c in cases for lay in lays
            if (layouts is None or lay in layouts)
            and not (lay == "keys2d" and (table, c[0]) in _SKIP2)]


def _entry(table, name):
    return next(c for c in TABLES[table][0] if c[0] == name)


def _data(table, name):
    """The reference test's data for an entry."""
    if table == "device":
        x = _x()
        return np.sort(x.ravel()) if name == "searchsorted" else x
    if table == "tail":
        return _x2()
    if table == "tail2":
        return _xnan() if name.startswith("nan") else _x2()[:8]
    if table == "linalg":
        return _entry(table, name)[2]()
    if table == "tail8":
        x = _xnan() if "nan" in name else _x2()[:8]
        return x[:, 0, 0].copy() if name.startswith("ediff1d") else x
    if table == "tail9":
        return _x2()
    return _x2()[:8]


# a pod's worker sets this to a function that checks each bolt result's
# layout (:func:`_check_layout`)
_ON_RESULT = []


def value(v):
    """What a test reads of a call's result: a bolt array's values,
    shape, split and dtype; each member of a tuple or list; a host
    value's values."""
    if hasattr(v, "toarray") and hasattr(v, "split"):
        for hook in _ON_RESULT:
            hook(v)
        return {"v": np.asarray(v.toarray()), "shape": list(v.shape),
                "split": int(v.split), "dtype": str(np.dtype(v.dtype))}
    if isinstance(v, (tuple, list)):
        return [value(i) for i in v]
    return {"host": np.asarray(v)}


def raised(fn, pattern=None):
    """``[class name, whether the message matches pattern]`` of the
    exception ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — the error is the answer
        return [type(exc).__name__,
                pattern is None or bool(re.search(pattern, str(exc)))]
    return None


def table_case(bolt, mesh, case_id):
    """One entry ``"table:name:layout"`` on ``mesh``: the reference
    test's data as a bolt array at the layout (``keys1d``: one key axis,
    ``keys2d``: two), the call, and :func:`value` of its result (the
    error, where the reference expects one)."""
    table, name, layout = case_id.split(":")
    call = _entry(table, name)[1]
    x = _data(table, name)
    axis = (0,) if layout == "keys1d" or x.ndim < 2 else (0, 1)
    b = bolt.array(x, mesh, axis=axis)
    if (table, name, layout) == ("tail", "rot90-values", "keys2d"):
        # axes (1, 2) straddle the key/value boundary: the odd rotation
        # rejects like transpose does
        return {"raised": raised(lambda: call(b), "swap")}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {"out": value(call(b))}


# ---------------------------------------------------------------------
# the reference's detail tests of the table, one case each:
# fn(bolt, mesh) -> dict (``other``: a second mesh of the pod, where the
# reference checks the ``different meshes`` error)
# ---------------------------------------------------------------------

def dev(b):
    """Whether ``b`` is a bolt array on the device (either package)."""
    return getattr(b, "mode", None) in ("tpu", "gpu")


def _module(bolt, name):
    """The package's submodule ``name`` (either package, by name)."""
    return importlib.import_module("%s.%s" % (bolt.__name__, name))


def _port(bolt):
    return bolt.__name__ == "bolt_tpu_torch"


def programs(bolt, tag):
    """The programs the package's cache holds under ``tag``."""
    keys = _module(bolt, "engine")._CACHE if _port(bolt) else \
        _module(bolt, "tpu.array")._JIT_CACHE
    return sum(1 for k in list(keys) if k[0] == tag)


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


def c_np_sort_functional_does_not_mutate(bolt, mesh):
    x = _x()
    b = bolt.array(x, mesh)
    s = np.sort(b, axis=0)
    m = bolt.array(x, mesh).map(lambda v: v * 2)
    s2 = np.sort(m, axis=0)
    return {"b": arr(b), "s": value(s), "s2": value(s2), "m": arr(m)}


def c_concatenate_mixed_operands(bolt, mesh):
    x = _x()
    b = bolt.array(x, mesh)
    out = np.concatenate([b, bolt.array(x), x], axis=0)
    out2 = np.concatenate([x, b], axis=0)
    return {"out": value(out), "device": dev(out),
            "host": isinstance(out2, np.ndarray), "out2": out2}


def c_concatenate_axis_none_and_one_program(bolt, mesh):
    x = _x()
    b = bolt.array(x, mesh, axis=(0, 1))
    out = np.concatenate([b, b], axis=None)
    mixed = np.concatenate([b, bolt.array(x[0, 0], mesh)], axis=None)
    b1 = bolt.array(x, mesh)
    n0 = programs(bolt, "concat")
    four = np.concatenate([b1, b1, b1, b1], axis=1)
    return {"out": value(out), "mixed": value(mixed), "four": value(four),
            "programs": programs(bolt, "concat") - n0}


class _Duck:
    """A foreign duck array implementing ``__array_function__``."""

    def __array_function__(self, func, types, args, kwargs):
        return "duck-served"


def c_nep18_defers_to_unknown_duck_types(bolt, mesh):
    b = bolt.array(_x(), mesh)
    return {"served": np.concatenate([b, _Duck()]) == "duck-served"}


def c_searchsorted_rejects_float_sorter(bolt, mesh):
    x = np.sort(np.random.RandomState(13).randn(8))
    sorter = np.array([0.2, 2.9, 1.5, 0, 1, 2, 3, 4])
    return {"local": raised(lambda: bolt.array(x).searchsorted(
        0.0, sorter=sorter), "integer"),
        "mesh": raised(lambda: bolt.array(x, mesh).searchsorted(
            0.0, sorter=sorter), "integer")}


def c_unsupported_kwargs_fall_back_correctly(bolt, mesh):
    x = _x()
    b = bolt.array(x, mesh)
    out = np.zeros(())
    _quiet(lambda: np.sum(b, out=out))
    v = bolt.array(np.array([0.0, 0.0, 1.0, 2.0, 0.0]), mesh)
    st = _quiet(lambda: np.trim_zeros(v))
    return {"out": out, "dtype": _quiet(lambda: np.sum(b, dtype=np.float32)),
            "trim_host": isinstance(st, np.ndarray), "trim": st}


def _gather_knobs(bolt):
    """``(module, threshold name, reset)`` of the package's implicit
    gather warning."""
    if not _port(bolt):
        mod = _module(bolt, "tpu.npdispatch")

        def reset():
            mod._warned = [False]
        return mod, "IMPLICIT_GATHER_WARN_BYTES", reset
    mod = _module(bolt, "gpu.array")

    def reset():
        mod._gather_warned[:] = []
    return mod, "IMPLICIT_GATHER_WARN_BYTES", reset


def _warns(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fn()
    return [str(i.message) for i in w if issubclass(i.category,
                                                    UserWarning)]


def c_implicit_gather_warns_once_above_threshold(bolt, mesh):
    x = _x()
    b = bolt.array(x, mesh)
    mod, name, reset = _gather_knobs(bolt)
    old = getattr(mod, name)
    setattr(mod, name, 64)
    try:
        reset()
        first = _warns(lambda: np.asarray(b))
        second = _warns(lambda: np.asarray(b))
        reset()
        explicit = _warns(lambda: b.toarray())
    finally:
        setattr(mod, name, old)
        reset()
    return {"first": len(first) == 1 and "implicitly" in first[0],
            "second": len(second), "explicit": len(explicit),
            "value": np.asarray(b)}


def c_small_gather_is_silent(bolt, mesh):
    _, _, reset = _gather_knobs(bolt)
    reset()
    b = bolt.array(_x(), mesh)
    return {"warnings": len(_warns(lambda: np.asarray(b)))}


def c_shape_ndim_size(bolt, mesh):
    b = bolt.array(_x(), mesh)
    return {"shape": list(np.shape(b)), "ndim": np.ndim(b),
            "size": np.size(b), "size1": np.size(b, 1)}


def c_np_diff_validation(bolt, mesh):
    b = bolt.array(_x(), mesh)
    xb = _x() > 0
    gb = np.diff(bolt.array(xb, mesh), axis=0)
    return {"n": raised(lambda: np.diff(b, n=-1), "non-negative"),
            "axis": raised(lambda: np.diff(b, axis=7)),
            "prepend": _quiet(lambda: np.asarray(
                np.diff(b, axis=0, prepend=0.0))),
            "bool": value(gb)}


def c_np_flip_validation(bolt, mesh):
    b = bolt.array(_x(), mesh)
    return {"range": raised(lambda: np.flip(b, 5)),
            "dup": raised(lambda: np.flip(b, (1, -2)))}


def c_np_moveaxis_validation(bolt, mesh):
    b = bolt.array(_x(), mesh)
    return {"neg": raised(lambda: np.moveaxis(b, 0, -4)),
            "rep": raised(lambda: np.moveaxis(b, (0, 1), (0, 0))),
            "src": raised(lambda: np.moveaxis(b, 5, 0)),
            "len": raised(lambda: np.moveaxis(b, (0, 1), (0,)))}


def c_np_split(bolt, mesh):
    x = _x()
    b = bolt.array(x, mesh)
    out = {}
    for i, args in enumerate([(4,), (2, 1), (np.array([3, 9]),), ([2, -4],),
                              ([3, 1],)]):
        got = np.split(b, *args) if len(args) == 1 \
            else np.split(b, args[0], axis=args[1])
        out["split%d" % i] = value(list(got))
        out["device%d" % i] = all(dev(g) for g in got)
    out["equal"] = raised(lambda: np.split(b, 5), "equal division")
    out["array_split"] = value(list(np.array_split(b, 5)))
    out["zero"] = raised(lambda: np.split(b, 0))
    out["zero_d"] = value(list(np.split(b, np.array(4))))
    out["float"] = raised(lambda: np.split(b, [2.5]))
    return out


def c_np_where(bolt, mesh, other=None):
    x = _x()
    b = bolt.array(x, mesh)
    out = {"three": value(np.where(b > 0, b, 0.0)),
           "host_cond": value(np.where(x > 1, b, b * -1.0)),
           "scalars": value(np.where(b[0] > 0, 1.0, np.arange(4.0))),
           "one": value(np.where(bolt.array((x > 1).astype(int), mesh))),
           "neither": raised(lambda: np.where(b, 1.0), "both or neither"),
           "displaced": value(np.where(np.ones((16, 16, 6, 4), bool), b,
                                       0.0))}
    if other is not None:
        o = bolt.array(x, other)
        out["foreign"] = raised(lambda: np.where(b > 0, b, o),
                                "different meshes")
    return out


def c_np_histogram_and_bincount(bolt, mesh):
    x = _x()
    b = bolt.array(x, mesh)
    iv = bolt.array((np.abs(x[0]) * 4).astype(np.int64).ravel(), mesh)
    return {"h8": list(np.histogram(b, bins=8)),
            "h6": list(np.histogram(b, bins=6, range=(-1, 1),
                                    density=True)),
            "edges": _quiet(lambda: list(np.histogram(
                b, bins=np.linspace(-2, 2, 5)))),
            "bincount": np.bincount(iv),
            "minlength": np.bincount(iv, minlength=20),
            "two_d": raised(lambda: np.bincount(bolt.array(
                (np.abs(x) * 4).astype(np.int64), mesh))),
            "negative": raised(lambda: np.bincount(iv, minlength=-1),
                               "negative"),
            "nan": raised(lambda: np.histogram(
                b, bins=4, range=(np.nan, np.nan)), "finite"),
            "inf": raised(lambda: np.histogram(
                b, bins=4, range=(0.0, np.inf)), "finite")}


def c_np_unique_and_dot(bolt, mesh):
    x = np.floor(_x() * 2)
    b = bolt.array(x, mesh)
    w = np.random.RandomState(3).randn(4, 2)
    d = np.dot(b, w)
    return {"unique": list(np.unique(b, return_counts=True)),
            "inverse": _quiet(lambda: [np.asarray(v) for v in np.unique(
                b, return_inverse=True)]),
            "dot": value(d), "device": dev(d)}


def c_cov_corrcoef_parity(bolt, mesh, axis):
    x = np.random.RandomState(42).randn(8, 6)
    b = bolt.array(x, mesh, axis=axis)
    v = x[:, 0]
    bv = bolt.array(v, mesh)
    return {"cov": np.cov(b), "cov_cols": np.cov(b, rowvar=False),
            "bias": np.cov(b, bias=True), "ddof0": np.cov(b, ddof=0),
            "corr": np.corrcoef(b),
            "corr_cols": np.corrcoef(b, rowvar=False),
            "cov1": np.asarray(np.cov(bv)),
            "corr1": np.asarray(np.corrcoef(bv)),
            "shape1": list(np.shape(np.cov(bv)))}


def _trapped(bolt, mesh, x, fn):
    """``fn(b)`` for ``b`` the mesh array of ``x``, with its class's
    ``toarray`` and ``__array__`` made to raise: None when nothing
    gathered, else the error."""
    b = bolt.array(x, mesh)
    klass = type(b)
    saved = {n: klass.__dict__.get(n) for n in ("toarray", "__array__")}

    def gathered(self, *args, **kwargs):
        raise AssertionError("gathered!")

    klass.toarray = gathered
    klass.__array__ = gathered
    try:
        return raised(lambda: fn(b))
    finally:
        for n, f in saved.items():
            if f is None:
                delattr(klass, n)
            else:
                setattr(klass, n, f)


def c_dispatch_tail_stays_on_device(bolt, mesh):
    def calls(b):
        np.expand_dims(b, 0)
        np.broadcast_to(b, (2, 8, 6, 4))
        np.tile(b, (2, 1, 1))
        np.roll(b, 3, axis=1)
        np.rot90(b, axes=(1, 2))
        np.pad(b, 1)
        np.stack([b, b], axis=1)
        np.vstack([b, b])
        np.hstack([b, b])
        np.dstack([b, b])
        np.append(b, b, axis=0)
        np.einsum("ijk,ijk->i", b, b)
        np.tensordot(b, np.ones((4, 2)), axes=([2], [0]))
        np.inner(b, np.ones(4))
        np.outer(b, np.ones(3))
        np.copy(b)
        np.atleast_3d(b)
    return {"raised": _trapped(bolt, mesh, _x2(), calls)}


def c_device_served_no_gather(bolt, mesh):
    """np.sum, np.mean, np.sort and np.concatenate with ``toarray`` and
    ``__array__`` made to raise; the results afterwards."""
    x = _x()
    res = {}

    def calls(b):
        res["sum"] = np.sum(b).cache()
        res["mean"] = np.mean(b, axis=0).cache()
        res["sort"] = np.sort(b, axis=1)
        res["cat"] = np.concatenate([b, b], axis=2)
    out = {"raised": _trapped(bolt, mesh, x, calls)}
    out.update({k: value(v) for k, v in res.items()})
    return out


def c_dispatch_tail_deferred_chains_fuse(bolt, mesh):
    b = bolt.array(_x2(), mesh).map(lambda v: v * 2.0)
    return {"stack": value(np.stack([b, b], axis=0)),
            "roll": value(np.roll(b, 2, axis=0)), "b": arr(b)}


def c_dispatch_tail_rejections(bolt, mesh):
    x = _x2()
    b = bolt.array(x, mesh)
    rs = np.random.RandomState(1)
    c3, c2 = rs.randn(2, 3, 4), np.random.RandomState(1).randn(4, 3)
    return {
        "repeated": raised(lambda: np.expand_dims(b, (0, 0)),
                           "repeated axis"),
        "axis": raised(lambda: np.expand_dims(b, 9)),
        "bcast": raised(lambda: np.broadcast_to(b, (2, 2, 2))),
        "roll": raised(lambda: np.roll(b, 1, axis=5)),
        "rot_same": raised(lambda: np.rot90(b, axes=(1, 1)),
                           "must be different"),
        "rot_len": raised(lambda: np.rot90(b, axes=(0, 1, 2)),
                          r"len\(axes\)"),
        "rot_range": raised(lambda: np.rot90(b, axes=(0, 5)),
                            "out of range"),
        "rot_swap": raised(lambda: np.rot90(b, 1, axes=(0, 1)), "swap"),
        "rot_even": value(np.rot90(b, 2, axes=(0, 1))),
        "pad_neg": raised(lambda: np.pad(b, -1), "negative"),
        "pad_float": raised(lambda: np.pad(b, 1.5), "integral"),
        "pad_kw": raised(lambda: np.pad(b, 1, mode="edge",
                                        constant_values=3),
                         "unsupported keyword"),
        "stack_shape": raised(lambda: np.stack(
            [b, bolt.array(x[:4], mesh)]), "same shape"),
        "stack_axis": raised(lambda: np.stack([b, b], axis=7)),
        "cov_3d": raised(lambda: np.cov(bolt.array(c3, mesh)),
                         "2 dimensions"),
        "cov_ddof": raised(lambda: np.cov(bolt.array(c2, mesh), ddof=1.5),
                           "ddof")}


def c_dispatch_tail_fallbacks_stay_correct(bolt, mesh):
    x = _x2()
    b = bolt.array(x, mesh)
    out = np.einsum("i...,i...->...", b, b)
    w = np.arange(1, 7)
    return {"ellipsis": value(out), "device": dev(out),
            "mean": _quiet(lambda: np.asarray(np.pad(b, 1, mode="mean"))),
            "ramp": _quiet(lambda: np.asarray(np.pad(
                b, 1, mode="linear_ramp", end_values=2.0))),
            "fweights": _quiet(lambda: np.asarray(np.cov(
                bolt.array(x[:, :, 0], mesh), fweights=w)))}


def c_einsum_key_survival_and_mxu_policy(bolt, mesh):
    x = _x2()
    b = bolt.array(x, mesh)
    b2 = bolt.array(x, mesh, axis=(0, 1))
    return {"ijl": value(np.einsum("ijk,kl->ijl", b, np.ones((4, 3)))),
            "jk": value(np.einsum("ijk->jk", b)),
            "ij": value(np.einsum("ijk,k->ij", b2, np.arange(4.0)))}


def c_stack_family_split_bookkeeping(bolt, mesh):
    x = _x2()
    b = bolt.array(x, mesh)
    b2 = bolt.array(x, mesh, axis=(0, 1))
    return {"stack0": value(np.stack([b, b], axis=0)),
            "stack1": value(np.stack([b, b], axis=1)),
            "expand0": value(np.expand_dims(b, 0)),
            "expand1": value(np.expand_dims(b, 1)),
            "bcast": value(np.broadcast_to(b, (2,) + x.shape)),
            "tile": value(np.tile(b, (3, 1, 1, 1))),
            "stack_keys": value(np.stack([b2, b2], axis=1)),
            "roll": value(np.roll(b2, 1, axis=0))}


def c_dispatch_tail_review_edges(bolt, mesh):
    x = _x2()
    b = bolt.array(x, mesh)
    return {"roll_none": value(np.roll(b, 1, axis=())),
            "roll_empty": value(np.roll(b, (), axis=())),
            "roll_empty0": value(np.roll(b, (), axis=0)),
            "vstack": raised(lambda: np.vstack(
                [b, np.ones((3, 6, 4))[..., :3]]), "must match exactly"),
            "hstack": raised(lambda: np.hstack([b, np.ones(3)]),
                             "same number of dimensions"),
            "casting": raised(lambda: np.stack(
                [b.astype(np.float32), b], casting="no", dtype=np.float64),
                "Cannot cast")}


def c_dispatch_tail2_details(bolt, mesh):
    x = _x2()[:8]
    b = bolt.array(x, mesh)
    outs = np.gradient(b)
    w = np.arange(1.0, 7.0)
    xb = bolt.array(_xnan(), mesh)
    return {
        "gradient": value(list(outs)), "is_list": isinstance(outs, list),
        "gradient_device": all(dev(o) for o in outs),
        "returned": value(list(np.average(b, axis=0, returned=True))),
        "weighted": value(list(np.average(b, axis=1, weights=w,
                                          returned=True))),
        "nansum2": value(np.nansum(xb, axis=2)),
        "nansum0": value(np.nansum(xb, axis=0)),
        "norm2": value(np.linalg.norm(b, axis=2)),
        "weights_len": raised(lambda: np.average(
            b, axis=1, weights=np.arange(5.0)), "Length of weights"),
        "weights_zero": raised(lambda: np.average(
            b, axis=1, weights=np.zeros(6))),
        "gradient_small": raised(lambda: np.gradient(
            bolt.array(x[:1], mesh), axis=0), "at least 2 elements"),
        "interp_len": raised(lambda: np.interp(
            b, np.arange(4.0), np.arange(5.0)), "same length"),
        "interp_1d": raised(lambda: np.interp(
            b, np.ones((2, 2)), np.ones((2, 2))), "1-D"),
        "sum_nan": bool(np.isnan(float(np.asarray(np.sum(xb).toarray())))),
        "nansum_nan": bool(np.isnan(float(np.asarray(
            np.nansum(xb).toarray()))))}


def c_dispatch_tail2_split_matches_method_convention(bolt, mesh):
    x = np.random.RandomState(44).randn(8, 8, 4)
    b = bolt.array(x, mesh)
    b2 = bolt.array(x, mesh, axis=(0, 1))
    ib = bolt.array(np.arange(24).reshape(4, 6), mesh)
    bins = np.array([2.0, 1.0, -1.0, -2.0])
    return {
        "nansum0": value(np.nansum(b, axis=0)),
        "sum0": value(b.sum(axis=0)),
        "nansum1": value(np.nansum(b, axis=1)),
        "sum1": value(b.sum(axis=1)),
        "nanmean_kd": value(np.nanmean(b, axis=0, keepdims=True)),
        "mean_kd": value(b.mean(axis=0, keepdims=True)),
        "norm0": value(np.linalg.norm(b, axis=0)),
        "norm2": value(np.linalg.norm(b, axis=2)),
        "average0": value(np.average(b, axis=0)),
        "keys_nansum0": value(np.nansum(b2, axis=0)),
        "keys_nansum01": value(np.nansum(b2, axis=(0, 1))),
        "keys_nanvar2": value(np.nanvar(b2, axis=2)),
        "nanquantile": value(np.nanquantile(b, [0.2, 0.8], axis=1)),
        "quantile": value(b.quantile([0.2, 0.8], axis=1)),
        "int_nanquantile": value(np.nanquantile(ib, 0.3)),
        "int_nanmedian": value(np.nanmedian(ib)),
        "unsorted": raised(lambda: np.digitize(
            b, np.array([3.0, 1.0, 2.0])), "monotonically"),
        "decreasing": value(np.digitize(b, bins))}


def c_linalg_multi_output_and_batch_split(bolt, mesh):
    sq, m = _spd(), _tall()
    b = bolt.array(sq, mesh)
    bm = bolt.array(m, mesh)
    sgn, ld = np.linalg.slogdet(b)
    w, v = np.linalg.eigh(b)
    u, s, vh = np.linalg.svd(bm)
    q, r = np.linalg.qr(bm)
    rhs = np.random.RandomState(47).randn(16, 5, 2)
    vec = np.random.RandomState(48).randn(12)
    x_, res, rank, sv = np.linalg.lstsq(bm, vec, rcond=None)
    b2 = bolt.array(sq, mesh)
    vv, ww = np.asarray(v.toarray()), np.asarray(w.toarray())
    uu, ss = np.asarray(u.toarray()), np.asarray(s.toarray())
    return {"slogdet": value([sgn, ld]),
            "device": dev(sgn) and dev(ld),
            "eigvals": value(w),
            "recon": np.einsum("bij,bj,bkj->bik", vv, ww, vv),
            "svd_s": value(s),
            "svd_recon": uu[:, :5] * ss @ np.asarray(vh.toarray()),
            "qr_recon": np.asarray(q.toarray()) @ np.asarray(r.toarray()),
            "inv_split": np.linalg.inv(b).split,
            "eigh_split": np.linalg.eigh(b)[0].split,
            "solve": value(np.linalg.solve(b, rhs)),
            "lstsq": value([x_, res, sv]), "rank": int(rank),
            "rank_int": isinstance(rank, (int, np.integer)),
            "det_split": np.linalg.det(b2).split}


def c_linalg_rejections_and_uplo(bolt, mesh):
    m = _tall()
    bm = bolt.array(m, mesh)
    asym = np.random.RandomState(49).randn(5, 5)
    ba = bolt.array(asym, mesh)
    return {"inv": raised(lambda: np.linalg.inv(bm), "square"),
            "det": raised(lambda: np.linalg.det(bm), "square"),
            "svd": raised(lambda: np.linalg.svd(bolt.array(m[:, 0], mesh)),
                          "two-dimensional"),
            "uplo": raised(lambda: np.linalg.eigh(
                bolt.array(_spd(), mesh), UPLO="X"), "UPLO"),
            "L": value(np.linalg.eigvalsh(ba, UPLO="L")),
            "U": value(np.linalg.eigvalsh(ba, UPLO="U")),
            "rank0": int(np.linalg.matrix_rank(bolt.array(np.zeros(5),
                                                          mesh))),
            "rank1": int(np.linalg.matrix_rank(bolt.array(np.ones(5),
                                                          mesh)))}


def c_batch23_review_edges(bolt, mesh):
    x = np.random.RandomState(50).randn(8, 6, 4)
    b = bolt.array(x, mesh)
    bq = bolt.array(np.random.RandomState(54).randn(8, 5, 3), mesh)
    n0 = programs(bolt, "nanquantile")
    sweep = [value(np.nanquantile(bq, qv)) for qv in (0.1, 0.4, 0.9)]
    d = np.diag([10.0, 1.0, 0.1])
    bd = bolt.array(d, mesh)
    h = np.diag([2.0, -1.0, 1e-12])
    u = np.random.RandomState(51).randn(3, 5)
    rhs = np.random.RandomState(52).randn(3)
    _, res_g, _, _ = np.linalg.lstsq(bolt.array(u, mesh), rhs, rcond=None)
    bs = bolt.array(_spd(), mesh)
    rhs2 = np.random.RandomState(53).randn(2, 16, 5, 5)
    e0 = programs(bolt, "linalg_eigvalsh")
    eig = value(np.linalg.eigvalsh(bs))
    return {
        "nanvar": value(np.nanvar(b, 0, None, None, 1)),
        "nanstd": value(np.nanstd(b, 1, None, None, 1)),
        "digitize": value(np.digitize(b, np.array([1.0, 1.0, 2.0]))),
        "period": raised(lambda: np.interp(b, np.arange(4.0),
                                           np.arange(4.0), period=0),
                         "non-zero"),
        "sweep": sweep,
        "sweep_programs": programs(bolt, "nanquantile") - n0,
        "rtol": value(np.linalg.matrix_rank(bd, rtol=0.05)),
        "tol": value(np.linalg.matrix_rank(bd, tol=0.05)),
        "hermitian": value(np.linalg.matrix_rank(bolt.array(h, mesh),
                                                 hermitian=True)),
        "residuals": value(res_g),
        "solve": value(np.linalg.solve(bs, rhs2)),
        "eigvalsh": eig,
        "eigvalsh_program": programs(bolt, "linalg_eigvalsh") - e0 >= 0
        and programs(bolt, "linalg_eigvalsh") > 0}


def c_dispatch_tail4_details(bolt, mesh):
    x = _x2()[:8]
    b = bolt.array(x, mesh)
    cond = np.asarray(x[:, 0, 0]) > 0
    out = np.compress(cond, b, axis=0)
    dev_cond = (b[:, 0, 0] > 0)
    return {"compress": value(out), "device": dev(out),
            "extract": _quiet(lambda: np.asarray(np.extract(dev_cond, b))),
            "select": raised(lambda: np.select([b > 0], [b, b]),
                             "same length"),
            "vander": raised(lambda: np.vander(b), "one-dimensional"),
            "diag": raised(lambda: np.diag(b), "1- or 2-d"),
            "mode": raised(lambda: np.convolve(b[:, 0, 0], np.ones(3),
                                               mode="bogus"), "mode"),
            "tril": value(np.tril(b[:, :, 0])),
            "diag1": value(np.diag(b[:, 0, 0])),
            "diag2": value(np.diag(b[:, :, 0]))}


def c_batch4_review_edges(bolt, mesh):
    x = _x2()[:8]
    b = bolt.array(x, mesh)
    cond = np.array([True, False] * 4 + [False, False])
    iv = bolt.array(np.arange(8), mesh)
    v = bolt.array(np.arange(6.0), mesh)
    sq = _spd()
    bs = bolt.array(sq, mesh)
    r = np.linalg.slogdet(bs)
    e = np.linalg.eigh(bs)
    s = np.linalg.svd(bolt.array(_tall(), mesh))
    q = np.linalg.qr(bolt.array(_tall(), mesh))
    return {"compress": value(np.compress(cond, b, axis=0)),
            "bounds": raised(lambda: np.compress(
                np.array([False] * 9 + [True]), b, axis=0), "out of bounds"),
            "select_int": value(np.select([iv > 3], [iv], default=0)),
            "select_float": value(np.select([iv > 3], [iv], default=0.0)),
            "convolve": value(np.convolve(v, 2.0)),
            "sign": value(r.sign), "eigenvalues": value(e.eigenvalues),
            "svd_attrs": hasattr(s, "S") and hasattr(s, "Vh"),
            "qr_attrs": hasattr(q, "Q") and hasattr(q, "R"),
            "inv_1d": raised(lambda: np.linalg.inv(bolt.array(
                np.arange(4.0), mesh)), "two-dimensional")}


def c_dispatch_tail5_details(bolt, mesh):
    x = _x2()[:8]
    b = bolt.array(x, mesh)
    out = _quiet(lambda: np.apply_along_axis(
        lambda v: float(np.asarray(v).sum()), 1, b))
    return {"fft2": value(np.fft.fft(b, axis=2)),
            "apply2": value(np.apply_along_axis(lambda v: v.sum(), 2, b)),
            "apply0": value(np.apply_along_axis(lambda v: v.sum(), 0, b)),
            "device": dev(np.fft.fft(b)),
            "host_func": np.asarray(out),
            "ellipsis": raised(lambda: np.einsum(
                "i...,...->i", b, bolt.array(x[0], mesh)), "ellipsis"),
            "ell_split": value(np.einsum("i...,i...->...", b, b)),
            "ell_keys": value(np.einsum("...k,kj->...j", b,
                                        np.ones((4, 3))))}


def c_batch5_review_edges(bolt, mesh):
    x = _x2()[:8]
    b = bolt.array(x, mesh)
    out = _quiet(lambda: np.apply_along_axis(
        lambda v, w=None: v * w[0], 1, b, w=[2.0, 3.0]))
    b2 = bolt.array(x[:, :, 0], mesh)
    return {"unhashable": np.asarray(out),
            "empty_out": raised(lambda: np.einsum("i...->", b2),
                                "ellipsis")}


def c_set_operations_parity(bolt, mesh):
    rs = np.random.RandomState(55)
    a = rs.randint(0, 20, 64).astype(float)
    c = rs.randint(10, 30, 48).astype(float)
    ba, bc = bolt.array(a, mesh), bolt.array(c, mesh)
    r = _quiet(lambda: np.intersect1d(ba, bc, return_indices=True))
    return {"intersect": np.intersect1d(ba, bc),
            "intersect_host": np.intersect1d(ba, c),
            "union": np.union1d(ba, bc), "diff": np.setdiff1d(ba, bc),
            "xor": np.setxor1d(ba, bc),
            "indices": [np.asarray(i) for i in r]}


def c_complex_and_cleanup_parity(bolt, mesh):
    x = _x2()[:8]
    out = {}
    for tag, axis in (("keys1d", (0,)), ("keys2d", (0, 1))):
        b = bolt.array(x, mesh, axis=axis)
        p = np.cumsum(np.abs(x), axis=2)
        bp = bolt.array(p, mesh, axis=axis)
        y = x.copy()
        y[0, 0, 0], y[1, 1, 1], y[2, 2, 2] = np.nan, np.inf, -np.inf
        by = bolt.array(y, mesh, axis=axis)
        z = x[:, :, 0] + 1j * x[:, :, 1]
        bz = bolt.array(z, mesh, axis=axis)
        out[tag] = {
            "sinc": value(np.sinc(b)), "i0": value(np.i0(b)),
            "unwrap": value(np.unwrap(bp)),
            "unwrap_axis": value(np.unwrap(bp, period=3.0, axis=1)),
            "nan_to_num": value(np.nan_to_num(by)),
            "nan_to_num_args": value(np.nan_to_num(by, nan=-1, posinf=9)),
            "isposinf": value(np.isposinf(by)),
            "isneginf": value(np.isneginf(by)),
            "angle": value(np.angle(bz)),
            "angle_deg": value(np.angle(bz, deg=True)),
            "split": np.angle(bz).split == b.split}
    return out


def c_histogram2d_dd_parity(bolt, mesh):
    rs = np.random.RandomState(56)
    x, y = rs.randn(512), rs.randn(512)
    bx, by = bolt.array(x, mesh), bolt.array(y, mesh)
    s = rs.randn(256, 3)
    bs = bolt.array(s, mesh)
    h, ex, ey = np.histogram2d(bx, by, bins=8)
    hd, edges = np.histogramdd(bs, bins=4)
    return {"h": h, "h_dtype": str(h.dtype), "ex": ex, "ey": ey,
            "density": np.histogram2d(bx, by, bins=[4, 6],
                                      range=[[-2, 2], [-3, 3]],
                                      density=True)[0],
            "none_range": _quiet(lambda: np.histogram2d(
                bx, by, bins=6, range=[[0, 1], None])[0]),
            "hd": hd, "hd_dtype": str(hd.dtype), "edges": list(edges),
            "hd_density": np.histogramdd(bs, bins=(3, 4, 5),
                                         density=True)[0],
            "edge_arrays": _quiet(lambda: np.histogram2d(
                bx, by, bins=[np.linspace(-2, 2, 5),
                              np.linspace(-2, 2, 4)])[0])}


def c_cross_parity(bolt, mesh):
    v3 = np.random.RandomState(57).randn(16, 3)
    b3 = bolt.array(v3, mesh)
    w = np.array([1.0, 0.5, 0.25])
    other = np.random.RandomState(58).randn(16, 3)
    v2 = v3[:, :2]
    return {"w": value(np.cross(b3, w)), "other": value(np.cross(b3, other)),
            "two": value(np.cross(bolt.array(v2, mesh), v2[::-1]))}


def c_tail8_split_bookkeeping(bolt, mesh):
    b = bolt.array(_xnan(), mesh)
    return {"nancumsum2": value(np.nancumsum(b, axis=2)),
            "nancumsum": value(np.nancumsum(b)),
            "nanargmax1": value(np.nanargmax(b, axis=1)),
            "nanargmax0": value(np.nanargmax(b, axis=0)),
            "trapezoid": value(np.trapezoid(b, axis=2)),
            "flipud": value(np.flipud(b))}


def c_batch8_review_edges(bolt, mesh):
    v3 = np.random.RandomState(59).randn(16, 3)
    b3 = bolt.array(v3, mesh)
    return {"axisc": _quiet(lambda: np.asarray(np.cross(b3, v3[::-1],
                                                        axisc=0))),
            "mixed": _quiet(lambda: np.asarray(np.cross(
                bolt.array(v3[:, :2], mesh), np.ones(3))))}


def c_tail9_partition_invariants(bolt, mesh):
    x = _x2()
    b = bolt.array(x, mesh)
    out = {}
    for kth in (0, 3, -1):
        got = np.asarray(np.partition(b, kth, axis=2).toarray())
        k = kth + 4 if kth < 0 else kth
        srt = np.sort(x, axis=2)
        out["kth%d" % kth] = [
            bool(np.allclose(got[..., k], srt[..., k])),
            bool(np.allclose(np.sort(got, axis=2), srt)),
            bool((got[..., :k] <= got[..., k:k + 1]).all()),
            bool((got[..., k + 1:] >= got[..., k:k + 1]).all())]
    gf = np.asarray(np.partition(b, 10, axis=None).toarray())
    g0 = np.asarray(np.partition(b, 2, axis=0).toarray())
    ai = np.asarray(np.argpartition(b, 3, axis=2).toarray())
    vals = np.take_along_axis(x, ai, axis=2)
    out.update({
        "flat": [bool(np.allclose(np.sort(gf), np.sort(x, axis=None))),
                 bool((gf[:10] <= gf[10]).all())],
        "key": bool(np.allclose(g0[2], np.sort(x, axis=0)[2])),
        "arg": bool(np.allclose(vals[..., 3], np.sort(x, axis=2)[..., 3])),
        "local_bounds": raised(lambda: np.partition(bolt.array(x), 99,
                                                    axis=2), "out of bounds"),
        "mesh_bounds": raised(lambda: np.partition(b, 99, axis=2),
                              "out of bounds")})
    return out


def c_tail9_linalg_details(bolt, mesh):
    rs = np.random.RandomState(47)
    A = rs.randn(6, 4, 6, 4) + 5 * np.eye(24).reshape(6, 4, 6, 4)
    bA = bolt.array(A, mesh, axis=(0,))
    bvec = rs.randn(6, 4)
    sq = bolt.array(rs.randn(4, 4), mesh)
    return {"tensorinv": value(np.linalg.tensorinv(bA, ind=2)),
            "tensorsolve": value(np.linalg.tensorsolve(
                bA, bolt.array(bvec, mesh))),
            "ind": raised(lambda: np.linalg.tensorinv(bA, ind=0),
                          "Invalid ind"),
            "eig": raised(lambda: np.linalg.eig(sq), "nonsymmetric"),
            "eigvals": raised(lambda: np.linalg.eigvals(sq), "nonsymmetric"),
            "cond": raised(lambda: np.linalg.cond(bolt.array(rs.randn(5),
                                                             mesh)))}


def c_tail9_fftfreq(bolt, mesh):
    d = bolt.array(np.full(4, 0.25), mesh).mean()
    return {"ndim": d.ndim, "fftfreq": value(np.fft.fftfreq(8, d)),
            "rfftfreq": value(np.fft.rfftfreq(9, d))}


def c_tail9_put_along_axis_policy(bolt, mesh):
    b = bolt.array(_x2(), mesh)
    host = _x2()
    idx = bolt.array(np.zeros((8, 6, 1)).astype(int), mesh)
    _quiet(lambda: np.put_along_axis(host, idx, 7.0, axis=2))
    return {"immutable": raised(lambda: np.put_along_axis(
        b, np.zeros((8, 6, 1), dtype=int), 0.0, axis=2), "immutable"),
        "host": host}


def c_tail9_validation_parity(bolt, mesh):
    x = _x2()
    out = {}
    for tag, b in (("local", bolt.array(x)), ("mesh", bolt.array(x, mesh))):
        out[tag] = [
            raised(lambda: np.take_along_axis(
                b, np.zeros((8, 6), dtype=int), axis=2)),
            raised(lambda: np.take_along_axis(b, np.full((8, 6, 1), 9),
                                              axis=2)),
            raised(lambda: np.delete(b, 99, axis=0)),
            raised(lambda: np.insert(b, 99, 0.0, axis=0)),
            raised(lambda: np.insert(b, [99], 0.0, axis=0)),
            raised(lambda: np.meshgrid(b[:, 0, 0], np.arange(3.0),
                                       indexing="bogus"))]
    k1 = np.array([3, 1, 3, 1, 2, 2, 0, 0], dtype=float)
    k2 = np.array([1, 1, 0, 0, 1, 1, 0, 0], dtype=float)
    out["lexsort"] = value(np.lexsort((bolt.array(k1, mesh),
                                       bolt.array(k2, mesh))))
    out["lexsort_rows"] = value(np.lexsort(bolt.array(np.stack([k1, k2]),
                                                      mesh)))
    return out


def c_tail9_split_bookkeeping(bolt, mesh):
    x = _x2()
    b = bolt.array(x, mesh)
    outs = np.broadcast_arrays(b, np.ones(4))
    grids = np.meshgrid(b[:, 0, 0], np.arange(3.0))
    return {"take_along": value(np.take_along_axis(
        b, np.argsort(np.asarray(x), axis=2), axis=2)),
        "partition": value(np.partition(b, 2, axis=2)),
        "delete": value(np.delete(b, 1, axis=1)),
        "insert": value(np.insert(b, 1, 0.0, axis=1)),
        "resize": value(np.resize(b, (10, 6, 4))),
        "multi_dot": value(np.linalg.multi_dot([b[:, :, 0],
                                                np.ones((6, 2))])),
        "multi_dot_1d": value(np.linalg.multi_dot(
            [b[:, 0, 0], np.ones((8, 6)), np.ones((6, 2))])),
        "broadcast": value(outs[0]), "is_tuple": isinstance(outs, tuple),
        "grids_list": isinstance(grids, list)}


def c_advice_r4_edges(bolt, mesh):
    rs = np.random.RandomState(61)
    b16 = bolt.array(rs.randn(16), mesh)
    b8 = bolt.array(rs.randn(8), mesh)
    x2 = rs.randn(4, 4)
    h, ex, ey = np.histogram2d(b16, bolt.array(rs.randn(16), mesh))
    hd, edges = np.histogramdd(bolt.array(rs.randn(16, 3), mesh))
    second = rs.randn(2, 2)
    return {"length": raised(lambda: np.histogram2d(b16, b8), "same length"),
            "two_d": raised(lambda: np.histogram2d(
                bolt.array(x2, mesh), bolt.array(x2, mesh))),
            "edges": [str(ex.dtype), str(ey.dtype)] +
            [str(e.dtype) for e in edges],
            "h": h, "hd": hd,
            "hstack": raised(lambda: np.hstack([b16, second])),
            "hstack_host": raised(lambda: np.hstack([np.asarray(b16),
                                                     second]))}


def c_map_with_keys(bolt, mesh):
    """``map(..., with_keys=True)``: each record's key tuple, at one and
    two key axes, and a host-predicate ``filter``'s survivors in key
    order, and ``stats(accumulate=)`` of integer-valued data (each
    exact in bf16)."""
    x = _x2()
    out = {}
    for tag, axis in (("keys1d", (0,)), ("keys2d", (0, 1))):
        b = bolt.array(x, mesh, axis=axis)
        k = b.map(lambda kv: kv[1] * 0 + sum(
            (i + 1) * 10 ** j for j, i in enumerate(kv[0])),
            axis=axis, with_keys=True)
        out[tag] = {"keys": value(k), "sum": value(k.sum())}
    return out


def c_host_predicate_filter(bolt, mesh):
    """A filter whose predicate vmap cannot batch (it reads a record on
    the host): survivors in key order, their sum and layout."""
    x = _x2()
    out = {}
    for tag, axis in (("keys1d", (0,)), ("keys2d", (0, 1))):
        b = bolt.array(x, mesh, axis=axis)
        f = _quiet(lambda: b.filter(
            lambda v: float(np.asarray(v).mean()) > 0, axis=axis))
        out[tag] = {"filtered": value(f), "sum": value(f.sum()),
                    "none": value(_quiet(lambda: b.filter(
                        lambda v: float(np.asarray(v).max()) > 99,
                        axis=axis)))}
    return out


def c_stats_accumulate(bolt, mesh):
    """``stats(..., accumulate=)`` of integer-valued f32 data (exact in
    bf16, so the fold's order changes nothing)."""
    x = np.floor(_x2() * 4).astype(np.float32)
    out = {}
    for tag, axis in (("keys1d", (0,)), ("keys2d", (0, 1))):
        b = bolt.array(x, mesh, axis=axis)
        for mode in ("bf16", "f32"):
            g = b.stats("sum", "mean", "var", "max", accumulate=mode)
            out["%s_%s" % (tag, mode)] = {k: value(v) for k, v in g.items()}
    xi = np.floor(_x2() * 4).astype(np.int32)
    gi = bolt.array(xi, mesh).stats("sum", "max", accumulate="int8")
    out["int8"] = {k: value(v) for k, v in gi.items()}
    return out


CASES = {name[2:]: fn for name, fn in sorted(globals().items())
         if name.startswith("c_") and callable(fn)
         and name != "c_cov_corrcoef_parity"}
# the cases that take the pod's second mesh (``other``)
OTHER = ("np_where",)
# the cases whose reference test runs at both key layouts
LAYOUTS = {"cov_corrcoef_parity_keys1d": (0,),
           "cov_corrcoef_parity_keys2d": (0, 1)}


# ---------------------------------------------------------------------
# the payload
# ---------------------------------------------------------------------

def _check_layout(faults, where):
    """A hook of :func:`value`: a mesh result not laid out by ``key_spec``
    of its shape and split (the reference's constraint) is recorded in
    ``faults``."""
    def hook(v):
        from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
        from bolt_tpu_torch.parallel import sharding
        if not isinstance(v, BoltArrayMesh):
            faults.append([where[0], "not a mesh array: %s" % type(v)])
            return
        want = sharding.key_spec(v.mesh, v.shape, v.split)
        if tuple(v._spec) != tuple(want):
            faults.append([where[0], "spec %s, key_spec %s"
                           % (v._spec, want)])
    return hook


def payload_npsurface(rank, args, inputs):
    """For each entry of ``args["meshes"]`` (``{"label", "mesh", "names",
    "tables", "cases"}``), build the mesh and run its table entries
    (:func:`table_case`) and detail cases (:data:`CASES`); the result
    holds each one's value under the label, and ``layout_faults``: every
    bolt result not laid out by ``key_spec`` of its shape and split."""
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch.parallel.mesh import make_mesh
    out = {"rank": rank}
    for run in args["meshes"]:
        mesh = make_mesh(tuple(run["mesh"]), tuple(run["names"]))
        res = out[run["label"]] = {"layout_faults": []}
        where = [None]
        _ON_RESULT[:] = [_check_layout(res["layout_faults"], where)]
        try:
            for cid in run.get("tables", ()):
                where[0] = cid
                res[cid] = table_case(bolt, mesh, cid)
            other = make_mesh(tuple(run["other"]["mesh"]),
                              tuple(run["other"]["names"])) \
                if "other" in run else None
            for name in run.get("cases", ()):
                where[0] = name
                res[name] = run_case(bolt, mesh, name, other)
        finally:
            _ON_RESULT[:] = []
    return out



def run_case(bolt, mesh, name, other=None):
    """The detail case ``name`` on ``mesh`` (``other``: a second mesh,
    for the cases of :data:`OTHER`)."""
    if name in LAYOUTS:
        return c_cov_corrcoef_parity(bolt, mesh, LAYOUTS[name])
    if name in OTHER:
        return CASES[name](bolt, mesh, other)
    return CASES[name](bolt, mesh)
