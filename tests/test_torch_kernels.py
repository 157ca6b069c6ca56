"""The port's moment kernels against the reference's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the
tensors lie on the CPU); the reference's kernels run in interpret mode,
as ``test_ops_kernels.py`` runs them.  Inputs come from a seeded numpy
generator and go through both.  Tolerances:

* f64: ``rtol=1e-10`` — the summation order differs;
* f32: mean ``rtol=1e-5``, m2 ``rtol=1e-4, atol=1e-4`` as in
  ``test_ops_kernels.py``; sums ``rtol=1e-4`` as in its ``fused_stats``
  tests;
* bf16: results are bf16, so two bf16 steps (``rtol=atol=1.6e-2``);
* min/max and integer sums: exact.

The ``gpu``-marked tests hold the CUDA kernels against the plain versions
on the card and skip where there is none.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bolt_tpu.ops.kernels import fused_stats as ref_stats
from bolt_tpu.ops.kernels import fused_welford as ref_welford
from bolt_tpu_torch.ops import kernels as K

_TOL = {"float64": dict(rtol=1e-10, atol=0),
        "float32": dict(rtol=1e-4, atol=1e-4),
        "bfloat16": dict(rtol=1.6e-2, atol=1.6e-2)}


def _inputs(shape, dtype, seed=1, nan_col=False):
    x = np.random.RandomState(seed).randn(*shape)
    if nan_col:
        x.reshape(shape[0], -1)[:, 3] = np.nan
    if dtype == "bfloat16":
        return (jnp.asarray(x, dtype=jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    x = x.astype(dtype)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(v):
    """A reference or port result as a float64 numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(v, dtype=jnp.float64))


def _check_moments(got, want, dtype):
    mu, m2, mn, mx = (_np(v) for v in got)
    rmu, rm2, rmn, rmx = (_np(v) for v in want)
    tol = _TOL[dtype]
    mtol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else tol
    np.testing.assert_allclose(mu, rmu, equal_nan=True, **mtol)
    np.testing.assert_allclose(m2, rm2, equal_nan=True, **tol)
    np.testing.assert_array_equal(mn, rmn)
    np.testing.assert_array_equal(mx, rmx)


# shapes of test_ops_kernels.py::test_fused_welford_direct, where the
# reference kernel engages
@pytest.mark.parametrize("shape", [(64, 256), (128, 4, 128), (96, 8, 2, 128)])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_fused_welford_matches_reference(shape, dtype):
    xj, xt = _inputs(shape, dtype)
    want = ref_welford(xj)
    assert want is not None
    got = K.fused_welford(xt)
    assert all(v.dtype == xt.dtype and tuple(v.shape) == shape[1:]
               for v in got)
    _check_moments(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_fused_welford_nan_column(dtype):
    xj, xt = _inputs((64, 256), dtype, nan_col=True)
    got = K.fused_welford(xt)
    _check_moments(got, ref_welford(xj), dtype)
    assert all(np.isnan(_np(v)[3]) for v in got)


@pytest.mark.parametrize("shape", [(64, 100), (3, 5, 7), (37, 6)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_welford_where_reference_declines(shape, dtype):
    # the reference returns None off its TPU tiling plan; the port's
    # kernel takes any shape, so it is held to numpy
    xj, xt = _inputs(shape, dtype, seed=2)
    assert ref_welford(xj) is None
    x = xt.numpy()
    mu = x.mean(axis=0)
    want = (mu, ((x - mu) ** 2).sum(axis=0), x.min(axis=0), x.max(axis=0))
    _check_moments(K.fused_welford(xt), want, dtype)


@pytest.mark.parametrize("x", [
    torch.zeros((64, 128), dtype=torch.int32),   # not floating
    torch.zeros(128),                            # 1-d
    torch.zeros((1, 128)),                       # one row
], ids=["int32", "1d", "one_row"])
def test_fused_welford_none_contract(x):
    assert K.fused_welford(x) is None
    assert ref_welford(jnp.asarray(x.numpy())) is None


@pytest.mark.parametrize("shape", [(16, 128), (32, 256), (5, 7)])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_fused_stats_matches_reference(shape, dtype):
    xj, xt = _inputs(shape, dtype, seed=3)
    got = [_np(v) for v in K.fused_stats(xt)]
    want = [_np(v) for v in ref_stats(xj)]
    assert all(v.dtype == xt.dtype and v.dim() == 0
               for v in K.fused_stats(xt))
    tol = dict(_TOL[dtype])
    if dtype == "float32":
        tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[:2], want[:2], **tol)
    assert got[2:] == want[2:]


def test_fused_stats_nan():
    xj, xt = _inputs((16, 128), "float32", nan_col=True)
    got = [_np(v) for v in K.fused_stats(xt)]
    want = [_np(v) for v in ref_stats(xj)]
    assert all(np.isnan(got)) and all(np.isnan(want))


def test_fused_stats_integers():
    # integer inputs are computed outside the kernel, as the reference does
    x = np.arange(16 * 128, dtype=np.int32).reshape(16, 128)
    got = K.fused_stats(torch.from_numpy(x))
    want = ref_stats(jnp.asarray(x))
    for g, w in zip(got, want):
        assert g.item() == int(w)
        assert K._sum_dtype(torch.int32) == torch.int64


def test_fused_stats_empty_raises():
    with pytest.raises(ValueError):
        K.fused_stats(torch.zeros((0, 4)))


def test_wrappers_refuse_other_devices():
    # only a CPU tensor takes the plain version; any other non-CUDA
    # device is refused, never computed on the host
    x = torch.empty((8, 16), device="meta")
    with pytest.raises(ValueError):
        K.fused_welford(x)
    with pytest.raises(ValueError):
        K.fused_stats(x)


@pytest.mark.parametrize("n,columns,vec,chunks", [
    (3200, 819200, 4, 2),       # north-star stats(): two row chunks
    (64, 256, 4, 4),            # narrow: rows split down to 16-row chunks
    (20, 256, 4, 1),            # too few rows to split
    (3, 35, 1, 1),
])
def test_welford_row_plan(n, columns, vec, chunks):
    rpc, got = K.welford_rows(n, columns, vec, sm_count=132)
    assert got == chunks
    assert (got - 1) * rpc < n <= got * rpc


def test_launch_counters_reset():
    K.LAUNCHES["fused_welford"] = 5
    K.reset_launches()
    assert K.LAUNCHES == {"fused_welford": 0, "fused_stats": 0}


# ---------------------------------------------------------------------------
# on the card: kernel against its plain version
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((64, 256), torch.float32), ((3, 5, 7), torch.float32),
    ((1000, 333), torch.float32), ((257, 64, 64), torch.float64),
    ((128, 4096), torch.bfloat16), ((200, 1000), torch.float16)])
def test_kernels_match_plain_on_card(shape, dtype):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    x.reshape(shape[0], -1)[:, 1] = float("nan")
    tol = {torch.float64: 1e-10, torch.float32: 1e-4}.get(dtype, 1.6e-2)
    before = dict(K.LAUNCHES)
    for got, want in ((K.fused_welford(x), K._fused_welford_plain(x)),
                      (K.fused_stats(x), K._fused_stats_plain(x))):
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_.double(), w_.double(), rtol=tol,
                                       atol=tol, equal_nan=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_welford"] == before["fused_welford"] + 1
    assert K.LAUNCHES["fused_stats"] == before["fused_stats"] + 1


@pytest.mark.gpu
def test_kernels_take_non_contiguous_on_card():
    dev = _cuda()
    x = torch.randn((64, 96), device=dev).t()     # a transposed view
    for got, want in ((K.fused_welford(x), K._fused_welford_plain(x)),
                      (K.fused_stats(x), K._fused_stats_plain(x))):
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the build: one compiler process per source, raise on failure
# ---------------------------------------------------------------------------

def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(0o755)
    return str(path)


def test_build_raises_on_compiler_failure(tmp_path, monkeypatch):
    from bolt_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(
        tmp_path, "echo 'moments.cu(1): error: simulated' ; exit 2"))
    with pytest.raises(RuntimeError, match="simulated"):
        _build.build()
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "out"))


def test_build_writes_a_library_per_source_once(tmp_path, monkeypatch):
    from bolt_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    # the fake compiler writes its -o argument and counts its runs
    script = ('while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"; '
              'echo run >> %s' % (tmp_path / "runs"))
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path, script))
    built = _build.build()
    assert sorted(built) == _build.sources() == ["moments.cu"]
    assert all(os.path.exists(p) and "-" in os.path.basename(p)
               for p in built.values())
    assert _build.build() == built          # present: not rebuilt
    assert (tmp_path / "runs").read_text().count("run") == 1
