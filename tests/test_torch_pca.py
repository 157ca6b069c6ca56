"""The port's ``pca``, ``cov``, ``corrcoef`` and the Gram-route helpers on
bolt arrays against the reference's.

The assertions of ``tests/test_ops_pca.py`` and of the ``cov``/
``corrcoef`` cases of ``tests/test_stats_extras.py`` on
``bolt_tpu_torch`` (``context=torch.device("cpu")``), with the same
seeded inputs fed to ``bolt_tpu`` (8-device CPU mesh, x64): the same
oracle (numpy f64 SVD / ``np.cov``) at the reference test's tolerance,
and the reference's own results to the tolerance stated beside them.
``test_quantile_cov_2d_mesh`` has no single-device counterpart
(``ROADMAP.md`` A12).  The blocked Gram pass is driven by
``ops/linalg.py :: _GRAM_BLOCK_BYTES`` made small.
"""

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu.ops import corrcoef as ref_corrcoef, cov as ref_cov, \
    pca as ref_pca
from bolt_tpu_torch import engine
from bolt_tpu_torch.ops import (corrcoef, cov, linalg, lstsq, pca, svdvals,
                                tallskinny_pca)

CPU = torch.device("cpu")


def _oracle(x2d, k, center=False):
    x = x2d.astype(np.float64)
    if center:
        x = x - x.mean(axis=0, keepdims=True)
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    return (u[:, :k] * s[:k], vt[:k].T, s[:k])


def _assert_matches(scores, comps, svals, want, atol=1e-4):
    w_scores, w_comps, w_svals = want
    assert np.allclose(svals, w_svals, rtol=1e-5, atol=atol)
    got = np.asarray(scores.toarray() if hasattr(scores, "toarray")
                     else scores).reshape(w_scores.shape)
    for i in range(comps.shape[1]):
        # eigenvector signs are arbitrary, but scores and components flip
        # together
        sign = np.sign(np.dot(comps[:, i], w_comps[:, i])) or 1.0
        assert np.allclose(sign * comps[:, i], w_comps[:, i], atol=1e-5)
        assert np.allclose(sign * got[:, i], w_scores[:, i], atol=atol)


def _same_as_reference(port, theirs, rtol=1e-8, atol=1e-9):
    """Singular values of the two packages agree (components up to sign)."""
    assert np.allclose(port[2], theirs[2], rtol=rtol, atol=atol)


def test_pca_matches_numpy_oracle(mesh):
    x = np.random.RandomState(0).randn(64, 12)
    b = bolt.array(x, CPU, axis=(0,))
    scores, comps, svals = pca(b, k=4)
    assert scores.mode == "gpu" and scores.shape == (64, 4)
    assert scores.split == 1
    _assert_matches(scores, comps, svals, _oracle(x, 4))
    _same_as_reference((scores, comps, svals),
                       ref_pca(ref.array(x, mesh, axis=(0,)), k=4))


def test_pca_centering(mesh):
    x = np.random.RandomState(1).randn(48, 6) + 5.0
    b = bolt.array(x, CPU, axis=(0,))
    scores, comps, svals = pca(b, k=3, center=True)
    _assert_matches(scores, comps, svals, _oracle(x, 3, center=True))
    _, _, sv_raw = pca(b, k=1)
    assert not np.allclose(sv_raw, svals[:1], rtol=1e-2)
    _same_as_reference((scores, comps, svals),
                       ref_pca(ref.array(x, mesh, axis=(0,)), k=3,
                               center=True))


def test_pca_multi_key_axes_keep_shape(mesh2d):
    x = np.random.RandomState(2).randn(8, 6, 5)
    b = bolt.array(x, CPU, axis=(0, 1))
    scores, comps, svals = pca(b, k=2)
    assert scores.shape == (8, 6, 2) and scores.split == 2
    _assert_matches(scores, comps, svals, _oracle(x.reshape(48, 5), 2))
    _same_as_reference((scores, comps, svals),
                       ref_pca(ref.array(x, mesh2d, axis=(0, 1)), k=2))


def test_pca_local_oracle_mode():
    x = np.random.RandomState(3).randn(32, 7)
    scores, comps, svals = pca(bolt.array(x), k=3)
    assert scores.mode == "local" and scores.shape == (32, 3)
    _assert_matches(scores, comps, svals, _oracle(x, 3))
    theirs = ref_pca(ref.array(x), k=3)
    assert np.array_equal(svals, theirs[2])


def test_pca_value_axes_flatten(mesh):
    x = np.random.RandomState(4).randn(40, 4, 3)
    scores, comps, svals = pca(bolt.array(x, CPU, axis=(0,)), k=5)
    assert scores.shape == (40, 5)
    _assert_matches(scores, comps, svals, _oracle(x.reshape(40, 12), 5))


def test_pca_default_k_and_errors():
    rs = np.random.RandomState(5)
    b = bolt.array(rs.randn(16, 4), CPU, axis=(0,))
    _, comps, svals = pca(b)
    assert comps.shape == (4, 4) and svals.shape == (4,)
    with pytest.raises(ValueError):
        pca(bolt.array(rs.randn(3, 8), CPU, axis=(0,)))     # n < d
    with pytest.raises(ValueError):
        pca(b, k=9)
    with pytest.raises(TypeError):
        pca(rs.randn(16, 4))                                # not a bolt array


def test_pca_local_complex_conjugates():
    rs = np.random.RandomState(7)
    x = rs.randn(64, 5) + 1j * rs.randn(64, 5)
    _, _, svals = pca(bolt.array(x), k=5)
    assert np.allclose(svals, np.linalg.svd(x, compute_uv=False), rtol=1e-8)
    # the card path conjugates its Gram the same way
    _, _, sv_gpu = pca(bolt.array(x, CPU), k=5)
    assert np.allclose(sv_gpu, np.linalg.svd(x, compute_uv=False), rtol=1e-8)


def test_pca_integer_input_widens(mesh):
    counts = np.random.RandomState(8).poisson(20.0, size=(40, 6)).astype(
        np.int64)
    want = _oracle(counts.astype(np.float64), 2)
    for b in (bolt.array(counts), bolt.array(counts, CPU, axis=(0,))):
        scores, comps, svals = pca(b, k=2)
        assert np.issubdtype(comps.dtype, np.floating)
        assert np.abs(comps).max() > 0.1
        _assert_matches(scores, comps, svals, want)
    _same_as_reference(pca(bolt.array(counts, CPU), k=2),
                       ref_pca(ref.array(counts, mesh, axis=(0,)), k=2))


def test_pca_axis_parameter_matches_across_backends():
    x = np.random.RandomState(9).randn(6, 48, 5)
    want = _oracle(np.moveaxis(x, 1, 0).reshape(48, 6 * 5), 3)
    st, ct, vt = pca(bolt.array(x, CPU, axis=(0,)), k=3, axis=(1,))
    assert st.shape == (48, 3)
    _assert_matches(st, ct, vt, want)
    sl, cl, vl = pca(bolt.array(x), k=3, axis=(1,))
    assert sl.shape == (48, 3)
    _assert_matches(sl, cl, vl, want)


def test_pca_program_cache_hits():
    # the same shape, dtype, device and k reuse the engine's program
    b = bolt.array(np.random.RandomState(10).randn(32, 4), CPU, axis=(0,))
    pca(b, k=2)
    n_after_first = len(engine._CACHE)
    pca(b, k=2)
    assert len(engine._CACHE) == n_after_first
    assert any(k[0] == "ops-pca" for k in engine._CACHE)


def test_pca_composes_with_map_chain(mesh):
    x = np.random.RandomState(6).randn(32, 6)
    b = bolt.array(x, CPU, axis=(0,)).map(lambda v: v * 2.0)
    assert b.deferred
    scores, comps, svals = pca(b, k=2)
    assert b.deferred
    _assert_matches(scores, comps, svals, _oracle(x * 2.0, 2))


@pytest.mark.parametrize("center", [False, True])
def test_pca_blocked_gram_matches_whole(monkeypatch, center):
    # a chain longer than one block: the Gram, the mean and the scores
    # accumulate over blocks (here 7 records each, a ragged tail) and give
    # the one-block answer
    x = np.random.RandomState(19).randn(40, 3, 2) + 1.5
    b = bolt.array(x, CPU, axis=(0,)).map(lambda v: v * 2.0 + 1.0)
    whole = pca(b, k=3, center=center, return_mean=True)
    c_whole = cov(b)
    monkeypatch.setattr(linalg, "_GRAM_BLOCK_BYTES", 7 * 6 * 8)
    blocked = pca(b, k=3, center=center, return_mean=True)
    assert np.allclose(blocked[2], whole[2], rtol=1e-12)
    assert np.allclose(blocked[3], whole[3], rtol=1e-12)
    assert np.allclose(np.abs(blocked[0].toarray()),
                       np.abs(whole[0].toarray()), rtol=1e-10, atol=1e-12)
    assert np.allclose(cov(b), c_whole, rtol=1e-12, atol=1e-14)
    _assert_matches(blocked[0], blocked[1], blocked[2],
                    _oracle((x * 2.0 + 1.0).reshape(40, 6), 3, center))


def test_pca_fetch_false_stays_on_device():
    x = np.random.RandomState(20).randn(32, 5)
    out = pca(bolt.array(x, CPU), k=2, center=True, return_mean=True,
              fetch=False)
    assert all(isinstance(t, torch.Tensor) for t in out[1:])
    host = pca(bolt.array(x, CPU), k=2, center=True, return_mean=True)
    for t, h in zip(out[1:], host[1:]):
        assert np.array_equal(t.numpy(), h)


def test_tallskinny_and_svdvals_integer_widen():
    counts = np.random.RandomState(11).poisson(20.0, size=(40, 6)).astype(
        np.int32)
    comps, svals = tallskinny_pca(torch.from_numpy(counts), k=2)
    assert comps.dtype.is_floating_point
    assert np.abs(comps.numpy()).max() > 0.1
    expect = np.linalg.svd(counts.astype(np.float64), compute_uv=False)
    assert np.allclose(svals.numpy(), expect[:2], rtol=1e-6)
    sv = svdvals(torch.from_numpy(counts))
    assert sv.dtype.is_floating_point
    assert np.allclose(sv.numpy(), expect, rtol=1e-6)


def test_lstsq_on_gpu_arrays(mesh):
    from bolt_tpu.ops import lstsq as ref_lstsq
    rs = np.random.RandomState(16)
    a = rs.randn(64, 5)
    xtrue = rs.randn(5, 2)
    y = a @ xtrue + 0.01 * rs.randn(64, 2)
    ba = bolt.array(a, CPU, axis=(0,))
    x = lstsq(ba, bolt.array(y, CPU, axis=(0,))).numpy()
    assert np.allclose(x, np.linalg.lstsq(a, y, rcond=None)[0], atol=1e-9)
    theirs = np.asarray(ref_lstsq(ref.array(a, mesh, axis=(0,)),
                                  ref.array(y, mesh, axis=(0,))))
    assert np.allclose(x, theirs, atol=1e-9)
    xv = lstsq(ba, bolt.array(y[:, 0], CPU, axis=(0,))).numpy()
    assert xv.shape == (5,)
    assert np.allclose(xv, np.linalg.lstsq(a, y[:, 0], rcond=None)[0],
                       atol=1e-9)
    a3 = rs.randn(8, 8, 5)
    y3 = a3.reshape(64, 5) @ xtrue[:, 0]
    x3 = lstsq(bolt.array(a3, CPU, axis=(0, 1)), y3).numpy()
    assert np.allclose(x3, xtrue[:, 0], atol=1e-6)


def test_lstsq_local_bolt_arrays_match_gpu():
    rs = np.random.RandomState(17)
    a3 = rs.randn(8, 8, 5)
    y = a3.reshape(64, 5) @ rs.randn(5)
    xt = lstsq(bolt.array(a3, CPU, axis=(0, 1)), y).numpy()
    xl = lstsq(bolt.array(a3.reshape(64, 5)), bolt.array(y)).numpy()
    assert xt.shape == xl.shape == (5,)
    assert np.allclose(xt, xl, atol=1e-9)


def test_pca_return_mean_projects_new_data():
    rs = np.random.RandomState(18)
    x = rs.randn(48, 6) + 3.0
    b = bolt.array(x, CPU, axis=(0,))
    scores, comps, svals, mu = pca(b, k=2, center=True, return_mean=True)
    assert np.allclose(mu, x.mean(axis=0), atol=1e-9)
    proj = (rs.randn(5, 6) + 3.0 - mu) @ comps
    assert np.allclose((x - mu) @ comps, scores.toarray(), atol=1e-8)
    assert proj.shape == (5, 2)
    _, _, _, mu0 = pca(b, k=2, return_mean=True)
    assert np.allclose(mu0, 0.0)
    _, _, _, mul = pca(bolt.array(x), k=2, center=True, return_mean=True)
    assert np.allclose(mul, mu, atol=1e-9)


def test_pca_centering_fold_large_offset(mesh):
    # the fold G - n mu mu^T cancels when ||mu|| >> sigma: ~eps_f32 *
    # (mu/sigma)^2 relative at 200 sigma, the reference's pinned point
    x = (np.random.RandomState(7).randn(96, 5) + 200.0).astype(np.float32)
    scores, comps, svals = pca(bolt.array(x, CPU, axis=(0,)), k=2,
                               center=True)
    w_scores, w_comps, w_svals = _oracle(x, 2, center=True)
    assert np.allclose(svals, w_svals, atol=5e-2)
    got = scores.toarray()
    for i in range(2):
        sign = np.sign(np.dot(comps[:, i], w_comps[:, i])) or 1.0
        assert np.allclose(sign * comps[:, i], w_comps[:, i], atol=0.1)
        assert np.allclose(sign * got[:, i], w_scores[:, i], atol=0.2)
    theirs = ref_pca(ref.array(x, mesh, axis=(0,)), k=2, center=True)
    assert np.allclose(svals, theirs[2], atol=5e-2)


def test_cov_centering_fold_large_offset(mesh):
    x = (np.random.RandomState(8).randn(80, 4) + 200.0).astype(np.float32)
    c = cov(bolt.array(x, CPU, axis=(0,)))
    want = np.cov(x.astype(np.float64), rowvar=False)
    assert np.allclose(c, want, atol=3e-2)
    assert np.allclose(c, ref_cov(ref.array(x, mesh, axis=(0,))), atol=3e-2)


def test_pca_complex_centered(mesh):
    rs = np.random.RandomState(9)
    x = (rs.randn(64, 5) + 1j * rs.randn(64, 5)
         + (2.0 - 1.0j)).astype(np.complex64)
    scores, comps, svals = pca(bolt.array(x, CPU, axis=(0,)), k=3,
                               center=True)
    xc = x.astype(np.complex128)
    xc = xc - xc.mean(axis=0)
    assert np.allclose(svals, np.linalg.svd(xc, compute_uv=False)[:3],
                       rtol=1e-3, atol=1e-3)
    assert np.allclose(scores.toarray(), xc @ comps, rtol=1e-3, atol=1e-3)
    theirs = ref_pca(ref.array(x, mesh, axis=(0,)), k=3, center=True)
    assert np.allclose(svals, theirs[2], rtol=1e-3, atol=1e-3)


def test_cov_complex_centered(mesh):
    rs = np.random.RandomState(10)
    x = (rs.randn(48, 4) + 1j * rs.randn(48, 4)
         + (1.0 + 2.0j)).astype(np.complex64)
    c = cov(bolt.array(x, CPU, axis=(0,)))
    xd = x.astype(np.complex128)
    xc = xd - xd.mean(axis=0)
    want = (xc.T @ np.conj(xc)) / (len(xd) - 1)
    assert np.allclose(c, want, rtol=1e-4, atol=1e-4)
    assert np.allclose(c, ref_cov(ref.array(x, mesh, axis=(0,))),
                       rtol=1e-4, atol=1e-4)


def test_cov_fold_diagonal_never_negative():
    # tiny variance on a huge offset: the fold's cancellation exceeds the
    # true variance in f32; the clamp keeps the diagonal non-negative
    x = (np.random.RandomState(11).randn(64, 3) * 1e-3 + 30.0).astype(
        np.float32)
    b = bolt.array(x, CPU, axis=(0,))
    c = cov(b)
    assert (np.diag(c) >= 0).all()
    assert corrcoef(b).shape == (3, 3)


def _x(shape, seed=70):
    return np.random.RandomState(seed).randn(*shape)


def test_cov_parity(mesh):
    x = _x((32, 6))
    want = np.cov(x, rowvar=False)
    t = cov(bolt.array(x, CPU, axis=(0,)))
    loc = cov(bolt.array(x))
    assert np.allclose(t, want, rtol=1e-6)
    assert np.allclose(loc, want, rtol=1e-6)
    assert np.allclose(t, ref_cov(ref.array(x, mesh, axis=(0,))),
                       rtol=1e-12, atol=1e-14)
    y = _x((8, 4, 3))
    assert np.allclose(cov(bolt.array(y, CPU, axis=(0,))),
                       np.cov(y.reshape(8, 12), rowvar=False), rtol=1e-6)
    t0 = cov(bolt.array(x, CPU), center=False, ddof=0)
    assert np.allclose(t0, x.T @ x / 32, rtol=1e-6)
    c, mu = cov(bolt.array(x, CPU).map(lambda v: v + 1), return_mean=True)
    assert np.allclose(mu, x.mean(axis=0) + 1, rtol=1e-6)
    assert np.allclose(c, want, rtol=1e-6)
    with pytest.raises(ValueError):
        cov(bolt.array(_x((1, 4))), ddof=1)
    with pytest.raises(ValueError):
        cov(bolt.array(_x((1, 4)), CPU), ddof=1)
    with pytest.raises(TypeError):
        cov(np.ones((4, 4)))


def test_cov_complex(mesh):
    rs = np.random.RandomState(13)
    xc = rs.randn(32, 4) + 1j * rs.randn(32, 4)
    want = np.cov(xc, rowvar=False)
    assert np.allclose(cov(bolt.array(xc)), want, rtol=1e-6)
    assert np.allclose(cov(bolt.array(xc, CPU)), want, rtol=1e-6)
    assert np.allclose(cov(bolt.array(xc, CPU)),
                       ref_cov(ref.array(xc, mesh)), rtol=1e-12)


def test_corrcoef_parity(mesh):
    x = _x((24, 5))
    want = np.corrcoef(x, rowvar=False)
    assert np.allclose(corrcoef(bolt.array(x, CPU)), want, rtol=1e-6)
    assert np.allclose(corrcoef(bolt.array(x)), want, rtol=1e-6)
    assert np.allclose(np.diag(corrcoef(bolt.array(x, CPU))), np.ones(5),
                       rtol=1e-6)
    assert np.allclose(corrcoef(bolt.array(x, CPU)),
                       ref_corrcoef(ref.array(x, mesh)), rtol=1e-12)
