"""The port's batched Jacobi eigensolver, CholeskyQR2, thin SVD and
least squares against the reference's.

The assertions of ``tests/test_ops_linalg.py`` and of
``tests/test_property.py::test_jacobi_eigh_matches_numpy`` on
``bolt_tpu_torch.ops`` (CPU tensors), with the same seeded inputs fed to
``bolt_tpu.ops`` (CPU, x64): each port result meets the reference test's
own tolerance against numpy f64, and agrees with the reference's result
to the tolerance stated beside it.  ``jax.jit``/``jax.vmap``/``jax.grad``
become ``torch.func.vmap`` and autograd.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch.func import vmap

import jax.numpy as jnp

import bolt_tpu.ops as ref
from bolt_tpu_torch import ops
from bolt_tpu_torch.ops import linalg
from tests.generic import HYPOTHESIS_SETTINGS as SETTINGS


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(t):
    return t.detach().numpy()


def _gram(rs, b, n):
    x = rs.randn(b, 4 * n, n)
    return np.einsum("bni,bnj->bij", x, x)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 16, 17, 33, 64])
def test_matches_numpy_across_sizes(n):
    rs = np.random.RandomState(n)
    g = _gram(rs, 6, n)
    want = np.linalg.eigvalsh(g)
    got = _n(ops.jacobi_eigh(_t(g)))
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert np.max(np.abs(got - want) / scale) < 5e-11
    # and the reference's own answer, to the same relative bound
    theirs = np.asarray(ref.jacobi_eigh(jnp.asarray(g)))
    assert np.max(np.abs(got - theirs) / scale) < 5e-11


def test_float32_precision_and_dtype():
    rs = np.random.RandomState(0)
    g = _gram(rs, 8, 16).astype(np.float32)
    got = ops.jacobi_eigh(_t(g))
    assert got.dtype == torch.float32
    want = np.linalg.eigvalsh(g.astype(np.float64))
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert np.max(np.abs(_n(got) - want) / scale) < 1e-5
    theirs = np.asarray(ref.jacobi_eigh(jnp.asarray(g)))
    assert np.max(np.abs(_n(got) - theirs) / scale) < 2e-5


def test_indefinite_and_degenerate_spectra():
    rs = np.random.RandomState(1)
    a = rs.randn(4, 12, 12)
    a = (a + np.swapaxes(a, -1, -2)) / 2
    got = _n(ops.jacobi_eigh(_t(a)))
    assert np.allclose(got, np.linalg.eigvalsh(a), atol=1e-10)
    assert np.allclose(got, np.asarray(ref.jacobi_eigh(jnp.asarray(a))),
                       atol=1e-10)
    # repeated eigenvalues: identity and zero matrices are fixed points
    assert np.allclose(_n(ops.jacobi_eigh(torch.eye(7, dtype=torch.float64))),
                       np.ones(7))
    assert np.allclose(_n(ops.jacobi_eigh(torch.zeros((3, 9, 9),
                                                      dtype=torch.float64))),
                       0.0)
    # diagonal input returns the sorted diagonal
    d = np.diag([3.0, -1.0, 2.0, 0.0, 5.0])
    assert np.allclose(_n(ops.jacobi_eigh(_t(d))), np.sort(np.diag(d)))


def test_eigenvectors():
    rs = np.random.RandomState(2)
    for n in (2, 3, 8, 17):
        a = rs.randn(5, n, n)
        a = (a + np.swapaxes(a, -1, -2)) / 2
        w, v = (_n(t) for t in ops.jacobi_eigh(_t(a), vectors=True))
        eye = np.broadcast_to(np.eye(n), (5, n, n))
        assert np.allclose(np.swapaxes(v, -1, -2) @ v, eye, atol=1e-10)
        assert np.allclose(a @ v, v * w[..., None, :], atol=1e-9)
        assert np.allclose(w, np.linalg.eigvalsh(a), atol=1e-10)
        rw, _ = ref.jacobi_eigh(jnp.asarray(a), vectors=True)
        assert np.allclose(w, np.asarray(rw), atol=1e-10)


@pytest.mark.parametrize("n", [5, 6])  # odd n: the padded-dummy path
def test_extreme_scales_no_overflow(n):
    rs = np.random.RandomState(3)
    base = _gram(rs, 2, n)
    for scale in (1e-30, 1e30):
        got = _n(ops.jacobi_eigh(_t(base * scale)))
        assert np.all(np.isfinite(got))
        assert np.allclose(got, np.linalg.eigvalsh(base * scale), rtol=1e-9)
    got32 = _n(ops.jacobi_eigh(_t((base[0] * 1e30).astype(np.float32))))
    assert np.all(np.isfinite(got32))
    assert np.allclose(got32, np.linalg.eigvalsh(base[0] * 1e30), rtol=1e-4)
    theirs = np.asarray(ref.jacobi_eigh(jnp.asarray(
        (base[0] * 1e30).astype(np.float32))))
    assert np.allclose(got32, theirs, rtol=1e-4)


def test_integer_input_promotes():
    a = torch.tensor([[2, 1], [1, 2]], dtype=torch.int32)
    got = ops.jacobi_eigh(a)
    assert got.dtype.is_floating_point
    assert np.allclose(_n(got), [1.0, 3.0])
    assert np.allclose(_n(got), np.asarray(ref.jacobi_eigh(
        jnp.asarray([[2, 1], [1, 2]], jnp.int32))))


def test_complex_falls_back():
    rs = np.random.RandomState(4)
    x = rs.randn(6, 4) + 1j * rs.randn(6, 4)
    h = x.conj().T @ x
    got = _n(ops.jacobi_eigh(_t(h)))
    assert np.allclose(got, np.linalg.eigvalsh(h), rtol=1e-9)
    w, v = (_n(t) for t in ops.jacobi_eigh(_t(h), vectors=True))
    assert np.allclose(v @ np.diag(w) @ v.conj().T, h, atol=1e-9)


def test_bad_shape_rejected():
    with pytest.raises(ValueError):
        ops.jacobi_eigh(torch.zeros((3, 4)))
    with pytest.raises(ValueError):
        ops.jacobi_eigh(torch.zeros((5,)))


def test_vmap_composes():
    # the reference's jit-and-vmap composition: under torch.func.vmap the
    # eigensolver batches (one and two levels) to the same answer
    rs = np.random.RandomState(5)
    g = _gram(rs, 4, 8)
    want = np.linalg.eigvalsh(g)
    assert np.allclose(_n(vmap(ops.jacobi_eigh)(_t(g))), want, atol=1e-10)
    got2 = _n(vmap(vmap(ops.jacobi_eigh))(_t(g.reshape(2, 2, 8, 8))))
    assert np.allclose(got2.reshape(4, 8), want, atol=1e-10)


def test_tsqr_matches_qr():
    rs = np.random.RandomState(6)
    for shape in [(64, 8), (3, 100, 12), (40, 1)]:
        x = rs.randn(*shape)
        q, r = (_n(t) for t in ops.tsqr(_t(x)))
        d = shape[-1]
        eye = np.broadcast_to(np.eye(d), r.shape)
        assert np.allclose(np.swapaxes(q, -1, -2) @ q, eye, atol=1e-12)
        assert np.allclose(q @ r, x, atol=1e-12)
        assert np.allclose(np.tril(r, -1), 0.0, atol=1e-12)
        assert np.all(np.diagonal(r, axis1=-2, axis2=-1) > 0)
        # positive-diagonal QR is unique: the reference's factors agree
        rq, rr = ref.tsqr(jnp.asarray(x))
        assert np.allclose(q, np.asarray(rq), atol=1e-10)
        assert np.allclose(r, np.asarray(rr), atol=1e-10)


def test_tsqr_f32_and_int_and_errors():
    rs = np.random.RandomState(7)
    x = rs.randn(256, 6).astype(np.float32)
    q, r = ops.tsqr(_t(x))
    assert q.dtype == torch.float32
    assert np.allclose(_n(q) @ _n(r), x, atol=1e-4)
    qi, _ = ops.tsqr(_t((x * 10).astype(np.int32)))
    assert qi.dtype.is_floating_point
    with pytest.raises(ValueError):
        ops.tsqr(torch.zeros((4, 8)))


def test_tallskinny_svd_matches_numpy():
    rs = np.random.RandomState(8)
    for shape in [(128, 10), (4, 96, 6)]:
        x = rs.randn(*shape)
        u, s, vh = (_n(t) for t in ops.tallskinny_svd(_t(x)))
        d = shape[-1]
        assert np.allclose(u * s[..., None, :] @ vh, x, atol=1e-9)
        eye = np.broadcast_to(np.eye(d), s.shape[:-1] + (d, d))
        assert np.allclose(np.swapaxes(u, -1, -2) @ u, eye, atol=1e-8)
        assert np.allclose(s, np.linalg.svd(x, compute_uv=False), rtol=1e-9)
        _, rs_, _ = ref.tallskinny_svd(jnp.asarray(x))
        assert np.allclose(s, np.asarray(rs_), rtol=1e-9)
    x = rs.randn(64, 8)
    u, s, vh = ops.tallskinny_svd(_t(x), k=3)
    assert tuple(u.shape) == (64, 3) and tuple(s.shape) == (3,) \
        and tuple(vh.shape) == (3, 8)
    assert np.allclose(_n(s), np.linalg.svd(x, compute_uv=False)[:3],
                       rtol=1e-9)


def test_tallskinny_svd_rank_deficient_and_errors():
    rs = np.random.RandomState(9)
    col = rs.randn(40, 1)
    x = col @ rs.randn(1, 5)
    u, s, vh = (_n(t) for t in ops.tallskinny_svd(_t(x)))
    assert np.all(np.isfinite(u)) and np.all(np.isfinite(s))
    assert np.allclose(s[1:], 0.0, atol=1e-6 * s[0])
    assert np.allclose(u * s[None, :] @ vh, x, atol=1e-8 * abs(x).max())
    with pytest.raises(ValueError):
        ops.tallskinny_svd(torch.zeros((4, 8)))


def test_component_count_validated_across_family():
    x = _t(np.random.RandomState(10).randn(20, 5))
    for bad in (-1, 0, 99):
        with pytest.raises(ValueError):
            ops.tallskinny_svd(x, k=bad)
        with pytest.raises(ValueError):
            ops.tallskinny_pca(x, k=bad)


def test_jacobi_routing_branches():
    # big batches and vmapped contexts take Jacobi; single small matrices
    # and d > 64 take the library (the reference's pinned constants)
    assert linalg._JACOBI_MAX_DIM == 64 and linalg._JACOBI_MIN_WORK == 2048
    assert not linalg._use_jacobi(torch.eye(8))            # 8 < 2048
    assert linalg._use_jacobi(torch.zeros((512, 8, 8)))    # 512*8 >= 2048
    assert not linalg._use_jacobi(torch.zeros((4, 128, 128)))
    rs = np.random.RandomState(12)
    x = rs.randn(32, 1024, 16).astype(np.float32)
    want = np.stack([np.linalg.svd(m.astype(np.float64), compute_uv=False)
                     for m in x])
    got = _n(vmap(ops.svdvals)(_t(x)))                     # config 5b route
    assert np.allclose(got, want, rtol=1e-3, atol=1e-2)
    got2 = _n(ops.svdvals(_t(x)))                          # eager batch
    assert np.allclose(got2, want, rtol=1e-3, atol=1e-2)
    import jax
    theirs = np.asarray(jax.jit(jax.vmap(ref.svdvals))(jnp.asarray(x)))
    assert np.allclose(got, theirs, rtol=1e-4, atol=1e-4)


def test_jacobi_routing_true_batch_under_vmap():
    seen = {}

    def probe(tag):
        def f(g):
            seen[tag] = (linalg._true_batch(g), linalg._use_jacobi(g))
            return g
        return f
    vmap(probe("small"))(torch.zeros((4, 8, 8)))
    assert seen["small"] == (4, False)
    vmap(probe("big"))(torch.zeros((512, 8, 8)))
    assert seen["big"] == (512, True)
    vmap(vmap(probe("nested")))(torch.zeros((32, 16, 8, 8)))
    assert seen["nested"] == (512, True)
    # a meta tensor of batch 1 (the chunk map's shape inference) takes the
    # library and gives the Jacobi route's shape and dtype
    meta = torch.empty((1, 1024, 16), device="meta")
    out = vmap(ops.svdvals)(meta)
    assert tuple(out.shape) == (1, 16) and out.dtype == torch.float32


def test_jacobi_is_differentiable():
    rs = np.random.RandomState(13)
    a = rs.randn(6, 6)
    a = (a + a.T) / 2
    m = torch.tensor(a, requires_grad=True)
    ops.jacobi_eigh(m).sum().backward()
    assert np.allclose(_n(m.grad), np.eye(6), atol=1e-8)
    m = torch.tensor(a, requires_grad=True)
    ops.jacobi_eigh(m)[-1].backward()
    _, v = np.linalg.eigh(a)
    assert np.allclose(_n(m.grad), np.outer(v[:, -1], v[:, -1]), atol=1e-6)
    # through the Gram-route svdvals, batched so it really takes Jacobi
    assert linalg._use_jacobi(torch.zeros((400, 6, 6)))
    x = rs.randn(400, 64, 6)
    xt = torch.tensor(x, requires_grad=True)
    ops.svdvals(xt).sum().backward()
    g3 = _n(xt.grad)
    eps = 1e-6
    for i in range(3):
        xp = x.copy()
        xp[7, 0, i] += eps
        xm = x.copy()
        xm[7, 0, i] -= eps
        num = (np.linalg.svd(xp[7], compute_uv=False).sum()
               - np.linalg.svd(xm[7], compute_uv=False).sum()) / (2 * eps)
        assert abs(g3[7, 0, i] - num) < 1e-5


def test_lstsq_matches_numpy():
    rs = np.random.RandomState(14)
    a = rs.randn(200, 7)
    b = rs.randn(200, 3)
    x = _n(ops.lstsq(_t(a), _t(b)))
    assert np.allclose(x, np.linalg.lstsq(a, b, rcond=None)[0], atol=1e-10)
    assert np.allclose(x, np.asarray(ref.lstsq(jnp.asarray(a),
                                               jnp.asarray(b))), atol=1e-10)
    bv = rs.randn(200)
    xv = _n(ops.lstsq(_t(a), _t(bv)))
    assert xv.shape == (7,)
    assert np.allclose(xv, np.linalg.lstsq(a, bv, rcond=None)[0], atol=1e-10)
    ab = rs.randn(4, 64, 5)
    bb = rs.randn(4, 64, 2)
    xb = _n(ops.lstsq(_t(ab), _t(bb)))
    refb = np.stack([np.linalg.lstsq(ab[i], bb[i], rcond=None)[0]
                     for i in range(4)])
    assert np.allclose(xb, refb, atol=1e-9)
    ac = rs.randn(500, 6) * np.logspace(0, 3, 6)
    bc = rs.randn(500)
    xc = _n(ops.lstsq(_t(ac), _t(bc)))
    assert np.allclose(xc, np.linalg.lstsq(ac, bc, rcond=None)[0],
                       rtol=1e-7)
    with pytest.raises(ValueError):
        ops.lstsq(torch.zeros((4, 8)), torch.zeros(4))      # wide
    with pytest.raises(ValueError):
        ops.lstsq(torch.zeros((8, 4)), torch.zeros(7))      # row mismatch


def test_lstsq_dtype_promotion_and_complex_rejection():
    rs = np.random.RandomState(15)
    a32 = rs.randn(64, 4).astype(np.float32)
    b64 = rs.randn(64)
    assert ops.lstsq(_t(a32), _t(b64)).dtype == torch.float64
    with pytest.raises(ValueError):
        ops.lstsq(_t(a32), _t(b64 + 1j * b64))


@given(st.integers(1, 20), st.integers(1, 4), st.integers(0, 2 ** 16),
       st.sampled_from([1e-8, 1.0, 1e8]))
@settings(**SETTINGS)
def test_jacobi_eigh_matches_numpy(n, batch, seed, scale):
    rs = np.random.RandomState(seed)
    a = rs.randn(batch, n, n) * scale
    a = (a + np.swapaxes(a, -1, -2)) / 2
    w, v = (_n(t) for t in ops.jacobi_eigh(_t(a), vectors=True))
    want = np.linalg.eigvalsh(a)
    anorm = np.abs(want).max() + 1e-300
    assert np.max(np.abs(w - want)) / anorm < 1e-10
    assert np.max(np.abs(a @ v - v * w[..., None, :])) / anorm < 1e-9


def test_host_input_goes_to_the_card(monkeypatch):
    # a tensor stays on its device; a host array goes to the card, and
    # without CUDA that raises instead of running on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = np.eye(3)
    assert ops.jacobi_eigh(_t(g)).device.type == "cpu"
    for call in (lambda: ops.jacobi_eigh(g),
                 lambda: ops.svdvals(np.ones((8, 2))),
                 lambda: ops.tsqr(np.ones((8, 2))),
                 lambda: ops.lstsq(np.ones((8, 2)), np.ones(8))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_ops_exports_every_reference_name():
    # the port's ops namespace is the reference's plus its own extras
    import bolt_tpu_torch.ops as port_ops
    assert set(ref.__all__) <= set(port_ops.__all__)
    assert {"fused_decode_sum", "lane_band"} <= set(port_ops.__all__)
    for name in port_ops.__all__:
        assert callable(getattr(port_ops, name)), name
