"""Dense linear algebra for the per-chunk workloads, on one card.

Port of ``bolt_tpu/ops/linalg.py``.  The reference runs its PCA workload
as per-chunk ``numpy.linalg.svd`` calls (``BASELINE`` config 5); the
straight translation, a library eigensolver over a batch of small
matrices, serialises on the batch.  The Gram route keeps the reference's
algorithm:

* :func:`jacobi_eigh` — batched symmetric eigendecomposition by cyclic
  Jacobi with the parallel (round-robin) ordering.  Every step applies
  the ``m // 2`` disjoint rotations of one round to the whole batch as
  two gathers plus elementwise math: no data-dependent control flow, a
  fixed ``sweeps * (m - 1)`` steps of plain torch ops, so it batches
  under ``torch.func.vmap``, runs on ``meta`` tensors and differentiates.
* :func:`svdvals` / :func:`tallskinny_pca` / :func:`tallskinny_svd` —
  singular values / principal components of tall-skinny blocks via the
  Gram matrix: the ``(n, d)`` data is read by one matmul and the
  eigenproblem is only ``(d, d)``, routed to :func:`jacobi_eigh` when the
  batch (vmapped levels included) amortises the sweep chain, else to
  ``torch.linalg.eigvalsh``/``eigh``, the counterpart of XLA's QDWH.
* :func:`tsqr` / :func:`lstsq` — CholeskyQR2 and the least-squares solve
  through it.
* :func:`pca` / :func:`cov` / :func:`corrcoef` — samples × features
  statistics of a bolt array.  The Gram matrix and the mean accumulate
  block by block over the deferred chain, so the mapped ``(n, d)``
  tensor is never written whole; the centering folds into the Gram
  algebraically (``G - n mu mu^H``).

Rotation angles use ``0.5 * atan2(2 a_pq, a_qq - a_pp)``: no divisions
and no overflow for any input scale.  Matmuls run under the scoped
precision policy (``bolt_tpu_torch.precision``), pinned at ``"highest"``
(full f32, TF32 off): f32 data loses about three digits otherwise.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from bolt_tpu_torch import _precision
from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.utils import prod, tupleize


def _adjoint(x):
    """Conjugate transpose of the trailing two dims (plain transpose for
    real dtypes)."""
    xt = x.transpose(-1, -2)
    return xt.conj() if xt.is_complex() else xt


def _real_dtype(dtype):
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


def _widen(x):
    """A float dtype the decomposition can run in: integers widen to f64
    (ints would truncate components to zero), f16/bf16 to f32 (the Gram
    accumulates in f32, as the reference's ``preferred_element_type``)."""
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        return x.to(torch.float64)
    if x.dtype in (torch.float16, torch.bfloat16):
        return x.to(torch.float32)
    return x


def _np_widen(x):
    """The local oracle's :func:`_widen`: integers widen to f64."""
    return x if np.issubdtype(x.dtype, np.inexact) else x.astype(np.float64)


def _default_device():
    from bolt_tpu_torch.gpu.construct import resolve_device
    return resolve_device(None)


def _as_tensor(x, device=None):
    """``x`` as a tensor: a tensor stays where it lives; anything else is
    placed on ``device`` (default: the card, ``cuda:0``)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(np.array(a, order="C")).to(
        _default_device() if device is None else device)


@lru_cache(maxsize=None)
def _round_robin(n):
    """Parallel-ordering Jacobi schedule (the circle method): ``n`` even →
    ``n - 1`` rounds of ``n // 2`` disjoint (p, q) pairs covering every
    index, so one round rotates the whole matrix."""
    others = list(range(1, n))
    rounds = []
    for _ in range(n - 1):
        cur = [0] + others
        pairs = sorted((min(cur[i], cur[n - 1 - i]),
                        max(cur[i], cur[n - 1 - i])) for i in range(n // 2))
        rounds.append(pairs)
        others = others[-1:] + others[:-1]
    return np.asarray(rounds)  # (n-1, n//2, 2)


def _default_sweeps(n, dtype):
    """Cyclic Jacobi converges quadratically once sweeps ~ log2(n); the +4
    (+6 for f64's longer mantissa) lands at machine precision with
    margin."""
    extra = 6 if torch.finfo(dtype).bits >= 64 else 4
    return max(6, int(math.ceil(math.log2(max(n, 2)))) + extra)


@lru_cache(maxsize=64)
def _schedule(m, device):
    """The round-robin schedule of an ``m``-even Jacobi as index tensors on
    ``device``, one row per round: for every position ``i`` the pair
    ``(p, q)`` it belongs to (``pp``, ``qq``, and ``pq = p * m + q`` into
    the flattened matrix), its partner ``pi`` (the involution ``p <-> q``)
    and the sign its sine takes (``-`` at ``p``, ``+`` at ``q``).  Each
    round's pairs cover every index, so the per-position rotation
    coefficients are gathers of the per-pair angle, not scatters."""
    rounds = _round_robin(m)                         # (m-1, m//2, 2)
    r = m - 1
    rows = np.arange(r)[:, None]
    p, q = rounds[..., 0], rounds[..., 1]
    pp = np.empty((r, m), np.int64)
    qq = np.empty((r, m), np.int64)
    pi = np.empty((r, m), np.int64)
    sign = np.empty((r, m), np.float64)
    for idx, s in ((p, -1.0), (q, 1.0)):
        pp[rows, idx] = p
        qq[rows, idx] = q
        sign[rows, idx] = s
    pi[rows, p] = q
    pi[rows, q] = p

    def dev(a):
        return torch.from_numpy(a).to(device)
    return dev(pp), dev(qq), dev(pp * m + qq), dev(pi), dev(0.5 * sign)


def jacobi_eigh(a, vectors=False, sweeps=None):
    """Batched symmetric eigendecomposition (reference:
    ``bolt_tpu.ops.jacobi_eigh``).

    ``a`` is ``(..., n, n)`` symmetric real (a tensor stays on its
    device; anything else goes to the card); returns ascending
    eigenvalues ``(..., n)``, or ``(w, v)`` with orthonormal columns
    ``a @ v = v * w`` when ``vectors=True``.

    A fixed-iteration cyclic Jacobi with parallel ordering: ``sweeps *
    (m - 1)`` steps (``m`` is ``n`` rounded up to even), each applying
    ``m // 2`` disjoint rotations to every matrix of the batch by two row
    and column gathers and elementwise arithmetic.  An odd ``n`` is padded
    with a dummy diagonal above the spectral radius, which never rotates.
    Best for large batches of small ``n``; complex input goes to
    ``torch.linalg.eigh``/``eigvalsh``, integer input widens to f64."""
    a = _as_tensor(a)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError("jacobi_eigh requires (..., n, n), got %s"
                         % (tuple(a.shape),))
    if a.is_complex():
        return torch.linalg.eigh(a) if vectors else torch.linalg.eigvalsh(a)
    if not a.dtype.is_floating_point:
        a = a.to(torch.float64)
    n = a.shape[-1]
    if sweeps is None:
        sweeps = _default_sweeps(n, a.dtype)
    odd = n % 2
    m = n + odd
    if odd:
        a = torch.nn.functional.pad(a, (0, 1, 0, 1))
        # dummy diagonal above the spectral radius (Gershgorin: rho <=
        # m * max|a|, computed without squaring so f32 inputs near the
        # dtype max don't overflow): every (i, dummy) pair then rotates by
        # theta = 0.5*atan2(0, big - a_ii) = 0 and the dummy stays
        # decoupled (a zero diagonal would swap itself in by theta = pi/2)
        big = 1.0 + m * a.abs().amax(dim=(-2, -1))
        corner = torch.zeros((m, m), dtype=a.dtype, device=a.device)
        corner[n, n] = 1.0
        a = a + big[..., None, None] * corner
    pp, qq, pq, pi, half = _schedule(m, a.device)
    half = half.to(a.dtype)
    v = torch.eye(m, dtype=a.dtype, device=a.device) if vectors else None
    for _ in range(sweeps):
        for r in range(m - 1):
            d = torch.diagonal(a, dim1=-2, dim2=-1)
            app = d.index_select(-1, pp[r])
            aqq = d.index_select(-1, qq[r])
            apq = a.flatten(-2).index_select(-1, pq[r])
            # per position: theta of its pair, negated at p, so that
            #   (Jt A)[i, :] = cos(t_i) A[i, :] + sin(t_i) A[pi(i), :]
            # on both sides (sin(-theta) = -sin(theta) exactly)
            t = torch.atan2(2.0 * apq, aqq - app) * half[r]
            cv, sv = torch.cos(t), torch.sin(t)
            a = torch.addcmul(cv[..., :, None] * a, sv[..., :, None],
                              a.index_select(-2, pi[r]))
            a = torch.addcmul(cv[..., None, :] * a, sv[..., None, :],
                              a.index_select(-1, pi[r]))
            if v is not None:
                v = torch.addcmul(cv[..., None, :] * v, sv[..., None, :],
                                  v.index_select(-1, pi[r]))
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    if odd:
        w = w[..., :n]   # the dummy never swaps, so it is still at index n
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.take_along_dim(w, order, dim=-1)
    if not vectors:
        return w
    if odd:
        v = v[..., :n, :n]
    return w, torch.take_along_dim(v, order[..., None, :], dim=-1)


# Jacobi-vs-library routing, the reference's constants (measured on a v5e
# chip, and pinned by its tests): small dims AND enough total work
_JACOBI_MAX_DIM = 64
_JACOBI_MIN_WORK = 2048          # batch * d below this -> the library


def _true_batch(g):
    """Total batch count including vmapped levels: under ``vmap`` the
    outer batch is invisible in ``g.shape`` (the per-chunk ``svdvals`` of
    BASELINE config 5b maps over the chunk grid, so one ``(d, d)`` Gram is
    really a whole batch of them).  Each functorch level wrapping ``g``
    multiplies in its batch size.  Without functorch's inspection API only
    the visible batch counts, which routes vmapped calls to the library:
    slower, never wrong."""
    batch = prod(g.shape[:-2])
    ft = getattr(torch._C, "_functorch", None)
    is_batched = getattr(ft, "is_batchedtensor", None)
    unwrap = getattr(ft, "get_unwrapped", None)
    bdim = getattr(ft, "maybe_get_bdim", None)
    if is_batched is None or unwrap is None or bdim is None:
        return batch
    t = g
    while is_batched(t):
        inner = unwrap(t)
        batch *= inner.shape[bdim(t)]
        t = inner
    return batch


def _use_jacobi(g):
    d = g.shape[-1]
    if d > _JACOBI_MAX_DIM or g.is_complex():
        return False
    return _true_batch(g) * d >= _JACOBI_MIN_WORK


def _gram_eigvalsh(g):
    return jacobi_eigh(g) if _use_jacobi(g) else torch.linalg.eigvalsh(g)


def _card_eigh(g):
    if _use_jacobi(g):
        return jacobi_eigh(g, vectors=True)
    # the solver's error check reads its status on the host
    return _engine.host_sync("eigh", torch.linalg.eigh, g)


def svdvals(x, gram_ratio=4):
    """Singular values of a (possibly batched) matrix (reference:
    ``bolt_tpu.ops.svdvals``).

    For tall-skinny blocks (rows >= ``gram_ratio`` * cols) the values come
    from the Gram matrix, ``sqrt(eigvalsh(x^H x))``: one matmul, then a
    ``(cols, cols)`` eigenproblem routed to :func:`jacobi_eigh` when cols
    <= 64 and the batch (or a vmapped context) amortises it, else to
    ``torch.linalg.eigvalsh``.  Forming the Gram squares the condition
    number, so trailing values below ``sqrt(eps) * s_max`` lose accuracy.
    Wide or near-square inputs go to ``torch.linalg.svdvals``."""
    x = _widen(_as_tensor(x))
    rows, cols = x.shape[-2], x.shape[-1]
    if rows >= gram_ratio * cols:
        with _precision.f32_matmul("highest"):
            g = torch.matmul(_adjoint(x), x)
        ev = _gram_eigvalsh(g)                         # ascending, real
        ev = torch.clamp(ev.flip(-1), min=0.0)         # descending, clamped
        return torch.sqrt(ev).to(_real_dtype(x.dtype))
    return torch.linalg.svdvals(x)


def _check_k(k, d):
    """Validate a component-count request against ``d`` features; None
    means all."""
    if k is None:
        return d
    if not 1 <= k <= d:
        raise ValueError("k=%d out of range for %d features" % (k, d))
    return k


def _decompose_gram(g, k, eigh_fn):
    """Eigendecompose a Gram matrix: ``(vec (d, k), ev (k,))`` in
    descending order with negative eigenvalues clamped to zero."""
    ev, vec = eigh_fn(g)                                       # ascending
    ev = torch.clamp(ev.flip(-1), min=0.0)[..., :k]
    return vec.flip(-1)[..., :k], ev


def _gram_decompose(x, k):
    with _precision.f32_matmul("highest"):
        g = torch.matmul(_adjoint(x), x)
    return _decompose_gram(g, k, _card_eigh)


def _np_gram_decompose(x, k):
    """The local oracle's Gram route (the reference's numpy sequence)."""
    xt = np.swapaxes(x, -1, -2)
    if np.iscomplexobj(x):
        xt = np.conj(xt)
    ev, vec = np.linalg.eigh(xt @ x)
    ev = np.maximum(ev[..., ::-1], 0.0)[..., :k]
    return vec[..., ::-1][..., :k], ev


def lstsq(a, b):
    """Least-squares solution of tall-skinny ``a @ x ~ b`` (reference:
    ``bolt_tpu.ops.lstsq``), through :func:`tsqr` (CholeskyQR2) and one
    residual-refinement pass.

    ``a`` is ``(..., n, d)`` with ``n >= d`` and full column rank; ``b`` is
    ``(..., n)`` or ``(..., n, k)``; returns ``(..., d)`` / ``(..., d, k)``.
    Either may be a bolt array: records are the rows (key axes flatten to
    ``n``, axis 0 on the local backend), value axes flatten to the
    features / targets.  A gpu array unwraps to its tensor; a local one
    (the host oracle) to a CPU tensor; other host operands join the first
    operand's device."""
    a = _system_operand(a, matrix=True)
    b = _system_operand(b, matrix=False)
    device = a.device if isinstance(a, torch.Tensor) else (
        b.device if isinstance(b, torch.Tensor) else None)
    a = _widen(_as_tensor(a, device))
    b = _widen(_as_tensor(b, a.device))
    if a.is_complex() or b.is_complex():
        raise ValueError("lstsq supports real systems; use "
                         "torch.linalg.lstsq for complex ones")
    # promote, never narrow (an f64 b must not silently drop to f32 a)
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    vec = b.ndim == a.ndim - 1
    if a.ndim < 2 or (not vec and b.ndim != a.ndim) \
            or b.shape[-2 if not vec else -1] != a.shape[-2]:
        raise ValueError(
            "lstsq needs a (..., n, d) and b (..., n) or (..., n, k); got "
            "%s and %s" % (tuple(a.shape), tuple(b.shape)))
    if vec:
        b = b[..., None]
    q, r = tsqr(a)
    with _precision.f32_matmul("highest"):
        y = torch.matmul(_adjoint(q), b)
        x = torch.linalg.solve_triangular(r, y, upper=True)
        # one refinement pass: e = y - r x at full precision repairs the
        # solve's rounding (see tsqr's r_inv note)
        e = y - torch.matmul(r, x)
        x = x + torch.linalg.solve_triangular(r, e, upper=True)
    return x[..., 0] if vec else x


def _system_operand(v, matrix):
    """A bolt operand of :func:`lstsq` as a tensor (gpu) or a CPU tensor
    (local): records flatten to rows, values to features/targets."""
    mode = getattr(v, "mode", None)
    if mode == "gpu":
        n = prod(v.shape[:v.split])
        t = v.totorch()
        if matrix:
            return t.reshape((n, prod(v.shape[v.split:])))
        return t.reshape((n,)) if v.ndim == v.split else t.reshape(
            (n, prod(v.shape[v.split:])))
    if mode == "local":
        arr = np.asarray(v)
        if matrix:
            arr = arr.reshape((arr.shape[0], -1))
        elif arr.ndim != 1:
            arr = arr.reshape((arr.shape[0], -1))
        return torch.from_numpy(np.array(arr, order="C"))
    return v


def tallskinny_svd(x, k=None):
    """Thin SVD ``(u, s, vh)`` of tall-skinny (batched) matrices via the
    Gram route (reference: ``bolt_tpu.ops.tallskinny_svd``): one matmul
    over the ``(..., n, d)`` data, a ``(d, d)`` eigenproblem and one more
    matmul for ``u = x @ v / s``.  Zero singular values give zero ``u``
    columns.  ``k`` truncates to the top components; descending order,
    ``numpy.linalg.svd`` conventions."""
    x = _widen(_as_tensor(x))
    if x.ndim < 2 or x.shape[-2] < x.shape[-1]:
        raise ValueError("tallskinny_svd requires (..., n, d) with n >= d, "
                         "got %s; use torch.linalg.svd" % (tuple(x.shape),))
    d = x.shape[-1]
    vec, ev = _gram_decompose(x, _check_k(k, d))
    s = torch.sqrt(ev)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    with _precision.f32_matmul("highest"):
        u = torch.matmul(x, vec) / safe[..., None, :]
    u = torch.where(s[..., None, :] > 0, u, torch.zeros_like(u))
    return u, s.to(_real_dtype(x.dtype)), _adjoint(vec)


def tsqr(x):
    """Thin QR of tall-skinny (batched) matrices by CholeskyQR2 (reference:
    ``bolt_tpu.ops.tsqr``): ``(q, r)`` with orthonormal ``q``, upper-
    triangular ``r`` with a positive diagonal and ``q @ r == x``.  Two
    rounds of ``R = chol(X^H X)^H; Q = X R^-1``: matmuls and a ``(d, d)``
    Cholesky.  Orthogonality error ~eps for cond(x) up to ~1/sqrt(eps)."""
    x = _widen(_as_tensor(x))
    if x.ndim < 2 or x.shape[-2] < x.shape[-1]:
        raise ValueError("tsqr requires (..., n, d) with n >= d, got %s"
                         % (tuple(x.shape),))
    d = x.shape[-1]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)

    def chol_qr(a):
        g = torch.matmul(_adjoint(a), a)
        low = torch.linalg.cholesky(g)                 # g = low @ low^H
        r = _adjoint(low)
        # invert only the small (d, d) triangle, then apply it by matmul;
        # one Newton step X <- X(2I - RX) scrubs the solve's own rounding
        r_inv = _adjoint(torch.linalg.solve_triangular(
            low, eye.expand(low.shape), upper=False))
        r_inv = torch.matmul(r_inv, 2.0 * eye - torch.matmul(r, r_inv))
        return torch.matmul(a, r_inv), r

    with _precision.f32_matmul("highest"):
        q1, r1 = chol_qr(x)
        q, r2 = chol_qr(q1)                            # re-orthogonalise
        return q, torch.matmul(r2, r1)


def tallskinny_pca(x, k=None):
    """Principal components of a tall-skinny ``(n, d)`` matrix via the
    Gram route (reference: ``bolt_tpu.ops.tallskinny_pca``):
    ``(components (d, k), singular_values (k,))``, descending."""
    n, d = x.shape
    if n < d:
        raise ValueError(
            "tallskinny_pca requires n >= d (got %d x %d): the rank-%d Gram "
            "matrix would pad the spectrum with zero eigenvalues whose "
            "eigenvectors are arbitrary; use torch.linalg.svd" % (n, d, n))
    x = _widen(_as_tensor(x))
    vec, ev = _gram_decompose(x, _check_k(k, d))
    return vec.to(x.dtype), torch.sqrt(ev).to(_real_dtype(x.dtype))


# the Gram and projection passes of pca/cov apply a deferred chain block
# by block of about this many bytes of records: a two-op chain holds two
# mapped blocks at once, and pca's (n, k) scores exist beside the second
# pass, so 256 MB blocks keep the growth of a chained (33554432, 16) f32
# pca (2.15 GB) under the scores plus 1 GB
_GRAM_BLOCK_BYTES = 256 << 20


def _blocks(base, funcs, split, n, d, dtype):
    """``(start, stop, x)`` over the samples × features view of the chain
    ``funcs`` over ``base``: ``x`` is the widened ``(stop - start, d)``
    block, a view of the base where there is no chain.  The Gram's f32
    sums then also accumulate over blocks, not along all ``n`` rows of
    one product."""
    from bolt_tpu_torch.gpu.array import _chain_blocks
    rec = max(d * np.dtype(dtype).itemsize,
              prod(base.shape[split:]) * base.element_size())
    per = max(1, _GRAM_BLOCK_BYTES // max(1, rec))
    for s, e, recs in _chain_blocks(base, funcs, split, per):
        yield s, e, _widen(recs.reshape(e - s, d))


def _moments(base, funcs, split, n, d, dtype, pr, conj_first):
    """``(G, mu)`` of the chain over ``base`` viewed as ``(n, d)``, from
    one pass of blocks: ``G = X^H X`` (``conj_first``, pca's Gram) or
    ``X^T conj(X)`` (np.cov's convention, the conjugate on the second
    factor), and the per-feature mean."""
    g, s1 = _moment_sums(base, funcs, split, n, d, dtype, pr, conj_first)
    return g, s1 / n


def _moment_sums(base, funcs, split, n, d, dtype, pr, conj_first):
    """``(G, column sums)`` of :func:`_moments`."""
    if n == 0:
        from bolt_tpu_torch.gpu.dtypes import torch_dtype
        z = _widen(torch.zeros((0, d), dtype=torch_dtype(dtype),
                               device=base.device))
        return torch.zeros((d, d), dtype=z.dtype, device=z.device), \
            torch.zeros(d, dtype=z.dtype, device=z.device)
    g = s1 = None
    with _precision.f32_matmul(pr):
        for _, _, x in _blocks(base, funcs, split, n, d, dtype):
            xt = x.transpose(0, 1)
            part = torch.matmul(xt.conj(), x) if conj_first else \
                torch.matmul(xt, x.conj())
            col = x.sum(dim=0)
            g = part if g is None else g + part
            s1 = col if s1 is None else s1 + col
            del x, xt
    return g, s1


def _mesh_moments(b, split, d, pr, conj_first):
    """``(G, column sums, box)`` of a mesh array's samples × features:
    each rank's Gram and sums over its own rows (whole records, through
    the deferred chain), folded over the mesh axes that split the
    samples in rank order, the same bits on every rank ("shard-local
    Gram + all-reduce")."""
    from bolt_tpu_torch.parallel import multihost, sharding
    loc = b.local
    base, funcs = loc._chain_parts()
    nloc = prod(loc.shape[:split])
    with b._scope():
        g, s1 = _moment_sums(base, funcs, split, nloc, d, b.dtype, pr,
                             conj_first)
    maxes = sharding.shard_axes(b._spec, range(split))
    if maxes:
        g, s1 = multihost.fold_partials(
            (g, s1), lambda x, y: (x[0] + y[0], x[1] + y[1]),
            b._mesh.group(maxes))
    return g, s1


def _mesh_pca(b, split, shape, n, d, k, center, pr):
    """:func:`pca` on a mesh of more than one rank: the folded Gram, the
    same ``(d, d)`` eigenproblem on every rank, and each rank's own rows
    projected (the scores keep the keys' layout)."""
    from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
    b = b._whole_records()
    g, s1 = _mesh_moments(b, split, d, pr, True)
    mu = s1 / n
    if not center:
        mu = torch.zeros_like(mu)
    else:
        g = g - n * torch.outer(mu.conj(), mu)
    vec, ev = _decompose_gram(g, k, _card_eigh)
    loc = b.local
    base, funcs = loc._chain_parts()
    kbox = tuple(loc.shape[:split])
    nloc = prod(kbox)
    parts = []
    with b._scope(), _precision.f32_matmul(pr):
        off = torch.matmul(mu, vec) if center else None
        for _, _, x in _blocks(base, funcs, split, nloc, d, b.dtype):
            blk = torch.matmul(x, vec)
            parts.append(blk - off if off is not None else blk)
    if not parts:
        parts = [torch.zeros((0, k), dtype=vec.dtype, device=vec.device)]
    scores = (parts[0] if len(parts) == 1 else torch.cat(parts)).reshape(
        kbox + (k,))
    out = BoltArrayMesh.wrap(scores, b._mesh, tuple(shape[:split]) + (k,),
                             split, b._spec[:split] + (None,))
    return out._constrained(), vec, torch.sqrt(ev), mu


def pca(b, k=None, center=False, axis=None, return_mean=False,
        fetch=True, precision=None):
    """PCA of a bolt array: sample axes × feature axes (reference:
    ``bolt_tpu.ops.pca``).

    The Gram matrix ``X^H X`` accumulates block by block over the
    deferred map chain (the mapped ``(n, d)`` tensor is never written
    whole), the small ``(d, d)`` eigenproblem is solved on the card and
    the projection ``X @ V`` applies the chain once more, block by block.
    With ``center=True`` the centering folds into the Gram algebraically
    (``Gc = G - n mu mu^H``): entries lose ~``eps * (||mu||/sigma)^2``
    relative accuracy at large offsets (the local oracle subtracts the
    mean explicitly).

    Parameters: ``b`` — a bolt array (gpu or local mode); ``k`` — number
    of components (default: all ``d``); ``center`` — subtract per-feature
    means first; ``axis`` — the sample axes (default: the key axes / axis
    0 locally; a gpu array aligns by swapping when they differ).

    Returns ``(scores, components, singular_values)``: scores is a bolt
    array shaped ``sample_shape + (k,)`` with the input's mode; components
    ``(d, k)`` and singular values ``(k,)`` are numpy arrays (descending).
    ``return_mean=True`` appends the per-feature mean ``(d,)`` (zeros when
    ``center=False``).  ``fetch=False`` (gpu mode) returns those as tensors
    on the card instead, with no host copy.  ``precision=None`` resolves
    through the scoped policy, pinned at ``"highest"``; the local oracle
    computes in f64."""
    pr = _precision.resolve(precision)
    mode, b, x_full, split, shape, n, d = _samples_features(
        b, axis, "pca", hint="; for plain matrices use tallskinny_pca")
    kshape = tuple(shape[:split])
    if n < d:
        raise ValueError(
            "pca requires #samples >= #features (got %d x %d); swap your "
            "key/value axes or use torch.linalg.svd" % (n, d))
    k = _check_k(k, d)

    if mode == "local":
        # the numpy oracle: the reference's sequence, host-side
        x = _np_widen(x_full.reshape(n, d))
        mu = x.mean(axis=0) if center else np.zeros(d, x.dtype)
        if center:
            x = x - mu
        vec, ev = _np_gram_decompose(x, k)
        vec = np.ascontiguousarray(vec)
        scores = (x @ vec).reshape(kshape + (k,))
        out = (type(b)(scores), vec,
               np.sqrt(ev).astype(np.finfo(x.dtype).dtype))
        return out + (mu,) if return_mean else out

    from bolt_tpu_torch.gpu.array import BoltArrayGPU, _cached_jit, _download
    from bolt_tpu_torch.gpu.mesharray import on_mesh
    if on_mesh(b):
        wrapped, vec, sv, mu = _mesh_pca(b, split, shape, n, d, k, center,
                                         pr)
        if not fetch:
            return (wrapped, vec, sv, mu) if return_mean else \
                (wrapped, vec, sv)
        out = (wrapped, _download(vec), _download(sv))
        return out + (_download(mu),) if return_mean else out
    base, funcs = b._chain_parts()
    dtype = b.dtype

    def build():
        def run(data):
            with _obs.span("linalg.pca", n=n, d=d, k=k):
                with _obs.span("linalg.gram"):
                    g, mu = _moments(data, funcs, split, n, d, dtype, pr,
                                     True)
                    if not center:
                        mu = torch.zeros_like(mu)
                    else:
                        g = g - n * torch.outer(mu.conj(), mu)
                with _obs.span("linalg.eigh"):
                    vec, ev = _decompose_gram(g, k, _card_eigh)
                off = None
                scores = None
                with _obs.span("linalg.project"), \
                        _precision.f32_matmul(pr):
                    if center:
                        off = torch.matmul(mu, vec)
                    for s, e, x in _blocks(data, funcs, split, n, d, dtype):
                        blk = torch.matmul(x, vec)
                        if off is not None:
                            blk = blk - off
                        if e - s == n:
                            scores = blk
                        else:
                            if scores is None:
                                scores = torch.empty((n, k), dtype=blk.dtype,
                                                     device=blk.device)
                            scores[s:e] = blk
                        del x, blk
                return (scores.reshape(kshape + (k,)), vec, torch.sqrt(ev),
                        mu)
        return run

    fn = _cached_jit(("ops-pca", funcs, tuple(base.shape), str(base.dtype),
                      split, b.device, k, center, pr), build)
    scores, vec, sv, mu = fn(base)
    wrapped = BoltArrayGPU(scores, split, b.device)
    if not fetch:
        return (wrapped, vec, sv, mu) if return_mean else (wrapped, vec, sv)
    out = (wrapped, _download(vec), _download(sv))
    return out + (_download(mu),) if return_mean else out


def _samples_features(b, axis, name, hint=""):
    """Shared samples×features preamble of :func:`pca`/:func:`cov`: mode
    dispatch, sample-axis resolution (``_align`` on gpu, moveaxis
    locally) and the flattened ``(n, d)`` sizes.  Returns ``(mode, b,
    x_full, split, shape, n, d)`` where ``x_full`` is the axis-aligned
    host array in local mode (None on gpu)."""
    mode = getattr(b, "mode", None)
    if mode not in ("local", "gpu"):
        raise TypeError("%s expects a bolt array (mode 'local' or 'gpu')%s"
                        % (name, hint))
    if mode == "gpu":
        axes = sorted(tupleize(axis)) if axis is not None \
            else list(range(b.split))
        b = b._align(axes)
        split = b.split
        x_full = None
        shape = b.shape
    else:
        axes = sorted(tupleize(axis)) if axis is not None else [0]
        split = len(axes)
        # move sample axes to the front (the local analog of _align)
        x_full = np.moveaxis(np.asarray(b), axes, range(split))
        shape = x_full.shape
    return mode, b, x_full, split, shape, prod(shape[:split]), \
        prod(shape[split:])


def cov(b, axis=None, center=True, ddof=1, return_mean=False,
        precision=None):
    """Feature-covariance matrix of a bolt array viewed as samples ×
    features (reference: ``bolt_tpu.ops.cov``).

    Same sample/feature split as :func:`pca`.  ``ddof=1`` gives the sample
    covariance (``np.cov``'s default); ``center=False`` divides the raw
    second moment ``X^T conj(X)`` by ``n - ddof`` instead.  The product
    accumulates block by block over the deferred chain and the centering
    folds in algebraically, with the diagonal clamped at zero (the fold
    can cancel past f32 precision for tiny-variance features on a large
    offset).  Returns a ``(d, d)`` numpy array; ``return_mean=True``
    appends the per-feature mean."""
    pr = _precision.resolve(precision)
    mode, b, x_full, split, shape, n, d = _samples_features(b, axis, "cov")
    if n - ddof <= 0:
        raise ValueError("cov needs more than ddof=%d samples, got %d"
                         % (ddof, n))

    if mode == "local":
        x = _np_widen(x_full.reshape(n, d))
        mu = x.mean(axis=0) if center else np.zeros(d, x.dtype)
        if center:
            x = x - mu
        # np.cov convention: C_ij = E[(x_i - mu_i) conj(x_j - mu_j)] —
        # the conjugate is on the SECOND factor
        c = (x.T @ np.conj(x)) / (n - ddof)
        return (c, mu) if return_mean else c

    from bolt_tpu_torch.gpu.array import _cached_jit, _download
    from bolt_tpu_torch.gpu.mesharray import on_mesh
    if on_mesh(b):
        g, s1 = _mesh_moments(b._whole_records(), split, d, pr, False)
        c, mu = _cov_final(g, s1 / n, n, center, ddof)
        return (_download(c), _download(mu)) if return_mean else \
            _download(c)
    base, funcs = b._chain_parts()
    dtype = b.dtype

    def build():
        def run(data):
            c, mu = _moments(data, funcs, split, n, d, dtype, pr, False)
            return _cov_final(c, mu, n, center, ddof)
        return run

    fn = _cached_jit(("ops-cov", funcs, tuple(base.shape), str(base.dtype),
                      split, b.device, center, ddof, pr), build)
    c, mu = fn(base)
    if return_mean:
        return _download(c), _download(mu)
    return _download(c)


def _cov_final(c, mu, n, center, ddof):
    """The covariance and the mean of the second moment ``c`` and the
    mean ``mu`` of ``n`` samples."""
    if not center:
        return c / (n - ddof), torch.zeros_like(mu)
    c = c - n * torch.outer(mu, mu.conj())
    # the explicit-centering form's diagonal (a sum of squared moduli)
    # cannot go negative; the fold can cancel past f32 precision, so
    # restore the invariant (corrcoef's sqrt(diag) depends on it)
    diag = torch.clamp(torch.diagonal(c).real, min=0.0)
    c = c.clone()
    torch.diagonal(c).copy_(diag.to(c.dtype))
    return c / (n - ddof), mu


def corrcoef(b, axis=None, precision=None):
    """Feature-correlation matrix (Pearson) of a bolt array viewed as
    samples × features: :func:`cov` normalised by the outer product of the
    per-feature standard deviations, on the host (the ``(d, d)`` result is
    tiny).  Zero-variance features yield NaN rows/columns, as
    ``np.corrcoef``."""
    c = cov(b, axis=axis, center=True, ddof=1, precision=precision)
    sd = np.sqrt(np.diag(c))
    with np.errstate(divide="ignore", invalid="ignore"):
        r = c / np.outer(sd, sd)
    return r
