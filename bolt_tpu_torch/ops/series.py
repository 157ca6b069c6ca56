"""Per-record time-series transforms: detrend, z-score, centre,
cross-correlation, Fourier coherence, baseline normalisation.

Port of ``bolt_tpu/ops/series.py``.  Thunder's TimeSeries workloads
(records keyed by pixel or channel, values a time axis) detrend and
standardise every record before analysis.  Each transform is a per-record
``map``: it defers like any map and joins the next action's chain, with
the body batched by ``torch.func.vmap`` on the gpu mode and run on numpy
records in the local mode (the oracle).  Result dtypes on the gpu mode
follow the reference's jnp rule (``gpu/dtypes.py``): an int32 record
widens to f32.

Polynomial detrending is two thin matmuls per record against the
precomputed Vandermonde ``A`` and its pseudo-inverse (``v - A @ (pinv(A)
@ v)``), built host-side once per (length, order); ``torch.matmul`` runs
them with TF32 off (precision ``"highest"``, as the reference pins).
"""

from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch


def _value_axis(b, axis):
    """Resolve ONE value-axis index (relative to the value group)."""
    split = b.split if b.mode == "gpu" else 1
    nv = b.ndim - split
    ax = int(axis)
    if ax < 0:
        ax += nv
    if ax < 0 or ax >= nv:
        raise ValueError(
            "value axis %r out of range for %d value axes" % (axis, nv))
    return ax, split


def _apply_map(b, func):
    """Per-record map on either mode (axis = the array's key axes)."""
    if b.mode == "gpu":
        return b.map(func, axis=tuple(range(b.split)))
    return b.map(func, axis=(0,))


def _float_of(v):
    """The float dtype a record computes in: ``promote_types(v.dtype,
    float32)`` (numpy's rule for a numpy record, jnp's for a tensor)."""
    if isinstance(v, np.ndarray):
        return np.promote_types(v.dtype, np.float32)
    from bolt_tpu_torch.gpu import dtypes
    return dtypes.promote(v.dtype, torch.float32)


def _inexact(v):
    """A tensor record widened as jnp widens it for a mean (int32 → f32)."""
    from bolt_tpu_torch.gpu import dtypes
    return v.to(dtypes.inexact(v.dtype))


def detrend(b, order=1, axis=0):
    """Remove a least-squares polynomial trend of ``order`` along the
    value axis ``axis`` of every record.

    ``order=0`` removes the mean, ``order=1`` a linear trend, etc.  The
    fit is exact (normal equations via ``pinv``, precomputed host-side).
    """
    order = int(order)
    if order < 0:
        raise ValueError("order must be >= 0, got %d" % order)
    ax, split = _value_axis(b, axis)
    length = b.shape[split + ax]
    if length <= order:
        raise ValueError(
            "axis of length %d cannot fit a degree-%d trend" % (length, order))
    return _apply_map(b, _detrend_fn(length, order, ax))


@contextmanager
def _highest_matmul():
    """Run the block with torch's float32 matmul precision at
    ``"highest"`` (TF32 off) and restore the caller's setting after.  The
    setting is process-wide, not thread-local: another thread's matmuls
    see it while the block runs."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@lru_cache(maxsize=256)
def _detrend_fn(length, order, ax):
    # residual = v - A @ (pinv(A) @ v): two THIN matmuls (L x (order+1)),
    # never the (L, L) projector.  Memoised so repeated calls return the
    # SAME callable.
    t = np.linspace(-1.0, 1.0, length)
    a_mat = np.vander(t, order + 1, increasing=True)
    pinv_a = np.linalg.pinv(a_mat)

    def f(v):
        # promote to float: casting the fit matrices to an int dtype
        # would truncate them to zeros
        dt = _float_of(v)
        if isinstance(v, np.ndarray):
            moved = np.moveaxis(v.astype(dt), ax, -1)
            fit = (moved @ pinv_a.astype(dt).T) @ a_mat.astype(dt).T
            return np.moveaxis(moved - fit, -1, ax)
        a_ = torch.as_tensor(a_mat, dtype=dt, device=v.device)
        p_ = torch.as_tensor(pinv_a, dtype=dt, device=v.device)
        moved = torch.movedim(v.to(dt), ax, -1)
        # pinned to "highest" whatever the precision scope, as the
        # reference pins it: the fit matrices are f32/f64 host constants,
        # and a TF32 pass would dominate the residual
        with _highest_matmul():
            fit = torch.matmul(torch.matmul(moved, p_.T), a_.T)
        return torch.movedim(moved - fit, -1, ax)

    return f


def zscore(b, axis=0, ddof=0, epsilon=0.0):
    """Standardise every record along the value axis ``axis``:
    ``(v - mean) / (std + epsilon)``.

    ``ddof`` selects population (0, default) or sample (1) standard
    deviation; ``epsilon`` guards constant records (otherwise they divide
    by zero, matching numpy's nan/inf behaviour).
    """
    ax, _ = _value_axis(b, axis)
    return _apply_map(b, _zscore_fn(ax, int(ddof), float(epsilon)))


@lru_cache(maxsize=256)
def _zscore_fn(ax, ddof, epsilon):
    def f(v):
        if isinstance(v, np.ndarray):
            mu = np.mean(v, axis=ax, keepdims=True)
            sd = np.std(v, axis=ax, ddof=ddof, keepdims=True)
            return (v - mu) / (sd + epsilon)
        v = _inexact(v)
        mu = torch.mean(v, dim=ax, keepdim=True)
        sd = torch.std(v, dim=ax, correction=ddof, keepdim=True)
        return (v - mu) / (sd + epsilon)
    return f


def center(b, axis=0):
    """Subtract the per-record mean along the value axis ``axis``."""
    ax, _ = _value_axis(b, axis)
    return _apply_map(b, _center_fn(ax))


@lru_cache(maxsize=256)
def _center_fn(ax):
    def f(v):
        if isinstance(v, np.ndarray):
            return v - np.mean(v, axis=ax, keepdims=True)
        return v - torch.mean(_inexact(v), dim=ax, keepdim=True)
    return f


def crosscorr(b, signal, lag=0, axis=0, epsilon=0.0):
    """Per-record normalised cross-correlation with a reference ``signal``
    along the value axis ``axis`` (the Thunder ``TimeSeries.crossCorr``
    workload).

    For each integer shift ``k`` in ``[-lag, lag]`` the Pearson
    correlation between ``v[t]`` and ``signal[t - k]`` is computed over
    their overlapping window, so the axis of length ``L`` is replaced by
    ``2*lag + 1`` correlation values.  ``epsilon`` is added to the
    normaliser to guard constant records/windows.
    """
    lag = int(lag)
    if lag < 0:
        raise ValueError("lag must be >= 0, got %d" % lag)
    ax, split = _value_axis(b, axis)
    length = b.shape[split + ax]
    sig = np.asarray(signal, dtype=np.float64).ravel()
    if sig.shape[0] != length:
        raise ValueError(
            "signal length %d does not match axis length %d"
            % (sig.shape[0], length))
    if lag > length - 2:
        raise ValueError(
            "lag %d needs at least 2 overlapping samples on an axis of "
            "length %d (Pearson r of a single sample is undefined)"
            % (lag, length))
    return _apply_map(
        b, _crosscorr_fn(sig.tobytes(), length, lag, ax, float(epsilon)))


@lru_cache(maxsize=128)
def _crosscorr_fn(sig_bytes, length, lag, ax, epsilon):
    # per-shift signal statistics are functions of the host-side signal:
    # centre each window and take its sum of squares in float64 here.
    # Memoised by signal CONTENT.
    sig = np.frombuffer(sig_bytes, dtype=np.float64)
    windows = []
    for k in range(-lag, lag + 1):
        ssub = sig[:length - k] if k >= 0 else sig[-k:]
        sc = ssub - ssub.mean()
        windows.append((k, sc, float(np.sum(sc * sc))))

    def f(v):
        dt = _float_of(v)
        if isinstance(v, np.ndarray):
            moved = np.moveaxis(v.astype(dt), ax, -1)
        else:
            moved = torch.movedim(v.to(dt), ax, -1)
        outs = []
        for k, sc_np, sc_ss in windows:
            a = moved[..., k:] if k >= 0 else moved[..., :length + k]
            if isinstance(v, np.ndarray):
                ac = a - np.mean(a, axis=-1, keepdims=True)
                sc = sc_np.astype(dt)
                denom = np.sqrt(np.sum(ac * ac, axis=-1) * sc_ss) + epsilon
                outs.append(np.sum(ac * sc, axis=-1) / denom)
            else:
                ac = a - torch.mean(a, dim=-1, keepdim=True)
                sc = torch.as_tensor(sc_np, dtype=dt, device=v.device)
                denom = torch.sqrt(torch.sum(ac * ac, dim=-1) * sc_ss) \
                    + epsilon
                outs.append(torch.sum(ac * sc, dim=-1) / denom)
        if isinstance(v, np.ndarray):
            return np.stack(outs, axis=ax)
        return torch.stack(outs, dim=ax)

    return f


def fourier(b, freq, axis=0, epsilon=0.0):
    """Spectral coherence and phase of every record at one frequency
    index along the value axis ``axis`` (the Thunder ``Series.fourier``
    workload).

    Each record is mean-centred and transformed with a real FFT; at bin
    ``freq`` (1 ≤ freq ≤ L//2, DC excluded):

    * **coherence** = ``|co[freq]| / sqrt(sum_{k>=1} |co[k]|^2)``;
    * **phase** = ``angle(co[freq])`` in radians.

    Returns ``(coherence, phase)`` as bolt arrays with the axis removed,
    both still deferred maps.  ``epsilon`` guards constant records.
    """
    freq = int(freq)
    ax, split = _value_axis(b, axis)
    length = b.shape[split + ax]
    if not 1 <= freq <= length // 2:
        raise ValueError(
            "freq must be in [1, %d] for an axis of length %d, got %d"
            % (length // 2, length, freq))

    out = _apply_map(b, _fourier_fn(freq, ax, float(epsilon)))
    return (_apply_map(out, _pick_fn(ax, 0)),
            _apply_map(out, _pick_fn(ax, 1)))


@lru_cache(maxsize=128)
def _fourier_fn(freq, ax, epsilon):
    def f(v):
        dt = _float_of(v)
        if isinstance(v, np.ndarray):
            moved = np.moveaxis(v.astype(dt), ax, -1)
            y = moved - np.mean(moved, axis=-1, keepdims=True)
            co = np.fft.rfft(y, axis=-1)
            mag2 = np.abs(co[..., 1:]) ** 2
            coh = (np.abs(co[..., freq])
                   / (np.sqrt(np.sum(mag2, axis=-1)) + epsilon))
            return np.stack([coh, np.angle(co[..., freq])], axis=ax)
        moved = torch.movedim(v.to(dt), ax, -1)
        y = moved - torch.mean(moved, dim=-1, keepdim=True)
        co = torch.fft.rfft(y, dim=-1)
        mag2 = torch.abs(co[..., 1:]) ** 2
        coh = (torch.abs(co[..., freq])
               / (torch.sqrt(torch.sum(mag2, dim=-1)) + epsilon))
        return torch.stack([coh, torch.angle(co[..., freq])], dim=ax)
    return f


@lru_cache(maxsize=128)
def _pick_fn(ax, i):
    sel = (slice(None),) * ax
    return lambda v: v[sel + (i,)]


def normalize(b, baseline="percentile", perc=20.0, axis=0, epsilon=0.0):
    """Normalise every record to its own baseline along the value axis
    ``axis``: ``(v - base) / denom`` with the sign-aware denominator
    ``denom = base + epsilon`` for ``base >= 0`` and ``base - epsilon``
    otherwise — the ΔF/F transform of the Thunder ``Series.normalize``
    workload.

    ``baseline``: ``'percentile'`` (the ``perc``-th per-record percentile,
    default 20) or ``'mean'``.  On the gpu mode the percentile is
    ``torch.quantile`` (linear interpolation, numpy's default), which
    ``torch.func.vmap`` runs through its per-record fallback.
    """
    if baseline not in ("percentile", "mean"):
        raise ValueError(
            "baseline must be 'percentile' or 'mean', got %r" % (baseline,))
    perc = float(perc)
    if not 0.0 <= perc <= 100.0:
        raise ValueError("perc must be in [0, 100], got %r" % (perc,))
    ax, _ = _value_axis(b, axis)
    return _apply_map(b, _normalize_fn(baseline, perc, ax, float(epsilon)))


@lru_cache(maxsize=128)
def _normalize_fn(baseline, perc, ax, epsilon):
    def f(v):
        dt = _float_of(v)
        if isinstance(v, np.ndarray):
            vf = v.astype(dt)
            if baseline == "percentile":
                base = np.percentile(vf, perc, axis=ax, keepdims=True)
            else:
                base = np.mean(vf, axis=ax, keepdims=True)
            denom = np.where(base >= 0, base + epsilon, base - epsilon)
            return (vf - base) / denom
        vf = v.to(dt)
        if baseline == "percentile":
            base = torch.quantile(vf, perc / 100.0, dim=ax, keepdim=True)
        else:
            base = torch.mean(vf, dim=ax, keepdim=True)
        # sign-aware guard: a signed baseline (after detrend) must move
        # away from zero, not onto it
        denom = torch.where(base >= 0, base + epsilon, base - epsilon)
        return (vf - base) / denom
    return f
