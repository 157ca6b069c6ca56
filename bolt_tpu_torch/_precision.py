"""Scoped precision policy for the port's matmul-class and window ops.

Port of ``bolt_tpu/_precision.py`` (``MODES``, ``precision``,
``resolve``).  The three modes keep the reference's names:

- ``"default"``  — the fastest form a kernel offers (the reference's one
  bf16 MXU pass, ~1e-2 relative);
- ``"high"``     — an f32-class form;
- ``"highest"``  — f32/f64 arithmetic (the pinned library default).

Resolution order: an explicit per-call ``precision=`` kwarg wins, then the
innermost active ``with bolt.precision(...)`` scope, then the op's pinned
default.  The scope is thread-local.  The port's window kernels
(``ops/kernels.py :: sepfilter1d``/``lane_band``) resolve the mode and
compute the exact f32/f64 sum under every mode, which lies inside each
mode's envelope; ``ops/series.py`` pins its ``torch.matmul`` to
``"highest"`` (TF32 off), as the reference does.

The reference also accepts ``jax.lax.Precision`` members; the port has no
jax, so it takes the mode strings only.  ``accumulate`` is the opt-in
reduced-precision path of the fused stat groups (``gpu/multistat.py``);
``codec_bound`` is the codec's parity contract (``gpu/codec.py``).
"""

import threading
from contextlib import contextmanager

MODES = ("default", "high", "highest")

_tls = threading.local()


def _check(mode):
    """Validate/coerce one precision spelling to a mode string (any
    case)."""
    if isinstance(mode, str) and mode.lower() in MODES:
        return mode.lower()
    raise ValueError("precision mode must be one of %r (got %r)"
                     % (MODES, mode))


@contextmanager
def precision(mode):
    """Scoped precision policy: every matmul-class or window op called
    inside the ``with`` block uses ``mode`` unless the call passes its own
    ``precision=``.  Nests (innermost wins); defaults are unchanged
    outside any scope."""
    mode = _check(mode)
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    st.append(mode)
    try:
        yield
    finally:
        st.pop()


# torch's float32 matmul precision for each mode: "highest" is full f32
# (TF32 off), "high" TF32, "default" the bf16 pass
_F32_MATMUL = {"default": "medium", "high": "high", "highest": "highest"}


@contextmanager
def f32_matmul(mode):
    """Run the block at torch's float32 matmul precision for ``mode`` and
    restore the caller's setting after.  The setting is process-wide, not
    thread-local: another thread's matmuls see it while the block runs."""
    import torch
    prev = torch.get_float32_matmul_precision()
    want = _F32_MATMUL[_check(mode)]
    if prev == want:
        yield
        return
    torch.set_float32_matmul_precision(want)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def resolve(explicit=None, pinned="highest"):
    """The effective precision for one call: ``explicit`` per-call kwarg
    > innermost active scope > the op's ``pinned`` default."""
    if explicit is not None:
        return _check(explicit)
    st = getattr(_tls, "stack", None)
    if st:
        return st[-1]
    return pinned


# ---------------------------------------------------------------------
# reduced-precision accumulation of fused stat groups (the reference's
# ``_precision.accumulate``): "bf16" rounds the values of the additive
# terminals (sum/prod/mean/var/std) to bf16 and accumulates in f32; "f32"
# casts them to f32 (exact for f32 pipelines); "int8" takes an integer
# pipeline's sum/prod through int8 values and an int32 accumulator.
# Order statistics (min/max/any/all and the pair behind ptp) stay exact.
# The default, None, is exact.  Scoped like ``precision`` (thread-local,
# innermost wins); the per-call door is ``compute(..., accumulate=...)``.
# ---------------------------------------------------------------------

ACCUMULATE_MODES = ("bf16", "f32", "int8")

_acc_tls = threading.local()


def _check_accumulate(mode):
    if mode is None:
        return None
    if isinstance(mode, str) and mode.lower() in ACCUMULATE_MODES:
        return mode.lower()
    raise ValueError("accumulate mode must be one of %r or None (got %r)"
                     % (ACCUMULATE_MODES, mode))


@contextmanager
def accumulate(mode):
    """Scoped reduced-precision accumulation for fused stat groups::

        with bolt_tpu_torch.accumulate("bf16"):
            s, v = bolt_tpu_torch.compute(b.sum(), b.var())

    ``accumulate(None)`` restores the exact default inside the scope.
    Nests (innermost wins)."""
    mode = _check_accumulate(mode)
    st = getattr(_acc_tls, "stack", None)
    if st is None:
        st = _acc_tls.stack = []
    st.append(mode)
    try:
        yield
    finally:
        st.pop()


def resolve_accumulate(explicit=None):
    """The accumulation mode of one group's resolution: ``explicit``
    (``compute(..., accumulate=...)``) > innermost :func:`accumulate`
    scope > ``None`` (exact)."""
    if explicit is not None:
        return _check_accumulate(explicit)
    st = getattr(_acc_tls, "stack", None)
    if st:
        return st[-1]
    return None


# codec name -> (lossless, documented relative-error envelope vs the
# uncompressed streamed result; None = bit-identical).  int8's envelope
# is ABSOLUTE per element (~half the per-slab quantisation step,
# value-range dependent): tests derive the concrete bound from each
# slab's range.
CODEC_BOUNDS = {
    "bf16": (False, 1e-2),
    "f16": (False, 1e-3),
    "int8": (False, "~scale/2 absolute (scale = slab range / 255)"),
    "delta-f32": (True, None),
}


def codec_bound(name):
    """``(lossless, envelope)`` for a registered codec name, the
    documented parity contract of ``gpu/codec.py``.  Unknown names return
    ``(False, None)`` (a custom registered codec documents its own
    bound)."""
    return CODEC_BOUNDS.get(name, (False, None))
