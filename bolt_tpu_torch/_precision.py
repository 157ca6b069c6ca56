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
jax, so it takes the mode strings only.  ``accumulate`` waits for its user
(the fused multi-stat); ``codec_bound`` is the codec's parity contract
(``gpu/codec.py``).
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


def resolve(explicit=None, pinned="highest"):
    """The effective precision for one call: ``explicit`` per-call kwarg
    > innermost active scope > the op's ``pinned`` default."""
    if explicit is not None:
        return _check(explicit)
    st = getattr(_tls, "stack", None)
    if st:
        return st[-1]
    return pinned


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
