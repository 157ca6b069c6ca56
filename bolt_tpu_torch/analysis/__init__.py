"""bolt_tpu_torch.analysis — static analysis for deferred pipelines and
the package (port of ``bolt_tpu/analysis``).

Two halves:

* **Abstract pipeline checker** (:func:`check` / :func:`explain`): walk a
  ``BoltArrayGPU``'s deferred state (a map chain, a pending filter, a
  pending stat, a stream's stages) and evaluate it on ``device="meta"``
  tensors — result shape, dtype and key split per stage, plus the
  structured ``BLT0xx`` diagnostics — with no build, no launch and no
  device allocation (``engine.counters()`` stays flat apart from the
  ``diagnostics`` tally the checker feeds)::

      rep = bolt_tpu_torch.analysis.check(b.map(f).filter(p))
      print(rep)                  # per-stage table + diagnostics
      rep.shape, rep.dtype        # the prediction a terminal will realise

* **Repo invariant linter** (:mod:`bolt_tpu_torch.analysis.astlint` and
  :mod:`~bolt_tpu_torch.analysis.concurrency`, run by
  ``python bolt_tpu_torch/analysis/lint.py --check``): the ``BLT1xx``
  rules; zero findings on ``bolt_tpu_torch/`` is a tier-1 test.

:func:`strict` arms the engine's pre-dispatch gate: inside the scope,
every dispatching terminal (chain materialisation, ``reduce``, the stat
family and a stat group's resolution, the filter terminals,
``chunk().map()``, ``stacked().map()``, the streamed terminals, a serve
batched dispatch) first runs the checker and REFUSES to dispatch —
raising :class:`PipelineError` before any build or launch — on
error-severity findings::

    with bolt_tpu_torch.analysis.strict():
        b.map(broken).sum()       # raises PipelineError, nothing built

Importing this package imports neither the serving layer nor a CUDA
extension: the checker reads the serving state through ``sys.modules``.

``working_set_bytes`` and ``admission_floor_bytes`` are the estimates
admission control (``serve.Server.submit``) reads.
"""

import contextlib
import threading

from bolt_tpu_torch import _lockdep
from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.analysis.diagnostics import (CODES, Diagnostic,
                                                 PipelineError, Report,
                                                 Stage)
from bolt_tpu_torch.analysis.check import (admission_floor_bytes, check,
                                           explain, working_set_bytes)
from bolt_tpu_torch.analysis import astlint

__all__ = ["check", "explain", "strict", "in_strict", "CODES",
           "Diagnostic", "Report", "Stage", "PipelineError", "astlint",
           "working_set_bytes", "admission_floor_bytes"]

_tls = threading.local()
_ACTIVE = 0                       # strict scopes alive across ALL threads
_ACTIVE_LOCK = _lockdep.lock("analysis.strict")


def in_strict():
    """True while the calling thread is inside a :func:`strict` scope."""
    return getattr(_tls, "depth", 0) > 0


def _strict_dispatch_guard(arr, op):
    """The engine's pre-dispatch gate (installed by :func:`strict`):
    check the array about to dispatch ``op`` and refuse, before any
    build or launch, on error-severity findings.  Threads outside a
    strict scope pass through (the scope is thread-local)."""
    if not in_strict():
        return
    _engine.strict_checked()
    rep = check(arr)
    if not rep.ok:
        _engine.strict_rejected()
        raise PipelineError(op, rep)


@contextlib.contextmanager
def strict():
    """Scope making the engine run :func:`check` before every
    dispatching terminal and refuse (``PipelineError``) on
    error-severity findings.  Nests; thread-local (threads outside the
    scope dispatch normally).  Engine counters account the gate:
    ``strict_checks`` runs, ``strict_rejections`` refusals,
    ``diagnostics`` findings."""
    global _ACTIVE
    _tls.depth = getattr(_tls, "depth", 0) + 1
    with _ACTIVE_LOCK:
        _ACTIVE += 1
        if _ACTIVE == 1:
            _engine.set_strict_guard(_strict_dispatch_guard)
    try:
        yield
    finally:
        _tls.depth -= 1
        with _ACTIVE_LOCK:
            _ACTIVE -= 1
            if _ACTIVE == 0:
                _engine.set_strict_guard(None)
