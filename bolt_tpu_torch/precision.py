"""Alias for :mod:`bolt_tpu_torch._precision`, as ``bolt_tpu/precision.py``
is for the reference.

The package re-exports the :func:`~bolt_tpu_torch._precision.precision`
context manager as ``bolt_tpu_torch.precision``, and Python resolves
``import bolt_tpu_torch.precision as p`` through the package attribute.
Loading this module sets it onto the package after its body runs, so the
module itself is made callable (delegating to the context manager): both
``bolt_tpu_torch.precision("default")`` and
``from bolt_tpu_torch.precision import resolve`` keep working in either
order.
"""

import sys
import types

from bolt_tpu_torch._precision import MODES, precision, resolve  # noqa: F401

__all__ = ["MODES", "precision", "resolve"]


class _CallableAlias(types.ModuleType):

    def __call__(self, mode):
        return precision(mode)


sys.modules[__name__].__class__ = _CallableAlias
