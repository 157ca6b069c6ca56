"""bolt_tpu_torch.analysis — the device working-set estimates admission
control reads.

Port of ``bolt_tpu/analysis``, started with the estimates the serving
layer needs (``bolt_tpu_torch.serve``'s admission floor, the reference's
BLT010 contract): :func:`working_set_bytes`, the peak device bytes a
pipeline needs at once, and :func:`admission_floor_bytes`, the least it
can degrade to (one slab for a stream).  A codec armed on a stream
counts its wire bytes, as the executor leases them.

Not ported yet (ROADMAP A11): the abstract pipeline checker
(``check``/``explain`` with its BLT0xx diagnostics, among them the
BLT010 admission and BLT015 batching forecasts), ``strict`` and the
repository linters.
"""

from bolt_tpu_torch.analysis.check import (admission_floor_bytes,
                                           working_set_bytes)

__all__ = ["working_set_bytes", "admission_floor_bytes"]
