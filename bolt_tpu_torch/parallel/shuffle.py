"""The out-of-core shuffle planner: slab-wise re-axis for a streamed
``swap``.

Port of ``bolt_tpu/parallel/shuffle.py``, single-process.  A ``swap``
recorded on a streamed source resolves in two phases
(``stream.resolve_swaps``):

* **phase 1 (re-bucket)**: every input slab streams up through the
  uploader pool, and one program per slab geometry decodes it (when a
  codec is armed), applies the stages recorded before the swap and
  permutes it: that slab's share of the output, the full new-key extent
  with the slab's records along axis ``j0 = perm.index(0)``, where the
  old record axis lands.  On one card this is a view; nothing crosses
  devices;
* **phase 2 (re-assemble)**: the permuted slabs are either copied into
  one output tensor (RESIDENT, when the output fits the budget) or cut
  into buckets of ``out_block`` new-key records that SPILL to files,
  which a fresh callback source then streams through the same executor
  as any other source.

A transpose moves bytes and never rounds, and phase 1 applies the same
stage bodies and the same ``permute`` as the materialised swap, so a
streamed swap equals the materialised one bit for bit, resident or
spilled.  The reference's pod form (one ``all_to_all`` per slab) waits
for the port's pods (ROADMAP A12).
"""

import numpy as np

from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.utils import prod


class ShufflePlan:
    """The static description of one streamed-swap resolution.

    ``resident`` is the phase-2 decision: keep every permuted slab on the
    device in one output tensor (True), or spill bucket files and stream
    them again (False)."""

    __slots__ = ("in_shape", "dtype", "split", "perm", "new_split",
                 "out_shape", "j0", "slab", "nslabs", "out_block",
                 "nbuckets", "total_bytes", "slab_bytes", "budget",
                 "resident", "spill_dir")

    def __init__(self, **kw):
        for name in self.__slots__:
            setattr(self, name, kw[name])

    def describe(self):
        """One-line summary of the plan."""
        mb = 1024.0 * 1024.0
        mode = "resident" if self.resident else (
            "spill to %s" % (self.spill_dir or "<no spill dir>"))
        return ("shuffle plan: %d slab%s -> %s (%.1f MiB working set, "
                "budget %s, %d bucket%s x %d records)"
                % (self.nslabs, "s" if self.nslabs != 1 else "", mode,
                   self.total_bytes / mb,
                   ("%.1f MiB" % (self.budget / mb))
                   if self.budget is not None else "unbounded",
                   self.nbuckets, "s" if self.nbuckets != 1 else "",
                   self.out_block))


def _pick_out_block(extent, target_rows, mult=1):
    """Largest divisor of ``extent`` that is a multiple of ``mult`` and no
    larger than ``target_rows``: the phase-2 bucket extent.  The smallest
    valid divisor when none fits under the target; ``None`` when no
    divisor is a multiple of ``mult``."""
    mult = max(1, int(mult))
    divisors = [d for d in range(1, extent + 1)
                if extent % d == 0 and d % mult == 0]
    if not divisors:
        return None
    under = [d for d in divisors if d <= max(target_rows, 1)]
    return under[-1] if under else divisors[0]


def plan_shuffle(staged_shape, dtype, split, perm, new_split, slab, budget,
                 spill_dir):
    """Plan one streamed-swap resolution over the geometry AFTER the
    stages recorded before the swap: ``staged_shape``/``dtype``/``split``
    are what the permutation sees; ``perm``/``new_split`` are the swap's
    permutation as ``gpu/array.py :: _do_swap`` builds it; ``slab`` the
    input records per slab; ``budget`` the resident ceiling in bytes
    (``None``: unbounded, always resident); ``spill_dir`` where bucket
    files would land."""
    staged_shape = tuple(int(s) for s in staged_shape)
    perm = tuple(int(p) for p in perm)
    out_shape = tuple(staged_shape[p] for p in perm)
    itemsize = np.dtype(dtype).itemsize
    total_bytes = prod(out_shape) * itemsize
    n = staged_shape[0]
    nslabs = max(1, -(-n // max(slab, 1)))
    slab_bytes = min(slab, n) * prod(staged_shape[1:]) * itemsize
    # buckets tile the new leading key axis exactly, each about one
    # input slab of bytes
    out_n = out_shape[0]
    target = max(1, slab_bytes // max(prod(out_shape[1:]) * itemsize, 1))
    out_block = _pick_out_block(out_n, target) or out_n
    resident = budget is None or total_bytes + slab_bytes <= budget
    return ShufflePlan(
        in_shape=staged_shape, dtype=np.dtype(dtype), split=int(split),
        perm=perm, new_split=int(new_split), out_shape=out_shape,
        j0=perm.index(0), slab=int(slab), nslabs=int(nslabs),
        out_block=int(out_block), nbuckets=int(out_n // out_block),
        total_bytes=int(total_bytes), slab_bytes=int(slab_bytes),
        budget=None if budget is None else int(budget),
        resident=bool(resident), spill_dir=spill_dir)


def rebucket_program(plan, pre_stages, codec_obj, raw_dtype, raw_slab_shape,
                     delta_ok, device):
    """The phase-1 program of an input slab of ``raw_slab_shape`` (wire
    shape under a codec): decode, the pre-swap stages, the swap's
    ``permute``.  It takes the uploaded parts (the wire block, then its
    sidecars) and returns the slab's permuted block, a view of the
    staged slab.  One engine program per slab geometry."""
    split, perm = plan.split, plan.perm
    key = ("stream-shuffle", pre_stages, tuple(raw_slab_shape),
           str(np.dtype(raw_dtype)), split, perm, plan.new_split,
           codec_obj.name if codec_obj is not None else None, device)

    def build():
        from bolt_tpu_torch.gpu.dtypes import torch_dtype
        from bolt_tpu_torch.stream import _stage_apply
        tdt = torch_dtype(raw_dtype)

        def run(parts):
            if codec_obj is None:
                x = parts[0]
            else:
                x = codec_obj.decode(parts[0], parts[1:], tdt, delta_ok)
            for stg in pre_stages:
                x = _stage_apply(stg, split, x)
            return x.permute(perm)
        return run

    return _engine.get(key, build)


def concat_program(plan, part_shape, device):
    """The resident phase 2 for one permuted slab of ``part_shape``: copy
    it into the output at its records' offset along ``plan.j0`` (the
    output is allocated once, so the parts never live beside it)."""
    key = ("stream-shuffle-concat", tuple(part_shape), str(plan.dtype),
           plan.j0, plan.new_split, device)

    def build():
        j0 = plan.j0

        def run(out, part, lo):
            out.narrow(j0, lo, part.shape[j0]).copy_(part)
        return run

    return _engine.get(key, build)
