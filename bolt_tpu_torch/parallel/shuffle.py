"""The out-of-core shuffle planner: slab-wise re-axis for a streamed
``swap``.

Port of ``bolt_tpu/parallel/shuffle.py``.  A ``swap`` recorded on a
streamed source resolves in two phases (``stream.resolve_swaps``):

* **phase 1 (re-bucket)**: every input slab streams up through the
  uploader pool, and one program per slab geometry decodes it (when a
  codec is armed), applies the stages recorded before the swap and
  permutes it: that slab's share of the output, the full new-key extent
  with the slab's records along axis ``j0 = perm.index(0)``, where the
  old record axis lands.  On one card this is a view; nothing crosses
  devices.  On a pod each rank permutes its own rows of the slab, and
  ONE ``multihost.all_to_all`` per slab (:class:`PodShuffle`) sends
  every rank of the record axis's group the new-key rows of its output
  box, which it concatenates along ``j0`` in record order;
* **phase 2 (re-assemble)**: the permuted slabs are either copied into
  one output tensor (RESIDENT, when the output fits the budget) or cut
  into buckets of ``out_block`` new-key records that SPILL to files,
  which a fresh callback source then streams through the same executor
  as any other source.

A transpose moves bytes and never rounds, and phase 1 applies the same
stage bodies and the same ``permute`` as the materialised swap, so a
streamed swap equals the materialised one bit for bit, resident or
spilled, on one card or a pod.  A pod shuffle is resident only: a
spilled bucket would be owned by one rank, while a pod slab must be
split across the ranks.
"""

import numpy as np
import torch

from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.parallel import multihost, sharding
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
                 spill_dir, mesh=None):
    """Plan one streamed-swap resolution over the geometry AFTER the
    stages recorded before the swap: ``staged_shape``/``dtype``/``split``
    are what the permutation sees; ``perm``/``new_split`` are the swap's
    permutation as ``gpu/array.py :: _do_swap`` builds it; ``slab`` the
    input records per slab; ``budget`` the resident ceiling in bytes
    (``None``: unbounded, always resident); ``spill_dir`` where bucket
    files would land.  On a pod (``mesh`` of more than one rank) the new
    leading key extent must divide by the rank count (the reference's
    pointed refusal, raised here before any thread starts)."""
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
    nproc = multihost.mesh_process_count(mesh)
    if nproc > 1 and out_n % nproc != 0:
        raise ValueError(
            "streamed swap on a %d-process pod needs the new leading key "
            "extent (%d) divisible by the process count — repartition or "
            "materialise the swap instead" % (nproc, out_n))
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


class PodShuffle:
    """The pod half of one streamed-swap resolution: the output's key
    layout, this rank's output box, and the group of ranks along the mesh
    axes the input record axis is sharded over.  :meth:`exchange` turns
    this rank's permuted share of a slab into its output rows of the
    whole slab by ONE ``multihost.all_to_all``.

    The geometry checks are the reference's (``_pod_axes_or_refuse``):
    the new leading key axis must come from a value axis (a key axis
    moving to the front has a per-rank layout this exchange does not
    redraw), and the output's leading key axis must be sharded over the
    same mesh axes as the input record axis (the exchange splits the new
    record extent over the ranks it gathers the old one from).  The
    port's exchange also needs the output's other axes whole on every
    rank; a swap that keeps the record axis leading re-lays every record
    out and is not recorded on a pod at all (``stream.swap_stage``)."""

    def __init__(self, mesh, plan, slab_rows):
        perm, split = plan.perm, plan.split
        staged = (slab_rows,) + tuple(plan.in_shape[1:])
        in_spec = sharding.key_spec(mesh, staged, split)
        axes_in = sharding.spec_names(in_spec[0])
        out_spec = sharding.key_spec(mesh, plan.out_shape, plan.new_split)
        axes_out = sharding.spec_names(out_spec[0])
        if perm[0] < split:
            raise ValueError(
                "streamed swap on a pod needs the new leading key axis to "
                "come from a value axis or stay the record axis; key axis "
                "%d moving to the front has per-process layout this "
                "executor does not reshard — materialise the swap instead"
                % (perm[0],))
        if axes_in != axes_out or any(e is not None for e in out_spec[1:]):
            raise ValueError(
                "streamed swap on a pod needs the output key sharding to "
                "reuse the input record axis's mesh axes (got %r -> %r); "
                "materialise the swap instead"
                % (axes_in, tuple(out_spec)))
        self.plan = plan
        self.out_spec = out_spec
        self.out_box = sharding.box(mesh, out_spec, plan.out_shape)
        ranks = mesh.group_ranks(axes_in)
        # the group in record order: by each rank's first input row
        self.ranks = sorted(ranks, key=lambda q: sharding.box(
            mesh, in_spec, staged, q)[0][0])
        self.rows = {q: sharding.box(mesh, out_spec, plan.out_shape,
                                     q)[0] for q in self.ranks}
        self.me = mesh.rank

    def exchange(self, y):
        """This rank's output rows of one slab from its permuted share
        ``y`` (the full new leading extent, its own records along
        ``j0``): each rank of the group is sent its rows, and the shares
        received come back concatenated along ``j0`` in record order."""
        j0 = self.plan.j0
        world = multihost.process_count()
        empty = torch.empty(0, dtype=torch.uint8, device=y.device)
        sends, sizes = [empty] * world, [0] * world
        lo, hi = self.rows[self.me]
        shape = (hi - lo,) + tuple(y.shape[1:])
        nbytes = prod(shape) * y.element_size()
        for q in self.ranks:
            qlo, qhi = self.rows[q]
            if q != self.me:
                sends[q] = multihost._as_bytes(y.narrow(0, qlo, qhi - qlo))
                sizes[q] = nbytes
        got = multihost.all_to_all(sends, sizes, y.device)
        parts = [y.narrow(0, lo, hi - lo) if q == self.me else
                 multihost._from_bytes(got[q], y.dtype, shape)
                 for q in self.ranks]
        return torch.cat(parts, dim=j0)


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
