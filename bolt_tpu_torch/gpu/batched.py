"""Batched terminal programs: continuous micro-batching for the serve
queue.

Port of ``bolt_tpu/tpu/batched.py``.  A service under heavy traffic is
mostly many small pipelines of one shape, where the cost of each
request's dispatch, not its bytes, is the limit.  This module gives the
lazy terminals a batched form the scheduler (``bolt_tpu_torch.serve``)
dispatches once for W queued requests:

* :func:`batch_key`: the coalescing identity of a submitted pipeline.
  The same deferred structure (map chain and terminal slots), base shape
  and dtype, split and device hash equal; any difference keeps requests
  apart.  It covers the lazy stat terminals (single, and stat groups),
  the deferred ``reduce(func)`` (``multistat.defer_reduce``, open while
  batching is armed) and the materialisation of a deferred chain.
* :func:`claim` / :func:`dispatch` / :func:`unclaim`: one batched
  execution.  The requests' stat groups are CLAIMED (a concurrent reader
  waits on the claim event instead of dispatching twice; new members are
  declined), ONE engine program ``("batched", key, bucket)`` runs the
  standalone terminal's own body over every request's base (the shared
  bodies of ``gpu/array.py``: ``_chain_group_lanes``, ``_reduce_body``,
  ``_chain_values``), and each lane's results go back to its request.
  Where the reference vmaps its terminal (a Pallas kernel gains a batch
  axis), a compiled ``sum`` here runs every lane in ONE
  ``fused_map_reduce_lanes`` launch, each lane on its standalone plan;
  the other terminals run the standalone body once a lane inside the
  batched program (a torch reduction of a stacked tensor may split its
  sum otherwise than each lane's own call, so it is not stacked).  Every
  lane equals its standalone dispatch bit for bit.
* **bucketed widths**: a partial batch takes the next bucket (powers of
  two up to the policy's ``max_batch``) as its engine key, so steady state
  builds nothing new (:func:`warm` builds the buckets ahead); pad lanes
  are not computed.

Donating pipelines never batch (a batched program reads every base, and
a consumed base serves one terminal), and streams batch per slab in their
own executor, not here.  The serve layer records one
``batched_dispatches``/``batched_requests`` pair per coalesced dispatch
and the ``serve.batch_occupancy.hist`` histogram.
"""

import math
import os
import threading

from bolt_tpu_torch import _lockdep
from bolt_tpu_torch import engine as _engine
from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.utils import prod

# ---------------------------------------------------------------------
# policy defaults (serve.BatchPolicy reads these)
# ---------------------------------------------------------------------

# the widest coalesced dispatch
DEFAULT_MAX_BATCH = max(2, int(os.environ.get("BOLT_SERVE_MAX_BATCH",
                                              "16")))
# seconds a worker lingers to FILL a batch once its gather found a
# partner; a lone request never lingers
DEFAULT_LINGER = float(os.environ.get("BOLT_SERVE_LINGER", "0.002"))


def buckets_for(max_batch):
    """The batch widths for ``max_batch``: powers of two up to it, and
    ``max_batch`` itself when it is not one."""
    max_batch = int(max_batch)
    if max_batch < 2:
        raise ValueError("max_batch must be >= 2, got %d" % max_batch)
    out, b = set(), 2
    while b <= max_batch:
        out.add(b)
        b *= 2
    out.add(max_batch)
    return tuple(sorted(out))


def bucket_width(n, buckets):
    """The smallest bucket that fits ``n`` requests (``bucket - n`` lanes
    are padding)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def autotune_buckets(hist_buckets, max_batch, min_share=0.05):
    """A bucket set from an OBSERVED batch-occupancy histogram (the
    ``[(upper_bound, count)]`` pairs of ``serve.batch_occupancy.hist``).
    Each log2 band ``[2^e, 2^(e+1))`` holding at least ``min_share`` of
    the observations gives both its edges as widths (clamped to ``[2,
    max_batch]``): the lower edge serves the band's exact powers with no
    padding, the upper edge the rest of the band.  ``max_batch`` always
    closes the set.  ``None`` when the histogram holds no observation."""
    total = sum(c for _, c in hist_buckets)
    if not total:
        return None
    mb = int(max_batch)
    out = {mb}
    for ub, cnt in hist_buckets:
        if not cnt or cnt / total < min_share:
            continue
        if not math.isfinite(ub):
            out.add(mb)                 # overflow band: max_batch only
            continue
        out.add(min(mb, max(2, int(ub))))        # the band's upper edge
        out.add(min(mb, max(2, int(ub) // 2)))   # ...and its lower edge
    return tuple(sorted(out))


# ---------------------------------------------------------------------
# arming (reduce()'s lazy door reads this; each batching server arms)
# ---------------------------------------------------------------------

_ARMED = 0
_ARM_LOCK = _lockdep.lock("batched.arm")


def arm():
    """Arm the batching doors (``serve.Server`` with a batching policy;
    nests across servers)."""
    global _ARMED
    with _ARM_LOCK:
        _ARMED += 1


def disarm():
    global _ARMED
    with _ARM_LOCK:
        _ARMED = max(0, _ARMED - 1)


def armed():
    """True while at least one batching server lives: the gate
    ``multistat.defer_reduce`` reads."""
    return _ARMED > 0


# ---------------------------------------------------------------------
# the batch key
# ---------------------------------------------------------------------

def _group_slots(g):
    """A stat group's program slots (deduplicated and sorted as its
    program's), or the reduce slot of a deferred reduce."""
    from bolt_tpu_torch.gpu.multistat import _slot
    ms = g.live_members()
    if g.rfunc is not None:
        m = ms[0] if ms else None
        return (("reduce", None if m is None else m.axes,
                 None if m is None else m.keepdims, None),)
    if len(ms) == 1:
        return _slot(ms[0])
    return tuple(sorted({s for m in ms for s in _slot(m)}, key=repr))


def batch_key(arr):
    """The coalescing identity of a submitted pipeline, or ``None`` when
    it cannot batch.  Requests with equal keys share one batched
    dispatch: the same terminal slots, the same map chain (callable
    identity: hoist stage functions), the same base shape and dtype, split
    and device.  Not eligible: donating chains, streams, pending filters
    and resolved handles."""
    from bolt_tpu_torch.gpu.array import BoltArrayGPU, _chain_donate_ok
    if not isinstance(arr, BoltArrayGPU) or arr._donated:
        return None
    h = arr._spending
    if h is not None:
        if h.result is not None:
            return None
        g = h.group
        if g.kind != "chain" or g.donate or g.dispatched or g.base is None:
            return None
        base = g.base
        return ("stat", _group_slots(g), g.funcs, g.rfunc,
                tuple(base.shape), str(base.dtype), g.split, g.device)
    if (arr._chain is not None and arr._concrete is None
            and arr._fpending is None and arr._stream is None
            and arr._stat_group is None):
        # a deferred map chain whose submitted terminal is its
        # materialisation (serve resolves it through .cache())
        if _chain_donate_ok(arr._chain):
            return None
        base, funcs = arr._chain
        if not funcs:
            return None
        return ("chain", funcs, tuple(base.shape), str(base.dtype),
                arr._split, arr._device)
    return None


# ---------------------------------------------------------------------
# claim / dispatch / unclaim
# ---------------------------------------------------------------------

class _Batch:
    """One claimed batched execution: the requests and the geometry the
    program closes over (never a tensor)."""

    __slots__ = ("kind", "key", "arrs", "groups", "slots", "funcs",
                 "rfunc", "split", "shape", "dtype", "device", "bases")

    def __init__(self, kind, key, arrs, groups, slots, funcs, rfunc, split,
                 shape, dtype, device, bases):
        self.kind = kind
        self.key = key
        self.arrs = arrs
        self.groups = groups
        self.slots = slots
        self.funcs = funcs
        self.rfunc = rfunc
        self.split = split
        self.shape = shape          # the mapped (result-of-chain) shape
        self.dtype = dtype          # ...and numpy dtype
        self.device = device
        self.bases = bases


def _claim_group(g, slots):
    """Claim one stat group for a batched fill; False when it raced away
    (resolved or claimed concurrently, or a sibling joined since
    submit)."""
    with g.lock:
        if g.dispatched or g.claimed or g.base is None:
            return False
        if _group_slots(g) != slots:
            return False
        g.claimed = True
        if g.claim_event is None:
            g.claim_event = threading.Event()
        else:
            g.claim_event.clear()
        return True


def _unclaim_group(g):
    with g.lock:
        g.claimed = False
        ev = g.claim_event
    if ev is not None:
        ev.set()


def claim(arrs, key):
    """Claim the requests ``arrs`` (sharing ``key``) for one batched
    dispatch; a :class:`_Batch` over the claimable subset: a member that
    raced away (its group resolved, a sibling joined, its base was
    donated) is dropped and dispatches standalone in the caller's
    adoption loop.  ``None`` when fewer than two members remain."""
    kind = key[0]
    if kind == "stat":
        slots = key[1]
        kept, groups = [], []
        for a in arrs:
            h = a._spending
            g = h.group if h is not None else None
            if g is None or h.result is not None or \
                    not _claim_group(g, slots):
                continue               # raced away: the standalone path
            kept.append(a)
            groups.append(g)
        if len(kept) < 2:
            for cg in groups:
                _unclaim_group(cg)
            return None
        g0 = groups[0]
        return _Batch("stat", key, kept, groups, slots, g0.funcs, g0.rfunc,
                      g0.split, g0.shape, g0.dtype, g0.device,
                      [g.base for g in groups])
    kept = [a for a in arrs if a._chain is not None and not a._donated]
    if len(kept) < 2:
        return None
    a0 = kept[0]
    return _Batch("chain", key, kept, None, None, a0._chain[1], None,
                  a0._split, a0._shape, a0._dtype, a0._device,
                  [a._chain[0] for a in kept])


def unclaim(batch):
    """Release a claimed batch WITHOUT filling it (the dispatch failed or
    was abandoned): its groups resolve standalone."""
    if batch.groups is not None:
        for g in batch.groups:
            _unclaim_group(g)


def _program(kind, slots, funcs, rfunc, split, shape, dtype):
    """The batched program: the standalone terminal's body over each
    lane's base, as a list of per-lane result tuples."""
    from bolt_tpu_torch.gpu import array as _array
    if kind == "stat" and rfunc is not None:
        (_, _, keepdims, _), = slots
        n = prod(shape[:split])
        vshape = tuple(shape[split:])

        def run(*bases):
            return [(_array._reduce_body(b, rfunc, funcs, split, n, vshape,
                                         keepdims),) for b in bases]
    elif kind == "stat":
        def run(*bases):
            return _array._chain_group_lanes(list(bases), funcs, split,
                                             shape, dtype, slots)
    else:
        def run(*bases):
            return [(_array._chain_values(b, funcs, split, shape, dtype),)
                    for b in bases]
    return run


def dispatch(batch, buckets, record=True):
    """Run ONE batched program for every request of ``batch`` and give
    each lane's results to its request: stat and reduce members filled
    under their group locks (waiting readers wake), a chain request
    adopting its materialised result.  Engine-keyed as ``("batched", key,
    bucket)``, so steady state calls built programs only.  ``record``
    counts the dispatch as realised coalescing (``warm`` does not)."""
    from bolt_tpu_torch.gpu import ufuncs
    from bolt_tpu_torch.gpu.multistat import _slot
    n = len(batch.arrs)
    bw = bucket_width(n, buckets)
    kind, slots, rfunc = batch.kind, batch.slots, batch.rfunc
    fn = _engine.get(("batched", batch.key, bw),
                     lambda: _program(kind, slots, batch.funcs, rfunc,
                                      batch.split, batch.shape, batch.dtype))
    sp = _obs.begin("serve.batched_dispatch", width=n, bucket=bw,
                    kind=kind)
    try:
        outs = fn(*batch.bases)
    finally:
        _obs.end(sp)
    if record:
        _engine.record_batched(n)
    if kind == "stat":
        index = {s: j for j, s in enumerate(slots)}
        for lane, g in zip(outs, batch.groups):
            with g.lock:
                for m in g.live_members():
                    if rfunc is not None:
                        m.result = lane[0]
                    elif m.name == "ptp":
                        mx, mn = (lane[index[s]] for s in _slot(m))
                        m.result = ufuncs.binary("subtract", mx, mn)
                    else:
                        m.result = lane[index[_slot(m)[0]]]
                g.retire()
                ev = g.claim_event
            if ev is not None:
                ev.set()                # wake readers parked in resolve
    else:
        for a, lane in zip(batch.arrs, outs):
            a._adopt_materialised(lane[0])
    return n


def warm(make, buckets=None, max_batch=None, policy=None):
    """Build the batched programs at every bucket width for the batch key
    of ``make()``'s pipeline: each width dispatches one throwaway batch of
    fresh ``make()`` pipelines (not counted as realised coalescing), so a
    serving steady state builds nothing new whatever widths it fills.
    Returns the warmed widths.  ``policy=`` re-arms an autotuning
    :class:`~bolt_tpu_torch.serve.BatchPolicy` from the observed
    occupancy first (``policy.rearm()``); a static policy passes
    through."""
    if policy is not None:
        policy.rearm()
        bks = tuple(policy.buckets)
    elif buckets:
        bks = tuple(buckets)
    else:
        bks = buckets_for(
            max_batch if max_batch is not None else DEFAULT_MAX_BATCH)
    warmed = []
    for bw in bks:
        arrs = [make() for _ in range(bw)]
        key = batch_key(arrs[0])
        if key is None:
            raise ValueError(
                "warm(): make() built a pipeline that cannot batch "
                "(no batch key — see batched.batch_key)")
        b = claim(arrs, key)
        if b is None:
            raise RuntimeError("warm(): could not claim the throwaway "
                               "warm pipelines")
        dispatch(b, (bw,), record=False)
        warmed.append(bw)
    return tuple(warmed)
