"""Abstract pipeline checker: interpret a deferred pipeline without
building or launching anything (port of ``bolt_tpu/analysis/check.py``).

:func:`check` walks an array's recorded state — the ``_chain`` map
chain, a pending ``_fpending`` filter, a pending stat (``_spending``) or
a stream's stages — and evaluates it stage by stage on ``device="meta"``
tensors (no memory, no data, no kernel), predicting the result shape,
dtype and key split per stage and emitting the structured ``BLT0xx``
diagnostics of :mod:`bolt_tpu_torch.analysis.diagnostics`:

* a stage that fails on its meta input (``BLT001``: the terminal would
  raise the same error, a callable bug as its ``TypeError``);
* a recorded result shape or dtype that contradicts the chain
  (``BLT002``);
* silent dtype widening along the chain (``BLT003``);
* a donated buffer on the read path (``BLT005``), and the donation the
  next terminal WILL take (``BLT006``);
* a filter predicate that is not scalar per record (``BLT007``) and a
  dynamic shape pending a survivor count (``BLT008``);
* the stat group's single-pass forecast (``BLT009``), the serving
  admission budget (``BLT010``), a one-shot iterator under checkpointing
  (``BLT011``), a pod stream's slab the key-axis assignment does not
  divide (``BLT012``), batch eligibility (``BLT015``), codec-encoded
  ingest (``BLT016``, with the sidecar codec's refusal on a pod) and the
  streamed shuffle's plan (``BLT017``).

On a mesh (``gpu/mesharray.py``) the check walks this rank's box as the
single-device checker does (each stage's spec is the rank's box) and adds
``BLT004`` when the key sharding leaves ranks idle.  A pod stream's
source stage notes every rank's rows of a slab and its recovery plan
(the liveness watch's cadence and deadline, the resume topology, and
the supervised contract when a ``parallel.supervisor`` is installed);
``BLT013`` flags a pod stream with no recovery path (no checkpoint
directory, or a sub-pod mesh) and ``BLT014`` a supervised pod stream
whose ``fromiter`` source a rejoined rank cannot re-ingest.

Each map stage evaluates through the terminals' own
``gpu/array.py :: _chain_apply`` (and so ``_user_call``, with its
``CarrierMode`` rerun of callables torch has no unsigned kernel for),
each stream stage through ``stream.stage_aval`` (``_stage_apply``), and
a predicate through ``filter``'s own ``_infer_pred``, all memoised in
``gpu/array.py``'s shape-inference cache: predicted and executed shape
and dtype cannot drift.  Checking allocates nothing on the device and
leaves the engine's build and launch counters flat.

Beside the checker live the working-set estimates admission control
reads (:func:`working_set_bytes`, :func:`admission_floor_bytes`).  Nothing
here imports the serving layer: its state is read through
``sys.modules``.
"""

import sys

import numpy as np

from bolt_tpu_torch.utils import prod


from bolt_tpu_torch.obs import trace as _obs
from bolt_tpu_torch.analysis.diagnostics import Diagnostic, Report, Stage


def _name(func):
    return getattr(func, "__name__", None) or type(func).__name__


def _func_label(func):
    from bolt_tpu_torch.gpu.array import _WithKeysFunc
    if isinstance(func, _WithKeysFunc):
        return "map(%s, with_keys)" % _name(func.func)
    return "map(%s)" % _name(func)


def _np(dtype):
    """The numpy dtype of torch ``dtype`` (the torch dtype itself where
    numpy has none, bfloat16)."""
    from bolt_tpu_torch.gpu.array import numpy_dtype
    try:
        return numpy_dtype(dtype)
    except TypeError:
        return dtype


def _fmt_bytes(n):
    if n >= 1 << 30:
        return "%.1f GB" % (n / float(1 << 30))
    if n >= 1 << 20:
        return "%.1f MB" % (n / float(1 << 20))
    return "%d B" % n


def _first_line(exc):
    first = str(exc).splitlines()[0] if str(exc) else ""
    return "%s%s" % (type(exc).__name__, ": " + first if first else "")


def _stage_eval(func, split, aval):
    """One chain stage on the meta tensor ``aval``: the terminals' own
    ``_chain_apply``, memoised in ``gpu/array.py``'s shape-inference
    cache (keyed on the callable and the input's shape and dtype)."""
    from bolt_tpu_torch.gpu.array import (_cached_eval_shape, _chain_apply,
                                          _meta)
    shape, dtype = tuple(aval.shape), aval.dtype
    return _cached_eval_shape(
        ("analysis-stage", func, split, shape, str(dtype)),
        lambda: _chain_apply((func,), split, _meta(shape, dtype)))


def _would_donate(arr):
    """Would the NEXT terminal take this array's chain base?  The
    terminals' own ``_chain_donate_ok``, asked with the same reference
    pattern (the attribute straight into the call, no local bound to the
    base: the ownership test counts references)."""
    from bolt_tpu_torch.gpu.array import _chain_donate_ok
    if arr._fpending is not None:
        return _chain_donate_ok(arr._fpending)
    if arr.deferred:
        return _chain_donate_ok(arr._chain)
    return False


# ---------------------------------------------------------------------
# the serving layer's forecasts (BLT010, BLT015), read through
# sys.modules so checking never imports serving
# ---------------------------------------------------------------------

def _admission_budget():
    """The active serving arbiter's byte budget, or None."""
    sv = sys.modules.get("bolt_tpu_torch.serve")
    if sv is None:
        return None
    arb = sv.device_arbiter()
    return arb.budget if arb is not None else None


def _note_admission(est, idx, diags):
    """``BLT010``: the pipeline's least device working set exceeds the
    serving budget, so ``serve.submit`` rejects it."""
    budget = _admission_budget()
    if budget is None or est is None or est <= budget:
        return
    diags.append(Diagnostic(
        "BLT010", idx,
        "minimum device working set ~%s exceeds the serving admission "
        "budget %s even fully degraded; serve.submit will reject this "
        "pipeline" % (_fmt_bytes(int(est)), _fmt_bytes(int(budget))),
        hint="shrink the operand or streaming slabs "
             "(fromcallback(chunks=...)), or start the server with a "
             "larger budget_bytes"))


def _batch_note(arr):
    """``BLT015``'s message when a batching server is active and
    ``arr`` carries a batch key (``gpu/batched.py :: batch_key``), else
    None.  Asked before any local holds the chain's base: the key
    refuses donating chains by counting references."""
    sv = sys.modules.get("bolt_tpu_torch.serve")
    srv = sv.active() if sv is not None else None
    pol = getattr(srv, "batching", None) if srv is not None else None
    bt = sys.modules.get("bolt_tpu_torch.gpu.batched")
    if pol is None or bt is None:
        return None
    try:
        key = bt.batch_key(arr)
    except Exception:
        return None
    if key is None:
        return None
    return ("terminal is batch-eligible (%s form): the active batching "
            "server coalesces up to %d queued same-key requests — same "
            "pipeline structure/shape/dtype/terminal, across tenants — "
            "into ONE batched dispatch at bucketed widths %s, each lane "
            "bit-identical to its standalone dispatch"
            % (key[0], pol.max_batch, tuple(pol.buckets)))


def _note_batchable(msg, idx, diags):
    if msg is not None:
        diags.append(Diagnostic(
            "BLT015", idx, msg,
            hint="submit same-shape pipelines concurrently to share one "
                 "batched program; serve.stats()['batching'] shows the "
                 "realised occupancy, batched.warm() builds the "
                 "buckets"))


# ---------------------------------------------------------------------
# stat groups (BLT009)
# ---------------------------------------------------------------------

def _note_fusable(arr, idx, diags):
    """``BLT009``: this array's source carries a live stat group, so its
    pending terminals resolve from ONE read."""
    g = getattr(arr, "_stat_group", None)
    if g is not None:
        _note_fusable_group(g, idx, diags)


def _note_fusable_group(g, idx, diags):
    if g.dispatched:
        return
    pend = [m for m in g.live_members() if m.result is None]
    if not pend:
        return
    names = ", ".join(m.name for m in pend)
    nbytes = _group_bytes(g)
    diags.append(Diagnostic(
        "BLT009", idx,
        "fusable terminal set: %d pending stat terminal(s) [%s] resolve "
        "from ONE %s pass reading ~%s (instead of %d passes / ~%s); "
        "results are bit-identical to the standalone terminals"
        % (len(pend), names, g.kind, _fmt_bytes(nbytes), len(pend),
           _fmt_bytes(nbytes * len(pend))),
        hint="read any member (or bolt.compute(...)) to dispatch the "
             "group; terminals on other sources fall back per group"))


def _check_spending(arr, target, stages, diags):
    """A pending stat array: the group's source and the terminal's
    result, plus the ``BLT009`` forecast; nothing resolves."""
    h = arr._spending
    g = h.group
    device = arr._device
    if g.kind == "stream":
        src_shape = tuple(g.source.shape)
        src_dtype = np.dtype(g.source.dtype)
        label = "stream source (%s)" % g.source.kind
    elif g.kind == "fpending":
        base = g.fpending[0]
        src_shape = tuple(base.shape)
        src_dtype = _np(base.dtype)
        label = "filtered chain base"
    else:
        src_shape = tuple(g.base.shape)
        src_dtype = _np(g.base.dtype)
        label = "chain base" if g.funcs else "base (concrete)"
    stages.append(Stage(0, label, src_shape, src_dtype, g.split, device))
    stages.append(Stage(
        1, "%s() [pending stat]" % h.name, tuple(h.shape),
        np.dtype(h.dtype), h.new_split, device,
        note="terminal of a %d-member fused group, not yet dispatched"
             % len(g.live_members())))
    _note_fusable_group(g, 1, diags)
    _note_batchable(_batch_note(arr), 1, diags)
    _note_admission(_stream_slab_bytes(g.source) if g.kind == "stream"
                    else _group_bytes(g), 1, diags)
    if g.kind == "stream":
        _note_codec(g.source, 1, diags,
                    members=[m.name for m in g.live_members()])
    return Report(target + ", pending stat", stages, diags)


# ---------------------------------------------------------------------
# streams (BLT011, BLT016, BLT017)
# ---------------------------------------------------------------------

def _note_codec(src, idx, diags, members=()):
    """``BLT016``: the bytes a codec-encoded stream will not move over
    the host-to-device link, or a WARNING when a lossy codec meets an
    order statistic (the executor refuses it) or a dtype the codec
    cannot encode."""
    c = _effective_codec(src)
    if c is None:
        return
    if src.mesh is not None:
        from bolt_tpu_torch.parallel import multihost
        err = multihost.sidecar_codec_error(c, src.mesh)
        if err is not None:
            diags.append(Diagnostic(
                "BLT016", idx, "the streamed run will refuse it: " + err,
                severity="warning",
                hint="use a sidecar-free codec ('bf16', 'f16', "
                     "'delta-f32') on a pod, or stream uncompressed"))
            return
    raw = int(prod(src.shape) * src.dtype.itemsize)
    try:
        wire = int(prod(src.shape) * c.wire_dtype(src.dtype).itemsize)
    except ValueError as exc:
        diags.append(Diagnostic(
            "BLT016", idx,
            "codec %r cannot encode this %s pipeline — the streamed "
            "run will refuse pointedly: %s"
            % (c.name, np.dtype(src.dtype), str(exc).splitlines()[0]),
            severity="warning",
            hint="pick a codec that supports the dtype, or stream "
                 "uncompressed"))
        return
    sensitive = sorted({m for m in members if m in ("min", "max",
                                                    "ptp")})
    if not c.lossless and sensitive:
        diags.append(Diagnostic(
            "BLT016", idx,
            "lossy codec %r meets the bit-exactness-sensitive order "
            "statistic(s) %s — the streamed run will refuse them "
            "(a quantised extremum is never the intended answer)"
            % (c.name, sensitive), severity="warning",
            hint="use the lossless 'delta-f32' codec for order stats, "
                 "or resolve them over an uncompressed source"))
        return
    diags.append(Diagnostic(
        "BLT016", idx,
        "codec-encoded ingest (%s%s): one full pass ships ~%s on the "
        "wire instead of ~%s (%.2fx)%s"
        % (c.name, "" if c.lossless else ", LOSSY opt-in",
           _fmt_bytes(wire), _fmt_bytes(raw),
           (wire / raw) if raw else 1.0,
           " — lossless: bit-identical to uncompressed streaming"
           if c.lossless else ""),
        hint="uploader workers encode per slab (codec_bytes_raw/"
             "codec_bytes_wire engine counters); the slab program "
             "decodes on the card fused into the fold, and the arbiter "
             "leases the wire bytes"))


def _note_shuffle(src, stage, aval, split, idx, diags):
    """``BLT017``: the streamed shuffle's plan, from the planner the
    executor runs (``parallel/shuffle.py :: plan_shuffle``) with the
    budget and spill directory it resolves (``stream.swap_budget()``,
    ``stream.spill_scope()``), so forecast and dispatch cannot drift.
    WARNING when the plan spills with no spill directory (the executor
    refuses)."""
    from bolt_tpu_torch import stream as _stream
    from bolt_tpu_torch.parallel import shuffle as _shuffle
    perm, new_split = stage[1], stage[2]
    spill_dir = _stream.spill_scope()[0]
    try:
        plan = _shuffle.plan_shuffle(
            tuple(aval.shape), _np(aval.dtype), split, perm, new_split,
            src.slab, _stream.swap_budget(), spill_dir)
    except ValueError as exc:
        diags.append(Diagnostic(
            "BLT017", idx,
            "the streamed shuffle refuses this swap — the run will "
            "raise identically at dispatch: %s"
            % str(exc).splitlines()[0], severity="warning",
            hint="materialise first (toarray) and swap in memory"))
        return
    if not plan.resident and plan.spill_dir is None:
        diags.append(Diagnostic(
            "BLT017", idx,
            plan.describe() + " — but NO spill directory is "
            "configured: the executor will refuse this swap at "
            "dispatch rather than materialise silently",
            severity="warning",
            hint="wrap the run in bolt_tpu_torch.stream.spill(dir=...) "
                 "to license disk spill, or raise the budget so the "
                 "re-keyed buckets stay resident"))
        return
    diags.append(Diagnostic(
        "BLT017", idx, plan.describe(),
        hint="phase 1 re-buckets each uploaded slab on the card and %s; "
             "phase 2 streams the buckets through the standard slab "
             "machinery — bit-identical to the materialised swap "
             "(shuffle_bytes/spill_bytes engine counters)"
             % ("keeps them resident in device memory"
                if plan.resident
                else "spills them, codec-encoded, to the fingerprint "
                     "directory")))


def _note_resumable(src, idx, diags):
    """``BLT011``: checkpointing is armed (the source's ``checkpoint=``
    or a ``stream.resumable()`` scope) over a ONE-SHOT iterator, which
    dies with the process: resume is impossible."""
    ck_dir = _stream_ckpt_dir(src)
    if ck_dir is None or src.kind != "iter" or src.blocks is None:
        return
    if iter(src.blocks) is not src.blocks:
        return                      # re-iterable (a list of blocks): fine
    diags.append(Diagnostic(
        "BLT011", idx,
        "resumable checkpointing is armed (dir %r) but this fromiter "
        "source is a one-shot iterator: a killed run cannot re-stream "
        "it, so resume is impossible and the checkpoint is wasted"
        % ck_dir,
        hint="use fromcallback (random access) or pass a re-iterable "
             "block list so a restarted run can skip the already-"
             "retired slabs"))


def _stream_ckpt_dir(src):
    """The checkpoint directory a run over ``src`` would use (the
    source's ``checkpoint=`` before the thread's ``resumable()`` scope),
    or ``None``."""
    from bolt_tpu_torch import stream as _stream
    if src.ckpt is not None:
        return src.ckpt
    scope = _stream.checkpoint_scope()
    return scope[0] if scope is not None else None


def _active_supervisor():
    """The installed recovery supervisor, probed through ``sys.modules``
    so checking a pipeline never imports (or starts) the supervision
    layer."""
    import sys
    sup = sys.modules.get("bolt_tpu_torch.parallel.supervisor")
    return None if sup is None else sup.active()


def _recovery_plan(src, nproc):
    """The pod fault-tolerance plan ``explain()`` renders for a pod
    stream: the heartbeat cadence, the watchdog deadline, the topology a
    peer loss resumes on, and, with a recovery supervisor installed, the
    SUPERVISED contract (backoff budget, quarantine, the rejoin door)."""
    from bolt_tpu_torch.parallel import podwatch
    cfg = podwatch.config()
    if cfg.get("timeout"):
        hb = ("peer loss -> PeerLostError (heartbeat %.3gs, watchdog "
              "deadline %.3gs, %s transport)"
              % (cfg["interval"], cfg["timeout"], cfg["transport"]))
    else:
        hb = "watchdog OFF (BOLT_POD_TIMEOUT=0): peer loss may hang"
    ck_dir = _stream_ckpt_dir(src)
    if ck_dir is not None:
        resume = ("resume topology: reform to the survivors (<= %d "
                  "processes) and resume from %r" % (nproc - 1, ck_dir))
    else:
        resume = ("NO checkpoint dir: peer loss discards all partials "
                  "(BLT013)")
    plan = "recovery plan: %s; %s" % (hb, resume)
    sup = _active_supervisor()
    if sup is not None:
        scfg = sup.config()
        q = scfg.get("quarantine") or []
        plan += ("; SUPERVISED: auto-reform (%d retries, %.3gs "
                 "exponential backoff), rejoin door open via the %s "
                 "transport (quiesce at a slab-boundary checkpoint, "
                 "reform UP, resume bit-identically), quarantine %s"
                 % (scfg["retries"], scfg["backoff"], cfg["transport"],
                    sorted(q) if q else "empty"))
    return plan


def _note_pod_recovery(src, nproc, idx, diags):
    """``BLT013``: a pod stream with no recovery path: no checkpoint
    directory (one peer loss discards every fold partial), or a SUB-POD
    mesh (the checkpoint's barriers cover the whole pod, so
    checkpointing is refused there)."""
    if nproc <= 1:
        return
    from bolt_tpu_torch.parallel import multihost
    ck_dir = _stream_ckpt_dir(src)
    if ck_dir is None:
        diags.append(Diagnostic(
            "BLT013", idx,
            "this pipeline streams across %d processes with NO "
            "checkpoint dir: a single peer loss discards every fold "
            "partial and the whole run restarts from scratch "
            "(recovery impossible)" % nproc,
            hint="arm stream.resumable(dir) or fromcallback/fromiter "
                 "checkpoint=dir so the survivors can "
                 "multihost.reform() and resume from the last "
                 "rendezvous-consistent watermark"))
        return
    runtime = multihost.process_count()
    if runtime > 1 and nproc != runtime:
        diags.append(Diagnostic(
            "BLT013", idx,
            "this stream's mesh spans %d of the runtime's %d "
            "processes (a SUB-POD mesh): the checkpoint rendezvous "
            "barrier covers the whole runtime, so resumable "
            "checkpointing is refused and peer loss discards all "
            "partials" % (nproc, runtime),
            hint="stream the checkpointed run on a mesh covering "
                 "every process, or drop checkpoint=/resumable() for "
                 "this sub-mesh run"))


def _note_supervised_source(src, nproc, idx, diags):
    """``BLT014``: a recovery supervisor is installed (re-expansion is
    armed) and this pod stream reads a ``fromiter`` block iterable: only
    a per-process ``fromcallback`` loader lets a REJOINED process
    re-ingest its rows of the remaining slabs, so the pod cannot grow
    during this run."""
    if nproc <= 1 or src.kind != "iter" or _active_supervisor() is None:
        return
    diags.append(Diagnostic(
        "BLT014", idx,
        "automatic re-expansion is armed (a recovery supervisor is "
        "installed) but this %d-process stream reads a fromiter block "
        "iterable: a REJOINED replacement process has no way to "
        "re-ingest its shard mid-run, so the supervisor cannot grow "
        "the pod during this stream" % nproc,
        hint="use fromcallback(..., per_process=True) with a shared-"
             "storage loader (any process can then produce any shard "
             "range), or accept that re-expansion defers to the next "
             "per-process-sourced run"))


def _check_predicate(pred, vshape, vdtype, idx, diags):
    """The predicate over one record, through ``filter``'s own
    ``_infer_pred``: ``BLT001`` when it fails, ``BLT007`` when it is not
    one truth value per record.  Shared by the pending-filter and the
    stream walks."""
    from bolt_tpu_torch.gpu.array import _infer_pred
    try:
        pshape = _infer_pred(pred, tuple(vshape), vdtype)
    except Exception as exc:
        diags.append(Diagnostic(
            "BLT001", idx,
            "filter predicate %s fails abstract tracing: %s"
            % (_name(pred), _first_line(exc)),
            hint="the predicate must run over one value block"))
        return
    if prod(pshape) != 1:
        diags.append(Diagnostic(
            "BLT007", idx,
            "filter predicate %s returns shape %s per record; it must "
            "reduce each value block to ONE truth value"
            % (_name(pred), tuple(pshape)),
            hint="reduce inside the predicate, e.g. "
                 "lambda v: (v > 0).all()"))


def _pod_note(src, diags):
    """A pod stream's per-rank plan (``explain`` shows it: every rank's
    rows of a slab, and the mesh axes each slab's partial is folded
    over), and ``BLT012`` when a slab the key-axis assignment does not
    divide will be refused, with the executor's own message."""
    from bolt_tpu_torch.parallel import multihost, sharding
    mesh, split = src.mesh, src.split
    nproc = multihost.mesh_process_count(mesh)
    err = multihost.slab_divisibility_error(
        mesh, src.shape, split,
        src.slab_ranges() if src.kind == "callback" else [])
    axes = multihost.key_collective_axes(mesh, src.shape, split)
    note = ("MULTI-PROCESS: %d ranks x ~%d records/slab each (per-rank "
            "ingest, each slab's partial folded over mesh axes %s)"
            % (nproc, src.slab // nproc, axes or ("?",)))
    if err is not None:
        if err.startswith("BLT012: "):
            err = err[len("BLT012: "):]
        diags.append(Diagnostic(
            "BLT012", 0, err,
            hint="pick chunks= and key extents that are multiples of the "
                 "key-axis device assignment; uneven tails cannot stream "
                 "across processes"))
        return note
    slab = (min(src.slab, src.shape[0]),) + tuple(src.shape[1:])
    spec = sharding.key_spec(mesh, slab, split)
    rows = ", ".join("rank %d rows [%d, %d)" % ((q,) + sharding.box(
        mesh, spec, slab, q)[0]) for q in range(mesh.size))
    return note + "; of each %d-record slab: %s" % (slab[0], rows)


def _check_stream(arr, target, stages, diags):
    """A streaming plan: the source and its recorded stages, each
    through ``stream.stage_aval`` (the slab program's own bodies on
    meta tensors).  Nothing uploads, builds or streams."""
    from bolt_tpu_torch import stream as _stream
    from bolt_tpu_torch.gpu.array import _meta, torch_dtype
    src = arr._stream
    device = arr._device
    walk_split = src.split
    nslabs = -(-src.shape[0] // src.slab) if src.shape[0] else 0
    aval = _meta(src.shape, torch_dtype(src.dtype))
    note = ("out-of-core: ~%d slabs of %d records, prefetch depth %d, "
            "uploader pool %d"
            % (nslabs, src.slab, _stream.prefetch_depth(),
               _stream.pool_size(src)))
    from bolt_tpu_torch.parallel import multihost
    nproc = 1 if src.mesh is None \
        else multihost.mesh_process_count(src.mesh)
    if src.mesh is not None:
        note += "; " + _pod_note(src, diags)
    if nproc > 1:
        # what a peer's death does to this run
        note += "; " + _recovery_plan(src, nproc)
    stages.append(Stage(0, "stream source (%s)" % src.kind, src.shape,
                        np.dtype(src.dtype), walk_split, device,
                        note=note))
    _note_admission(_stream_slab_bytes(src), 0, diags)
    _note_codec(src, 0, diags)
    _note_resumable(src, 0, diags)
    _note_pod_recovery(src, nproc, 0, diags)
    _note_supervised_source(src, nproc, 0, diags)
    dynamic = False
    for i, stage in enumerate(src.stages):
        idx = i + 1
        if stage[0] == "filter":
            pred = stage[1]
            n = prod(aval.shape[:walk_split])
            vshape = tuple(aval.shape[walk_split:])
            _check_predicate(pred, vshape, aval.dtype, idx, diags)
            out_shape = (n,) + vshape
            stages.append(Stage(idx, "filter(%s) [streamed]" % _name(pred),
                                out_shape, _np(aval.dtype), 1, device,
                                dynamic=True,
                                note="survivor count pending (<= %d); "
                                     "streamed reductions fold the mask "
                                     "per slab" % n))
            diags.append(Diagnostic(
                "BLT008", idx,
                "the result shape is dynamic: at most %d records survive "
                "the predicate; streamed reduction terminals fold the "
                "mask without materialising, any other consumer "
                "materialises the whole source" % n))
            dynamic = True
            break
        label = "%s [streamed]" % _stream.stage_label(stage)
        try:
            nxt = _stream.stage_aval(stage, walk_split, aval)
        except Exception as exc:
            diags.append(Diagnostic(
                "BLT001", idx,
                "%s fails abstract tracing on input %s %s: %s"
                % (label, tuple(aval.shape), _np(aval.dtype),
                   _first_line(exc)),
                hint="the stage would fail identically inside the "
                     "per-slab program; fix the callable's shape/dtype "
                     "contract"))
            break
        if stage[0] == "swap":
            # the forecast reads the PRE-swap geometry (the planner's
            # input); later stages see the swapped split
            _note_shuffle(src, stage, aval, walk_split, idx, diags)
            walk_split = stage[2]
        old, new = aval.dtype, nxt.dtype
        if new.itemsize > old.itemsize:
            diags.append(Diagnostic(
                "BLT003", idx,
                "%s widens the pipeline dtype %s -> %s (every streamed "
                "slab costs %dx its upload size on the card)"
                % (label, _np(old), _np(new),
                   new.itemsize // old.itemsize),
                hint="keep constants in the input dtype or cast back "
                     "with map(dtype=...) if the widening is unintended"))
        aval = nxt
        stages.append(Stage(idx, label, aval.shape, _np(aval.dtype),
                            walk_split, device))
    return Report(target + ", streaming (out-of-core)", stages, diags,
                  dynamic=dynamic)


# ---------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------

def check(obj):
    """Abstractly interpret ``obj``'s recorded pipeline; returns a
    :class:`~bolt_tpu_torch.analysis.diagnostics.Report`.

    Accepts a ``BoltArrayGPU``, a ``ChunkedArray``/``StackedArray`` view
    (checked through its array) or a local array (a trivial report).
    Never builds, launches, allocates on the card, syncs a survivor
    count or resolves deferred state: ``engine.counters()`` moves only in
    the ``diagnostics`` tally this check feeds.  Each check records an
    ``analysis.check`` span on the obs timeline (inside the terminal's
    own span under :func:`~bolt_tpu_torch.analysis.strict`)."""
    with _obs.span("analysis.check") as sp:
        rep = _check_impl(obj)
        sp.set(diagnostics=len(rep.diagnostics), dynamic=rep.dynamic)
        return rep


def _check_impl(obj):
    from bolt_tpu_torch import engine
    rep = _report(obj)
    engine.record_diagnostics(len(rep.diagnostics))
    return rep


def _idle_device_check(mesh, shape, split, stage_idx, diags, seen):
    """``BLT004`` once per report: the derived key sharding leaves mesh
    ranks idle because the key extents do not divide the mesh (the
    reference's check, code, severity and message)."""
    from bolt_tpu_torch.parallel.sharding import key_spec, spec_names
    if seen or mesh is None or not split:
        return seen
    try:
        spec = key_spec(mesh, shape, split)
        names = [n for e in spec for n in spec_names(e)]
        assigned = prod([mesh.shape[n] for n in names]) if names else 1
        full = prod([mesh.shape[n] for n in mesh.axis_names
                     if mesh.shape[n] > 1])
    except Exception:       # noqa: BLE001 — malformed state: BLT002's
        return seen
    if assigned < full:
        diags.append(Diagnostic(
            "BLT004", stage_idx,
            "key axes %s assign only %d of %d mesh devices (extents do "
            "not divide the mesh %s)"
            % (tuple(shape[:split]), assigned, full, dict(mesh.shape)),
            hint="reshape the key axes (keys.reshape) or choose key "
                 "extents divisible by the mesh axis sizes"))
        return True
    return seen


def _mesh_report(arr, target):
    """A mesh array's report: this rank's box walked as a single-device
    array, each stage's spec the rank's box in global coordinates, and
    ``BLT004`` when the key sharding leaves ranks idle."""
    mesh = arr._mesh
    target = "%s, mesh %s rank %d" % (target, dict(mesh.shape), mesh.rank)
    rep = _report(arr._local)
    if arr._mfilter is not None:
        kbox, gkshape, _, _ = arr._mfilter
        key_box, shape = kbox, None
    else:
        key_box = arr.box[:arr._split]
        shape = arr._shape
    for st in rep.stages:
        st.spec = "box %s" % (tuple(key_box) + tuple(
            (0, d) for d in st.shape[len(key_box):]),)
    diags = []
    if shape is not None:
        _idle_device_check(mesh, shape, arr._split, 0, diags, False)
    return Report(target, rep.stages, diags + list(rep.diagnostics),
                  dynamic=rep.dynamic)


def _report(obj):
    from bolt_tpu_torch.gpu.array import BoltArrayGPU, _meta
    from bolt_tpu_torch.gpu.chunk import ChunkedArray
    from bolt_tpu_torch.gpu.stack import StackedArray

    target = "gpu"
    arr = obj
    if isinstance(arr, ChunkedArray):
        target = "gpu, chunked view plan=%s" % (arr.plan,)
        arr = arr._barray
    elif isinstance(arr, StackedArray):
        target = "gpu, stacked view size=%d" % arr.size
        arr = arr._barray
    if getattr(arr, "_mesh", None) is not None:
        if arr._stream is None:
            return _mesh_report(arr, target)
        target = "%s, mesh %s rank %d" % (target, dict(arr._mesh.shape),
                                          arr._mesh.rank)

    if not isinstance(arr, BoltArrayGPU):
        # the local oracle (or anything array-like): nothing deferred
        if not hasattr(arr, "shape"):
            arr = np.asarray(arr)
        shape, dtype = tuple(arr.shape), np.dtype(arr.dtype)
        return Report("local", [Stage(0, "base", shape, dtype,
                                      getattr(arr, "split", 0) or 0)], [])

    diags = []
    stages = []
    device = arr._device

    if arr._donated:
        op = arr._donated if isinstance(arr._donated, str) \
            else "a donating terminal"
        diags.append(Diagnostic(
            "BLT005", -1,
            "this array's device buffer was donated to %s; every read "
            "path (toarray, reduce, map, ...) will raise" % op,
            hint="re-materialise from the source array, or disable the "
                 "policy with engine.donation(None) before the "
                 "consuming terminal"))
        # a donating pending terminal's group still takes siblings
        _note_fusable(arr, -1, diags)
        return Report(target, stages, diags)

    h = arr._spending
    if h is not None and h.result is None:
        return _check_spending(arr, target, stages, diags)

    if arr._stream is not None:
        _note_fusable(arr, 0, diags)
        return _check_stream(arr, target, stages, diags)

    # the donation forecast and the batch key BEFORE any local binds the
    # base (both count references to it)
    will_donate = _would_donate(arr)
    batch = _batch_note(arr)

    fp = arr._fpending
    if fp is not None:
        base, funcs, pred, walk_split, vshape, n = fp
    elif arr.deferred:
        base, funcs = arr._chain
        walk_split = arr._split
    else:
        # concrete (or a resolved stat): the recorded shape and dtype
        shape = tuple(h.result.shape) if h is not None else arr._shape
        stages.append(Stage(0, "base (concrete)", shape, arr._dtype,
                            arr._split, device))
        _note_fusable(arr, 0, diags)
        _note_batchable(batch, 0, diags)
        return Report(target, stages, diags)

    base_nbytes = base.numel() * base.element_size()
    aval = _meta(base.shape, base.dtype)
    del base
    stages.append(Stage(0, "base", aval.shape, _np(aval.dtype), walk_split,
                        device))

    # ---- the deferred map chain, one stage per func --------------------
    failed = False
    for i, func in enumerate(funcs):
        label = _func_label(func)
        try:
            nxt = _stage_eval(func, walk_split, aval)
        except Exception as exc:
            from bolt_tpu_torch.gpu.array import _is_trace_error
            if _is_trace_error(exc):
                # what map() and filter() reroute through the local
                # oracle with a HostFallbackWarning: no device stage
                stages.append(Stage(
                    i + 1, label, aval.shape, _np(aval.dtype), walk_split,
                    device, note="not batchable by torch.func.vmap (%s): "
                                 "the host fallback serves it"
                                 % _first_line(exc)))
            else:
                diags.append(Diagnostic(
                    "BLT001", i + 1,
                    "%s fails abstract tracing on input %s %s: %s"
                    % (label, tuple(aval.shape), _np(aval.dtype),
                       _first_line(exc)),
                    hint="the stage would fail identically at dispatch; "
                         "fix the callable's shape/dtype contract"))
            failed = True
            break
        old, new = aval.dtype, nxt.dtype
        if new.itemsize > old.itemsize:
            diags.append(Diagnostic(
                "BLT003", i + 1,
                "%s widens the pipeline dtype %s -> %s (the materialised "
                "result costs %dx the base's device memory)"
                % (label, _np(old), _np(new),
                   new.itemsize // old.itemsize),
                hint="keep constants in the input dtype or cast back "
                     "with astype/map(dtype=...) if the widening is "
                     "unintended"))
        aval = nxt
        stages.append(Stage(i + 1, label, aval.shape, _np(aval.dtype),
                            walk_split, device))

    if not failed and fp is None:
        # the chain's recorded result must agree with the derived one
        rec_shape, rec_dtype = arr._shape, arr._dtype
        if rec_shape is not None and (
                tuple(rec_shape) != tuple(aval.shape)
                or rec_dtype != _np(aval.dtype)):
            diags.append(Diagnostic(
                "BLT002", len(funcs),
                "the recorded result %s %s contradicts what the chain "
                "actually produces (%s %s)"
                % (tuple(rec_shape), rec_dtype, tuple(aval.shape),
                   _np(aval.dtype)),
                hint="a value_shape/dtype hint lied, or deferred state "
                     "was constructed by hand; trust the derived shape"))

    if not failed and fp is not None:
        # ---- the pending filter: predicate + dynamic compaction ------
        vdtype = arr._dtype
        pidx = len(funcs) + 1
        if prod(aval.shape[:walk_split]) != n \
                or tuple(aval.shape[walk_split:]) != tuple(vshape) \
                or _np(aval.dtype) != vdtype:
            diags.append(Diagnostic(
                "BLT002", pidx,
                "the recorded filter state (n=%d, value shape %s, dtype "
                "%s) contradicts the mapped chain result %s %s"
                % (n, tuple(vshape), vdtype, tuple(aval.shape),
                   _np(aval.dtype)),
                hint="deferred filter state was constructed by hand or "
                     "the chain drifted; rebuild via filter()"))
        _check_predicate(pred, vshape, aval.dtype, pidx, diags)
        out_shape = (n,) + tuple(vshape)
        stages.append(Stage(pidx, "filter(%s)" % _name(pred), out_shape,
                            vdtype, 1, device, dynamic=True,
                            note="survivor count pending (<= %d)" % n))
        diags.append(Diagnostic(
            "BLT008", pidx,
            "the result shape is dynamic: at most %d records survive the "
            "predicate; reading .shape runs the compaction and syncs one "
            "scalar" % n))

    if not failed:
        _note_admission(
            base_nbytes + prod(tuple(stages[-1].shape))
            * stages[-1].dtype.itemsize, len(stages) - 1, diags)

    if will_donate and not failed:
        diags.append(Diagnostic(
            "BLT006", len(stages) - 1,
            "the next dispatching terminal will DONATE the %d-byte chain "
            "base (sole owner, >= engine.donation_min_bytes()); this "
            "array serves exactly ONE terminal and then becomes "
            "unreadable" % base_nbytes,
            hint="hold another reference to the source array or scope "
                 "engine.donation(None) to keep it readable"))

    _note_fusable(arr, len(stages) - 1, diags)
    _note_batchable(batch, len(stages) - 1, diags)
    return Report(target, stages, diags, dynamic=fp is not None
                  and not failed)


def explain(obj):
    """Human-readable per-stage rendering of :func:`check`'s report."""
    return str(check(obj))


def _nbytes(t):
    return int(t.numel()) * int(t.element_size())


def _group_bytes(g):
    """Bytes one pass of a stat group reads."""
    if g.kind == "chain":
        return _nbytes(g.base)
    if g.kind == "fpending":
        return _nbytes(g.fpending[0])
    return prod(g.source.shape) * np.dtype(g.source.dtype).itemsize


def _effective_codec(src):
    """The codec a run over ``src`` would resolve (the source's
    ``codec=`` wins over the caller's ``stream.codec()`` scope), without
    the dtype validation ``stream.resolve_codec`` makes: an estimate
    never raises."""
    from bolt_tpu_torch import stream as _stream
    name = src.codec if src.codec is not None else _stream.current_codec()
    if name is None:
        return None
    try:
        return _stream._codec_registry().get(name)
    except ValueError:
        return None


def _stream_slab_bytes(src):
    """One slab's device bytes: the wire representation when a codec is
    armed (the ring holds, and the serving arbiter leases, the encoded
    slab)."""
    itemsize = src.dtype.itemsize
    c = _effective_codec(src)
    if c is not None:
        try:
            itemsize = c.wire_dtype(src.dtype).itemsize
        except ValueError:
            pass          # a refused combination never streams
    return int(src.slab * prod(src.shape[1:]) * itemsize)


def _stream_ring_bytes(src):
    """A streaming plan's peak device footprint: slab bytes times the
    ring bound (prefetch depth + uploader pool), the slabs one run's
    ingest can hold at once."""
    from bolt_tpu_torch import stream as _stream
    return _stream_slab_bytes(src) * (_stream.prefetch_depth()
                                      + _stream.pool_size(src))


def _gpu_array(obj):
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    from bolt_tpu_torch.gpu.chunk import ChunkedArray
    from bolt_tpu_torch.gpu.stack import StackedArray
    arr = obj
    if isinstance(arr, (ChunkedArray, StackedArray)):
        arr = arr._barray
    return arr if isinstance(arr, BoltArrayGPU) else None


def admission_floor_bytes(obj):
    """The least device bytes ``obj``'s pipeline needs at once, which
    admission control (``serve.Server.submit``) compares with the
    serving budget: a stream degrades to one slab in flight (the
    arbiter's starvation valve shallows its ring), so its floor is the
    slab; an in-memory pipeline cannot shrink, so its floor is
    :func:`working_set_bytes`.  ``None`` when nothing can be
    estimated."""
    arr = _gpu_array(obj)
    if arr is None:
        return None
    h = arr._spending
    if h is not None and h.result is None and h.group.kind == "stream":
        return _stream_slab_bytes(h.group.source)
    if arr._stream is not None:
        return _stream_slab_bytes(arr._stream)
    return working_set_bytes(arr)


def working_set_bytes(obj):
    """Estimated peak device bytes ``obj``'s pipeline needs at once:

    * a stream: slab bytes times (prefetch depth + uploader pool);
    * a pending stat: its group's one-pass read (a stream group's ring);
    * a deferred chain, a pending filter or a concrete array: its source
      bytes plus its result bytes (both live while it runs).

    ``None`` for objects with nothing to estimate (local arrays, numpy
    arrays)."""
    arr = _gpu_array(obj)
    if arr is None:
        return None
    h = arr._spending
    if h is not None and h.result is not None:
        return _nbytes(h.result)         # resolved: only the result lives
    if h is not None:
        if h.group.kind == "stream":
            return _stream_ring_bytes(h.group.source)
        return _group_bytes(h.group)
    if arr._stream is not None:
        return _stream_ring_bytes(arr._stream)
    out_bytes = prod(arr._shape) * arr._dtype.itemsize \
        if arr._shape is not None else 0
    if arr._fpending is not None:
        # the survivors are unknown: count the result as the base's
        base = _nbytes(arr._fpending[0])
        return base + (out_bytes or base)
    if arr._chain is not None:
        return _nbytes(arr._chain[0]) + out_bytes
    return out_bytes
