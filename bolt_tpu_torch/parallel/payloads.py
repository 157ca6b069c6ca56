"""The payloads a pod of :mod:`bolt_tpu_torch.parallel.harness` runs.

Each payload is ``fn(rank, args, inputs) -> dict``: ``args`` is the run's
JSON, ``inputs`` its numpy arrays (the same on every rank).  Every rank
runs the same calls in the same order, as the pod's collectives need.
The ``checks`` payload runs named checks (:data:`CHECKS`) on one or
more meshes of the pod and returns each one's result.

Nothing here imports jax or the reference package: the tests hold these
results against the reference in their own process.
"""

import operator
import time
import warnings

import numpy as np


def _bolt():
    import bolt_tpu_torch as bolt
    return bolt


def _mesh(args):
    from bolt_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(tuple(args["mesh"]), tuple(args["names"]))


def _layout(b):
    """What a test reads of a mesh array's placement on this rank."""
    return {"shape": list(b.shape), "split": b.split,
            "spec": [list(e) if isinstance(e, tuple) else e
                     for e in b._spec],
            "box": [list(x) for x in b.box],
            "local_shape": list(b._data.shape)}


def _add1(v):
    return v + 1


def _mean_pos(v):
    return v.mean() > 1


# ---------------------------------------------------------------------
# the named checks of the ``checks`` payload: fn(mesh, inputs) -> dict
# ---------------------------------------------------------------------

def check_ones(mesh, inputs):
    b = _bolt().ones((8, 64), mesh)
    m = b.map(lambda v: v * 2)
    return {"ones": _layout(b), "map": _layout(m), "value": m.toarray()}


def check_swap(mesh, inputs):
    b = _bolt().array(inputs["swap_x"], mesh)
    s = b.swap((0,), (1,))
    return dict(_layout(s), value=s.toarray())


def check_welford(mesh, inputs):
    c = _bolt().array(inputs["welford_x"], mesh).stats()
    return {"count": int(c.count()), "mean": np.asarray(c.mean()),
            "var": np.asarray(c.variance()), "max": np.asarray(c.max())}


def check_reduce(mesh, inputs):
    b = _bolt().array(inputs["reduce_x"], mesh)
    return {"value": b.reduce(operator.add).toarray()}


def check_gather(mesh, inputs):
    from bolt_tpu_torch.gpu import mesharray
    from bolt_tpu_torch.parallel import sharding
    b = _bolt().array(inputs["gather_x"], mesh)
    out = {"value": b.toarray(), "stats": dict(mesharray._LAST_GATHER_STATS)}
    old = sharding._GATHER_PIECE_BYTES
    sharding._GATHER_PIECE_BYTES = 64
    try:
        out["small_value"] = b.toarray()
        out["small_stats"] = dict(mesharray._LAST_GATHER_STATS)
    finally:
        sharding._GATHER_PIECE_BYTES = old
    return out


def check_two_keys(mesh, inputs):
    """Two key axes over a 2-d mesh (``test_mesh2d_two_key_axes``)."""
    x = inputs["two_keys_x"]
    b = _bolt().array(x, mesh, axis=(0, 1))
    c = b.stats()
    return {"layout": _layout(b),
            "map": b.map(_add1, axis=(0, 1)).toarray(),
            "sum": b.sum().toarray(), "mean": np.asarray(c.mean()),
            "var": np.asarray(c.variance())}


def check_whole_mesh(mesh, inputs):
    """One key axis over every rank of a 2-d mesh."""
    x = inputs["whole_x"]
    b = _bolt().array(x, mesh, axis=(0,))
    st = b.stats()
    return {"layout": _layout(b),
            "sum": b.map(_add1).sum(axis=(0,)).toarray(),
            "mean": np.asarray(st.mean()), "stdev": np.asarray(st.stdev())}


def check_matching(mesh, inputs):
    """The matching search's layout end to end."""
    x = inputs["matching_x"]
    b = _bolt().array(x, mesh, axis=(0, 1))
    return {"layout": _layout(b),
            "sum": b.map(_add1).sum(axis=(0, 1)).toarray()}


_GROUP = ("sum", "mean", "var", "min", "max", "ptp")


def check_main_path(mesh, inputs):
    """The main path at a small north-star-like shape; the fluent stat
    group with the engine's group counts it moved (one group a rank)."""
    from bolt_tpu_torch import engine
    from bolt_tpu_torch.parallel import multihost
    x = inputs["main_x"]
    b = _bolt().array(x, mesh)
    m = b.map(_add1)
    c0, x0 = engine.counters(), multihost.counters()["collective_bytes"]
    group = m.stats(*_GROUP)
    c1, x1 = engine.counters(), multihost.counters()["collective_bytes"]
    st = b.stats()
    f = b.map(_add1).filter(_mean_pos)
    fs = b.map(_add1).filter(_mean_pos)
    return {"map_sum": b.map(_add1).sum().toarray(),
            "mean": np.asarray(st.mean()), "var": np.asarray(st.variance()),
            "min": np.asarray(st.min()), "max": np.asarray(st.max()),
            "filter_sum": fs.sum().toarray(),
            "filter_mean": b.map(_add1).filter(_mean_pos).mean().toarray(),
            "filter": f.toarray(), "filter_layout": _layout(f),
            "toarray": b.toarray(),
            "swap": b.swap((0,), (0,)).toarray(),
            "group": {k: v.toarray() for k, v in group.items()},
            "group_counts": dict(
                {k: c1.get(k, 0) - c0.get(k, 0) for k in
                 ("fused_stat_groups", "fused_stat_terminals")},
                collective_bytes=x1 - x0),
            "alone": {k: getattr(b.map(_add1), k)().toarray()
                      for k in _GROUP}}


def check_not_ported(mesh, inputs):
    """Nothing is left guarded on a multi-rank mesh: numpy's function
    table, ``_wrap``, ``map(with_keys=True)``, a host-predicate filter and
    ``stats(accumulate=)`` run (``None``: the call returned; else the
    ``NotImplementedError``'s message), and ``np.quantile`` gives numpy's
    value.  ``_mapped``/``_chain_parts``, which name no mesh form, refuse
    with a ``TypeError`` (``no_form``: its message)."""
    bolt = _bolt()
    x = inputs["main_x"]
    b = bolt.array(x, mesh)
    out = {}
    calls = {
        "quantile": lambda: np.quantile(b, 0.5),
        "getitem": lambda: b[0:2],
        "add": lambda: b + 1,
        "asarray": lambda: np.asarray(b),
        "with_keys": lambda: b.map(lambda kv: kv[1], with_keys=True).sum(),
        "host_filter": lambda: b.filter(
            lambda v: float(np.asarray(v).mean()) > 0).sum(),
        "accumulate": lambda: b.stats("sum", accumulate="f32"),
        "wrap": lambda: b._wrap(b._whole_tensor(), 1),
    }
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, call in calls.items():
            try:
                call()
                out[name] = None
            except NotImplementedError as exc:
                out[name] = str(exc)
    out["no_form"] = {}
    for name in ("_mapped", "_chain_parts"):
        try:
            getattr(b, name)()
            out["no_form"][name] = None
        except TypeError as exc:
            out["no_form"][name] = str(exc)
    out["quantile_value"] = np.asarray(np.quantile(b, 0.5).toarray())
    out["wrap_value"] = b._wrap(b._whole_tensor(), 1).toarray()
    return out


def check_halo(mesh, inputs):
    """``exchange_halo`` zero and wrap, and its two errors."""
    import torch
    from bolt_tpu_torch.parallel import exchange_halo
    out = {}
    for mode, key in (("zero", "halo_zero_x"), ("wrap", "halo_wrap_x")):
        x = inputs[key]
        n = mesh.size
        step = x.shape[0] // n
        local = torch.from_numpy(x[mesh.rank * step:(mesh.rank + 1) * step])
        padded = exchange_halo(local, 1, 0, "k", mode=mode, mesh=mesh)
        out[mode] = (padded[:-2] + padded[1:-1] + padded[2:]).numpy()
    local = torch.ones(2, dtype=torch.float64)
    for name, call in (
            ("pad_exceeds",
             lambda: exchange_halo(local, 5, 0, "k", mesh=mesh)),
            ("bogus_mode",
             lambda: exchange_halo(local, 1, 0, "k", mode="bogus",
                                   mesh=mesh))):
        try:
            call()
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


def check_value_sharding(mesh, inputs):
    """The chunk view's value-axis shards on a 2-d ``("a", "b")`` mesh
    (``tests/test_value_sharding.py``)."""
    bolt = _bolt()
    x = inputs["vs_x"]
    out = {}
    c = bolt.array(x, mesh).chunk(size=(8,), axis=(0,)).shard("b")
    out["shard"] = dict(_layout(c._barray), vshard=c.vshard,
                        value=c.unchunk().toarray())
    m = c.map(lambda blk: blk * 2 + 1)
    out["map"] = dict(_layout(m._barray), vshard=m.vshard,
                      value=m.unchunk().toarray())
    p = bolt.array(x, mesh).chunk(size=(4,), axis=(0,), padding=1) \
        .shard("b").map(lambda blk: blk * 3)
    out["padded"] = dict(_layout(p._barray), value=p.unchunk().toarray())
    out["default_axis"] = bolt.array(x, mesh).chunk(
        size=(8,), axis=(0,)).shard("b").vshard
    c = bolt.array(x, mesh, axis=(0,)).chunk(size=(8,), axis=(0,)) \
        .shard("b")
    k2v = c.keys_to_values((0,))
    out["k2v"] = dict(_layout(k2v._barray), vshard=k2v.vshard,
                      value=k2v.unchunk().toarray())
    out["v2k_vshard"] = c.values_to_keys((0,)).vshard
    c = bolt.array(x, mesh).chunk(size=(16,), axis=(0,)).shard("b")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        d = c.map(lambda blk: blk[:15])
    out["dropped"] = {"vshard": d.vshard,
                      "warnings": [str(i.message) for i in w],
                      "value": d.unchunk().toarray()}
    y = inputs["absorb_x"]
    cs = bolt.array(y, mesh, axis=(0,)).chunk(size=(2,), axis=(0,)) \
        .shard("b", axis=0)
    out["absorb"] = {"vshard": cs.vshard,
                     "value": cs.map(lambda blk: blk * 2.0).unchunk()
                     .toarray()}
    return out


def check_overlap(mesh, inputs):
    """The separable filters with ``shard=``: the window kernel on each
    rank's halo-extended block."""
    from bolt_tpu_torch import ops
    from bolt_tpu_torch.ops import kernels
    x = inputs["overlap_x"]
    b = _bolt().array(x, mesh, axis=(0,))
    before = kernels.LAUNCHES["sepfilter1d"]
    g = ops.gaussian(b, 1.0, axis=(0,), shard="b")
    s = ops.smooth(b, 3, axis=(0,), size=(6,), shard={0: "b"})
    m = ops.median_filter(b, 3, axis=(0,), shard="b")
    return {"gaussian": g.toarray(), "gaussian_layout": _layout(g),
            "smooth": s.toarray(), "median": m.toarray(),
            "launches": kernels.LAUNCHES["sepfilter1d"] - before}


def check_analysis(mesh, inputs):
    """BLT004 on an array whose key extent leaves ranks idle, and none on
    one that divides."""
    from bolt_tpu_torch import analysis
    bolt = _bolt()
    idle = bolt.array(inputs["idle_x"], mesh)
    rep = analysis.check(idle.map(_add1))
    busy = analysis.check(bolt.array(inputs["main_x"], mesh).map(_add1))
    return {"idle": [{"code": d.code, "severity": d.severity,
                      "message": d.message, "stage": d.stage}
                     for d in rep.diagnostics],
            "busy": [d.code for d in busy.diagnostics],
            "explain": str(rep)}


CHECKS = {
    "ones": check_ones, "swap": check_swap, "welford": check_welford,
    "reduce": check_reduce, "gather": check_gather,
    "two_keys": check_two_keys, "whole_mesh": check_whole_mesh,
    "matching": check_matching, "main_path": check_main_path,
    "not_ported": check_not_ported, "halo": check_halo,
    "value_sharding": check_value_sharding, "overlap": check_overlap,
    "analysis": check_analysis,
}


def payload_checks(rank, args, inputs):
    """For each entry of ``args["meshes"]`` (``{"label", "mesh",
    "names", "checks"}``; every mesh spans the whole pod), build the mesh
    and run its named checks; the result holds, under each label, this
    rank's coordinates and each check's result.  An unexpected error
    ends the rank, and the harness the pod, naming it (a check that
    expects an error catches it itself)."""
    out = {"rank": rank}
    for run in args["meshes"]:
        mesh = _mesh(run)
        res = out[run["label"]] = {"coords": list(mesh.coords().values())}
        for name in run["checks"]:
            res[name] = CHECKS[name](mesh, inputs)
    return out


def dryrun_multichip(n):
    """The multichip dry run (the reference's
    ``__graft_entry__.dryrun_multichip``) on a pod of ``n`` ranks: map →
    swap → stats → sum → gather with real key shardings over both mesh
    axes (a 1-d mesh at odd ``n``: the replication branches), then a
    filter, a value-sharded halo-padded chunk map and ``randn``.  Raises
    on a wrong answer; returns what it checked."""
    from bolt_tpu_torch.parallel.mesh import make_mesh
    bolt = _bolt()
    if n % 2 == 0 and n > 1:
        mesh = make_mesh((n // 2, 2), ("ka", "kb"))
        kshape = (n // 2, 2)
    else:
        mesh = make_mesh((n,), ("ka",))
        kshape = (n, 1)
    vshape = (4, 6)
    shape = kshape + vshape
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    b = bolt.array(x, mesh, axis=(0, 1))
    if b.split != 2 or b.mode != "gpu":
        raise AssertionError("array on the mesh: split %d mode %s"
                             % (b.split, b.mode))
    m = b.map(lambda v: v * 2.0 + 1.0, axis=(0, 1))
    mx = x * 2.0 + 1.0
    s = m.swap((1,), (0,))
    if s.split != 2 or not np.array_equal(
            s.toarray(), np.transpose(mx, (0, 2, 1, 3))):
        raise AssertionError("swap")
    st = m.stats()
    if not np.allclose(np.asarray(st.mean()), mx.mean(axis=(0, 1))):
        raise AssertionError("stats mean")
    total = m.sum(axis=(0, 1)).toarray()
    if not np.allclose(total, mx.sum(axis=(0, 1))):
        raise AssertionError("sum")
    out = {"shape": list(shape), "spec": [list(e) if isinstance(e, tuple)
                                          else e for e in b._spec],
           "sum": total}
    if len(mesh.axis_names) > 1:
        y = np.arange(kshape[0] * 6 * 4, dtype=np.float64).reshape(
            kshape[0], 6, 4)
        cs = bolt.array(y, mesh, axis=(0,)).chunk(
            size=(3,), axis=(0,), padding=1).shard(mesh.axis_names[1],
                                                    axis=0)
        if cs.vshard != {0: mesh.axis_names[1]}:
            raise AssertionError("vshard %s" % (cs.vshard,))
        if not np.allclose(cs.map(lambda blk: blk * 2.0).unchunk()
                           .toarray(), y * 2.0):
            raise AssertionError("sharded padded chunk map")
    f = m.filter(lambda v: v.mean() > 0, axis=(0, 1))
    flat = mx.reshape(-1, *vshape)
    keep = flat[flat.mean(axis=(1, 2)) > 0]
    if f.split != 1 or f.shape != keep.shape or not np.allclose(
            f.toarray(), keep):
        raise AssertionError("filter")
    rnd = bolt.randn((n * 2, 3, 4), mesh, dtype=np.float32, seed=9)
    if rnd.shape != (n * 2, 3, 4) or not np.isfinite(rnd.toarray()).all():
        raise AssertionError("randn")
    out["filtered"] = int(keep.shape[0])
    out.update(_dryrun_surface(bolt, mesh, kshape, x, m))
    return out


def _dryrun_surface(bolt, mesh, kshape, x, m):
    """The dry run's steps on the array surface, the ops library and
    numpy's function table (the reference's, past the filter):
    distributed ``pca``, ``median``, ``cov``, the per-chunk SVD, ``set``,
    an in-place ``sort``, the vector quantile, ``segment_reduce`` with
    labels on the device, ``topk``, ``toarray(out=)``, ``iter_shards``
    and the numpy tail (:func:`_dryrun_numpy`).  Raises on a wrong
    answer."""
    import torch
    n = mesh.size
    pdata = np.random.RandomState(7).randn(n * 6, 5)
    pb = bolt.array(pdata, mesh, axis=(0,))
    scores, comps, svals = bolt.ops.pca(pb, k=3, center=True)
    xc = pdata - pdata.mean(axis=0)
    if not np.allclose(svals, np.linalg.svd(xc, compute_uv=False)[:3],
                       rtol=1e-6) or scores.shape != (n * 6, 3):
        raise AssertionError("pca")
    if not np.allclose(m.median().toarray(),
                       np.median(x * 2.0 + 1.0, axis=(0, 1))):
        raise AssertionError("median")
    if not np.allclose(bolt.ops.cov(pb, return_mean=False),
                       np.cov(pdata, rowvar=False), rtol=1e-6):
        raise AssertionError("cov")
    tall = np.random.RandomState(5).randn(kshape[0], 32, 3).astype(
        np.float32)
    tb = bolt.array(tall, mesh, axis=(0,))
    sv = tb.chunk(size=(8,), axis=(0,)).map(
        lambda blk: torch.linalg.svdvals(blk)[None, :]).unchunk()
    expect = np.stack([np.stack([
        np.linalg.svd(tall[k, i * 8:(i + 1) * 8], compute_uv=False)
        for i in range(4)]) for k in range(kshape[0])])
    if not np.allclose(np.asarray(sv.toarray()).reshape(expect.shape),
                       expect, rtol=1e-4, atol=1e-4):
        raise AssertionError("per-chunk svd")
    sdata = np.random.RandomState(11).randn(kshape[0], 12, 3)
    sb = bolt.array(sdata, mesh, axis=(0,))
    rows = [0, 1] if sdata.shape[0] > 1 else [0]
    st = sb.set((rows, slice(None), [0, 2]), -1.0)
    sref = sdata.copy()
    sref[np.ix_(rows, range(12), [0, 2])] = -1.0
    if not np.allclose(st.toarray(), sref):
        raise AssertionError("set")
    srt = bolt.array(sdata, mesh, axis=(0,))
    if srt.sort(axis=1) is not None or not np.allclose(
            srt.toarray(), np.sort(sdata, axis=1)):
        raise AssertionError("in-place sort")
    vq = sb.quantile([0.25, 0.75])
    if vq.split != 1 or not np.allclose(
            vq.toarray(), np.quantile(sdata, [0.25, 0.75], axis=0)):
        raise AssertionError("vector quantile")
    dlab = torch.as_tensor(np.arange(sdata.shape[0]) % 2,
                           device=mesh.device)
    gseg = bolt.ops.segment_reduce(sb, dlab, num_segments=2, op="sum")
    if not np.allclose(gseg.toarray(), np.stack(
            [sdata[np.arange(sdata.shape[0]) % 2 == g].sum(axis=0)
             for g in range(2)])):
        raise AssertionError("segment_reduce")
    tv, _ = bolt.ops.topk(sb, 2, axis=1)
    if tv.shape != (sdata.shape[0], 2, 3):
        raise AssertionError("topk")
    tgt = np.empty(sb.shape, sb.dtype)
    if sb.toarray(out=tgt) is not tgt or not np.allclose(tgt, sdata):
        raise AssertionError("toarray(out=)")
    walked = 0
    for idx, blk in sb.iter_shards():
        if not np.allclose(blk, sdata[idx]):
            raise AssertionError("iter_shards")
        walked += blk.size
    return {"pca_svals": np.asarray(svals), "median_shape": list(
        m.median().shape), "shard_elements": walked,
        "numpy": _dryrun_numpy(bolt, sb, sdata, pb, pdata)}


def _dryrun_numpy(bolt, sb, sdata, pb, pdata):
    """The dry run's numpy-table steps (the reference's tail): ``np.sum``
    and ``np.concatenate`` on the device, the stack family, the layout
    expanders and the contractions as one program each, keys surviving
    where they still lead, and ``np.cov``.  Raises on a wrong answer;
    returns the splits and the sum it checked."""
    nsum = np.sum(sb)
    if nsum.mode != "gpu" or not np.allclose(
            float(np.asarray(nsum.toarray())), sdata.sum()):
        raise AssertionError("np.sum")
    cat = np.concatenate([sb, sb], axis=1)
    if cat.mode != "gpu" or not np.allclose(
            cat.toarray(), np.concatenate([sdata, sdata], 1)):
        raise AssertionError("np.concatenate")
    stk = np.stack([sb, sb], axis=0)
    if stk.mode != "gpu" or stk.split != 2 or not np.allclose(
            stk.toarray(), np.stack([sdata, sdata], axis=0)):
        raise AssertionError("np.stack")
    if not np.allclose(np.roll(sb, 3, axis=1).toarray(),
                       np.roll(sdata, 3, axis=1)):
        raise AssertionError("np.roll")
    pads = ((0, 0), (2, 1), (0, 0))
    if not np.allclose(np.pad(sb, pads, mode="reflect").toarray(),
                       np.pad(sdata, pads, mode="reflect")):
        raise AssertionError("np.pad")
    w = np.ones((sdata.shape[2], 2), sdata.dtype)
    ein = np.einsum("ijk,kl->ijl", sb, w)
    if ein.split != sb.split or not np.allclose(
            ein.toarray(), np.einsum("ijk,kl->ijl", sdata, w)):
        raise AssertionError("np.einsum")
    td = np.tensordot(sb, np.ones((3, 2), sdata.dtype), axes=([2], [0]))
    if not np.allclose(td.toarray(), np.tensordot(
            sdata, np.ones((3, 2)), axes=([2], [0]))):
        raise AssertionError("np.tensordot")
    bcast = np.broadcast_to(sb, (2,) + tuple(sb.shape))
    if bcast.split != sb.split + 1 or not np.allclose(
            bcast.toarray(), np.broadcast_to(sdata, (2,) + sdata.shape)):
        raise AssertionError("np.broadcast_to")
    ncov = np.cov(pb, rowvar=False)
    if not np.allclose(ncov, np.cov(pdata, rowvar=False), rtol=1e-5):
        raise AssertionError("np.cov")
    return {"sum": float(np.asarray(nsum.toarray())),
            "splits": [int(stk.split), int(ein.split), int(bcast.split)]}


def payload_dryrun(rank, args, inputs):
    from bolt_tpu_torch.parallel import multihost
    return {"rank": rank,
            "result": dryrun_multichip(multihost.process_count())}


def payload_sched(rank, args, inputs):
    """The schedule verifier on a pod: every rank runs the same pipeline
    and the digests agree; then ``args["skew_rank"]`` enqueues one extra
    program of its own (no collective, so nothing can hang) and the next
    verify raises a pointed divergence on every rank."""
    import torch
    from bolt_tpu_torch import engine
    from bolt_tpu_torch.parallel import multihost
    engine.schedule_log_arm(True)
    mesh = _mesh(args)
    bolt = _bolt()
    b = bolt.array(inputs["x"], mesh)
    res = {"rank": rank, "sum": b.map(_add1).sum().toarray()}
    res["digest_matched"] = multihost.verify_schedule("matched")
    res["count_matched"] = engine.schedule_digest()[0]
    res["skewed"] = rank == args["skew_rank"]
    if res["skewed"]:
        bolt.array(inputs["x"], torch.device("cpu")).map(_add1).sum() \
            .toarray()
    try:
        multihost.verify_schedule("skewed", timeout=30.0)
        res["divergence"] = None
    except multihost.ScheduleDivergenceError as exc:
        res["divergence"] = {"peer": exc.peer, "index": exc.index,
                             "local_key": exc.local_key,
                             "message": str(exc)[:400]}
    res["analysis"] = check_analysis(mesh, inputs)
    multihost.barrier("sched.done")
    return res


def payload_sleep(rank, args, inputs):
    """Sleep ``args["seconds"]`` (the wall-limit test)."""
    time.sleep(float(args["seconds"]))
    return {"rank": rank}


# ---------------------------------------------------------------------
# streamed pods (the reference harness's stream payloads)
# ---------------------------------------------------------------------

def crafted(n, vdim, period=8):
    """The reference harness's exact data (``scripts/multihost_harness.py
    :: _crafted``): record ``r``, value slot ``j`` holds ``r % period +
    j * 0.5`` in f32.  Sums are exact in f32 in any order, and every
    range of a multiple of ``period`` records has the same mean, so the
    moments folded over ranks equal one process's bit for bit."""
    r = np.arange(n, dtype=np.float32) % period
    v = np.arange(vdim, dtype=np.float32) * 0.5
    return (r[:, None] + v[None, :]).astype(np.float32)


def _pod_mesh(names=("k",), shape=None):
    from bolt_tpu_torch.parallel import multihost
    from bolt_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(tuple(shape) if shape else (multihost.process_count(),),
                     tuple(names))


def _value(b):
    """The host value of a result every rank holds whole."""
    from bolt_tpu_torch.parallel import multihost
    return multihost.local_value(b)


def _stream_args(args):
    return (int(args.get("n", 64)), int(args.get("vdim", 8)),
            int(args.get("chunks", 16)))


def payload_stream_parity(rank, args, inputs):
    """The streamed pod's parity payload (the reference's
    ``payload_stream_parity``): ``fromcallback(per_process=True)``'s
    ``map(v + 1).sum()`` over two passes (compile once, the transfer
    bytes of the rank's rows), ``stats("sum", "var")``, the rows each
    rank's loader produced, ``explain``'s per-rank plan, BLT012 refused
    and forecast, a re-iterable ``fromiter``'s sum and a one-shot
    iterator refused, with no span left open."""
    from bolt_tpu_torch import analysis, engine, obs
    from bolt_tpu_torch.parallel import multihost
    bolt = _bolt()
    n, vdim, chunks = _stream_args(args)
    x = crafted(n, vdim)
    mesh = _pod_mesh()
    nproc = multihost.process_count()
    obs.clear()
    obs.enable()
    rows = []                  # list.append is thread-safe (the pool)

    def loader(idx):
        rows.append(len(range(*idx[0].indices(n))))
        return x[idx]

    def make():
        return bolt.fromcallback(loader, (n, vdim), mesh, dtype=np.float32,
                                 chunks=chunks, per_process=True)

    res = {"rank": rank, "nproc": nproc}
    c0 = engine.counters()
    res["sum"] = _value(make().map(_add1).sum().cache())
    c1 = engine.counters()
    make().map(_add1).sum().cache()
    c2 = engine.counters()
    res["misses_first_pass"] = c1["misses"] - c0["misses"]
    res["recompiles_second_pass"] = (c2["aot_compiles"] - c1["aot_compiles"]
                                     + c2["misses"] - c1["misses"])
    res["transfer_bytes"] = c2["transfer_bytes"] - c0["transfer_bytes"]
    st = make().map(_add1).stats("sum", "var")
    res["stats_sum"], res["stats_var"] = _value(st["sum"]), \
        _value(st["var"])
    res["rows_produced"] = sum(rows)
    res["rows_expected"] = 3 * (n // nproc)
    res["explain"] = str(analysis.explain(make().map(_add1)))
    bad = bolt.fromcallback(lambda idx: x[idx], (n, vdim), mesh,
                            dtype=np.float32, chunks=3, per_process=True)
    try:
        bad.map(_add1).sum().cache()
        res["blt012_refused"] = None
    except ValueError as exc:
        res["blt012_refused"] = str(exc)
    res["blt012_forecast"] = analysis.check(bad.map(_add1)).has("BLT012")
    blocks = [x[i:i + chunks] for i in range(0, n, chunks)]
    fi = bolt.fromiter(blocks, (n, vdim), mesh, dtype=np.float32)
    res["fromiter_sum"] = _value(fi.map(_add1).sum().cache())
    try:
        bolt.fromiter((b for b in blocks), (n, vdim), mesh,
                      dtype=np.float32)
        res["oneshot_refused"] = None
    except ValueError as exc:
        res["oneshot_refused"] = str(exc)
    res["leaked_spans"] = obs.active_count()
    obs.disable()
    return res


def payload_single_ref(rank, args, inputs):
    """The one-rank reference of :func:`payload_stream_parity`: the same
    data and pipelines on a one-rank mesh (the single-device path)."""
    bolt = _bolt()
    n, vdim, chunks = _stream_args(args)
    x = crafted(n, vdim)
    mesh = _pod_mesh()

    def make():
        return bolt.fromcallback(lambda idx: x[idx], (n, vdim), mesh,
                                 dtype=np.float32, chunks=chunks,
                                 per_process=True)

    st = make().map(_add1).stats("sum", "var")
    blocks = [x[i:i + chunks] for i in range(0, n, chunks)]
    fi = bolt.fromiter(blocks, (n, vdim), mesh, dtype=np.float32)
    return {"rank": rank, "sum": _value(make().map(_add1).sum().cache()),
            "stats_sum": _value(st["sum"]), "stats_var": _value(st["var"]),
            "fromiter_sum": _value(fi.map(_add1).sum().cache())}


def payload_resume(rank, args, inputs):
    """A checkpointed streamed pod sum over 8 slabs (the reference's
    ``payload_resume``): the caller arms ``BOLT_CHAOS`` to kill every
    rank mid-run, then runs it again clean, which resumes from the
    ranks' shards.  ``args["sub_pod"]`` instead asks a checkpointed run
    on a mesh of fewer ranks than the pod (refused; the ranks outside it
    build nothing).  Run over a checkpoint cut at another width it
    resumes through the topology remap."""
    from bolt_tpu_torch import engine
    bolt = _bolt()
    ck = args["ckpt"]
    n, vdim, chunks = 64, 8, 8                      # 8 slabs of 8
    x = crafted(n, vdim)
    mesh = _pod_mesh()
    c0 = engine.counters()
    src = bolt.fromcallback(lambda idx: x[idx], (n, vdim), mesh,
                            dtype=np.float32, chunks=chunks, checkpoint=ck,
                            per_process=True)
    s = src.map(_add1).sum().cache()
    c1 = engine.counters()
    return {"rank": rank, "sum": _value(s),
            "resumes": c1["stream_resumes"] - c0["stream_resumes"],
            "slabs": c1["stream_chunks"] - c0["stream_chunks"]}


def payload_pod_extras(rank, args, inputs):
    """On a four-rank pod: a ``(2, 2)`` ``("a", "b")`` mesh streaming a
    key extent ``"b"`` does not divide (each box replicated on ``"b"``:
    the sum folds over ``"a"`` alone, with no double count), and a
    checkpointed run on a mesh of half the pod's ranks (refused; the
    ranks outside it build nothing); then ``checkpoint.save``/``load`` of
    a mesh array on the ``(2, 2)`` mesh, a shard file a rank
    (``args["array_dir"]``)."""
    from bolt_tpu_torch import checkpoint
    from bolt_tpu_torch.parallel import multihost
    from bolt_tpu_torch.parallel.mesh import Mesh
    bolt = _bolt()
    res = {"rank": rank}
    shape = tuple(args.get("replicated_shape", (6, 4)))
    xq = crafted(shape[0], int(np.prod(shape[1:])), 4).reshape(shape)
    mesh2 = _pod_mesh(("a", "b"), (2, multihost.process_count() // 2))
    srcq = bolt.fromcallback(lambda idx: xq[idx], shape, mesh2,
                             dtype=np.float32,
                             chunks=int(args.get("replicated_chunks", 2)),
                             per_process=True)
    res["replicated_spec"] = [list(e) if isinstance(e, tuple) else e
                              for e in srcq._spec]
    res["replicated_sum"] = _value(srcq.map(_add1).sum().cache())
    res["sub_pod_refused"] = None
    width = multihost.process_count() // 2
    if rank < width:
        x = crafted(64, 8)
        mesh = Mesh((width,), ("k",), [multihost.local_device()] * width)
        src = bolt.fromcallback(lambda idx: x[idx], (64, 8), mesh,
                                dtype=np.float32, chunks=8,
                                checkpoint=args["ckpt"], per_process=True)
        try:
            src.map(_add1).sum().cache()
        except ValueError as exc:
            res["sub_pod_refused"] = str(exc)
    b = bolt.array(xq, mesh2).map(_add1)
    checkpoint.save(args["array_dir"], b)
    back = checkpoint.load(args["array_dir"], mesh2)
    res["array"] = {"saved_box": b._data.cpu().numpy(),
                    "loaded_box": back._data.cpu().numpy(),
                    "box": [list(x) for x in back.box],
                    "spec": [list(e) if isinstance(e, tuple) else e
                             for e in back._spec],
                    "shape": list(back.shape), "split": back.split,
                    "value": back.toarray()}
    return res


def payload_codec_pod(rank, args, inputs):
    """Codec-encoded ingest on a pod (the reference's
    ``payload_codec_pod``): each rank encodes its own rows, so ``bf16``
    ships half the raw bytes, ``delta-f32`` folds to the raw pod sum bit
    for bit, and the sidecar codec ``int8`` is refused."""
    from bolt_tpu_torch import engine, obs
    bolt = _bolt()
    n, vdim, chunks = _stream_args(args)
    x = crafted(n, vdim)
    mesh = _pod_mesh()
    obs.clear()
    obs.enable()

    def make(codec=None):
        return bolt.fromcallback(lambda idx: x[idx], (n, vdim), mesh,
                                 dtype=np.float32, chunks=chunks,
                                 per_process=True, codec=codec)

    res = {"rank": rank}
    c0 = engine.counters()
    res["raw"] = _value(make().map(_add1).sum().cache())
    c1 = engine.counters()
    res["delta"] = _value(make("delta-f32").map(_add1).sum().cache())
    c2 = engine.counters()
    res["bf16"] = _value(make("bf16").map(_add1).sum().cache())
    c3 = engine.counters()
    res["raw_bytes"] = c1["transfer_bytes"] - c0["transfer_bytes"]
    res["delta_bytes"] = c2["transfer_bytes"] - c1["transfer_bytes"]
    res["bf16_bytes"] = c3["transfer_bytes"] - c2["transfer_bytes"]
    try:
        make("int8").map(_add1).sum().cache()
        res["sidecar_refused"] = None
    except ValueError as exc:
        res["sidecar_refused"] = str(exc)
    res["leaked_spans"] = obs.active_count()
    obs.disable()
    return res


def payload_swap(rank, args, inputs):
    """The streamed swap on a pod (the reference's ``payload_swap``): one
    ``all_to_all`` a slab, each rank's box against the materialised
    mesh swap of the same source; lazy until read, shuffle bytes moved,
    nothing spilled, and a pod spill refused."""
    from bolt_tpu_torch import engine, obs, stream
    bolt = _bolt()
    n, vdim, chunks = _stream_args(args)
    x = crafted(n, vdim)
    mesh = _pod_mesh()
    obs.clear()
    obs.enable()

    def make():
        return bolt.fromcallback(lambda idx: x[idx], (n, vdim), mesh,
                                 dtype=np.float32, chunks=chunks,
                                 per_process=True)

    res = {"rank": rank}
    c0 = engine.counters()
    streamed = make().swap((0,), (0,))
    res["lazy_after_swap"] = streamed._stream is not None
    res["streamed"] = streamed._data.cpu().numpy()
    res["box"] = [list(b) for b in streamed.box]
    c1 = engine.counters()
    mat = make()
    mat.cache()
    res["materialised"] = mat.swap((0,), (0,))._data.cpu().numpy()
    res["shuffle_bytes"] = c1["shuffle_bytes"] - c0["shuffle_bytes"]
    res["spill_bytes"] = c1["spill_bytes"] - c0["spill_bytes"]
    try:
        with stream.spill(dir=args["spill"], budget=1):
            make().swap((0,), (0,))._data
        res["pod_spill_refused"] = None
    except RuntimeError as exc:
        res["pod_spill_refused"] = str(exc)
    res["leaked_spans"] = obs.active_count()
    obs.disable()
    return res


def payload_retried(rank, args, inputs):
    """A retried slab dispatch on ONE rank (``args["fault_rank"]``, the
    ``stream.dispatch`` seam under ``stream.retries(1)``): the rank reruns
    only its own slab program, before the slab's exchange, so the pod's
    sum keeps its bits and every rank's dispatch schedule digest still
    agrees (``multihost.verify_schedule``)."""
    from bolt_tpu_torch import _chaos, engine, stream
    from bolt_tpu_torch.parallel import multihost
    bolt = _bolt()
    n, vdim, chunks = _stream_args(args)
    x = crafted(n, vdim)
    mesh = _pod_mesh()

    def run():
        return _value(bolt.fromcallback(
            lambda idx: x[idx], (n, vdim), mesh, dtype=np.float32,
            chunks=chunks, per_process=True).map(_add1).sum().cache())

    clean = run()
    c0 = engine.counters()
    if rank == int(args.get("fault_rank", 1)):
        _chaos.inject("stream.dispatch", nth=2)
    try:
        with stream.retries(1):
            retried = run()
    finally:
        _chaos.clear()
    return {"rank": rank, "clean": clean, "retried": retried,
            "retries": engine.counters()["stream_retries"]
            - c0["stream_retries"],
            "digest": multihost.verify_schedule("retried")}


def payload_stream_suite(rank, args, inputs):
    """:func:`payload_stream_parity`, :func:`payload_codec_pod`,
    :func:`payload_swap` and :func:`payload_retried` on one pod (one
    start-up for the four)."""
    return {"rank": rank, "parity": payload_stream_parity(rank, args, inputs),
            "codec": payload_codec_pod(rank, args, inputs),
            "swap": payload_swap(rank, args, inputs),
            "retried": payload_retried(rank, args, inputs)}


def payload_surface(rank, args, inputs):
    """The array surface and the ops library on the pod's meshes
    (:mod:`bolt_tpu_torch.parallel.surface`)."""
    from bolt_tpu_torch.parallel import surface
    return surface.payload_surface(rank, args, inputs)


def payload_npsurface(rank, args, inputs):
    """numpy's function table on the pod's meshes
    (:mod:`bolt_tpu_torch.parallel.npsurface`)."""
    from bolt_tpu_torch.parallel import npsurface
    return npsurface.payload_npsurface(rank, args, inputs)


PAYLOADS = {
    "checks": payload_checks,
    "surface": payload_surface,
    "npsurface": payload_npsurface,
    "dryrun": payload_dryrun,
    "sched": payload_sched,
    "sleep": payload_sleep,
    "stream_parity": payload_stream_parity,
    "single_ref": payload_single_ref,
    "resume": payload_resume,
    "codec_pod": payload_codec_pod,
    "swap": payload_swap,
    "retried": payload_retried,
    "stream_suite": payload_stream_suite,
    "pod_extras": payload_pod_extras,
}


# ---------------------------------------------------------------------
# the card's pods (chip_smoke.py phase 15): every rank on one device,
# shapes from args so a CPU rehearsal can shrink them
# ---------------------------------------------------------------------

_FP_CHUNK = 1 << 25        # 16-bit words a fingerprint step reads
_FP_MOD = (1 << 61) - 1


def fingerprint(t):
    """An exact fingerprint of a tensor's bytes, computed where it lies:
    ``(sum of its 16-bit words, sum of each word times its position's
    weight)`` modulo a prime, each step in int64 with no overflow.  Two
    tensors of one dtype and shape with equal bits give equal
    fingerprints on any device; a difference changes them (short of a
    deliberate collision)."""
    import torch
    from bolt_tpu_torch.parallel.multihost import _as_bytes
    b = _as_bytes(t)
    if b.numel() % 2:
        b = torch.cat([b, b.new_zeros(1)])
    words = b.view(torch.int16)
    s1 = s2 = 0
    for off in range(0, words.numel(), _FP_CHUNK):
        w = words[off:off + _FP_CHUNK].to(torch.int64) & 0xFFFF
        pos = torch.arange(off, off + w.numel(), device=w.device,
                           dtype=torch.int64)
        s1 = (s1 + int(w.sum())) % _FP_MOD
        s2 = (s2 + int((w * (pos % 65521 + 1)).sum())) % _FP_MOD
    return [int(t.numel()), s1, s2]


def crafted_box(shape, box, device):
    """This rank's box of the crafted array of ``shape`` (f32): record
    ``r``, value slot ``j`` holds ``r % 8 - 4 + (j % 16) * 0.5``.  Small
    integers and halves: every sum over records is exact in f32 in any
    order, so a fold over ranks gives the single-device bits; after
    ``v + 1`` a record's mean is ``r % 8 + 0.75``, so config 4's
    ``mean > 1`` keeps seven records in eight."""
    import torch
    (r0, r1) = box[0]
    vshape = tuple(shape[1:])
    nv = int(np.prod(vshape, dtype=np.int64))
    rec = (torch.arange(r0, r1, device=device) % 8 - 4).to(torch.float32)
    val = (torch.arange(nv, device=device) % 16).to(torch.float32) * 0.5
    full = (rec[:, None] + val[None, :]).reshape((r1 - r0,) + vshape)
    return full[(slice(None),) + tuple(slice(s, e) for s, e in box[1:])] \
        .contiguous()


def constant_box(shape, box, device):
    """This rank's box of an array whose every column is constant over
    the records (value slot ``j`` holds ``(j % 16) * 0.5``): the data on
    which a running (Welford) mean and M2 are exact in f32 whatever the
    row partition, so ``stats()`` folded over ranks gives the
    single-device bits."""
    import torch
    vshape = tuple(shape[1:])
    nv = int(np.prod(vshape, dtype=np.int64))
    val = ((torch.arange(nv, device=device) % 16).to(torch.float32) * 0.5) \
        .reshape(vshape)
    val = val[tuple(slice(s, e) for s, e in box[1:])]
    n = box[0][1] - box[0][0]
    return val.expand((n,) + tuple(val.shape)).contiguous()


def trend_box(shape, box, device):
    """This rank's box of an array (f32) whose record ``r``, value slot
    ``j`` holds ``r % 8 - 4 + r / 256 + (j % 16) * 0.5``: exact in f32,
    every column's variance over the records the same, and the records'
    mean rising with ``r``, so each rank's box has a mean and a variance
    of its own (a dropped rank or a dropped mean-delta term in a fold
    changes the variance)."""
    import torch
    (r0, r1) = box[0]
    vshape = tuple(shape[1:])
    nv = int(np.prod(vshape, dtype=np.int64))
    r = torch.arange(r0, r1, device=device)
    rec = (r % 8 - 4).to(torch.float32) + r.to(torch.float32) / 256.0
    val = (torch.arange(nv, device=device) % 16).to(torch.float32) * 0.5
    full = (rec[:, None] + val[None, :]).reshape((r1 - r0,) + vshape)
    return full[(slice(None),) + tuple(slice(s, e) for s, e in box[1:])] \
        .contiguous()


def trend_variance(n):
    """The variance over ``n`` records of every column of
    :func:`trend_box` data, in f64 (exact inputs)."""
    r = np.arange(n)
    return float(np.var((r % 8 - 4) + r / 256.0))


def _on_mesh(mesh, shape, spec, make, split=1):
    """A mesh array of ``shape`` laid out by ``spec``, each rank's box
    built on its device by ``make(shape, box, device)``."""
    from bolt_tpu_torch.parallel import sharding
    sh = sharding.Sharding(mesh, spec, shape)
    part = make(shape, sh.box(), mesh.device)
    return sharding.assemble_from_parts(shape, sh, [part], split=split)


class _Path:
    """One measured path of a card pod: its wall, the rank's peak device
    memory growth, its kernel launches, collective bytes and the
    engine's stream counters (``transfer_bytes``, ``stream_chunks``,
    ``misses``, ``stream_resumes``, ``shuffle_bytes``), all counted from
    0 at the start; ``extra`` (a dict the path may fill while it runs)
    joins the record."""

    _ENGINE = ("transfer_bytes", "stream_chunks", "misses",
               "stream_resumes", "shuffle_bytes")

    def __init__(self, out, name, extra=None):
        self.out, self.name = out, name
        self.extra = {} if extra is None else extra

    def __enter__(self):
        import torch
        from bolt_tpu_torch.ops import kernels
        from bolt_tpu_torch.parallel import multihost
        self.dev = multihost.local_device()
        if self.dev.type == "cuda":
            # a measured path starts and ends with the card idle
            torch.cuda.synchronize(self.dev)  # lint: allow(BLT107 a path's wall)
            torch.cuda.reset_peak_memory_stats(self.dev)
            self.a0 = torch.cuda.memory_allocated(self.dev)
        from bolt_tpu_torch import engine
        kernels.reset_launches()
        multihost.reset_counters()
        self.c0 = engine.counters()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        import torch
        from bolt_tpu_torch.ops import kernels
        from bolt_tpu_torch.parallel import multihost
        if exc[0] is not None:
            return False
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)  # lint: allow(BLT107 a path's wall)
        from bolt_tpu_torch import engine
        c1 = engine.counters()
        rec = {"wall_s": time.monotonic() - self.t0,
               "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
               "collectives": multihost.counters(),
               "engine": {k: c1[k] - self.c0[k] for k in self._ENGINE}}
        rec.update(self.extra)
        if self.dev.type == "cuda":
            rec["peak_growth_bytes"] = \
                torch.cuda.max_memory_allocated(self.dev) - self.a0
        self.out.setdefault("paths", {})[self.name] = rec
        return False


def _first_call(out, mesh):
    """The process's first ``map(v + 1).sum()`` and ``stats()``, on a
    small array of the mesh: the kernel libraries' loads and the first
    trace of a chain, timed apart from the measured paths."""
    with _Path(out, "first_call"):
        x = _bolt().ones((mesh.size * 2, 4, 8), mesh, dtype=np.float32)
        x.map(_add1).sum().toarray()
        x.stats()


def payload_card_one(rank, args, inputs):
    """The one-rank pod: the north-star ``randn`` (seed 0) on a one-rank
    mesh, ``map(v + 1).sum()``, ``stats()`` and ``swap`` (its
    fingerprint), each the single-device path's bits."""
    from bolt_tpu_torch.parallel import multihost
    from bolt_tpu_torch.parallel.mesh import default_mesh
    bolt = _bolt()
    shape = tuple(args["north_star"])
    out = {"rank": rank, "backend": multihost.backend()}
    mesh = default_mesh()
    _first_call(out, mesh)
    b = bolt.randn(shape, mesh, dtype=np.float32, seed=0)
    with _Path(out, "one_map_sum"):
        out["map_sum"] = b.map(_add1).sum().toarray()
    with _Path(out, "one_stats"):
        st = b.stats()
        out["mean"], out["var"] = np.asarray(st.mean()), \
            np.asarray(st.variance())
    with _Path(out, "one_swap"):
        s = b.swap((0,), (0,))
        out["swap"] = fingerprint(s._data)
    del s, b
    if args.get("stream"):
        _stream_int8(out, args["stream"])
    return out


def _f64_sums(x, chunk=64):
    """f64 column sums and sums of squares over axis 0 of ``x``, over
    chunks of records (the references of a randn box)."""
    import torch
    s = q = None
    for i in range(0, x.shape[0], chunk):
        c = x[i:i + chunk].to(torch.float64)
        cs, cq = c.sum(0), (c * c).sum(0)
        s = cs if s is None else s + cs
        q = cq if q is None else q + cq
    return s, q


# the fluent stat group of the two-rank pod
GROUP_NAMES = ("sum", "mean", "var", "min", "max")


def payload_card_pod2(rank, args, inputs):
    """The two-rank pod, both ranks on one card: the north-star split
    1600 records a rank (crafted data bit for bit against the single
    device: the map-sum, ``reduce``, config 4's filter, ``stats()`` and
    the fluent group of :data:`GROUP_NAMES` of constant columns;
    ``randn`` against f64 references), then config 1's crafted ``swap``
    through the all_to_all and ``toarray()`` (each fingerprinted for the
    single device's bits, and the swap against ``np.transpose`` of the
    gather)."""
    import torch
    from operator import add
    from bolt_tpu_torch.gpu import mesharray
    from bolt_tpu_torch.parallel import multihost
    from bolt_tpu_torch.parallel.mesh import make_mesh
    bolt = _bolt()
    ns, c1 = tuple(args["north_star"]), tuple(args["config1"])
    mesh = make_mesh((multihost.process_count(),), ("k",))
    out = {"rank": rank, "backend": multihost.backend()}
    _first_call(out, mesh)
    x = _on_mesh(mesh, ns, ("k", None, None, None), crafted_box)
    with _Path(out, "ns_map_sum"):
        out["map_sum"] = x.map(_add1).sum().toarray()
    with _Path(out, "ns_reduce"):
        out["reduce"] = x.reduce(add).toarray()
    with _Path(out, "ns_filter"):
        f = x.map(_add1).filter(_mean_pos)
        out["filter_sum"] = f.sum().toarray()
        out["filter_mean"] = x.map(_add1).filter(_mean_pos).mean().toarray()
    del x, f
    z = _on_mesh(mesh, ns, ("k", None, None, None), constant_box)
    with _Path(out, "ns_stats"):
        st = z.stats()
        out["const_stats"] = {k: np.asarray(getattr(st, k)()) for k in
                              ("mean", "variance", "min", "max")}
        out["const_count"] = int(st.count())
    zm = z.map(_add1)
    with _Path(out, "ns_group"):
        g = zm.stats(*GROUP_NAMES)
        out["const_group"] = {k: g[k].toarray() for k in GROUP_NAMES}
    del z, zm, st, g
    r = bolt.randn(ns, mesh, dtype=np.float32, seed=0)
    with _Path(out, "ns_randn"):
        got = r.map(_add1).sum().toarray()
        st = r.stats()
        mean, var = np.asarray(st.mean()), np.asarray(st.variance())
    box = r._data.reshape(r._data.shape[0], -1)
    s, q = multihost.all_reduce_sum(torch.stack(_f64_sums(box)),
                                    mesh.group(("k",)))
    n = ns[0]
    ref_sum = (s + n).reshape(ns[1:])
    ref_mean = (s / n).reshape(ns[1:])
    ref_var = (q / n - (s / n) ** 2).reshape(ns[1:])
    out["randn_err"] = {
        "sum": float((torch.from_numpy(got).to(s.device) - ref_sum).abs()
                     .max()),
        "mean": float((torch.from_numpy(mean).to(s.device) - ref_mean)
                      .abs().max()),
        "var_rel": float(((torch.from_numpy(var).to(s.device) - ref_var)
                          .abs() / ref_var.abs().clamp_min(1e-6)).max())}
    del r, box
    c = _on_mesh(mesh, c1, ("k", None, None, None), crafted_box)
    with _Path(out, "c1_swap"):
        sw = c.swap((0,), (0,))
        sw._data
    with _Path(out, "c1_toarray"):
        full = c.toarray()
        out["gather_stats"] = dict(mesharray._LAST_GATHER_STATS)
        swapped = sw.toarray()
    out["swap_equal"] = bool(np.array_equal(
        swapped, np.transpose(full, (1, 0, 2, 3))))
    out["swap_box"] = [list(b) for b in sw.box]
    out["swap_fp"] = fingerprint(sw._data)
    dev = multihost.local_device()
    out["toarray_fp"] = fingerprint(torch.from_numpy(full).to(dev))
    out["swapped_fp"] = fingerprint(torch.from_numpy(swapped).to(dev))
    del c, sw, full, swapped
    if args.get("stream"):
        _stream_ns(out, mesh, args["stream"])
        _stream_c1(out, mesh, args["stream"])
    if args.get("surface"):
        _surface_ns(out, mesh, args["surface"])
        _surface_ops(out, mesh, args["surface"])
    if args.get("numpy"):
        _numpy_two(out, mesh, args["numpy"])
    return out


def payload_card_pod4(rank, args, inputs):
    """The four-rank ``(2, 2)`` ``("k", "v")`` pod on one card at config
    1: the keys split on ``"k"`` and replicated on ``"v"`` (the sum folds
    over ``"k"`` alone), then ``chunk().shard("v")`` with a halo-padded
    map and ``ops.gaussian(..., shard="v")`` (the window kernels on each
    rank's halo-extended block), each rank's box fingerprinted."""
    from bolt_tpu_torch import ops
    from bolt_tpu_torch.parallel.mesh import make_mesh
    c1 = tuple(args["config1"])
    mesh = make_mesh((2, 2), ("k", "v"))
    out = {"rank": rank, "coords": list(mesh.coords().values())}
    _first_call(out, mesh)
    x = _on_mesh(mesh, c1, ("k", None, None, None), crafted_box)
    out["spec"] = list(x._spec)
    with _Path(out, "c1_sum"):
        out["map_sum"] = x.map(_add1).sum().toarray()
    with _Path(out, "c1_halo"):
        h = x.chunk(size=(args["chunk"],), axis=(0,), padding=2) \
            .shard("v").map(lambda blk: blk * 2 + 1)
        out["halo"] = {"box": [list(b) for b in h._barray.box],
                       "fp": fingerprint(h._barray._data),
                       "vshard": h.vshard}
    with _Path(out, "c1_gaussian"):
        g = ops.gaussian(x, 2.0, axis=(0, 2), shard="v")
        out["gaussian"] = {"box": [list(b) for b in g.box],
                           "fp": fingerprint(g._data)}
    del x, h, g
    if args.get("stream"):
        _stream_rep(out, mesh, args["stream"])
    if args.get("surface"):
        _surface_c1(out, mesh, args["surface"])
    if args.get("numpy"):
        _numpy_four(out, mesh, args["numpy"])
    return out


# ---------------------------------------------------------------------
# the card's streamed pods (chip_smoke.py phase 16): the phase 15 pods
# run these paths too when their args carry "stream", so no pod start is
# paid twice; each path is named "s16_..."
# ---------------------------------------------------------------------

def seeded_records(rec, seed=7, integers=False):
    """A ``fromcallback`` loader drawing record ``r`` from
    ``np.random.default_rng(seed + r)`` (``chip_smoke.py`` phase 6's):
    standard normals, or integers in [-8, 8]."""
    def cb(index):
        lo, hi = index[0].start, index[0].stop
        out = np.empty((hi - lo,) + tuple(rec), np.float32)
        for r in range(lo, hi):
            g = np.random.default_rng(seed + r)
            out[r - lo] = g.integers(-8, 9, rec) if integers else \
                g.standard_normal(rec, dtype=np.float32)
        return out
    return cb


def crafted_records(rec, constant=False):
    """A ``fromcallback`` loader of :func:`crafted_box`'s data (record
    ``r``, value slot ``j``: ``r % 8 - 4 + (j % 16) * 0.5``), or with
    ``constant`` of :func:`constant_box`'s (``(j % 16) * 0.5``)."""
    nv = int(np.prod(rec, dtype=np.int64))
    val = ((np.arange(nv) % 16) * 0.5).astype(np.float32)

    def cb(index):
        lo, hi = index[0].start, index[0].stop
        r = np.zeros(hi - lo, np.float32) if constant else \
            (np.arange(lo, hi) % 8 - 4).astype(np.float32)
        return (r[:, None] + val[None, :]).reshape((hi - lo,) + tuple(rec))
    return cb


def _counted(cb, rows):
    """``cb`` counting the records it produced into ``rows`` (the pool
    calls it from several threads; ``list.append`` is atomic)."""
    def f(index):
        rows.append(index[0].stop - index[0].start)
        return cb(index)
    return f


def _s16_path(out, name, fn, rows=None):
    """One phase 16 path: ``fn()`` measured (:class:`_Path`), with the
    records this rank's loader produced."""
    extra = {}
    with _Path(out, name, extra):
        got = fn()
        if rows is not None:
            extra["rows"] = sum(rows)
            del rows[:]
    return got


def _stream_ns(out, mesh, args):
    """Path a: the streamed north-star at full width, 160 slabs of 20
    records (10 a rank) under four uploaders a rank: phase 6's seeded
    ``randn`` records' ``map(v + 1).sum()`` and fluent group, then the
    crafted records' ``map(v + 1).sum()`` twice (the second pass must
    build nothing) and the constant columns' group."""
    from bolt_tpu_torch import stream
    bolt = _bolt()
    ns = tuple(args["north_star"])
    chunks = int(args["chunks"])
    rows = []
    res = out["s16"] = {}

    def src(cb):
        return bolt.fromcallback(_counted(cb, rows), ns, mesh,
                                 dtype=np.float32, chunks=chunks,
                                 per_process=True)

    randn = seeded_records(ns[1:], args["seed"])
    crafted = crafted_records(ns[1:])
    const = crafted_records(ns[1:], constant=True)
    with stream.uploaders(int(args["uploaders"])):
        res["randn_sum"] = _s16_path(out, "s16_ns_randn_sum", lambda: _value(
            src(randn).map(_add1).sum().cache()), rows)
        res["randn_group"] = _s16_path(out, "s16_ns_randn_group", lambda: {
            k: _value(v) for k, v in src(randn).map(_add1).stats(
                *GROUP_NAMES).items()}, rows)
        res["crafted_sum"] = _s16_path(out, "s16_ns_crafted_sum", lambda:
                                       _value(src(crafted).map(_add1).sum()
                                              .cache()), rows)
        res["crafted_again"] = _s16_path(out, "s16_ns_crafted_again",
                                         lambda: _value(src(crafted).map(
                                             _add1).sum().cache()), rows)
        res["const_group"] = _s16_path(out, "s16_ns_const_group", lambda: {
            k: _value(v) for k, v in src(const).map(_add1).stats(
                *GROUP_NAMES).items()}, rows)


def _stream_c1(out, mesh, args):
    """Path b on two ranks, crafted config 1: the streamed ``swap``
    through one ``all_to_all`` a slab (this rank's box fingerprinted), a
    pod spill refused, the codecs (``bf16`` half the bytes, ``delta-f32``
    the raw fold's bits, ``int8`` refused), an uneven slab refused with
    BLT012 and forecast, a one-shot ``fromiter`` refused, and the clean
    checkpointed sum path c's resumed run is held against."""
    from bolt_tpu_torch import analysis, stream
    bolt = _bolt()
    c1 = tuple(args["config1"])
    chunks = int(args["chunks"])
    crafted = crafted_records(c1[1:])
    res = out["s16"]

    def src(codec=None, chunks=chunks, cb=crafted, ckpt=None):
        return bolt.fromcallback(cb, c1, mesh, dtype=np.float32,
                                 chunks=chunks, per_process=True,
                                 codec=codec, checkpoint=ckpt)

    def swap():
        sw = src().swap((0,), (0,))
        data = sw._data
        return {"box": [list(b) for b in sw.box], "fp": fingerprint(data)}

    res["swap"] = _s16_path(out, "s16_c1_swap", swap)
    try:
        with stream.spill(dir=args["spill"], budget=1):
            src().swap((0,), (0,))._data
        res["pod_spill_refused"] = None
    except RuntimeError as exc:
        res["pod_spill_refused"] = str(exc)
    res["codec"] = {}
    for codec in (None, "delta-f32", "bf16"):
        res["codec"][codec or "raw"] = _s16_path(
            out, "s16_c1_%s" % (codec or "raw"),
            lambda: _value(src(codec).map(_add1).sum().cache()))
    try:
        src("int8").sum().cache()
        res["int8_refused"] = None
    except ValueError as exc:
        res["int8_refused"] = str(exc)
    bad = src(chunks=3).map(_add1)
    try:
        bad.sum().cache()
        res["blt012_refused"] = None
    except ValueError as exc:
        res["blt012_refused"] = str(exc)
    res["blt012_forecast"] = analysis.check(bad).has("BLT012")
    try:
        bolt.fromiter((crafted((slice(i, i + chunks),))
                       for i in range(0, c1[0], chunks)), c1, mesh,
                      dtype=np.float32)
        res["oneshot_refused"] = None
    except ValueError as exc:
        res["oneshot_refused"] = str(exc)
    res["clean_sum"] = _s16_path(out, "s16_c1_clean_ckpt", lambda: _value(
        _resume_source(bolt, mesh, args, args["ckpt_clean"]).map(_add1)
        .sum().cache()))


def _resume_source(bolt, mesh, args, ckpt):
    """Path c's checkpointed source: crafted config 1 on the pod."""
    c1 = tuple(args["config1"])
    return bolt.fromcallback(crafted_records(c1[1:]), c1, mesh,
                             dtype=np.float32, chunks=int(args["chunks"]),
                             per_process=True, checkpoint=ckpt)


def payload_card_resume(rank, args, inputs):
    """Path c on the card: the checkpointed crafted config 1 sum of a
    two-rank pod (the caller kills it mid-run on every rank, then runs it
    again, which resumes from the ranks' shards)."""
    from bolt_tpu_torch.parallel import multihost
    from bolt_tpu_torch.parallel.mesh import make_mesh
    bolt = _bolt()
    mesh = make_mesh((multihost.process_count(),), ("k",))
    out = {"rank": rank, "s16": {}}
    out["s16"]["sum"] = _s16_path(out, "s16_c1_resumed", lambda: _value(
        _resume_source(bolt, mesh, args, args["ckpt"]).map(_add1).sum()
        .cache()))
    return out


def _stream_int8(out, args):
    """Path d on the one NCCL rank: config 1's armed int8 streamed sum of
    integer-valued records, one ``fused_decode_sum`` a slab (a one-rank
    mesh streams as one device)."""
    import os
    from bolt_tpu_torch.parallel.mesh import default_mesh
    bolt = _bolt()
    c1 = tuple(args["config1"])
    cb = seeded_records(c1[1:], args["seed"], integers=True)
    os.environ["BOLT_CODEC_KERNEL"] = "1"
    try:
        out["s16"] = {"int8_sum": _s16_path(out, "s16_c1_int8", lambda:
                                            _value(bolt.fromcallback(
                                                cb, c1, default_mesh(),
                                                dtype=np.float32,
                                                chunks=int(args["chunks"]),
                                                codec="int8").sum()
                                                .cache()))}
    finally:
        os.environ.pop("BOLT_CODEC_KERNEL", None)


def _stream_rep(out, mesh, args):
    """Path b on four ranks: a key extent the ``(2, 2)`` mesh's ``"v"``
    axis does not divide (each box replicated on ``"v"``), streamed
    ``map(v + 1).sum()`` with no double count; then a checkpointed run on
    a mesh of half the pod's ranks (refused on the ranks in it)."""
    from bolt_tpu_torch.parallel import multihost
    from bolt_tpu_torch.parallel.mesh import Mesh
    bolt = _bolt()
    shape = tuple(args["replicated"])
    src = bolt.fromcallback(crafted_records(shape[1:]), shape, mesh,
                            dtype=np.float32,
                            chunks=int(args["replicated_chunks"]),
                            per_process=True)
    res = out["s16"] = {"spec": [list(e) if isinstance(e, tuple) else e
                                 for e in src._spec]}
    res["rep_sum"] = _s16_path(out, "s16_rep_sum", lambda: _value(
        src.map(_add1).sum().cache()))
    res["sub_pod_refused"] = None
    width = multihost.process_count() // 2
    if mesh.rank < width:
        sub = Mesh((width,), ("k",), [multihost.local_device()] * width)
        try:
            _resume_source(bolt, sub, args, args["ckpt_sub"]).sum().cache()
        except ValueError as exc:
            res["sub_pod_refused"] = str(exc)


# ---------------------------------------------------------------------
# pod recovery (the reference harness's reform, serve_pod, supervise and
# precollective payloads): a victim rank dies by BOLT_CHAOS=...:kill,
# the survivors catch PeerLostError, reform and resume; a replacement
# process (BOLT_POD_REJOINER=1: it brought up no pod) joins through
# supervisor.attach
# ---------------------------------------------------------------------

def _recovery_loader(args, pace=0.0):
    """``(shape, loader)`` of a recovery payload: the reference
    harness's ``crafted(n, vdim)`` (``args["shape"]`` of two axes), or
    ``crafted_records`` of the card's north-star (more axes), either
    slowed by ``pace`` seconds a call (an emulated storage fetch)."""
    shape = tuple(int(d) for d in args["shape"])
    if len(shape) == 2:
        x = crafted(*shape)

        def base(idx):
            return x[idx]
    else:
        base = crafted_records(shape[1:])

    def loader(idx):
        if pace:
            time.sleep(pace)
        return base(idx)
    return shape, loader


def _pod_device():
    from bolt_tpu_torch.parallel import multihost
    return multihost.local_device()


def _detection_age(podwatch, dead):
    """How stale the dead peer's beat was when this rank learned of it:
    the age its watch reports (the detection latency)."""
    return podwatch.peers().get(dead[0], {}).get("age") if dead else None


def payload_reform(rank, args, inputs):
    """Pod fault tolerance end to end (the reference's
    ``payload_reform``).  With ``BOLT_CHAOS`` armed on one rank (the
    victim), each survivor: (1) catches ``PeerLostError`` from the
    killed checkpointed streamed ``map(v + 1).sum()``, naming the dead
    rank; (2) sees ``multihost.barrier`` convert too; (3)
    ``multihost.reform``s onto the survivors (a ``FileStore`` at
    ``args["reform_store"]``); (4) resumes the sum from the killed
    pod's checkpoint (the topology remap); then (5) runs a checkpointed
    ``stats("sum", "var")`` on the reformed pod through an injected
    abort on every rank and its resume.  Run with no victim it is the
    clean baseline at the smaller width.  ``args["card"]`` adds, on the
    reformed pod, config 1's armed int8 sum and a resident
    ``map(v + 1).sum()`` (chip_smoke.py phase 17), each a measured
    path with its launches."""
    from bolt_tpu_torch import _chaos, engine, obs, stream
    from bolt_tpu_torch import checkpoint as ckptlib
    from bolt_tpu_torch.parallel import multihost, podwatch
    import os
    bolt = _bolt()
    pace = float(args.get("pace", 0))
    shape, loader = _recovery_loader(args, pace)
    chunks = int(args["chunks"])
    ck_sum = os.path.join(args["ckpt"], "sum")
    res = {"rank": rank, "start_nproc": multihost.process_count()}
    obs.clear()
    obs.enable()

    def make_sum():
        src = bolt.fromcallback(loader, shape, _pod_mesh(),
                                dtype=np.float32, chunks=chunks,
                                checkpoint=ck_sum, per_process=True)
        return src.map(_add1).sum()

    ec0 = engine.counters()
    t0 = time.monotonic()
    with stream.uploaders(int(args.get("uploaders", 1))):
        try:
            s = make_sum().cache()
            res["peer_lost"] = False
            res["wall_s"] = time.monotonic() - t0
        except multihost.PeerLostError as exc:
            t_caught = time.monotonic()
            res["peer_lost"] = True
            res["caught_s"] = t_caught - t0
            res["caught_peer"] = exc.peer
            res["caught_slab"] = exc.slab
            res["caught_phase"] = exc.phase
            deadline = podwatch.deadline() or 5.0
            while not podwatch.dead_peers() and \
                    time.monotonic() - t_caught < 2 * deadline:
                time.sleep(0.05)
            dead = podwatch.dead_peers()
            res["dead_peers"] = list(dead)
            res["detection_s"] = _detection_age(podwatch, dead)
            # (2) a barrier next to the dead peer converts on every
            # survivor within 2x the deadline
            tb = time.monotonic()
            try:
                multihost.barrier("post-loss-probe")
                res["barrier_peerlost"] = False
            except multihost.PeerLostError:
                res["barrier_peerlost"] = True
            res["barrier_s"] = time.monotonic() - tb
            res["watchdog_deadline"] = deadline
            # (3) reform onto the survivors (rank mapping from the watch)
            survivors = podwatch.alive_peers()
            c_lib = engine.counters()["persistent_misses"]
            tr = time.monotonic()
            res["new_pid"] = multihost.reform(
                store_path=args["reform_store"],
                num_processes=len(survivors))
            res["reform_s"] = time.monotonic() - tr
            res["reform_builds"] = \
                engine.counters()["persistent_misses"] - c_lib
            res["new_nproc"] = multihost.process_count()
            res["new_device"] = str(multihost.local_device())
            res["new_backend"] = multihost.backend()
            # (4) resume the checkpointed sum on the smaller pod
            t4 = time.monotonic()
            s = make_sum().cache()
            res["resume_s"] = time.monotonic() - t4
            res["recovery_s"] = time.monotonic() - t_caught
    res["sum"] = _value(s)
    ec1 = engine.counters()
    res["sum_resumes"] = ec1["stream_resumes"] - ec0["stream_resumes"]
    res["sum_stale_ckpt"] = ckptlib.stream_pending(ck_sum) \
        or bool([p for p in os.listdir(ck_sum) if p.startswith("stream_")]
                if os.path.isdir(ck_sum) else [])
    # the killed stream's and the resume's tallies (the card's measured
    # paths count their own from zero)
    _process_tallies(res)
    if args.get("card"):
        _reformed_card_paths(res, args)
    if args.get("stats", True):
        _reform_stats(res, args)
    res["nproc_final"] = multihost.process_count()
    res["leaked_spans"] = obs.active_count()
    obs.disable()
    return res


def _process_tallies(res):
    """This process's collective tallies (``multihost.counters()``: the
    exchanges of every pod it was part of) and kernel launches so far."""
    from bolt_tpu_torch.ops import kernels
    from bolt_tpu_torch.parallel import multihost
    res["collectives"] = multihost.counters()
    res["launches_total"] = {k: v for k, v in kernels.LAUNCHES.items()
                             if v}


def _reform_stats(res, args):
    """The reference's leg (5): a checkpointed ``stats("sum", "var")``
    of 128 crafted records in slabs of 16 on the (reformed) pod: on a
    pod every rank injects the same fault at its 5th upload (one
    uploader, so the same slab everywhere), the abort-path checkpoint
    (no barrier) is left, and the re-run resumes from it.  Skipped where
    a rank's rows of a slab are not a whole period of the data (the
    moments are then not exact at every width)."""
    import os
    from bolt_tpu_torch import _chaos, engine, stream
    from bolt_tpu_torch import checkpoint as ckptlib
    from bolt_tpu_torch.parallel import multihost
    bolt = _bolt()
    n2, chunks2 = 128, 16
    x2 = crafted(n2, int(args["shape"][-1]))
    ck = os.path.join(args["ckpt"], "stats")
    if n2 % (multihost.process_count() * 8):
        res["stats_skipped"] = multihost.process_count()
        return

    def make():
        src = bolt.fromcallback(lambda idx: x2[idx], x2.shape, _pod_mesh(),
                                dtype=np.float32, chunks=chunks2,
                                checkpoint=ck, per_process=True)
        return src.map(_add1).stats("sum", "var")

    ec1 = engine.counters()
    with stream.uploaders(1):
        if multihost.process_count() > 1:
            _chaos.inject("stream.upload", nth=5)
            try:
                _value(make()["sum"])
                res["stats_died"] = None
            except Exception as exc:    # noqa: BLE001 — recorded
                res["stats_died"] = type(exc).__name__
            finally:
                _chaos.clear()
            res["stats_ckpt_after_abort"] = ckptlib.stream_pending(ck)
        st = make()
        res["stats_sum"] = _value(st["sum"])
        res["stats_var"] = _value(st["var"])
    ec2 = engine.counters()
    res["stats_resumes"] = ec2["stream_resumes"] - ec1["stream_resumes"]
    res["stats_stale_ckpt"] = ckptlib.stream_pending(ck)


def _reformed_card_paths(res, args):
    """On the reformed one-rank pod (chip_smoke.py phase 17 path e):
    config 1's armed int8 streamed sum of integer-valued records (one
    ``fused_decode_sum`` a slab) and a resident ``map(v + 1).sum()`` of
    the crafted config 1 (one ``fused_map_reduce``), each a measured
    path."""
    import os
    from bolt_tpu_torch.parallel.mesh import default_mesh
    bolt = _bolt()
    c1 = tuple(args["config1"])
    out = {"rank": res["rank"]}
    cb = seeded_records(c1[1:], args["seed"], integers=True)
    os.environ["BOLT_CODEC_KERNEL"] = "1"
    try:
        res["int8_sum"] = _s16_path(out, "s17_c1_int8", lambda: _value(
            bolt.fromcallback(cb, c1, default_mesh(), dtype=np.float32,
                              chunks=int(args["c1_chunks"]),
                              codec="int8").sum().cache()))
    finally:
        os.environ.pop("BOLT_CODEC_KERNEL", None)
    x = crafted_records(c1[1:])((slice(0, c1[0]),))
    b = bolt.array(x, default_mesh())
    res["resident_sum"] = _s16_path(out, "s17_c1_resident", lambda: _value(
        b.map(_add1).sum()))
    res["paths"] = out["paths"]


def payload_serve_pod(rank, args, inputs):
    """Serve-layer pod degradation (the reference's ``payload_serve_pod``):
    a server per rank runs a streamed per-rank pipeline and the victim is
    killed mid-run; the survivor's future FAILS with ``PeerLostError``
    (never hangs), the arbiter reads zero bytes after it, admission
    drains until a reform notification resumes the queue."""
    from bolt_tpu_torch import obs, serve, stream
    from bolt_tpu_torch.parallel import multihost, podwatch
    bolt = _bolt()
    n, vdim, chunks = 64, 8, 8
    x = crafted(n, vdim)
    obs.clear()
    obs.enable()

    def make():
        src = bolt.fromcallback(lambda idx: x[idx], (n, vdim), _pod_mesh(),
                                dtype=np.float32, chunks=chunks,
                                per_process=True)
        return src.map(_add1).sum()

    res = {"rank": rank, "nproc": multihost.process_count()}
    with stream.uploaders(1):
        with serve.serving(workers=1, budget_bytes=16 << 20) as sv:
            fut = sv.submit(make(), tenant="podtest")
            exc = fut.exception(timeout=120)
            res["future_error"] = (type(exc).__name__ if exc is not None
                                   else None)
            res["future_peer"] = getattr(exc, "peer", None)
            res["arbiter_bytes_after_abort"] = \
                sv.stats()["arbiter"]["in_use_bytes"]
            t0 = time.monotonic()
            while not sv.pod_paused() and time.monotonic() - t0 < 30:
                time.sleep(0.05)
            res["pod_paused"] = sv.pod_paused()
            podwatch.notify_reform()
            res["pod_resumed"] = not sv.pod_paused()
    res["leaked_spans"] = obs.active_count()
    obs.disable()
    return res


def payload_precollective(rank, args, inputs):
    """The pre-collective death bound (the reference's
    ``payload_precollective``): the victim dies at its FIRST upload,
    before any exchange; the survivor's readiness rendezvous raises
    ``PeerLostError`` within ~2x ``BOLT_POD_TIMEOUT`` of the death.  The
    victim dies only once its own first run reached its first upload,
    so ``victim_last_beat_s`` (its last heartbeat on the shared-directory
    transport, on the host's clock, after this rank's start) dates the
    death."""
    import os
    from bolt_tpu_torch.parallel import multihost, podwatch
    bolt = _bolt()
    n, vdim, chunks = 64, 8, 8
    x = crafted(n, vdim)
    res = {"rank": rank, "deadline": podwatch.deadline()}
    # the mesh binds its process groups first (a store rendezvous both
    # ranks pass): the clock starts at the run itself
    mesh = _pod_mesh()
    t0, w0 = time.monotonic(), time.time()
    try:
        bolt.fromcallback(lambda idx: x[idx], (n, vdim), mesh,
                          dtype=np.float32, chunks=chunks,
                          per_process=True).map(_add1).sum().cache()
        res["pre_peerlost"] = False
    except multihost.PeerLostError as exc:
        res["pre_peerlost"] = True
        res["pre_elapsed"] = time.monotonic() - t0
        res["pre_phase"] = exc.phase
        res["pre_peer"] = exc.peer
        tr = podwatch.transport()
        beat = getattr(tr, "path", None) and os.path.join(
            tr.path, "hb.e%d.p%d" % (tr.epoch, exc.peer))
        if beat and os.path.exists(beat):
            res["victim_last_beat_s"] = os.path.getmtime(beat) - w0
    return res


def payload_raw_error(rank, args, inputs):
    """The raw error a dead gloo peer leaves (the watch OFF:
    ``BOLT_POD_TIMEOUT=0``): the victim (``BOLT_CHAOS=
    multihost.collective:2:kill``) dies at its second exchange, and the
    survivor records what its second collective raises and whether
    ``podwatch.is_transport_error`` classifies it."""
    import torch
    from bolt_tpu_torch.parallel import multihost, podwatch
    group = _pod_mesh().group(("k",))
    t = torch.ones(4)
    multihost.all_reduce_sum(t, group)
    time.sleep(0.5)
    res = {"rank": rank, "watch": podwatch.active()}
    try:
        multihost.all_reduce_sum(t, group)
        res["error"] = None
    except Exception as exc:            # noqa: BLE001 — recorded
        res["error"] = str(exc)
        res["error_type"] = type(exc).__name__
        res["classified"] = podwatch.is_transport_error(exc)
    return res


def payload_supervise(rank, args, inputs):
    """Self-healing end to end (the reference's ``payload_supervise``).
    Every rank runs ``Server(supervise=True)`` and submits, in the same
    order:

    * **A**, a checkpointed paced sum: the victim is killed mid-A; the
      survivors' futures succeed with no caller intervention (the held
      ``retries=`` re-attempt resumes once the supervisor's automatic
      shrink lands);
    * **B**, a checkpointed paced sum: a replacement process
      (``BOLT_POD_REJOINER=1``) rings the rejoin door mid-B; the pod
      quiesces at a slab-boundary checkpoint, the supervisor reforms up,
      and B's re-attempt resumes on the larger pod (the rejoiner submits
      B too and joins the resumed slab schedule);
    * **C**, ``stats("sum", "var")`` of period-4 crafted data
      (``args["stats"]``), a clean run on the re-expanded pod.

    Run with no victim and no rejoiner (the reference leg) all three
    stream clean.  ``args["shape"]`` of more than two axes streams the
    card's crafted north-star records."""
    import glob
    import os
    from bolt_tpu_torch import analysis, engine, obs, serve
    from bolt_tpu_torch import checkpoint as ckptlib
    from bolt_tpu_torch.parallel import multihost, podwatch, supervisor
    bolt = _bolt()
    out = args["out"]
    hbdir = os.environ["BOLT_POD_HB_DIR"]
    rejoiner = os.environ.get("BOLT_POD_REJOINER") == "1"
    pace = float(args.get("pace", 0.2))
    shape, loader = _recovery_loader(args, pace)
    chunks = int(args["chunks"])
    x2 = crafted(shape[0], 8, period=4) if len(shape) == 2 else None
    obs.clear()
    obs.enable()
    res = {"rank": rank, "rejoiner": rejoiner}
    deaths = []
    podwatch.on_peer_death(lambda dead: deaths.append(
        (dead, podwatch.peers().get(dead, {}).get("age"))))

    # jobs are FACTORIES: a retry after a reform rebuilds the pipeline on
    # the CURRENT mesh, and its checkpoint resumes through the remap
    def make_sum(name):
        def job():
            src = bolt.fromcallback(
                loader, shape, _pod_mesh(), dtype=np.float32,
                chunks=chunks, checkpoint=os.path.join(args["ckpt"], name),
                per_process=True)
            return src.map(_add1).sum().cache()
        return job

    def make_stats():
        def job():
            src = bolt.fromcallback(
                lambda idx: x2[idx], x2.shape, _pod_mesh(),
                dtype=np.float32, chunks=24,
                checkpoint=os.path.join(args["ckpt"], "statsC"),
                per_process=True)
            return src.map(_add1).stats("sum", "var")
        return job

    if rejoiner:
        # wait until every incumbent has B in flight, then ring the door
        want = int(args.get("expect_bstart", 2))
        hold = time.monotonic() + 300
        while len(glob.glob(os.path.join(out, "b_started.*"))) < want:
            if time.monotonic() > hold:
                raise RuntimeError("rejoiner: the B gate never opened")
            time.sleep(0.02)
        t0 = time.monotonic()
        spec = os.environ["BOLT_POD_DEVICE"]
        import torch
        device = torch.device("cuda", 0) if spec.startswith("cuda") \
            else torch.device(spec)
        sup = supervisor.attach(args.get("rejoin_id", "w1b"), dir=hbdir,
                                device=device,
                                backend=os.environ.get("BOLT_POD_BACKEND")
                                or None)
        res["attach_s"] = time.monotonic() - t0
        res["new_pid"] = multihost.process_index()
        res["new_nproc"] = multihost.process_count()
        sv = serve.start(workers=1, budget_bytes=64 << 20, supervise=sup)
    else:
        sv = serve.start(workers=1, budget_bytes=64 << 20, supervise=True)
    ec0 = engine.counters()
    try:
        if not rejoiner:
            tA = time.monotonic()
            sA = sv.submit(make_sum("sumA"), tenant="elastic",
                           retries=3).result(timeout=600)
            res["wall_a"] = time.monotonic() - tA
            res["sumA"] = _value(sA)
            ecA = engine.counters()
            res["a_resumes"] = ecA["stream_resumes"] - ec0["stream_resumes"]
            stA = sv.stats()
            res["a_reforms"] = stA["totals"]["reforms"]
            res["a_peer_losses"] = stA["totals"]["peer_losses"]
            res["budget_share_after_a"] = stA["pod"]["budget_share"]
            res["nproc_after_a"] = multihost.process_count()
            res["detection_age"] = deaths[0][1] if deaths else None
            supA = sv.supervisor.stats()
            res["reform_s"] = supA.get("last_reform_seconds")
            res["recovery_s"] = supA.get("last_recovery_seconds")
            tB = time.monotonic()
            futB = sv.submit(make_sum("sumB"), tenant="elastic", retries=3)
            gate = os.path.join(out, "b_started.%d" % rank)
            with open(gate + ".tmp", "w") as f:
                f.write("1")
            os.replace(gate + ".tmp", gate)
        else:
            tB = time.monotonic()
            futB = sv.submit(make_sum("sumB"), tenant="elastic", retries=3)
        ecB0 = engine.counters()
        sB = futB.result(timeout=600)
        res["wall_b"] = time.monotonic() - tB
        res["sumB"] = _value(sB)
        ecB = engine.counters()
        res["b_resumes"] = ecB["stream_resumes"] - ecB0["stream_resumes"]
        stB = sv.stats()
        res["reforms"] = stB["totals"]["reforms"]
        res["rejoins"] = stB["totals"]["rejoins"]
        res["supervise_seconds"] = stB["totals"]["supervise_seconds"]
        res["budget_share_after_b"] = stB["pod"]["budget_share"]
        res["nproc_after_b"] = multihost.process_count()
        res["rejoin_recovery_s"] = \
            sv.supervisor.stats().get("last_recovery_seconds")
        if x2 is not None:
            tC = time.monotonic()
            st = sv.submit(make_stats(), tenant="elastic",
                           retries=3).result(timeout=600)
            res["wall_c"] = time.monotonic() - tC
            res["statsC_sum"] = _value(st["sum"])
            res["statsC_var"] = _value(st["var"])
            n = shape[0]
            xs = crafted(*shape)
            blocks = [xs[i:i + chunks] for i in range(0, n, chunks)]
            fi = bolt.fromiter(blocks, shape, _pod_mesh(),
                               dtype=np.float32)
            res["blt014"] = analysis.check(fi.map(_add1)).has("BLT014")
            probe = bolt.fromcallback(lambda idx: xs[idx], shape,
                                      _pod_mesh(), dtype=np.float32,
                                      chunks=chunks, per_process=True)
            res["explain_supervised"] = \
                "SUPERVISED" in analysis.explain(probe.map(_add1))
        res["arbiter_bytes_after"] = sv.stats()["arbiter"]["in_use_bytes"]
    finally:
        serve.stop(wait=True)
    res["stale_ckpt"] = [name for name in ("sumA", "sumB", "statsC")
                         if ckptlib.stream_pending(
                             os.path.join(args["ckpt"], name))]
    tr = podwatch.transport()
    res["stale_markers"] = tr.stale_marker_count() if tr is not None else 0
    res["final_epoch"] = podwatch.epoch()
    _process_tallies(res)
    res["leaked_spans"] = obs.active_count()
    obs.disable()
    return res


def payload_nccl_reform(rank, args, inputs):
    """A one-rank NCCL pod on the card and a replacement process reform
    into two NCCL ranks on that one card: both refuse with the pointed
    ``ValueError`` (two ranks cannot share a GPU under NCCL, before and
    after a reform), and ``heal_backend_init`` then cleans the failed
    bring-up's store."""
    import os
    import torch
    from bolt_tpu_torch.parallel import multihost
    rejoiner = os.environ.get("BOLT_POD_REJOINER") == "1"
    res = {"rank": rank, "rejoiner": rejoiner,
           "before": None if rejoiner else multihost.backend()}
    try:
        multihost.reform(store_path=args["store"], num_processes=2,
                         process_id=1 if rejoiner else 0,
                         device=torch.device("cuda", 0), backend="nccl",
                         init_timeout=60)
        res["refused"] = None
    except ValueError as exc:
        res["refused"] = str(exc)
    res["healed"] = multihost.heal_backend_init()
    res["pod_up"] = multihost.is_initialized()
    return res


PAYLOADS.update({"reform": payload_reform,
                 "serve_pod": payload_serve_pod,
                 "precollective": payload_precollective,
                 "raw_error": payload_raw_error,
                 "nccl_reform": payload_nccl_reform,
                 "supervise": payload_supervise})


PAYLOADS.update({"card_one": payload_card_one,
                 "card_pod2": payload_card_pod2,
                 "card_pod4": payload_card_pod4,
                 "card_resume": payload_card_resume})


# ---------------------------------------------------------------------
# the array surface and the ops library on the card's pods (chip_smoke.py
# phase 18, inside phase 15's pods)
# ---------------------------------------------------------------------

def _boxed(t, b):
    """``{"box", "fp"}`` of this rank's box ``t`` of a mesh array ``b``."""
    return {"box": [list(x) for x in b.box], "fp": fingerprint(t)}


def _surface_ns(out, mesh, args):
    """The north-star split over the pod: three operator chains of the
    crafted data ending in ``sum``/``mean`` (one ``fused_map_reduce`` a
    rank each) and ``stats()`` of a chain of the constant columns (one
    ``fused_welford`` a rank)."""
    ns = tuple(args["north_star"])
    b = _on_mesh(mesh, ns, ("k", None, None, None), crafted_box)
    # Welford's f32 running mean rounds by the row partition, so the
    # chain's stats() takes the constant columns (phase 15's ns_stats)
    z = _on_mesh(mesh, ns, ("k", None, None, None), constant_box)
    res = out["s18"] = {}
    calls = (("ops_sum", lambda: (b * 2.0 + 1.0).sum().toarray()),
             ("ufunc_mean", lambda: np.add(b, 1.0).mean().toarray()),
             ("clip_sum", lambda: b.clip(-2.0, 2.0).sum().toarray()),
             ("ops_stats", lambda: _counter((z * 2.0 + 1.0).stats())))
    for name, fn in calls:
        with _Path(out, "s18_ns_" + name):
            res[name] = fn()
    del b, z


def _counter(st):
    """A ``StatCounter``'s mean, variance, min and max."""
    return {k: np.asarray(getattr(st, k)()) for k in
            ("mean", "variance", "min", "max")}


def _surface_ops(out, mesh, args):
    """The ops library at phase 9's shapes on the pod: ``pca``/``cov``/
    ``corrcoef`` of phase 9's scaled ``randn`` and ``segment_reduce``
    of its ``(8192, 1024, 64)`` records (each rank builds the single
    device's data and keeps its box), and ``unique`` with counts of
    config 1's crafted data doubled (integer-valued)."""
    import torch
    bolt = _bolt()
    from bolt_tpu_torch.parallel import sharding
    res = out["s18"]
    dev = mesh.device
    shape = tuple(args["pca"])
    full = bolt.randn(shape, context=dev, dtype=np.float32,
                      seed=int(args["pca_seed"])).totorch()
    full.mul_(torch.linspace(1.0, 4.0, shape[1], device=dev))
    b = _whole_to_mesh(mesh, full, 1)
    del full
    with _Path(out, "s18_pca"):
        _, comps, sv = bolt.ops.pca(b, k=4, center=True)
        res["pca"] = {"comps": comps, "sv": sv}
    with _Path(out, "s18_cov"):
        res["cov"] = bolt.ops.cov(b)
        res["corrcoef"] = bolt.ops.corrcoef(b)
    del b
    shape = tuple(args["segment"])
    nseg = int(args["nseg"])
    full = bolt.randn(shape, context=dev, dtype=np.float32,
                      seed=int(args["segment_seed"])).totorch()
    gen = torch.Generator(device=dev).manual_seed(
        int(args["segment_label_seed"]))
    lab = torch.randint(0, nseg, (shape[0],), generator=gen, device=dev)
    b = _whole_to_mesh(mesh, full, 1)
    del full
    with _Path(out, "s18_segment"):
        seg = bolt.ops.segment_reduce(b, lab, num_segments=nseg, op="sum")
        res["segment"] = seg.toarray()
    del b, seg
    c1 = tuple(args["config1"])
    spec = sharding.key_spec(mesh, c1, 1)
    c = _on_mesh(mesh, c1, spec, crafted_box) * 2.0
    with _Path(out, "s18_unique"):
        u, cnt = bolt.ops.unique(c, return_counts=True)
        res["unique"] = {"values": u, "counts": cnt}
    del c


def _whole_to_mesh(mesh, full, split):
    """A mesh array over this rank's box (``key_spec``) of the whole
    tensor ``full``, which every rank built alike."""
    from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
    from bolt_tpu_torch.parallel import sharding
    shape = tuple(full.shape)
    spec = sharding.key_spec(mesh, shape, split)
    box = full[sharding.box_slices(sharding.box(mesh, spec, shape))].clone()
    return BoltArrayMesh.wrap(box, mesh, shape, split, spec)


def _surface_c1(out, mesh, args):
    """Config 1's crafted data with both key axes split over the
    ``(2, 2)`` ``("k", "v")`` pod: quantiles over the keys, a sort, an
    argmax, a scan, a reshape that merges the keys, indexing, ``set``,
    ``concatenate`` and ``transpose``, each rank's box fingerprinted (the
    parent holds them against the single device's boxes)."""
    c1 = tuple(args["config1"])
    b = _on_mesh(mesh, c1, ("k", "v", None, None), crafted_box, split=2)
    res = out["s18"] = {"spec": [list(e) if isinstance(e, tuple) else e
                                 for e in b._spec]}

    def boxed(name, fn):
        with _Path(out, "s18_c1_" + name):
            r = fn()
            res[name] = _boxed(r._data, r)

    boxed("median", lambda: b.median())
    boxed("quantile", lambda: b.quantile([0.25, 0.75]))

    def sort():
        s = b.astype(np.float32)
        s.sort(axis=1)
        return s
    boxed("sort", sort)
    with _Path(out, "s18_c1_argmax"):
        res["argmax"] = int(b.argmax().toarray())
    boxed("cumsum", lambda: b.cumsum(axis=0))
    boxed("reshape", lambda: b.reshape((c1[0] * c1[1],) + c1[2:]))
    boxed("getitem", lambda: b[3:197, [0, 5, 9]])
    boxed("set", lambda: b.set(np.s_[90:110, 95:105, 10:20], -1.0))
    boxed("concatenate", lambda: b.concatenate(b, axis=0))
    boxed("transpose", lambda: b.transpose(1, 0, 3, 2))
    del b


# ---------------------------------------------------------------------
# numpy's function table on the card's pods (chip_smoke.py phase 19,
# inside phase 15's pods); each path is named "s19_..."
# ---------------------------------------------------------------------

def numpy_host_pred(v):
    """Phase 19's host predicate: it reads a record's mean on the host,
    which ``vmap`` cannot batch (the filter takes its host form)."""
    return float(np.asarray(v).mean()) > 1.0


def _numpy_two(out, mesh, args):
    """Phase 19 on the two-rank pod: at the north-star split 1600
    records a rank, ``b = x + 1`` of the crafted data (a deferred chain,
    so its sums read the base through the kernel): ``np.sum(b * 2 + 1)``
    and ``np.mean(b, axis=0)`` (one ``fused_map_reduce`` a rank each), and
    ``np.var(t, axis=0)`` of a chain of the trend data, whose ranks'
    boxes differ in mean and variance (one ``fused_welford`` a rank); at
    config 1, ``map(with_keys=True).sum()``, a host-predicate
    ``filter(...).sum()`` and ``stats("sum", "max", accumulate="bf16")``."""
    ns, c1 = tuple(args["north_star"]), tuple(args["config1"])
    res = out["s19"] = {}
    b = _on_mesh(mesh, ns, ("k", None, None, None), crafted_box) + 1.0
    with _Path(out, "s19_ns_sum"):
        res["sum"] = np.sum(b * 2.0 + 1.0).toarray()
    with _Path(out, "s19_ns_mean"):
        res["mean"] = np.mean(b, axis=0).toarray()
    del b
    t = _on_mesh(mesh, ns, ("k", None, None, None), trend_box) + 1.0
    with _Path(out, "s19_ns_var"):
        res["var"] = np.var(t, axis=0).toarray()
    del t
    c = _on_mesh(mesh, c1, ("k", None, None, None), crafted_box)
    with _Path(out, "s19_c1_with_keys"):
        res["with_keys"] = c.map(lambda kv: kv[1] + kv[0][0],
                                 with_keys=True).sum().toarray()
    with _Path(out, "s19_c1_host_filter"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            f = c.filter(numpy_host_pred)
        res["host_filter"] = {"count": int(f.shape[0]),
                              "sum": f.sum().toarray()}
    with _Path(out, "s19_c1_accumulate"):
        g = c.stats("sum", "max", accumulate="bf16")
        res["accumulate"] = {k: v.toarray() for k, v in g.items()}
    del c, f, g


def _numpy_four(out, mesh, args):
    """Phase 19 on the four-rank ``(2, 2)`` pod: config 1's crafted data
    with both key axes split, through numpy's table: a contraction over a
    sharded axis (the fold), ``tensordot`` over a value axis, the stack
    family, ``roll`` and ``pad`` across box edges, ``broadcast_to``,
    ``where``, ``nanmean``, the flat sort, ``rfft`` along a sharded axis,
    ``linalg.inv`` over the sharded batch and ``split``, each rank's box
    fingerprinted; for ``rfft`` and ``inv``, which the single device's
    need not equal bit for bit, each rank also builds the single
    device's result of the whole data (after the measured path) and
    reports its whole box's largest error against it, relative to the
    box's largest magnitude; ``cov``, ``histogram`` and ``unique`` (host
    results) as they come."""
    import torch
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    from bolt_tpu_torch.parallel import sharding
    c1 = tuple(args["config1"])
    b = _on_mesh(mesh, c1, ("k", "v", None, None), crafted_box, split=2)
    w = (np.arange(c1[3] * 8) % 5).astype(np.float32).reshape(c1[3], 8)
    eye = np.float32(1000.0) * np.eye(c1[3], dtype=np.float32)
    res = out["s19"] = {}

    def boxed(name, fn, close=False):
        with _Path(out, "s19_c1_" + name):
            r = fn(b)
            parts = r if isinstance(r, list) else [r]
            res[name] = [dict(_boxed(p._data, p), shape=list(p.shape),
                              split=int(p.split)) for p in parts]
        if close:
            one = fn(BoltArrayGPU(crafted_box(c1, tuple((0, k) for k in c1),
                                              mesh.device), 2, mesh.device))
            want = one.totorch()[sharding.box_slices(parts[0].box)]
            got = parts[0]._data
            res[name][0]["err"] = float((got - want).abs().max()
                                        / want.abs().max())
            res[name][0]["bits"] = bool(torch.equal(got, want))
            del one, want

    def host(name, fn):
        with _Path(out, "s19_c1_" + name):
            res[name] = fn()

    boxed("einsum", lambda x: np.einsum("ijkl->jkl", x))
    boxed("tensordot", lambda x: np.tensordot(x, w, axes=([3], [0])))
    boxed("stack", lambda x: np.stack([x, x]))
    boxed("concatenate", lambda x: np.concatenate([x, x], axis=1))
    boxed("roll", lambda x: np.roll(x, 3, axis=0))
    boxed("pad", lambda x: np.pad(x, ((0, 0), (2, 1), (0, 0), (0, 0)),
                                  mode="reflect"))
    boxed("broadcast_to", lambda x: np.broadcast_to(x, (2,) + c1))
    host("cov", lambda: np.cov(b[:, 0, :, 0], rowvar=False))
    host("histogram", lambda: list(np.histogram(b, bins=64)))
    boxed("where", lambda x: np.where(x > 0, x, 0.0))
    boxed("nanmean", lambda x: np.nanmean(x))
    boxed("sort", lambda x: np.sort(x, axis=None))
    host("unique", lambda: list(np.unique(b, return_counts=True)))
    boxed("rfft", lambda x: np.fft.rfft(x, axis=1), close=True)
    boxed("inv", lambda x: np.linalg.inv(x + eye), close=True)
    boxed("split", lambda x: np.split(x, 4, axis=0))
    del b
