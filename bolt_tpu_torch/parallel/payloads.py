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
    """Outside the slice a multi-rank mesh array raises, naming the
    ROADMAP item."""
    bolt = _bolt()
    b = bolt.array(inputs["main_x"], mesh)
    out = {}
    calls = {
        "quantile": lambda: np.quantile(b, 0.5),
        "stream": lambda: bolt.fromcallback(
            lambda idx: inputs["main_x"][idx], inputs["main_x"].shape,
            mesh, dtype=np.float64),
        "getitem": lambda: b[0:2],
        "add": lambda: b + 1,
        "asarray": lambda: np.asarray(b),
    }
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except NotImplementedError as exc:
            out[name] = str(exc)
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
    return out


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


PAYLOADS = {
    "checks": payload_checks,
    "dryrun": payload_dryrun,
    "sched": payload_sched,
    "sleep": payload_sleep,
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


def _on_mesh(mesh, shape, spec, make):
    """A mesh array of ``shape`` laid out by ``spec``, each rank's box
    built on its device by ``make(shape, box, device)``."""
    from bolt_tpu_torch.parallel import sharding
    sh = sharding.Sharding(mesh, spec, shape)
    part = make(shape, sh.box(), mesh.device)
    return sharding.assemble_from_parts(shape, sh, [part], split=1)


class _Path:
    """One measured path of a card pod: its wall, the rank's peak device
    memory growth, its kernel launches and collective bytes, all counted
    from 0 at the start."""

    def __init__(self, out, name):
        self.out, self.name = out, name

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
        kernels.reset_launches()
        multihost.reset_counters()
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
        rec = {"wall_s": time.monotonic() - self.t0,
               "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
               "collectives": multihost.counters()}
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
    return out


PAYLOADS.update({"card_one": payload_card_one,
                 "card_pod2": payload_card_pod2,
                 "card_pod4": payload_card_pod4})
