"""Multi-process (pod) execution: the ``torch.distributed`` bootstrap,
the topology queries, the named barrier, the dispatch-schedule verifier
and the collective wrappers.

Port of ``bolt_tpu/parallel/multihost.py``.  The reference keeps JAX's
single-controller model: one process drives a global mesh and XLA
inserts the collectives.  The port takes PyTorch's SPMD model instead:
one process per rank, each owning one ``torch.device``, every rank
calling the same methods in the same order (``torchrun``'s model).  This
module is the ONE place that touches ``torch.distributed`` (lint rule
BLT110): every other module calls the wrappers below.

* :func:`initialize` / :func:`shutdown` / :func:`is_initialized` — bring
  the process group up and down.  ``initialize`` creates its own
  key-value store (a ``FileStore`` when ``store_path`` is given, a
  ``TCPStore`` on ``coordinator_address`` otherwise) and hands it to
  ``init_process_group``; the same store serves :func:`barrier` and
  :func:`verify_schedule`.
* The backend is explicit: ``"nccl"`` when every rank owns a distinct
  GPU, ``"gloo"`` on the CPU, and ``"gloo"`` with CUDA tensors, where each
  collective copies its tensors to the host and back — counted in
  :func:`counters` as ``collective_host_bytes``.  ``"nccl"`` with two
  ranks on one device is refused before NCCL is touched.  Nothing falls
  back from one backend to another, or from the card to the CPU.
* The collectives (:func:`all_gather`, :func:`fold_partials`,
  :func:`all_reduce_sum`, :func:`all_to_all`, :func:`broadcast`,
  :func:`ppermute`) move raw bytes, so every dtype travels exactly.
  Folds are deterministic: the partials are gathered and combined in
  rank order on every rank, so every rank returns the same bits whatever
  the backend's reduction order.  While the liveness watch runs
  (:mod:`bolt_tpu_torch.parallel.podwatch`, started by
  :func:`initialize` on a pod of more than one rank) every collective
  is issued with ``async_op=True`` and its ``Work`` is polled against
  the watch, so a dead peer raises ``PeerLostError`` instead of
  blocking in C++ (a gloo op already blocked there is bounded only by
  the group's ``timeout``).
* :func:`reform` rebuilds the process group at another width: on the
  survivors of a peer death, or on survivors plus rejoined processes
  (``parallel.supervisor`` drives it); :func:`heal_backend_init` cleans
  up after a failed bring-up.
"""

import datetime
import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from bolt_tpu_torch.parallel import podwatch
from bolt_tpu_torch.parallel.podwatch import PeerLostError  # noqa: F401 — the
#   re-export: callers catch multihost.PeerLostError

# ---------------------------------------------------------------------
# bootstrap / teardown
# ---------------------------------------------------------------------


class _Pod:
    """The live process group this module brought up."""

    __slots__ = ("rank", "world", "backend", "device", "store",
                 "store_dir", "seq")

    def __init__(self, rank, world, backend, device, store, store_dir):
        self.rank = rank
        self.world = world
        self.backend = backend
        self.device = device
        self.store = store
        self.store_dir = store_dir     # a temporary FileStore directory
        self.seq = {}                  # barrier / verify name -> calls


_POD = None
_EPOCH = [0]                           # pods brought up by this process
_DEFAULT_TIMEOUT = 120.0               # seconds: bring-up and every wait

_COUNTS = {"collectives": 0, "collective_bytes": 0,
           "collective_host_bytes": 0}

# the last bring-up's rank, device and backend (kept past a teardown for
# reform), and its store while that bring-up has failed and is not yet
# healed (heal_backend_init's to clean; a bring-up that completes, or a
# heal, drops it: a pod shut down cleanly leaves nothing to heal)
_BRINGUP = {"store": None, "rank": None, "device": None, "backend": None}


def _env_int(name):
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def _default_device(rank):
    """The device a rank owns when ``initialize`` is given none: the
    card ``LOCAL_RANK`` names (else ``rank`` modulo the card count).
    Raises without CUDA: a pod never moves to the CPU on its own."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "multihost.initialize without device= puts each rank on a "
            "CUDA device, but CUDA is not available here; pass "
            "device=torch.device('cpu') (and backend='gloo') to run a "
            "pod on the CPU")
    local = _env_int("LOCAL_RANK")
    index = local if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def _device_identity(device):
    """A string naming the physical device across processes: the host
    and the card's UUID (its index where the UUID is not reported)."""
    host = os.uname().nodename
    if device.type != "cuda":
        return "%s/%s" % (host, device.type)
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return "%s/cuda/%s" % (host, uuid if uuid is not None
                           else (device.index or 0))


def shared_devices(identities):
    """``(rank_a, rank_b, identity)`` for the first two ranks of
    ``identities`` (one string a rank, :func:`_device_identity`) that
    name the same device, or ``None``."""
    seen = {}
    for rank, ident in enumerate(identities):
        if ident in seen:
            return seen[ident], rank, ident
        seen[ident] = rank
    return None


def _refuse_shared_nccl(store, rank, world, device, timeout):
    """NCCL cannot run two ranks on one device (it fails later with its
    "duplicate GPU" error): every rank publishes its device's identity
    through the store and each refuses, with the same pointed
    ``ValueError``, when two ranks share one."""
    wait = datetime.timedelta(seconds=timeout)
    store.set("bolt/device/%d" % rank, _device_identity(device))
    keys = ["bolt/device/%d" % r for r in range(world)]
    store.wait(keys, wait)
    idents = [store.get(k).decode() for k in keys]
    # every rank has read every identity before any goes on (a refused
    # rank's heal_backend_init deletes its key)
    if store.add("bolt/device/read", 1) == world:
        store.set("bolt/device/read/all", "1")
    store.wait(["bolt/device/read/all"], wait)
    hit = shared_devices(idents)
    if hit is not None:
        a, b, ident = hit
        raise ValueError(
            "backend='nccl' needs a distinct GPU per rank, but ranks %d "
            "and %d both run on %s; give each rank its own card, or run "
            "ranks that share a card with backend='gloo' (collectives "
            "then stage through the host, counted as "
            "collective_host_bytes)" % (a, b, ident))


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend=None, device=None,
               store_path=None, timeout=None):
    """Bring up the pod's process group.

    ::

        multihost.initialize(num_processes=2, process_id=rank,
                             store_path="/tmp/pod.store",
                             device=torch.device("cpu"))

    Arguments come from the call, else from ``torchrun``'s environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``,
    ``LOCAL_RANK``).  With neither, this is a single process and the call
    is a no-op returning ``False``.  ``device`` is the card this rank
    owns (default: ``cuda:LOCAL_RANK``; raises without CUDA), ``backend``
    ``"nccl"`` for a CUDA device and ``"gloo"`` otherwise.  The key-value
    store is a ``FileStore`` at ``store_path`` (no port to race for: what
    the tests and the harness use) or a ``TCPStore`` at
    ``coordinator_address`` (``host:port``, rank 0 serving it).  Every
    wait is bounded by ``timeout`` seconds (default 120).  On a pod of
    more than one rank the liveness watch starts
    (``podwatch.start``; ``BOLT_POD_TIMEOUT=0`` disables it).
    Idempotent: returns ``True`` when this call brought the group up,
    ``False`` when it was already up."""
    if _POD is not None:
        return False
    world = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE")
    if world is None:
        return False
    world = int(world)
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None:
        raise ValueError("multihost.initialize needs process_id= (or "
                         "RANK) for a %d-process pod" % world)
    if store_path is None and coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), \
            os.environ.get("MASTER_PORT")
        if addr and port:
            coordinator_address = "%s:%s" % (addr, port)
        elif world != 1:
            raise ValueError(
                "multihost.initialize needs store_path= (a FileStore "
                "every rank can reach) or coordinator_address= "
                "(host:port, or MASTER_ADDR/MASTER_PORT)")
    _bring_up(coordinator_address, world, int(rank), backend, device,
              store_path, timeout)
    if world > 1:
        podwatch.start(world, int(rank))
    return True


def _bring_up(coordinator_address, world, rank, backend, device,
              store_path, timeout):
    """The process group of ``world`` ranks with this process as
    ``rank``, on its own store: :func:`initialize`'s and
    :func:`reform`'s shared half."""
    global _POD
    if not 0 <= rank < world:
        raise ValueError("process_id %d out of range for %d processes"
                         % (rank, world))
    timeout = float(_DEFAULT_TIMEOUT if timeout is None else timeout)
    device = _default_device(rank) if device is None \
        else torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError("backend must be 'nccl' or 'gloo', got %r"
                         % (backend,))
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("backend='nccl' needs a CUDA device, got %s; "
                         "use backend='gloo' on the CPU" % device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    wait = datetime.timedelta(seconds=timeout)
    store_dir = None
    if store_path is None and coordinator_address is None:
        store_dir = tempfile.mkdtemp(prefix="bolt-pod-")
        store_path = os.path.join(store_dir, "store")
    if store_path is not None:
        store = dist.FileStore(str(store_path), world)
        store.set_timeout(wait)
    else:
        host, _, port = str(coordinator_address).rpartition(":")
        store = dist.TCPStore(host, int(port), world, rank == 0,
                              timeout=wait)
    _BRINGUP.update(store=store, rank=rank, device=device,
                    backend=backend)
    if backend == "nccl":
        _refuse_shared_nccl(store, rank, world, device, timeout)
    # the process group works on its own namespace of the store, so its
    # keys never meet this module's barrier and digest keys
    dist.init_process_group(backend, store=dist.PrefixStore("pg", store),
                            rank=rank, world_size=world, timeout=wait)
    # a first collective, on the backend's own device: a backend that
    # cannot run here fails now, not in the middle of a pipeline
    probe = torch.zeros(1, device=device if backend == "nccl" else "cpu")
    dist.all_reduce(probe)
    _POD = _Pod(rank, world, backend, device, store, store_dir)
    _BRINGUP["store"] = None
    _EPOCH[0] += 1


def shutdown():
    """Tear down the process group :func:`initialize` brought up (no-op
    otherwise); returns whether it did.  The liveness watch says
    farewell first (a peer still streaming must not latch a clean leaver
    dead); next to a dead peer the group is dropped with no rendezvous."""
    global _POD
    if _POD is None:
        return False
    podwatch.stop(farewell=True)
    pod, _POD = _POD, None
    try:
        _drop_group(_DEFAULT_TIMEOUT)
    finally:
        if pod.store_dir is not None:
            shutil.rmtree(pod.store_dir, ignore_errors=True)
    return True


def _drop_group(timeout):
    """Destroy the default process group with no barrier (a peer may be
    dead), the wait bounded by ``timeout`` seconds.  Gloo drops a group
    with a dead peer at once; a destroy still running past the bound is
    refused pointedly rather than waited on."""
    if not dist.is_initialized():
        return
    if not podwatch.bounded(dist.destroy_process_group, timeout,
                            "multihost.destroy_process_group"):
        raise RuntimeError(
            "multihost: destroying the old process group did not return "
            "within %.1fs; this process cannot bring up another one"
            % timeout)


def is_initialized():
    """Did :func:`initialize` bring the process group up?"""
    return _POD is not None


def backend():
    """The pod's backend (``"nccl"``/``"gloo"``), or ``None`` in a single
    process."""
    return None if _POD is None else _POD.backend


def epoch():
    """How many pods this process has brought up: a cache of meshes
    keyed on it never serves a pod that was shut down."""
    return _EPOCH[0]


def pod_devices(timeout=None):
    """Every rank's device in rank order, exchanged through the pod's
    store (each rank knows only its own)."""
    if _POD is None:
        return []
    key = _next_tag("devices", "mesh")
    store = _POD.store
    store.set("%s/%d" % (key, _POD.rank), str(_POD.device))
    keys = ["%s/%d" % (key, r) for r in range(_POD.world)]
    store.wait(keys, datetime.timedelta(
        seconds=_DEFAULT_TIMEOUT if timeout is None else float(timeout)))
    return [torch.device(store.get(k).decode()) for k in keys]


def local_device():
    """The device this rank owns (given to :func:`initialize`), or
    ``None`` when no pod is up."""
    return None if _POD is None else _POD.device


def pod_store():
    """The pod's key-value store (the liveness watch's ``KVTransport``
    rides it), or ``None`` when no pod is up."""
    return None if _POD is None else _POD.store


def reform(coordinator_address=None, num_processes=None, process_id=None,
           epoch=None, init_timeout=None, store_path=None, device=None,
           backend=None):
    """Shrink-or-grow-and-resume: rebuild the process group as a
    ``num_processes``-rank pod, on the SURVIVORS of a peer death or on
    survivors plus rejoined processes (``parallel.supervisor`` drives
    that).

    ::

        try:
            big.sum().cache()              # 3-rank pod, a peer dies
        except multihost.PeerLostError:
            multihost.reform("127.0.0.1:29511", num_processes=2)
            ...rebuild the mesh, re-run the pipeline: it resumes from
            the checkpoint through the topology remap...

    Every member calls it with the SAME new store: a ``TCPStore`` at
    ``coordinator_address`` (``host:port``, served by the new rank 0) or
    a ``FileStore`` at ``store_path`` (a path fresh for this reform); a
    reform onto one rank may name neither (a store of its own).
    ``process_id`` defaults to this rank's index among
    ``podwatch.alive_peers()`` (every survivor computes the same
    mapping).  The old group is dropped with no barrier and its pending
    ``Work`` is never waited on again; the new one comes up on the SAME
    ``torch.device`` this rank owned, with the same backend (``device=``
    and ``backend=`` only for a fresh process, the rejoiner, which has
    nothing to tear down): NCCL with two ranks on one card stays
    refused, and nothing falls back to gloo or to the CPU.  The
    engine's program cache is cleared (no kernel library is rebuilt).
    ``init_timeout`` bounds the teardown and the bring-up (the
    supervisor passes a short one so a second death mid-reform fails
    the attempt fast).  The liveness watch restarts at ``epoch`` (the
    supervisor's plan carries it), stale markers are swept, and
    ``podwatch.on_reform`` subscribers are notified last.  Returns the
    new rank."""
    global _POD
    if num_processes is None or int(num_processes) < 1:
        raise ValueError("reform num_processes must be >= 1, got %r"
                         % (num_processes,))
    if process_id is None:
        alive = podwatch.alive_peers()
        if not alive:
            raise RuntimeError(
                "multihost.reform needs process_id= when no liveness "
                "watch is running (the survivors' rank mapping comes "
                "from podwatch.alive_peers)")
        old = process_index()
        if old not in alive:
            raise RuntimeError(
                "multihost.reform: this process (%d) is not among the "
                "surviving peers %s" % (old, list(alive)))
        process_id = alive.index(old)
    if coordinator_address is None and store_path is None \
            and int(num_processes) > 1:
        raise ValueError("multihost.reform needs the new store: "
                         "coordinator_address= (host:port) or "
                         "store_path= (a fresh FileStore path)")
    timeout = float(_DEFAULT_TIMEOUT if init_timeout is None
                    else init_timeout)
    if _POD is not None:
        device, backend = _POD.device, _POD.backend
    elif device is None:
        device, backend = _BRINGUP["device"], backend or _BRINGUP["backend"]
    podwatch.stop(farewell=True)
    pod, _POD = _POD, None
    try:
        _drop_group(timeout)
    finally:
        if pod is not None and pod.store_dir is not None:
            shutil.rmtree(pod.store_dir, ignore_errors=True)
    from bolt_tpu_torch import engine as _engine
    _engine.clear()
    _bring_up(coordinator_address, int(num_processes), int(process_id),
              backend, device, store_path, timeout)
    if int(num_processes) > 1:
        podwatch.start(int(num_processes), int(process_id), epoch=epoch)
        podwatch.sweep_stale_markers()
    podwatch.notify_reform()
    return int(process_id)


def heal_backend_init():
    """Clean up after a FAILED bring-up (an ``initialize`` or ``reform``
    that raised part way): destroy a half-registered default process
    group, delete the keys this rank published in the failed bring-up's
    store (its device identity), drop the engine's programs, and emit
    ``multihost.backend_heal``, so the next bring-up starts clean.
    Returns ``True`` only when a live store was found to heal against."""
    if _POD is not None:
        return False              # a healthy pod: nothing to heal
    if dist.is_initialized():
        try:
            _drop_group(_DEFAULT_TIMEOUT)
        except Exception:         # noqa: BLE001 — best effort: the
            pass                  # group is unusable either way
    store, rank = _BRINGUP["store"], _BRINGUP["rank"]
    if store is None:
        return False              # no failed bring-up to heal
    _BRINGUP["store"] = None
    try:
        store.check(["bolt/device/%d" % rank])
    except Exception:             # noqa: BLE001 — a dead store: nothing
        return False              # to heal there
    try:
        store.delete_key("bolt/device/%d" % rank)
    except Exception:             # noqa: BLE001 — absent key
        pass
    from bolt_tpu_torch import engine as _engine
    _engine.clear()
    from bolt_tpu_torch.obs import trace as _obs
    _obs.event("multihost.backend_heal", process_id=rank)
    return True


# ---------------------------------------------------------------------
# the per-rank ingest contract of a streamed pod (bolt_tpu_torch.stream)
# ---------------------------------------------------------------------

class LocalSlabSpec:
    """The per-rank slab contract of one streamed source geometry: which
    contiguous sub-range of each slab's leading key axis THIS rank
    produces and uploads.  Built by :func:`local_slab_spec`; read by the
    streaming executor's uploader pool.

    ``local_range(lo, hi)`` maps a global slab ``[lo, hi)`` to this
    rank's ``[llo, lhi)`` in GLOBAL record coordinates (the slices a
    ``fromcallback(..., per_process=True)`` loader is called with): the
    leading-axis extent of the rank's box under the key sharding of the
    slab.  Replica ranks of one box (mesh axes that shard no key axis)
    get the same range.  Raises the pointed BLT012 error when the slab
    extent does not divide the key-axis assignment (no per-rank split
    exists)."""

    __slots__ = ("mesh", "shape", "split", "pid", "nproc", "_cache")

    def __init__(self, mesh, shape, split):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.split = int(split)
        self.pid = process_index()
        self.nproc = mesh_process_count(mesh)
        self._cache = {}

    def local_range(self, lo, hi):
        """Global-coordinate ``[llo, lhi)`` of slab ``[lo, hi)`` this
        rank ingests (the whole slab on a one-rank mesh)."""
        llo, lhi = self._local_box(hi - lo)
        return lo + llo, lo + lhi

    def _local_box(self, nrec):
        """This rank's leading-axis range ``(llo, lhi)`` RELATIVE to a
        slab of ``nrec`` records, from its box under the key sharding of
        the slab; a layout whose rank boundary does not fall on the
        leading key axis (the box is not whole records) is refused
        instead of silently mis-ingested."""
        got = self._cache.get(nrec)
        if got is not None:
            return got
        if self.nproc <= 1:
            out = (0, nrec)
            self._cache[nrec] = out
            return out
        err = slab_divisibility_error(self.mesh, self.shape, self.split,
                                      [(0, nrec)])
        if err is not None:
            raise ValueError(err)
        from bolt_tpu_torch.parallel.sharding import box, key_spec
        shape = (nrec,) + self.shape[1:]
        bx = box(self.mesh, key_spec(self.mesh, shape, self.split), shape)
        llo, lhi = bx[0]
        vol = int(np.prod([e - s for s, e in bx], dtype=np.int64))
        want = (lhi - llo) * int(np.prod(self.shape[1:], dtype=np.int64))
        if vol != want:
            raise ValueError(
                "multi-process streaming needs the process boundary on "
                "the leading key axis: this mesh scatters process %d's "
                "devices across a non-contiguous region of a %d-record "
                "slab; use a mesh whose leading axis spans the "
                "processes in order" % (self.pid, nrec))
        out = (llo, lhi)
        self._cache[nrec] = out
        return out


def local_slab_spec(mesh, shape=None, split=None):
    """The :class:`LocalSlabSpec` of one streamed geometry: ``(mesh,
    shape, split)``, or one source-like object with ``.mesh`` /
    ``.shape`` / ``.split`` attributes (a ``stream.StreamSource``)."""
    if shape is None and hasattr(mesh, "mesh"):
        src = mesh
        return LocalSlabSpec(src.mesh, src.shape, src.split)
    return LocalSlabSpec(mesh, shape, split)


def key_collective_axes(mesh, shape, split):
    """The mesh-axis names the leading ``split`` key axes of ``shape``
    shard over: the axes a streamed pod's per-slab fold reduces across
    (the other axes hold replicas, which are never counted twice)."""
    from bolt_tpu_torch.parallel.sharding import key_spec, spec_names
    spec = key_spec(mesh, shape, split)
    return tuple(n for e in tuple(spec)[:split] for n in spec_names(e))


def slab_divisibility_error(mesh, shape, split, ranges):
    """The BLT012 rule, as one shared message (``analysis.check`` emits
    it as a diagnostic; the streaming executor raises it): every slab's
    leading extent must keep the SAME key-axis assignment the full shape
    has, or per-rank sub-slabs do not exist for that slab and the fold
    over the ranks would double-count replicated records.  Returns the
    message, or ``None`` when every slab in ``ranges`` divides."""
    if mesh_process_count(mesh) <= 1:
        return None
    full_axes = key_collective_axes(mesh, shape, split)
    if not full_axes:
        width = int(np.prod([mesh.shape[n] for n in mesh.axis_names
                             if mesh.shape[n] > 1], dtype=np.int64))
        return ("BLT012: key axes %s do not divide the %d-device "
                "multi-process mesh %s, so no per-process shard "
                "assignment exists; choose key extents divisible by "
                "the mesh axis sizes"
                % (tuple(shape[:split]), width, dict(mesh.shape)))
    for lo, hi in ranges:
        slab_shape = (hi - lo,) + tuple(shape[1:])
        axes = key_collective_axes(mesh, slab_shape, split)
        if axes != full_axes:
            width = int(np.prod([mesh.shape[n] for n in full_axes],
                                dtype=np.int64))
            return ("BLT012: slab [%d, %d) holds %d records, not "
                    "divisible by the %d-way key-axis device assignment "
                    "%s — the per-process ingest split does not exist "
                    "for it; pick chunks= (records per slab) and a key "
                    "extent that are multiples of %d, or pad the "
                    "source (uneven tails cannot stream on a "
                    "multi-process mesh)"
                    % (lo, hi, hi - lo, width, full_axes, width))
    return None


def sidecar_codec_error(codec, mesh):
    """The pod codec rule, as one shared message (``stream`` raises it;
    ``analysis.check`` forecasts it under BLT016): a codec whose encode
    emits a per-slab SIDECAR (int8's scale and zero point) cannot stream
    on a mesh of more than one rank, because each rank encodes only its
    own rows, so the sidecars are per-rank values, not the replicated
    slab-wide inputs the pod's slab program decodes with.  Sidecar-free
    codecs (``bf16``/``f16``/``delta-f32``) stream on pods unchanged:
    each rank encodes its own rows, so its ingest bytes shrink by the
    wire ratio.  Returns the message, or ``None`` when the combination
    is fine."""
    if codec is None or not getattr(codec, "sidecar", False) \
            or mesh_process_count(mesh) <= 1:
        return None
    return ("codec %r carries a per-slab sidecar and cannot stream on "
            "a mesh spanning %d processes: per-process encodes produce "
            "per-process sidecars, which are not the replicated global "
            "inputs a pod's slab program requires.  Use a sidecar-free "
            "codec ('bf16', 'f16', 'delta-f32') on pods, or stream this "
            "source uncompressed" % (codec.name, mesh_process_count(mesh)))


# ---------------------------------------------------------------------
# topology queries (the BLT110 home)
# ---------------------------------------------------------------------

def process_index():
    """This process's rank in the pod (0 single-process)."""
    return 0 if _POD is None else _POD.rank


def process_count():
    """Processes in the pod (1 single-process)."""
    return 1 if _POD is None else _POD.world


def is_multiprocess(mesh=None):
    """Does ``mesh`` (or, with no mesh, the pod) span more than one
    process?"""
    if mesh is None:
        return process_count() > 1
    return mesh_process_count(mesh) > 1


def mesh_process_count(mesh):
    """Distinct processes owning ``mesh``'s ranks: one process a rank on
    a bound mesh; an unbound layout (or ``None``) is owned by none, so 1."""
    if mesh is None or not getattr(mesh, "bound", False):
        return 1
    return int(mesh.size)


def topology_token():
    """Hashable process-topology component of the engine's program keys:
    a program built for one pod width never serves another."""
    n = process_count()
    return ("mh", n) if n > 1 else None


def local_value(x):
    """Host ``numpy`` view of a replicated value: a mesh array whose
    layout replicates every axis (each rank holds all of it), a tensor,
    or anything ``np.asarray`` takes."""
    spec = getattr(x, "_spec", None)
    if spec is not None:
        if any(e is not None for e in spec):
            raise ValueError(
                "local_value needs a replicated array; this one is laid "
                "out %s over the mesh (use toarray() to gather it)"
                % (tuple(spec),))
        from bolt_tpu_torch.gpu.array import _download
        return _download(x._data)
    if isinstance(x, torch.Tensor):
        from bolt_tpu_torch.gpu.array import _download
        return _download(x)
    return np.asarray(x)


def _next_tag(kind, name):
    """A per-process call counter for ``(kind, name)``: every rank calls
    a barrier or a verify at the same program points, so the counters
    give matching keys."""
    k = (kind, str(name))
    _POD.seq[k] = _POD.seq.get(k, 0) + 1
    return "bolt/%s/%s/%d" % (kind, name, _POD.seq[k])


def barrier(name, timeout=None):
    """Named rendezvous of every rank (no-op single-process).  While the
    liveness watch runs it is the watchdog barrier (``podwatch.barrier``:
    a dead peer raises ``PeerLostError``); otherwise it goes through the
    pod's store.  The arrival is taken under the engine's dispatch-order
    lock, so it holds one place in this process's program order; the
    wait runs outside it.  Raises a pointed ``RuntimeError`` naming how
    many ranks arrived when the wait passes ``timeout`` seconds (default
    120)."""
    if process_count() <= 1:
        return
    from bolt_tpu_torch import _chaos
    from bolt_tpu_torch import engine as _engine
    _chaos.hit("multihost.barrier")
    if podwatch.active():
        # the watchdog barrier: a peer dead before arriving raises
        # PeerLostError on every survivor within ~one heartbeat timeout
        podwatch.barrier(name)
        return
    timeout = _DEFAULT_TIMEOUT if timeout is None else float(timeout)
    store = _POD.store
    with _engine.order_lock():
        key = _next_tag("barrier", name)
        if store.add(key, 1) == _POD.world:
            store.set(key + "/open", "1")
    try:
        store.wait([key + "/open"], datetime.timedelta(seconds=timeout))
    except RuntimeError as exc:
        raise RuntimeError(
            "barrier %r: only %d/%d ranks arrived within %.1fs"
            % (name, store.add(key, 0), _POD.world, timeout)) from exc


# ---------------------------------------------------------------------
# the dispatch-schedule verifier (the engine digest's rendezvous)
# ---------------------------------------------------------------------

class ScheduleDivergenceError(RuntimeError):
    """The pod's ranks enqueued DIFFERENT program schedules — what
    otherwise surfaces as a collective that never completes.  Carries
    the first divergent position when key logging was armed
    (``BOLT_SCHED_LOG=1``)."""

    def __init__(self, message, peer=None, index=None, local_key=None):
        super().__init__(message)
        self.peer = peer              # the diverging rank
        self.index = index            # first divergent schedule slot
        self.local_key = local_key    # this rank's key at that slot


_NOTE_KEYS = 256                      # per-key hashes shipped at most
_NOTE_CHARS = 160                     # chars of each key text shipped


def _schedule_payload():
    from bolt_tpu_torch import engine as _engine
    count, digest = _engine.schedule_digest()
    payload = {"count": count, "digest": digest}
    log = _engine.schedule_log()
    if log is not None:
        tail = log[-_NOTE_KEYS:]
        payload["base"] = len(log) - len(tail)
        payload["hashes"] = [hashlib.sha256(t.encode()).hexdigest()[:12]
                             for t in tail]
        payload["texts"] = [t[:_NOTE_CHARS] for t in tail]
    return payload


def _first_divergence(mine, theirs):
    """First divergent schedule slot between two payloads carrying key
    logs, or ``None`` when the logs don't overlap usefully."""
    if "hashes" not in mine or "hashes" not in theirs:
        return None
    base = max(mine["base"], theirs["base"])
    a = mine["hashes"][base - mine["base"]:]
    b = theirs["hashes"][base - theirs["base"]:]
    for i, (ha, hb) in enumerate(zip(a, b)):
        if ha != hb:
            return base + i
    if len(a) != len(b):
        return base + min(len(a), len(b))
    return None


def verify_schedule(name="sched", timeout=30.0):
    """Cross-rank dispatch-order check: publish this rank's schedule
    digest (:func:`bolt_tpu_torch.engine.schedule_digest`) in the pod's
    store, read every rank's, and FAIL LOUDLY on divergence.  Every rank
    calls it at the same program point, like a barrier.  Matching
    schedules return the common digest; a mismatch raises
    :class:`ScheduleDivergenceError` naming the diverging rank and, with
    key logging armed (``BOLT_SCHED_LOG=1`` /
    ``engine.schedule_log_arm()``), the first divergent slot and this
    rank's program key in it.  Single-process: the local digest."""
    payload = _schedule_payload()
    if process_count() <= 1:
        return payload["digest"]
    pid, nproc, store = _POD.rank, _POD.world, _POD.store
    key = _next_tag("sched", name)
    store.set("%s/%d" % (key, pid), json.dumps(payload))
    keys = ["%s/%d" % (key, r) for r in range(nproc)]
    try:
        store.wait(keys, datetime.timedelta(seconds=float(timeout)))
    except RuntimeError as exc:
        missing = [r for r in range(nproc)
                   if not store.check(["%s/%d" % (key, r)])]
        raise RuntimeError(
            "verify_schedule %r: ranks %s published no schedule digest "
            "within %.1fs" % (key, missing, timeout)) from exc
    for peer in range(nproc):
        if peer == pid:
            continue
        theirs = json.loads(store.get(keys[peer]).decode())
        if theirs["digest"] == payload["digest"]:
            continue
        idx = _first_divergence(payload, theirs)
        local_key = None
        if idx is not None and "texts" in payload:
            off = idx - payload["base"]
            if 0 <= off < len(payload["texts"]):
                local_key = payload["texts"][off]
        detail = "" if idx is None else (
            "; first divergent slot %d, local key %s"
            % (idx, local_key if local_key is not None
               else "<beyond local log>"))
        raise ScheduleDivergenceError(
            "dispatch schedules diverged: rank %d enqueued %d program(s) "
            "[digest %s..], rank %d enqueued %d [digest %s..]%s — every "
            "rank must enqueue the SAME programs in the SAME order (arm "
            "BOLT_SCHED_LOG=1 for exact keys)"
            % (pid, payload["count"], payload["digest"][:12], peer,
               theirs["count"], theirs["digest"][:12], detail),
            peer=peer, index=idx, local_key=local_key)
    return payload["digest"]


# ---------------------------------------------------------------------
# process groups of a mesh
# ---------------------------------------------------------------------

def new_subgroups(rank_lists):
    """Create one process group for each list of ranks in ``rank_lists``
    (every rank calls this with the same lists, in the same order, as
    ``torch.distributed.new_group`` requires) and return the group of the
    list holding this rank, or ``None`` when this rank is in none or no
    pod is up.  The whole pod's list reuses the world group."""
    if _POD is None:
        return None
    mine = None
    for ranks in rank_lists:
        ranks = [int(r) for r in ranks]
        if len(ranks) == _POD.world:
            group = dist.group.WORLD
        else:
            group = dist.new_group(ranks)
        if _POD.rank in ranks:
            mine = group
    return mine


# ---------------------------------------------------------------------
# the collectives: raw bytes, staged through the host under gloo
# ---------------------------------------------------------------------

def counters():
    """This process's collective tallies: ``collectives`` (calls that
    moved data between ranks), ``collective_bytes`` (bytes this rank
    sent plus received through them) and ``collective_host_bytes``
    (bytes copied between the card and the host because the backend is
    gloo: both directions)."""
    return dict(_COUNTS)


def reset_counters():
    for k in _COUNTS:
        _COUNTS[k] = 0


def _as_bytes(t):
    """``t`` as a flat ``uint8`` tensor over its own bytes (a lazily
    conjugated or negated view is resolved first)."""
    t = t.detach().resolve_conj().resolve_neg().contiguous().reshape(-1)
    if t.dtype == torch.uint8:
        return t
    if not t.numel():
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    if t.stride(0) != 1:
        # a one-element view of a strided tensor counts as contiguous
        # but keeps its stride, which a dtype view refuses
        t = t.clone(memory_format=torch.contiguous_format)
    return t.view(torch.uint8)


def _from_bytes(b, dtype, shape):
    """The inverse of :func:`_as_bytes`."""
    if not b.numel():
        return torch.empty(shape, dtype=dtype, device=b.device)
    if dtype != torch.uint8:
        b = b.view(dtype)
    return b.reshape(shape)


def _wire(t):
    """The tensor a collective hands the backend: a CUDA tensor goes to
    the host under gloo (counted)."""
    if _POD.backend == "gloo" and t.is_cuda:
        _COUNTS["collective_host_bytes"] += t.numel() * t.element_size()
        return t.cpu()
    return t


def _back(t, device):
    """A collective's output on ``device`` again (counted when gloo
    staged it)."""
    if t.device == device:
        return t
    _COUNTS["collective_host_bytes"] += t.numel() * t.element_size()
    return t.to(device)


def _group_size(group):
    return dist.get_world_size(group) if group is not None else 1


def _collective():
    """Every collective that moves data passes the chaos seam first."""
    from bolt_tpu_torch import _chaos
    _chaos.hit("multihost.collective")


def _complete(work, poll=True):
    """Wait for one issued collective.  While the liveness watch runs the
    ``Work`` is polled against it (``podwatch.wait_ready``), so a dead
    peer raises ``PeerLostError`` rather than blocking in C++, and a
    transport error from ``wait()`` is classified the same way.
    ``poll=False`` for gloo's point-to-point ``Work``, which reports
    completion only from ``wait()``: that wait is bounded by the group's
    ``timeout`` alone (a latched dead peer still refuses before it)."""
    if not podwatch.active():
        work.wait()
        return
    with podwatch.guard("collective"):
        if poll:
            podwatch.wait_ready(work, phase="collective")
        work.wait()


def _wire_device(device):
    """Where a collective's buffers live: the host under gloo."""
    return torch.device("cpu") if _POD.backend == "gloo" else device


def all_gather_bytes(b, group):
    """Every rank's ``uint8`` tensor ``b`` (any length), in the group's
    rank order."""
    n = _group_size(group)
    if n == 1:
        return [b]
    _collective()
    device = b.device
    size = torch.tensor([b.numel()], dtype=torch.int64,
                        device=_wire_device(device))
    sizes = [torch.empty_like(size) for _ in range(n)]
    _complete(dist.all_gather(sizes, size, group=group, async_op=True))
    lens = [int(s.item()) for s in sizes]
    top = max(lens)
    pad = b if b.numel() == top else torch.cat(
        [b, torch.zeros(top - b.numel(), dtype=torch.uint8, device=device)])
    wire = _wire(pad)
    outs = [torch.empty_like(wire) for _ in range(n)]
    _complete(dist.all_gather(outs, wire, group=group, async_op=True))
    _COUNTS["collectives"] += 1
    _COUNTS["collective_bytes"] += top * (n - 1) + b.numel()
    return [_back(o[:ln], device) for o, ln in zip(outs, lens)]


def _leaves(tree, out):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return out
    for x in tree:
        _leaves(x, out)
    return out


def _rebuild(tree, new):
    """``tree``'s structure with its tensor leaves taken from the
    iterator ``new``."""
    if isinstance(tree, torch.Tensor):
        return next(new)
    return type(tree)(_rebuild(x, new) for x in tree)


def all_gather(tree, group):
    """Every rank's ``tree`` (a tensor, or a tuple/list tree of tensors
    of one structure on every rank; shapes may differ across ranks) as a
    list in the group's rank order, through ONE byte exchange."""
    if _group_size(group) == 1:
        return [tree]
    leaves = _leaves(tree, [])
    device = leaves[0].device
    head = json.dumps([(str(t.dtype).replace("torch.", ""),
                        list(t.shape)) for t in leaves]).encode()
    prefix = np.frombuffer(np.int64(len(head)).tobytes() + head,
                           dtype=np.uint8).copy()
    parts = [torch.from_numpy(prefix).to(device)]
    parts += [_as_bytes(t.to(device)) for t in leaves]
    out = []
    for g in all_gather_bytes(torch.cat(parts), group):
        host = g[:8].cpu().numpy().tobytes()
        hl = int(np.frombuffer(host, dtype=np.int64)[0])
        meta = json.loads(g[8:8 + hl].cpu().numpy().tobytes().decode())
        off, new = 8 + hl, []
        for dt, shape in meta:
            dtype = getattr(torch, dt)
            nb = int(np.prod(shape, dtype=np.int64)) * \
                torch.empty((), dtype=dtype).element_size()
            new.append(_from_bytes(g[off:off + nb].clone(), dtype, shape))
            off += nb
        out.append(_rebuild(tree, iter(new)))
    return out


def fold_partials(tree, combine, group):
    """The partials ``tree`` of every rank of ``group`` folded into one,
    the same bits on every rank: ONE exchange of the trees, then
    ``acc = combine(acc, next)`` in the group's rank order."""
    trees = all_gather(tree, group)
    acc = trees[0]
    for t in trees[1:]:
        acc = combine(acc, t)
    return acc


def all_reduce_sum(t, group):
    """The sum of ``t`` over ``group``, folded in rank order (identical
    bits on every rank)."""
    return fold_partials(t, lambda a, b: a + b, group)


def all_to_all(sends, recv_sizes, device):
    """Exchange byte pieces between every pair of ranks in ONE
    ``all_to_all``: ``sends[r]`` is the ``uint8`` tensor this rank sends
    to rank ``r`` (its own entry stays local), ``recv_sizes[r]`` the
    bytes it receives from ``r``.  Returns the list of received
    tensors, this rank's own entry being ``sends[rank]``."""
    world, me = process_count(), process_index()
    if world == 1:
        return [sends[0]]
    empty = torch.empty(0, dtype=torch.uint8, device=device)
    _collective()
    in_sizes = [0 if r == me else int(sends[r].numel())
                for r in range(world)]
    out_sizes = [0 if r == me else int(recv_sizes[r])
                 for r in range(world)]
    inp = torch.cat([empty] + [sends[r].to(device) for r in range(world)
                               if r != me and in_sizes[r]])
    wire_in = _wire(inp)
    wire_out = torch.empty(sum(out_sizes), dtype=torch.uint8,
                           device=wire_in.device)
    _complete(dist.all_to_all_single(wire_out, wire_in, out_sizes,
                                     in_sizes, async_op=True))
    _COUNTS["collectives"] += 1
    _COUNTS["collective_bytes"] += sum(in_sizes) + sum(out_sizes)
    out = _back(wire_out, device)
    pieces, off = [], 0
    for r in range(world):
        if r == me:
            pieces.append(sends[r])
            continue
        pieces.append(out[off:off + out_sizes[r]])
        off += out_sizes[r]
    return pieces


def broadcast(t, src, out_device=None):
    """Rank ``src``'s tensor ``t`` on every rank.  The source returns its
    own ``t``; the others pass a tensor of the same shape and dtype (a
    ``meta`` one will do: only its shape and dtype are read) and receive
    into a new one on ``out_device`` (default: ``t``'s device; a meta
    ``t`` lands on the rank's device), which under gloo the bytes reach
    without staging when it is the host."""
    if process_count() == 1:
        return t
    _collective()
    _COUNTS["collectives"] += 1
    _COUNTS["collective_bytes"] += t.numel() * t.element_size()
    if process_index() == src:
        _complete(dist.broadcast(_wire(t.contiguous()), src,
                                 async_op=True))
        return t
    device = out_device or (_POD.device if t.device.type == "meta"
                            else t.device)
    wire = torch.empty(t.shape, dtype=t.dtype,
                       device=_wire_device(_POD.device))
    _complete(dist.broadcast(wire, src, async_op=True))
    return _back(wire, device)


def ppermute(t, ranks, pairs):
    """The point-to-point permutation behind the halo exchange:
    ``ranks`` lists the global ranks of one mesh axis in index order,
    ``pairs`` holds ``(source index, destination index)`` pairs.  Each
    rank sends ``t`` where a pair names it the source and returns what
    it receives (zeros when no pair names it a destination), through
    ``batch_isend_irecv``; a pair from a rank to itself is a copy."""
    me = process_index()
    idx = ranks.index(me)
    out = torch.zeros_like(t)
    ops, recv = [], None
    send_to = [ranks[d] for s, d in pairs if s == idx]
    recv_from = [ranks[s] for s, d in pairs if d == idx]
    if len(recv_from) > 1:
        raise ValueError("ppermute: more than one pair sends to index %d"
                         % idx)
    device = t.device
    if send_to or recv_from:
        _collective()
    wire = _wire(t.contiguous()) if send_to or recv_from else None
    for peer in send_to:
        if peer == me:
            out = t.clone()
        else:
            ops.append(dist.P2POp(dist.isend, wire, peer))
    for peer in recv_from:
        if peer != me:
            recv = torch.empty_like(wire)
            ops.append(dist.P2POp(dist.irecv, recv, peer))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            _complete(work, poll=False)
        _COUNTS["collectives"] += 1
        nb = t.numel() * t.element_size()
        _COUNTS["collective_bytes"] += nb * len(ops)
    if recv is not None:
        out = _back(recv, device)
    return out
