"""Checkpoint files: bolt arrays, streamed runs, and the shuffle spill.

Port of ``bolt_tpu/checkpoint.py``, in three parts:

* **arrays** (:func:`save`/:func:`load`): the reference's one-process
  ``"format": "npy"`` layout, ``bolt_meta.json`` (split, shape, dtype,
  format) beside ``array.npy`` written atomically (a temporary file, then
  a rename).  The reference writes orbax's sharded format when orbax is
  installed; orbax imports jax, so the port reads and writes ``npy``
  only and refuses an orbax directory pointedly.  An array on a mesh of
  more than one rank is written the way orbax owns shards: each rank
  writes its own box (``array.p<rank>.npy``), rank 0 the meta (the
  mesh, the spec and every rank's box, ``"format": "npy-shards"``), and
  a barrier ends the save; :func:`load` reads each rank's box back onto
  a mesh of the same layout.  numpy has no bfloat16, and the port's
  arrays hold numpy dtypes, so a reference checkpoint of a bfloat16
  array (its 2-byte patterns, ``V2``) is refused pointedly;

  >>> from bolt_tpu_torch import checkpoint
  >>> checkpoint.save("/tmp/ckpt", b)
  >>> b2 = checkpoint.load("/tmp/ckpt", context=torch.device("cuda", 0))

* **streamed runs** (:func:`stream_save`/:func:`stream_load`/
  :func:`stream_clear`/:func:`stream_pending`): a run's retired-slab
  watermark and its folded partial (the pairwise-tree levels and the
  unpaired pair partial: sum/reduce tensors, ``(n, mu, M2)`` moment
  triples, multi-stat component tuples), so a killed run restarted over
  the same source resumes from its last retired slab with a result equal
  to the uninterrupted run's bit for bit (``bolt_tpu_torch.stream`` owns
  the resume).  A bfloat16 leaf is stored as its 2-byte patterns
  (``V2``, as the reference's ``np.save`` of one writes it) and its node
  says so, so it round-trips bit for bit.  The state file is written
  and renamed first and the meta second; the meta carries a digest of
  the state and the state carries the watermark, so a torn pair or a
  rotten file is refused, never adopted.  A streamed pod writes one
  shard file a rank, named by its watermark (``stream_state.p<rank>.
  w<slabs>.npz``): a barrier proves every shard landed, rank 0 then
  flips the meta (which records the pod's width), and a second barrier
  fences the removal of superseded shards, so a pod killed at any
  instant leaves a meta whose watermark has a shard for every rank.
  The fold state is the same on every rank, so each shard is a whole
  resume point, and a checkpoint of the same run cut at another width
  resumes through the topology remap (:func:`stream_load`);
* **the shuffle spill**: when a streamed ``swap`` plans a working set
  larger than its resident budget (``stream.spill``), phase 1 of the
  shuffle writes each re-keyed bucket to disk and phase 2 streams the
  buckets back as a fresh source.  Each file is written atomically and
  describes itself: its codec, dtype, shape and global row offset ride
  inside.  The working directory is named by a digest of the run's
  fingerprint, so a run only ever adopts its own spill.  Integer and
  bool buckets are dictionary-coded (``gpu/codec.py``'s ``"dict"``) when
  they have at most 256 distinct values, and stored raw otherwise; the
  choice is recorded in the file.  Completion is tracked per input slab
  in a manifest, marked only after every bucket of the slab landed.

Standard library, numpy and torch only.
"""

import glob
import hashlib
import json
import os
import shutil

import numpy as np

from bolt_tpu_torch import _chaos

# the shuffle spill is single-process (a pod refuses to spill): its file
# names keep the reference's per-process suffix
_PROCESS = 0


class CheckpointCorruptError(RuntimeError):
    """A checkpoint or spill file is unreadable or fails its digest (bit
    rot, truncation, a torn storage layer), or a spill file is missing
    where its manifest says it was written: the message names the file;
    delete it (or the directory) to start the run from scratch."""


# ---------------------------------------------------------------------
# arrays
# ---------------------------------------------------------------------

def _npy_path(path):
    return os.path.join(path, "array.npy")


def _meta_path(path):
    return os.path.join(path, "bolt_meta.json")


def _host(t):
    """A tensor as a host numpy array; a bfloat16 one as its 2-byte
    patterns (``V2``: numpy has no bfloat16)."""
    import torch
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return np.ascontiguousarray(t.view(torch.int16).cpu().numpy()
                                    ).view("V2")
    return np.ascontiguousarray(t.cpu().numpy())


def _tensor(a, dtype):
    """A host array read back as a CPU tensor of numpy-or-bfloat16
    ``dtype`` (the name :func:`_host` wrote beside it)."""
    import torch
    if str(dtype) == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(
        a.astype(np.dtype(dtype), copy=False)))


def _shard_path(path, rank):
    return os.path.join(path, "array.p%d.npy" % int(rank))


def _write_npy(fpath, host):
    tmp = fpath + ".tmp"
    with open(tmp, "wb") as f:       # np.save(path) would append ".npy"
        np.save(f, host)
    os.replace(tmp, fpath)


def _write_meta(path, meta):
    tmp = _meta_path(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, _meta_path(path))


def save(path, barray, force=True):
    """Write a ``mode='gpu'`` bolt array (its data and its split, shape
    and dtype) under the directory ``path`` in the ``npy`` format: the
    array copied to the host once and written atomically, the meta
    after it.  A deferred chain is materialised first.  ``force`` is the
    reference's overwrite flag; the atomic rename always replaces.  On a
    mesh of more than one rank (every rank calls it) each rank writes its
    own box, rank 0 the meta, and a barrier ends the save."""
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    if not isinstance(barray, BoltArrayGPU):
        raise TypeError("checkpoint.save expects a mode='gpu' array; "
                        "got %r" % type(barray).__name__)
    mesh = getattr(barray, "_mesh", None)
    if mesh is not None and mesh.size > 1:
        return _save_shards(path, barray, mesh)
    os.makedirs(path, exist_ok=True)
    _write_npy(_npy_path(path), _host(barray._data))
    _write_meta(path, {"split": barray.split, "shape": list(barray.shape),
                       "dtype": str(barray.dtype), "format": "npy"})


def _save_shards(path, barray, mesh):
    """:func:`save` on a mesh of ranks: this rank's box to its own file,
    the meta (the mesh, the spec, every rank's box) from rank 0, then
    every rank's barrier."""
    from bolt_tpu_torch.parallel import multihost, sharding
    os.makedirs(path, exist_ok=True)
    host = _host(barray._data)
    spec, shape = barray._spec, barray.shape
    _write_npy(_shard_path(path, mesh.rank), host)
    if mesh.rank == 0:
        _write_meta(path, {
            "split": barray.split, "shape": list(shape),
            "dtype": str(barray.dtype), "format": "npy-shards",
            "mesh": [list(mesh.axis_names), list(mesh.sizes)],
            "spec": [list(e) if isinstance(e, tuple) else e for e in spec],
            "boxes": [[list(b) for b in bx]
                      for bx in sharding.boxes(mesh, spec, shape)]})
    multihost.barrier("bolt_checkpoint_save")


def _load_shards(path, meta, context):
    """:func:`load` of a mesh array's shards: this rank's box onto the
    mesh ``context``, which must have the saved layout."""
    from bolt_tpu_torch.gpu.construct import _is_mesh
    from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
    from bolt_tpu_torch.stream import transfer
    names, sizes = meta["mesh"]
    if not _is_mesh(context) or context.geometry != (tuple(names),
                                                     tuple(sizes)):
        raise ValueError(
            "checkpoint %r holds an array saved by a mesh %s of %s ranks, "
            "one file per rank; load it onto a mesh of that layout (got "
            "context %r)" % (path, tuple(names), tuple(sizes), context))
    rank = context.rank
    spec = tuple(tuple(e) if isinstance(e, list) else e
                 for e in meta["spec"])
    box = tuple(tuple(b) for b in meta["boxes"][rank])
    host = _tensor(np.load(_shard_path(path, rank)), meta["dtype"])
    want = tuple(e - s for s, e in box)
    if tuple(host.shape) != want:
        raise CheckpointCorruptError(
            "checkpoint shard %r has shape %s, its meta's box %s says %s"
            % (_shard_path(path, rank), tuple(host.shape), box, want))
    return BoltArrayMesh.wrap(transfer(host, context.device), context,
                              tuple(meta["shape"]), int(meta["split"]),
                              spec)


def load(path, context=None):
    """Restore an array :func:`save` wrote (or the reference's ``npy``
    format) onto ``context``'s device (default ``cuda:0``), through the
    counted transfer; a mesh array's shards onto the mesh ``context``,
    each rank reading its own box.  An orbax directory raises: the port
    reads the ``npy`` format only."""
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    from bolt_tpu_torch.gpu.construct import resolve_device
    from bolt_tpu_torch.stream import transfer
    with open(_meta_path(path)) as f:
        meta = json.load(f)
    if meta.get("format") == "npy-shards":
        return _load_shards(path, meta, context)
    if meta.get("format", "npy") != "npy" or not os.path.exists(
            _npy_path(path)):
        raise ValueError(
            "checkpoint %r is in the %r format; bolt_tpu_torch reads the "
            "single-process 'npy' format only (the reference writes it "
            "when orbax is not importable)" % (path, meta.get("format")))
    if meta["dtype"] == "bfloat16":
        raise TypeError(
            "checkpoint %r holds a bfloat16 array; bolt_tpu_torch's arrays "
            "hold numpy dtypes, which have no bfloat16 (its bits are "
            "np.load(...).view(np.uint16))" % path)
    device = resolve_device(context)
    host = _tensor(np.load(_npy_path(path)), meta["dtype"])
    if tuple(host.shape) != tuple(meta["shape"]):
        raise CheckpointCorruptError(
            "checkpoint array %r has shape %s, its meta says %s"
            % (_npy_path(path), tuple(host.shape), tuple(meta["shape"])))
    return BoltArrayGPU(transfer(host, device), int(meta["split"]), device)


# ---------------------------------------------------------------------
# streamed runs
# ---------------------------------------------------------------------
#
# On disk: <dir>/stream_state.npz (the partial's leaves and the
# watermark) and <dir>/stream_meta.json (fingerprint, watermark, leaf
# structure, digest, the run's width).  The meta is the checkpoint's
# existence: the state is replaced first and the meta second, both by an
# atomic rename, so a kill -9 at any instant leaves the previous
# checkpoint or the new one, never a meta naming torn state.
#
# A pod writes one shard a rank, <dir>/stream_state.p<rank>.w<slabs>.npz
# (the watermark in the name: old and new shards coexist), then every
# rank takes a barrier, then rank 0 alone flips the meta to the new
# watermark, and a second barrier fences the removal of superseded
# shards.  A pod killed at any instant leaves a meta whose watermark has
# a shard for every rank, so no two ranks resume from different
# watermarks.  The pod's fold state is the same on every rank (each
# slab's partial is folded across the ranks before it joins the fold),
# so a rank whose own shard is missing adopts a peer's.

_STATE_NAME = "stream_state.npz"
_SMETA_NAME = "stream_meta.json"


def _state_path(path, rank=None, slabs=None):
    if rank is None:
        return os.path.join(path, _STATE_NAME)
    return os.path.join(path, "stream_state.p%d.w%d.npz"
                        % (int(rank), int(slabs)))


def _smeta_path(path):
    return os.path.join(path, _SMETA_NAME)


def _encode(obj, leaves):
    """The structure of one fold-state node: ``None`` passes through,
    lists and tuples recurse (tagged, so decoding rebuilds the same
    container), a tensor or array lands in ``leaves`` as a host array
    (a bfloat16 leaf as its bits, its node saying so)."""
    import torch
    if obj is None:
        return None
    if isinstance(obj, list):
        return {"l": [_encode(x, leaves) for x in obj]}
    if isinstance(obj, tuple):
        return {"t": [_encode(x, leaves) for x in obj]}
    if isinstance(obj, torch.Tensor):
        leaves.append(_host(obj))
        node = {"a": len(leaves) - 1}
        if obj.dtype == torch.bfloat16:
            node["dtype"] = "bfloat16"
        return node
    leaves.append(np.asarray(obj))
    return {"a": len(leaves) - 1}


def _decode(node, leaves):
    """The fold state :func:`_encode` described, its leaves CPU tensors
    in their dtypes."""
    if node is None:
        return None
    if "l" in node:
        return [_decode(x, leaves) for x in node["l"]]
    if "t" in node:
        return tuple(_decode(x, leaves) for x in node["t"])
    a = leaves[node["a"]]
    return _tensor(a, node.get("dtype", a.dtype))


def _state_digest(slabs, records, leaves):
    """Content hash of one checkpoint's state: the watermark and every
    leaf's shape, dtype and bytes.  :func:`stream_save` records it in the
    meta and :func:`stream_load` checks it (a pod's meta writer's digest
    checks any rank's shard: their states are the same bits)."""
    h = hashlib.sha256()
    h.update(np.asarray([int(slabs), int(records)],
                        dtype=np.int64).tobytes())
    for leaf in leaves:
        arr = np.ascontiguousarray(leaf)
        h.update(repr((arr.shape, str(arr.dtype))).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _pod_width(multiprocess):
    from bolt_tpu_torch.parallel import multihost
    return multihost.process_count() if multiprocess else 1


def stream_save(path, fingerprint, slabs, records, state,
                multiprocess=False, rendezvous=True, codec=None, box=None,
                remap_from=None):
    """Write one streamed-run checkpoint: ``slabs`` retired slabs covering
    ``records`` records, ``state`` the executor's folded partial
    (``(levels, pend)``; tensors on any device are copied to the host
    here).  ``fingerprint`` names the logical run; :func:`stream_load`
    ignores a checkpoint of another one.  ``codec`` records the run's
    ingest codec in the meta (the fingerprint holds it too).  Returns
    the state's byte count (the ``checkpoint_bytes`` tally).

    ``multiprocess=True`` is a pod run: every rank calls this at the same
    watermark, writes its own shard (recording its key ``box``), a
    barrier proves every shard landed, rank 0 flips the meta, and a
    second barrier fences the removal of this rank's superseded shards.
    ``rendezvous=False`` is a failing pod run's write: no barrier (a peer
    may be gone), and the meta only moves forward (a checkpoint of the
    same run at a higher watermark is kept); one rank's shard is a whole
    resume point, since the fold state is the same on every rank.

    The seams of :mod:`bolt_tpu_torch._chaos`: ``stream.checkpoint`` on
    entry, ``checkpoint.corrupt`` (a tripped fault flips four bytes of
    the state file just written) and ``checkpoint.meta`` between the
    state's rename and the meta's."""
    from bolt_tpu_torch.parallel import multihost
    _chaos.hit("stream.checkpoint")
    os.makedirs(path, exist_ok=True)
    nproc = _pod_width(multiprocess)
    rank = multihost.process_index()
    leaves = []
    structure = _encode(state, leaves)
    arrays = {"leaf_%d" % i: leaf for i, leaf in enumerate(leaves)}
    # the watermark rides in the state file too: a kill between the two
    # renames leaves the old meta beside the new state, and stream_load
    # refuses that pair instead of folding slabs twice
    arrays["watermark"] = np.asarray([int(slabs), int(records)],
                                     dtype=np.int64)
    if box is not None:
        arrays["box"] = np.asarray(box, dtype=np.int64)
    spath = _state_path(path) if nproc == 1 \
        else _state_path(path, rank, slabs)
    tmp = spath + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, spath)
    try:
        _chaos.hit("checkpoint.corrupt")
    except _chaos.ChaosError:
        with open(spath, "r+b") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() // 2))
            f.write(b"\xde\xad\xbe\xef")
    nbytes = sum(int(leaf.nbytes) for leaf in leaves)
    if nproc > 1 and rendezvous:
        # every rank's shard of this watermark exists past here: only
        # then may the meta name it
        multihost.barrier("bolt_stream_ckpt_w%d" % int(slabs))
    meta = {"fingerprint": list(fingerprint), "slabs": int(slabs),
            "records": int(records), "structure": structure,
            "leaves": len(leaves), "nproc": nproc}
    if codec is not None:
        meta["codec"] = str(codec)
    if remap_from is not None:
        meta["remapped_from"] = int(remap_from)
    if nproc > 1 and not rendezvous:
        meta["abort"] = True
        cur = _read_meta(path)
        if cur is not None and \
                list(cur.get("fingerprint", ())) == list(fingerprint) \
                and int(cur.get("slabs", -1)) >= int(slabs):
            return nbytes           # advance-only: keep the later point
    if nproc == 1 or rank == 0 or not rendezvous:
        meta["digest"] = _state_digest(slabs, records, leaves)
        _chaos.hit("checkpoint.meta")
        tmp = _smeta_path(path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, _smeta_path(path))
    if nproc > 1 and rendezvous:
        # superseded shards go only once the meta names the new watermark
        multihost.barrier("bolt_stream_ckpt_meta_w%d" % int(slabs))
        for old in glob.glob(os.path.join(
                path, "stream_state.p%d.w*.npz" % rank)):
            if old != spath:
                _remove(old)
    return nbytes


def _remove(p):
    try:
        os.remove(p)
    except FileNotFoundError:
        pass


def _read_meta(path):
    try:
        with open(_smeta_path(path)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _remap_state_path(path, meta, rank):
    """A state file for the meta's watermark, whatever topology cut it:
    this rank's own shard when present, else the lowest-rank survivor's,
    else the single-process file (every rank's fold state is the same
    bits, so any of them is a whole resume point), or ``None``."""
    if int(meta.get("nproc", 1)) == 1:
        sp = _state_path(path)
        return sp if os.path.exists(sp) else None
    slabs = int(meta["slabs"])
    own = _state_path(path, rank, slabs)
    if os.path.exists(own):
        return own

    def _rank_of(p):
        try:
            return int(os.path.basename(p).split(".p")[1].split(".w")[0])
        except (IndexError, ValueError):
            return 1 << 30
    cands = glob.glob(os.path.join(path, "stream_state.p*.w%d.npz"
                                   % slabs))
    return min(cands, key=_rank_of) if cands else None


def stream_load(path, fingerprint, multiprocess=False, box=None,
                info=None):
    """The checkpoint :func:`stream_save` wrote, as ``(slabs, records,
    state)`` with CPU tensor leaves, or ``None`` when there is none, its
    fingerprint names another run (an edited pipeline, another codec, a
    reference checkpoint), or its meta and state come from different
    writes (a kill between the two renames).  A pod run reads the shared
    meta and its own shard of the meta's watermark (a peer's when its own
    never landed), whose recorded key ``box`` must be this rank's.

    A checkpoint of the same run cut at another TOPOLOGY (the
    fingerprint's last element: a pod's read by one process, one
    process's read by a pod, another pod width or mesh) is the
    **topology remap** of a shrink or a growth: every rank's fold state
    is the same bits, so any surviving shard of the meta's watermark is
    adopted (this rank's index first, else the lowest), its digest
    verified, and ``info`` (a dict) receives ``{"remapped_from": N}``,
    the width that cut it.  A state file that exists but cannot be
    read, or fails the meta's digest, raises
    :class:`CheckpointCorruptError`."""
    from bolt_tpu_torch.parallel import multihost
    meta = _read_meta(path)           # None when missing or malformed
    if meta is None:
        return None
    nproc = _pod_width(multiprocess)
    rank = multihost.process_index()
    got, want = list(meta.get("fingerprint", ())), list(fingerprint)
    if not got or got[:-1] != want[:-1]:
        return None
    meta_nproc = int(meta.get("nproc", 1))
    remap = got[-1] != want[-1] or meta_nproc != nproc
    spath = _remap_state_path(path, meta, rank)
    if spath is None:
        return None
    # the key box is checked on this rank's own shard of its own width
    own = not remap and (nproc == 1 or spath == _state_path(
        path, rank, int(meta["slabs"])))
    corrupt = (
        "stream checkpoint state file %r is corrupt (%%s); refusing to "
        "seed the fold with it — delete the file (or the whole "
        "checkpoint directory) to restart the run from scratch" % spath)
    try:
        z = np.load(spath)
    except FileNotFoundError:
        return None
    except Exception as exc:        # noqa: BLE001 — an existing state file
        # that does not open is rot or truncation (writes are atomic)
        raise CheckpointCorruptError(
            corrupt % ("unreadable npz: %s" % exc)) from exc
    try:
        try:
            wm = z["watermark"]
        except Exception as exc:    # noqa: BLE001
            raise CheckpointCorruptError(
                corrupt % ("watermark unreadable: %s" % exc)) from exc
        if int(wm[0]) != int(meta["slabs"]) \
                or int(wm[1]) != int(meta["records"]):
            return None             # meta and state of different writes
        if own and box is not None and "box" in z.files and \
                np.asarray(z["box"]).tolist() != [list(b) for b in box]:
            raise CheckpointCorruptError(
                corrupt % ("its key box %s is not this rank's %s"
                           % (np.asarray(z["box"]).tolist(),
                              [list(b) for b in box])))
        try:
            leaves = [np.asarray(z["leaf_%d" % i])
                      for i in range(int(meta["leaves"]))]
        except Exception as exc:    # noqa: BLE001 — same write as the
            # watermark that matched: an unreadable leaf is corruption
            raise CheckpointCorruptError(
                corrupt % ("leaf unreadable: %s" % exc)) from exc
    finally:
        z.close()
    digest = meta.get("digest")
    if digest is None:
        raise CheckpointCorruptError(
            corrupt % "the meta record holds no content digest")
    if _state_digest(meta["slabs"], meta["records"], leaves) != digest:
        raise CheckpointCorruptError(
            corrupt % "content digest mismatch vs the meta record")
    if remap and info is not None:
        info["remapped_from"] = meta_nproc
    return (int(meta["slabs"]), int(meta["records"]),
            _decode(meta["structure"], leaves))


def stream_clear(path, multiprocess=False):
    """Remove a directory's stream checkpoint (a finished run leaves none
    behind): the meta first, then the state, the reverse of the write
    order, so an interrupted clear never leaves a meta naming a missing
    state.  A pod (every rank calls it): a barrier proves every rank
    finished, rank 0 removes the meta, a second barrier fences it, then
    each rank removes its own shards and rank 0 every shard left (an
    abort write's, a dead peer's, a write a kill left half done, the
    one-process state a growth resumed), and the latched-dead peers'
    heartbeat markers go with them (``podwatch.sweep_dead_markers``).
    One process removes the shards of a pod checkpoint it resumed
    through the topology remap too."""
    if multiprocess and _pod_width(True) > 1:
        from bolt_tpu_torch.parallel import multihost, podwatch
        rank = multihost.process_index()
        multihost.barrier("bolt_stream_clear")
        if rank == 0:
            _remove(_smeta_path(path))
        multihost.barrier("bolt_stream_clear_meta")
        pat = "stream_state.p*" if rank == 0 \
            else "stream_state.p%d.w*.npz" % rank
        for p in glob.glob(os.path.join(path, pat)):
            _remove(p)
        if rank == 0:
            # a pod that resumed a one-process checkpoint (a growth)
            _remove(_state_path(path))
        podwatch.sweep_dead_markers()
        return
    for p in [_smeta_path(path), _state_path(path)] + glob.glob(
            os.path.join(path, "stream_state.p*.w*.npz")):
        _remove(p)


def stream_pending(path):
    """Does ``path`` hold a resumable stream checkpoint?"""
    return os.path.exists(_smeta_path(path))


# ---------------------------------------------------------------------
# the shuffle spill
# ---------------------------------------------------------------------


def _spill_root(path, fingerprint):
    h = hashlib.sha256(repr(fingerprint).encode()).hexdigest()[:16]
    return os.path.join(path, "bolt-spill-%s" % h)


def _spill_file(path, fingerprint, slab_i, bucket_i):
    return os.path.join(
        _spill_root(path, fingerprint),
        "slab%05d.bucket%05d.p%d.npz" % (int(slab_i), int(bucket_i),
                                         _PROCESS))


def _spill_manifest_path(path, fingerprint):
    return os.path.join(_spill_root(path, fingerprint),
                        "manifest.p%d.json" % _PROCESS)


def _dict_codec():
    from bolt_tpu_torch.gpu import codec
    return codec.get("dict")


def spill_save(path, fingerprint, slab_i, bucket_i, block, row0):
    """Write bucket ``bucket_i`` of input slab ``slab_i`` (the host array
    ``block``) atomically under ``path``'s fingerprint directory.
    ``row0`` is the bucket's global output row.  Returns the bytes
    written (the ``spill_bytes`` tally)."""
    block = np.ascontiguousarray(block)
    codec_name = ""
    wire, sides = block, ()
    if np.issubdtype(block.dtype, np.integer) \
            or block.dtype == np.dtype(np.bool_):
        try:
            w, s = _dict_codec().encode(block, delta_ok=False)
            wire, sides, codec_name = w.numpy(), tuple(s), "dict"
        except ValueError:        # > 256 distinct values: store raw
            pass
    root = _spill_root(path, fingerprint)
    os.makedirs(root, exist_ok=True)
    payload = {"wire": wire,
               "row0": np.asarray(int(row0), dtype=np.int64),
               "shape": np.asarray(block.shape, dtype=np.int64),
               "dtype": np.asarray(str(block.dtype)),
               "codec": np.asarray(codec_name),
               "nside": np.asarray(len(sides), dtype=np.int64)}
    for i, s in enumerate(sides):
        payload["side%d" % i] = np.asarray(s)
    fpath = _spill_file(path, fingerprint, slab_i, bucket_i)
    tmp = fpath + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, fpath)
    return os.path.getsize(fpath)


def spill_load(path, fingerprint, slab_i, bucket_i):
    """One spilled bucket back as ``(host block, row0)``, decoded on the
    host.  A missing or torn file raises :class:`CheckpointCorruptError`
    naming it."""
    fpath = _spill_file(path, fingerprint, slab_i, bucket_i)
    try:
        with np.load(fpath, allow_pickle=False) as z:
            wire = z["wire"]
            row0 = int(z["row0"])
            dtype = np.dtype(str(z["dtype"]))
            codec_name = str(z["codec"])
            shape = tuple(int(n) for n in z["shape"])
            sides = tuple(z["side%d" % i] for i in range(int(z["nside"])))
    except FileNotFoundError:
        raise CheckpointCorruptError(
            "spill bucket missing: %s — slab %d's bucket %d file is gone "
            "(deleted or never written); clear the spill directory "
            "(bolt_tpu_torch.checkpoint.spill_clear) and re-run"
            % (fpath, int(slab_i), int(bucket_i)))
    except (ValueError, OSError, KeyError) as exc:
        raise CheckpointCorruptError(
            "spill bucket unreadable: %s (%s) — torn write or storage "
            "rot; clear the spill directory "
            "(bolt_tpu_torch.checkpoint.spill_clear) and re-run"
            % (fpath, exc))
    if codec_name:
        import torch
        from bolt_tpu_torch.gpu import codec
        from bolt_tpu_torch.gpu.dtypes import torch_dtype
        block = codec.get(codec_name).decode(
            torch.from_numpy(wire),
            tuple(torch.from_numpy(s) for s in sides),
            torch_dtype(dtype), delta_ok=False).numpy()
    else:
        block = wire.astype(dtype, copy=False)
    return block.reshape(shape), row0


def spill_slab_done(path, fingerprint, slab_i):
    """Mark input slab ``slab_i`` complete in the spill manifest; called
    only after every bucket of the slab landed."""
    done = sorted(spill_manifest(path, fingerprint) | {int(slab_i)})
    mpath = _spill_manifest_path(path, fingerprint)
    os.makedirs(os.path.dirname(mpath), exist_ok=True)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"done": done}, f)
    os.replace(tmp, mpath)


def spill_manifest(path, fingerprint):
    """The input slabs fully spilled for ``fingerprint`` under ``path``
    (empty when there is no spill: another fingerprint hashes to another
    directory)."""
    try:
        with open(_spill_manifest_path(path, fingerprint)) as f:
            return set(int(s) for s in json.load(f)["done"])
    except (FileNotFoundError, ValueError, KeyError):
        return set()


def spill_pending(path):
    """Does ``path`` hold any shuffle spill directory?"""
    return bool(glob.glob(os.path.join(path, "bolt-spill-*")))


def spill_clear(path):
    """Remove every shuffle spill directory under ``path``, temporary
    files included."""
    for d in glob.glob(os.path.join(path, "bolt-spill-*")):
        shutil.rmtree(d, ignore_errors=True)
