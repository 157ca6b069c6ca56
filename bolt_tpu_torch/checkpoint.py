"""Checkpoint files: the shuffle spill layer.

Port of the spill half of ``bolt_tpu/checkpoint.py``.  When a streamed
``swap`` plans a working set larger than its resident budget
(``stream.spill``), phase 1 of the shuffle writes each re-keyed bucket
to disk and phase 2 streams the buckets back as a fresh source.  Each
file is written atomically (a temporary file, then a rename) and
describes itself: its codec, dtype, shape and global row offset ride
inside.  The working directory is named by a digest of the run's
fingerprint, so a run only ever adopts its own spill: another
pipeline's leftovers hash to another directory.

Integer and bool buckets are dictionary-coded (``gpu/codec.py``'s
``"dict"``: uint8 indices and a 256-entry dictionary) when the bucket
has at most 256 distinct values, and stored raw otherwise; the choice is
recorded in the file, so decoding never guesses.  Completion is tracked
per input slab in a manifest, marked only after every bucket of the
slab landed.

The array ``save``/``load`` and the stream checkpoints
(``stream_save``/``stream_load``) are not ported yet (ROADMAP A9).
Standard library, numpy and torch only.
"""

import glob
import hashlib
import json
import os
import shutil

import numpy as np

# one process on one card: the file names keep the reference's
# per-process suffix
_PROCESS = 0


class CheckpointCorruptError(RuntimeError):
    """A checkpoint or spill file is missing where its manifest says it
    was written, or unreadable (truncation, a torn storage layer): the
    message names the file; clear the directory and run again."""


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
