"""The port's streamed swap (the two-phase shuffle of
``bolt_tpu_torch/stream.py`` and ``bolt_tpu_torch/parallel/shuffle.py``)
and its spill layer (``bolt_tpu_torch/checkpoint.py``) against the
reference's (``tests/test_stream_swap.py``).

The same seeded numpy sources stream through ``bolt_tpu`` (the 8-device
CPU mesh) and through the port with ``context=torch.device("cpu")``.  A
transpose moves bytes and never rounds, so every swap, resident or
spilled, is compared bit for bit: with the materialised swap, with
``np.transpose`` and with the reference's streamed swap.  Sums over a
swapped integer-valued f64 source are exact under any fold order, so
they are bit for bit too.
"""

import glob
import os
import tempfile

import numpy as np
import pytest
import torch

import bolt_tpu as ref
from bolt_tpu import stream as ref_stream
from bolt_tpu.parallel import shuffle as ref_shuffle
import bolt_tpu_torch as bolt
from bolt_tpu_torch import _chaos, checkpoint, engine, stream
from bolt_tpu_torch.gpu import codec as codec_mod
from bolt_tpu_torch.parallel import shuffle

CPU = torch.device("cpu")
N, V0, V1 = 24, 6, 5
SHAPE = (N, V0, V1)


@pytest.fixture(autouse=True)
def _no_armed_chaos():
    _chaos.clear()
    yield
    _chaos.clear()


def _data(dtype=np.float32):
    n = int(np.prod(SHAPE))
    if np.issubdtype(np.dtype(dtype), np.integer):
        return ((np.arange(n) % 11) - 5).astype(dtype).reshape(SHAPE)
    return (np.arange(n, dtype=np.float64) * 0.37 - 100.0).astype(
        dtype).reshape(SHAPE)


def _source(data, chunks, codec=None):
    return bolt.fromcallback(lambda idx: data[idx], data.shape, CPU,
                             dtype=data.dtype, chunks=chunks, codec=codec)


def _theirs(data, mesh, chunks, codec=None):
    return ref.fromcallback(lambda idx: data[idx], data.shape, mesh,
                            dtype=data.dtype, chunks=chunks, codec=codec)


def _mat_swap(data, kaxes, vaxes):
    """The materialise-first oracle: a concrete array, the in-memory
    swap."""
    return bolt.array(data, CPU).swap(kaxes, vaxes).toarray()


# ---------------------------------------------------------------------
# streamed vs materialised parity
# ---------------------------------------------------------------------

@pytest.mark.parametrize("chunks", [4, 5, 1])   # even, uneven tail, 1-record
@pytest.mark.parametrize("kaxes,vaxes", [
    ((0,), (0,)),          # the canonical key<->value exchange
    ((0,), (1,)),          # trailing value axis to the keys
    ((0,), (0, 1)),        # one key for BOTH value axes (new_split=2)
])
def test_streamed_swap_parity_bitexact(mesh, chunks, kaxes, vaxes):
    data = _data()
    s = _source(data, chunks).swap(kaxes, vaxes)
    assert s.streaming                      # still lazy after the record
    r = _theirs(data, mesh, chunks).swap(kaxes, vaxes)
    assert s.shape == r.shape and s.split == r.split
    got = s.toarray()
    assert np.array_equal(got, _mat_swap(data, kaxes, vaxes))
    assert np.array_equal(got, np.asarray(r._data))


@pytest.mark.parametrize("spill", [False, True])
def test_iterator_source_swap(mesh, tmp_path, spill):
    # ragged iterator blocks: phase 1 takes each as a slab, phase 2 glues
    # the spilled pieces in block order
    data = _data()
    blocks = [data[:5], data[5:6], data[6:]]
    with stream.spill(dir=str(tmp_path), budget=1 if spill else None):
        s = bolt.fromiter(blocks, SHAPE, CPU, dtype=np.float32).swap(
            (0,), (0,))
        got = s.toarray()
    assert np.array_equal(got, np.transpose(data, (1, 0, 2)))
    r = ref.fromiter(blocks, SHAPE, mesh, dtype=np.float32).swap((0,), (0,))
    assert np.array_equal(got, np.asarray(r.toarray()))
    assert checkpoint.spill_pending(str(tmp_path)) is spill


def test_swap_roundtrip_restores_source_bits():
    data = _data()
    rt = _source(data, 4).swap((0,), (0,)).swap((0,), (0,))
    assert rt.streaming
    assert np.array_equal(rt.toarray(), data)


def test_swap_stays_lazy_until_consumed():
    calls = []

    def loader(idx):
        calls.append(idx)
        return _data()[idx]

    s = bolt.fromcallback(loader, SHAPE, CPU, dtype=np.float32,
                          chunks=4).swap((0,), (0,))
    assert calls == []                      # recording is free
    assert s.shape == (V0, N, V1) and calls == []
    s.toarray()
    assert len(calls) == 6                  # resolution streamed the slabs


def test_swap_sum_terminal_consumes_stream(mesh):
    data = np.round(_data(np.float64))      # integer-valued: exact sums
    s = _source(data, 4).swap((0,), (0,))
    c0 = engine.counters()
    got = s.sum().toarray()
    c1 = engine.counters()
    assert np.array_equal(got, np.transpose(data, (1, 0, 2)).sum(axis=0))
    assert np.array_equal(got, np.asarray(_theirs(data, mesh, 4).swap(
        (0,), (0,)).sum().toarray()))
    assert c1["shuffle_bytes"] - c0["shuffle_bytes"] == data.nbytes
    assert c1["shuffle_seconds"] > c0["shuffle_seconds"]
    assert not s.streaming                  # resident: adopted concrete


def test_swap_then_map_parity():
    data = _data()
    got = _source(data, 4).swap((0,), (0,)).map(lambda v: v * 2.0)
    assert got.streaming
    assert np.array_equal(got.toarray(), np.transpose(data, (1, 0, 2)) * 2.0)


def test_swap_then_chunk_map_parity():
    data = _data()
    got = (_source(data, 4).swap((0,), (0,)).chunk((3, 5))
           .map(lambda blk: blk + 1.0).unchunk())
    assert got.streaming
    assert np.array_equal(got.toarray(), np.transpose(data, (1, 0, 2)) + 1.0)


def test_map_then_swap_then_filter_sum():
    # stages before the swap run in phase 1, a filter after it rides the
    # resident result's fused terminal
    data = np.round(_data(np.float64))
    pred = lambda v: v.sum() > -1500.0      # noqa: E731
    out = (_source(data, 5).map(lambda v: v + 1.0).swap((0,), (0,))
           .filter(pred))
    want = np.transpose(data + 1.0, (1, 0, 2))
    want = want[want.reshape(V0, -1).sum(axis=1) > -1500.0]
    assert np.array_equal(out.sum().toarray(), want.sum(axis=0))


def test_streamed_swap_under_dict_codec():
    """A lossless-codec source swaps streamed (phase 1 decodes the wire
    slab before the permute), bit for bit."""
    data = _data(np.int32)
    s = _source(data, 4, codec="dict").swap((0,), (0,))
    assert s.streaming
    assert np.array_equal(s.toarray(), np.transpose(data, (1, 0, 2)))


def test_lossy_codec_swap_falls_back_to_materialise(mesh):
    """A LOSSY codec refuses the streamed shuffle (phase 1 would decode
    once and a later lossy terminal would quantise again): the swap takes
    the materialised path."""
    data = _data()
    s = _source(data, 4, codec="bf16").swap((0,), (0,))
    assert not s.streaming                  # materialised at record time
    assert s.toarray().shape == (V0, N, V1)
    assert _theirs(data, mesh, 4, codec="bf16").swap((0,), (0,)) \
        ._stream is None


def test_filtered_stream_swap_materialises():
    data = np.round(_data(np.float64))
    f = _source(data, 4).filter(lambda v: v.sum() > -1000.0)
    keep = data[data.reshape(N, -1).sum(axis=1) > -1000.0]
    s = f.swap((0,), (0,))
    assert not s.streaming
    assert np.array_equal(s.toarray(), np.transpose(keep, (1, 0, 2)))


# ---------------------------------------------------------------------
# the forced-spill path (budget ~ one bucket)
# ---------------------------------------------------------------------

def test_forced_spill_bitexact_and_cleared(tmp_path):
    data = _data()
    td = str(tmp_path)
    c0 = engine.counters()
    with stream.spill(dir=td, budget=1):
        s = _source(data, 4).swap((0,), (0,))
        got = s.toarray()
    c1 = engine.counters()
    assert np.array_equal(got, np.transpose(data, (1, 0, 2)))
    assert c1["spill_bytes"] > c0["spill_bytes"]
    assert c1["shuffle_bytes"] > c0["shuffle_bytes"]
    assert checkpoint.spill_pending(td)
    checkpoint.spill_clear(td)
    assert not checkpoint.spill_pending(td)
    assert not glob.glob(os.path.join(td, "bolt-spill-*"))


def test_spilled_sum_equals_resident_sum(mesh, tmp_path):
    # phase 2 streams the bucket files through the same executor: its sum
    # equals the resident swap's, and the reference's spilled one
    data = np.round(_data(np.float64))
    resident = _source(data, 4).swap((0,), (0,)).sum().toarray()
    with stream.spill(dir=str(tmp_path), budget=1):
        s = _source(data, 4).swap((0,), (0,))
        spilled = s.sum().toarray()
        assert s.streaming                  # adopted the bucket stream
    assert np.array_equal(spilled, resident)
    with ref_stream.spill(dir=str(tmp_path / "ref"), budget=1):
        want = np.asarray(_theirs(data, mesh, 4).swap((0,), (0,))
                          .sum().toarray())
    assert np.array_equal(spilled, want)


def test_forced_spill_chunk_map_rides_phase_two(tmp_path):
    """chunk().map() AFTER the swap streams through the spilled phase-2
    source."""
    data = _data()
    with stream.spill(dir=str(tmp_path), budget=1):
        got = (_source(data, 4).swap((0,), (0,)).chunk((3, 5))
               .map(lambda blk: blk * 3.0).unchunk().toarray())
    assert np.array_equal(got, np.transpose(data, (1, 0, 2)) * 3.0)


def test_spill_manifest_resume_skips_done_slabs(tmp_path):
    # a second resolution of the same pipeline over the same directory
    # finds every slab marked done and streams no input slab again
    data = _data()
    calls = []

    def loader(idx):
        calls.append(idx[0].start)
        return data[idx]

    def run():
        with stream.spill(dir=str(tmp_path), budget=1):
            return bolt.fromcallback(loader, SHAPE, CPU, dtype=np.float32,
                                     chunks=4).swap((0,), (0,)).toarray()

    first = run()
    assert sorted(calls) == list(range(0, N, 4))
    calls.clear()
    assert np.array_equal(run(), first)
    assert calls == []


def test_spill_without_dir_refuses_pointedly():
    data = _data()
    with stream.spill(budget=1):            # a budget but NO directory
        s = _source(data, 4).swap((0,), (0,))
        with pytest.raises(RuntimeError, match="spill"):
            s.toarray()


# ---------------------------------------------------------------------
# the planner and the compile-once contract
# ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,perm,new_split,slab,budget", [
    ((24, 6, 5), (1, 0, 2), 1, 4, None),
    ((24, 6, 5), (1, 0, 2), 1, 4, 1),
    ((24, 6, 5), (2, 0, 1), 1, 5, 1),
    ((200, 200, 64), (1, 0, 2), 1, 20, 1 << 20),
    ((30, 7, 9), (1, 2, 0), 2, 7, 1 << 30),
])
def test_plan_matches_the_reference(shape, perm, new_split, slab, budget):
    mine = shuffle.plan_shuffle(shape, np.float32, 1, perm, new_split, slab,
                                budget, "/spill")
    theirs = ref_shuffle.plan_shuffle(shape, np.float32, 1, perm, new_split,
                                      None, slab, budget, "/spill")
    for name in shuffle.ShufflePlan.__slots__:
        assert getattr(mine, name) == getattr(theirs, name), name
    assert mine.describe().startswith("shuffle plan:")


def test_pick_out_block_matches_the_reference():
    for extent in (1, 6, 24, 200, 97):
        for target in (1, 3, 20, 1000):
            for mult in (1, 2, 4):
                assert shuffle._pick_out_block(extent, target, mult) == \
                    ref_shuffle._pick_out_block(extent, target, mult)


def test_zero_second_pass_recompiles():
    data = _data()

    def run():
        return _source(data, 4).swap((0,), (0,)).toarray()

    first = run()
    c0 = engine.counters()
    second = run()
    c1 = engine.counters()
    assert c1["misses"] == c0["misses"], "second pass built programs"
    assert np.array_equal(first, second)


def test_shuffle_chaos_raise_absorbed_in_place():
    data = _data()
    want = np.transpose(data, (1, 0, 2))
    for seam in ("stream.shuffle", "stream.spill"):
        _chaos.inject(seam, nth=2)
        c0 = engine.counters()
        try:
            with stream.retries(1), stream.spill(budget=None):
                if seam == "stream.spill":
                    td = tempfile.mkdtemp(prefix="bolt-swapchaos-")
                    with stream.spill(dir=td, budget=1):
                        got = _source(data, 4).swap((0,), (0,)).toarray()
                    checkpoint.spill_clear(td)
                    os.rmdir(td)
                else:
                    got = _source(data, 4).swap((0,), (0,)).toarray()
        finally:
            _chaos.clear()
        c1 = engine.counters()
        assert c1["stream_retries"] - c0["stream_retries"] == 1, seam
        assert np.array_equal(got, want), seam


@pytest.mark.parametrize("seam", ["stream.shuffle", "stream.spill"])
def test_shuffle_chaos_without_retries_raises_the_original(seam, tmp_path):
    data = _data()
    boom = RuntimeError("bucket store went away")
    _chaos.inject(seam, nth=2, exc=boom)
    with stream.spill(dir=str(tmp_path), budget=1):
        with pytest.raises(RuntimeError) as ei:
            _source(data, 4).swap((0,), (0,)).toarray()
    assert ei.value is boom


# ---------------------------------------------------------------------
# the dict codec
# ---------------------------------------------------------------------

def test_dict_codec_registered():
    assert "dict" in codec_mod.names()
    c = codec_mod.get("dict")
    assert c.lossless and c.sidecar


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.int8, np.bool_])
def test_dict_codec_roundtrip_bitexact(dtype):
    c = codec_mod.get("dict")
    block = (np.arange(60) % 2 if dtype == np.bool_
             else (np.arange(60) % 7) * 3 - 5).astype(dtype).reshape(12, 5)
    wire, side = c.encode(block, delta_ok=False)
    assert wire.dtype == torch.uint8 and tuple(wire.shape) == block.shape
    assert len(side) == 1 and side[0].shape == (256,)
    assert side[0].dtype == block.dtype
    out = c.decode(wire, (torch.from_numpy(side[0]),),
                   torch.from_numpy(block).dtype, delta_ok=False)
    assert np.array_equal(out.numpy(), block)


def test_dict_codec_refuses_floats_pointedly():
    c = codec_mod.get("dict")
    with pytest.raises(ValueError, match="dictionary"):
        c.wire_dtype(np.float32)
    with pytest.raises(ValueError, match="dictionary"):
        c.encode(np.ones((4, 4), np.float64))


def test_dict_codec_cardinality_contract():
    with pytest.raises(ValueError, match="256"):
        codec_mod.get("dict").encode(np.arange(300, dtype=np.int32))


def test_dict_codec_streamed_sum_and_wire_ratio(mesh):
    """End to end through the uploader pool: int64 slabs ship as uint8
    indices (1/8 the wire bytes) and the decoded sum is exact."""
    data = _data(np.int64)
    c0 = engine.counters()
    got = _source(data, 4, codec="dict").sum().toarray()
    c1 = engine.counters()
    assert np.array_equal(got, data.sum(axis=0))
    assert np.array_equal(got, np.asarray(
        _theirs(data, mesh, 4, codec="dict").sum().toarray()))
    raw = c1["codec_bytes_raw"] - c0["codec_bytes_raw"]
    wire = c1["codec_bytes_wire"] - c0["codec_bytes_wire"]
    assert raw == 8 * wire


# ---------------------------------------------------------------------
# the spill-file layer (checkpoint.py)
# ---------------------------------------------------------------------

def test_spill_save_load_roundtrip(tmp_path):
    td, fp = str(tmp_path), ("fp-a", 1)
    ints = ((np.arange(40) % 5) - 2).astype(np.int64).reshape(8, 5)
    nb = checkpoint.spill_save(td, fp, 0, 0, ints, 16)
    assert nb > 0
    out, row0 = checkpoint.spill_load(td, fp, 0, 0)
    assert np.array_equal(out, ints) and out.dtype == ints.dtype
    assert row0 == 16

    floats = _data()[:8, :, 0]              # raw path (no dict for floats)
    checkpoint.spill_save(td, fp, 0, 1, floats, 0)
    out2, _ = checkpoint.spill_load(td, fp, 0, 1)
    assert np.array_equal(out2, floats)

    wide = np.arange(300, dtype=np.int32)   # > 256 uniques: raw fallback
    checkpoint.spill_save(td, fp, 1, 0, wide, 0)
    out3, _ = checkpoint.spill_load(td, fp, 1, 0)
    assert np.array_equal(out3, wide)


def test_spill_files_readable_by_the_reference(tmp_path):
    # the port writes the reference's file format: same names, same keys
    from bolt_tpu import checkpoint as ref_ckpt
    td, fp = str(tmp_path), ("fp-x", 3)
    ints = ((np.arange(40) % 5) - 2).astype(np.int64).reshape(8, 5)
    checkpoint.spill_save(td, fp, 2, 1, ints, 8)
    out, row0 = ref_ckpt.spill_load(td, fp, 2, 1)
    assert np.array_equal(out, ints) and row0 == 8
    checkpoint.spill_slab_done(td, fp, 2)
    assert ref_ckpt.spill_manifest(td, fp) == {2}


def test_spill_manifest_and_fingerprint_isolation(tmp_path):
    td, fp = str(tmp_path), ("fp-a",)
    assert checkpoint.spill_manifest(td, fp) == set()
    checkpoint.spill_slab_done(td, fp, 0)
    checkpoint.spill_slab_done(td, fp, 3)
    assert checkpoint.spill_manifest(td, fp) == {0, 3}
    # a different fingerprint hashes to a different directory
    assert checkpoint.spill_manifest(td, ("fp-b",)) == set()
    assert checkpoint.spill_pending(td)
    checkpoint.spill_clear(td)
    assert not checkpoint.spill_pending(td)


def test_spill_load_missing_bucket_refuses_pointedly(tmp_path):
    with pytest.raises(checkpoint.CheckpointCorruptError, match="spill"):
        checkpoint.spill_load(str(tmp_path), ("fp",), 0, 0)
