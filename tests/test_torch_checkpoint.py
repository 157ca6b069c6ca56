"""Array checkpoints of the port (``bolt_tpu_torch.checkpoint.save``/
``load``) against the reference's (``tests/test_checkpoint.py``, and the
orbax-less tests of ``tests/test_resilience.py``).

The port writes the reference's single-process ``npy`` format only
(orbax imports jax).  Files go both ways: the reference's ``load``
reads the port's files, and the port's ``load`` reads the reference's,
written with orbax hidden (``sys.modules["orbax"] = None``, as
``test_checkpoint_save_without_orbax_npy_fallback`` does); values are
compared exactly.  A bfloat16 array round-trips bit for bit (stored as
its 2-byte patterns, as the reference's own ``np.save`` writes one) as
a leaf of a stream checkpoint; the port's arrays hold numpy dtypes, so a
reference checkpoint of a bfloat16 array is refused pointedly (the
reference's own ``load`` cannot cast its file back either).

Left out (jax only): ``test_load_onto_different_mesh`` and
``test_checkpoint_tuple_spec_sharding`` (a 2-d mesh's sharding),
``test_checkpoint_npy_format_readable_with_orbax_back`` (the port has no
orbax to bring back: its npy files are read above) and
``test_checkpoint_multiprocess_without_orbax_pointed_error`` (a
multi-process jax runtime; the port's multi-process stream checkpoint
raises its own pointed error, below).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu import checkpoint as ref_ckpt
from bolt_tpu_torch import checkpoint
from bolt_tpu_torch.utils import allclose

CPU = torch.device("cpu")


def _x():
    rs = np.random.RandomState(30)
    return rs.randn(8, 4, 6)


@pytest.fixture
def no_orbax(monkeypatch):
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def test_save_load_roundtrip(tmp_path):
    x = _x()
    b = bolt.array(x, CPU, axis=(0, 1))
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, b)
    b2 = checkpoint.load(path, context=CPU)
    assert b2.mode == "gpu"
    assert b2.split == 2
    assert b2.shape == b.shape
    assert b2.dtype == b.dtype
    assert allclose(b2.toarray(), x)
    # restored array is live: ops work
    assert allclose(b2.map(lambda v: v + 1).toarray(), x + 1)
    with open(os.path.join(path, "bolt_meta.json")) as f:
        assert json.load(f) == {"split": 2, "shape": [8, 4, 6],
                                "dtype": "float64", "format": "npy"}


def test_save_deferred_materialises(tmp_path):
    x = _x()
    m = bolt.array(x, CPU).map(lambda v: v * 2)
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, m)
    assert allclose(checkpoint.load(path, CPU).toarray(), x * 2)


def test_save_rejects_local(tmp_path):
    with pytest.raises(TypeError):
        checkpoint.save(str(tmp_path / "c"), bolt.array(_x()))


def test_checkpoint_deferred_and_pending_states(tmp_path):
    rs = np.random.RandomState(40)
    x = rs.randn(16, 4)
    b = bolt.array(x, CPU).map(lambda v: v * 2)
    checkpoint.save(str(tmp_path / "a"), b)
    r = checkpoint.load(str(tmp_path / "a"), context=CPU)
    assert np.allclose(r.toarray(), x * 2)

    f = bolt.array(x, CPU).filter(lambda v: v.mean() > 0)
    checkpoint.save(str(tmp_path / "b"), f)
    r2 = checkpoint.load(str(tmp_path / "b"), context=CPU)
    keep = x[x.mean(axis=1) > 0]
    assert r2.shape == keep.shape and np.allclose(r2.toarray(), keep)


def test_save_of_a_stream_materialises(tmp_path):
    x = _x()
    s = bolt.fromcallback(lambda i: x[i], x.shape, CPU, dtype=np.float64,
                          chunks=3).map(lambda v: v - 1)
    checkpoint.save(str(tmp_path / "s"), s)
    r = checkpoint.load(str(tmp_path / "s"), context=CPU)
    assert np.array_equal(r.toarray(), x - 1)


def test_load_without_context_needs_cuda(tmp_path):
    checkpoint.save(str(tmp_path / "c"), bolt.array(_x(), CPU))
    if torch.cuda.is_available():
        pytest.skip("a card is present: load() places on cuda:0")
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.load(str(tmp_path / "c"))


DTYPES = [np.float64, np.float32, np.int32, np.uint16, np.uint64, np.bool_,
          np.complex64]


def _data(dtype):
    x = np.random.RandomState(31).randn(6, 3, 4) * 10
    if dtype == np.complex64:
        return (x + 1j * x[::-1]).astype(dtype)
    return x.astype(dtype) if dtype != np.bool_ else x > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", [(0,), (0, 1)])
def test_reference_reads_the_ports_files(mesh, tmp_path, dtype, axis):
    x = _data(dtype)
    path = str(tmp_path / "c")
    checkpoint.save(path, bolt.array(x, CPU, axis=axis))
    r = ref_ckpt.load(path, context=mesh)
    assert r.split == len(axis) and r.dtype == x.dtype
    assert np.array_equal(np.asarray(r.toarray()), np.asarray(
        bolt.array(x, CPU, axis=axis).toarray()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", [(0,), (1, 2)])
def test_port_reads_the_references_files(mesh, tmp_path, no_orbax, dtype,
                                         axis):
    x = _data(dtype)
    path = str(tmp_path / "c")
    rb = ref.array(x, mesh, axis=axis)
    ref_ckpt.save(path, rb)                  # no orbax: the npy format
    assert os.path.exists(os.path.join(path, "array.npy"))
    b = checkpoint.load(path, context=CPU)
    assert b.split == rb.split and b.shape == rb.shape
    assert b.dtype == rb.dtype
    assert np.array_equal(b.toarray(), np.asarray(rb.toarray()))


def test_bf16_state_leaf_roundtrip_bit_for_bit(tmp_path):
    t = torch.from_numpy(np.random.RandomState(32).randn(8, 5)).to(
        torch.bfloat16)
    t[0, 0] = float("nan")
    t[0, 1] = -0.0
    f = torch.arange(5, dtype=torch.float32)
    checkpoint.stream_save(str(tmp_path), ("fp",), 2, 8,
                           ([t, None, (f, t)], t[1]))
    slabs, records, (levels, pend) = checkpoint.stream_load(
        str(tmp_path), ("fp",))
    assert (slabs, records) == (2, 8) and levels[1] is None
    for got, want in ((levels[0], t), (levels[2][1], t), (pend, t[1])):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(levels[2][0], f)
    z = np.load(os.path.join(str(tmp_path), "stream_state.npz"))
    assert z["leaf_0"].dtype == np.dtype("V2")


def test_references_bf16_array_file_refused_pointedly(mesh, tmp_path,
                                                      no_orbax):
    import ml_dtypes
    x = np.random.RandomState(33).randn(8, 3).astype(ml_dtypes.bfloat16)
    path = str(tmp_path / "bf")
    ref_ckpt.save(path, ref.array(x, mesh))
    with pytest.raises(TypeError, match="bfloat16"):
        checkpoint.load(path, context=CPU)
    # the file holds the bits, as the port stores a bfloat16 leaf
    bits = np.load(os.path.join(path, "array.npy")).view(np.uint16)
    assert np.array_equal(bits, x.view(np.uint16))


def test_orbax_directory_refused_pointedly(mesh, tmp_path):
    pytest.importorskip("orbax.checkpoint")
    path = str(tmp_path / "ob")
    ref_ckpt.save(path, ref.array(_x(), mesh))    # orbax's format
    with pytest.raises(ValueError, match="npy"):
        checkpoint.load(path, context=CPU)


def test_corrupt_array_file_refused(tmp_path):
    path = str(tmp_path / "c")
    checkpoint.save(path, bolt.array(_x(), CPU))
    with open(os.path.join(path, "bolt_meta.json")) as f:
        meta = json.load(f)
    meta["shape"] = [9, 4, 6]
    with open(os.path.join(path, "bolt_meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(checkpoint.CheckpointCorruptError, match="shape"):
        checkpoint.load(path, context=CPU)


def test_save_writes_atomically_array_then_meta(tmp_path, monkeypatch):
    calls = []
    real_replace = os.replace

    def tracing_replace(a, b):
        calls.append(os.path.basename(b))
        return real_replace(a, b)

    monkeypatch.setattr(os, "replace", tracing_replace)
    checkpoint.save(str(tmp_path / "c"), bolt.array(_x(), CPU))
    assert calls == ["array.npy", "bolt_meta.json"]
    assert not [p for p in os.listdir(str(tmp_path / "c"))
                if p.endswith(".tmp")]


def test_multiprocess_stream_checkpoint_refused_pointedly(tmp_path):
    # a pod's checkpoint of this run (its meta records two processes)
    # read by one process: the topology remap adopts it (every rank's
    # fold state is the same bits) and reports the width that cut it
    checkpoint.stream_save(str(tmp_path), ("fp", "pod"), 2, 8,
                           ([np.ones(3)], None))
    meta = checkpoint._read_meta(str(tmp_path))
    meta.update(nproc=2, fingerprint=["fp", "pod"])
    with open(os.path.join(str(tmp_path), "stream_meta.json"), "w") as f:
        json.dump(meta, f)
    state = os.path.join(str(tmp_path), "stream_state.npz")
    shard = os.path.join(str(tmp_path), "stream_state.p1.w2.npz")
    os.replace(state, shard)          # rank 1's shard: rank 0's is gone
    info = {}
    got = checkpoint.stream_load(str(tmp_path), ("fp", ""), info=info)
    assert got[:2] == (2, 8) and info == {"remapped_from": 2}
    assert np.array_equal(got[2][0][0].numpy(), np.ones(3))
    # the same run cut at another topology (its last element)
    os.replace(shard, state)
    meta.update(nproc=1, fingerprint=["fp", "pod"])
    with open(os.path.join(str(tmp_path), "stream_meta.json"), "w") as f:
        json.dump(meta, f)
    info = {}
    assert checkpoint.stream_load(str(tmp_path), ("fp", ""),
                                  info=info)[0] == 2
    assert info == {"remapped_from": 1}
    # another run's checkpoint is ignored, not refused
    assert checkpoint.stream_load(str(tmp_path), ("other", "")) is None
