"""Resumable streams of the port (``bolt_tpu_torch.stream.resumable``, a
source's ``checkpoint=``, ``bolt_tpu_torch.checkpoint.stream_*``)
against the reference's (``tests/test_resilience.py``).

The load-bearing contract is the reference's: a streamed run killed
mid-way (a thread raise, a checkpoint-write fault, a subprocess
``kill -9``) leaves its retired-slab watermark and folded partial on
disk, and the same call resumes from it with a result BIT-IDENTICAL to
the port's own uninterrupted run, for ``sum``, the moment terminals,
``min``/``max``, ``reduce`` and multi-stat groups; an edited pipeline,
another codec, a torn or a corrupt checkpoint is refused, never
adopted.  Each resumed result is also held against ``bolt_tpu``'s
uninterrupted run on the 8-device CPU mesh: exactly on integer-valued
f64 (sums are exact in any order), within ``rtol=1e-12`` on random f64.
Sources run on the torch CPU device.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch import _chaos as chaos
from bolt_tpu_torch import checkpoint, engine, obs, stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N = 32
SHAPE = (N, 6, 4)


@pytest.fixture(autouse=True)
def _no_armed_chaos():
    chaos.clear()
    yield
    chaos.clear()


def _intdata():
    return ((np.arange(np.prod(SHAPE)) % 13) - 6).astype(
        np.float64).reshape(SHAPE)


def _randdata(seed=5):
    return np.random.RandomState(seed).randn(*SHAPE)


def _source(data, ck=None, chunks=4, codec=None):
    return bolt.fromcallback(lambda idx: data[idx], data.shape, CPU,
                             dtype=data.dtype, chunks=chunks,
                             checkpoint=ck, codec=codec)


def _ref_source(data, mesh, chunks=4):
    return ref.fromcallback(lambda idx: data[idx], data.shape, mesh,
                            dtype=data.dtype, chunks=chunks)


def _a(b):
    return np.asarray(b.toarray())


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _kill(run, nth=5, seam="stream.upload"):
    """``run()`` with ``seam`` armed at its ``nth`` hit: it must raise."""
    chaos.inject(seam, nth=nth)
    try:
        with pytest.raises(chaos.ChaosError):
            with stream.uploaders(1):
                run()
    finally:
        chaos.clear()


# ---------------------------------------------------------------------
# the kill-mid-run proof, thread-raise variant (8 slabs)
# ---------------------------------------------------------------------

def test_resume_sum_bit_identical_thread_raise(mesh, tmp_path):
    data = _intdata()
    ck = str(tmp_path / "ck")
    clean = _a(_source(data).sum())
    c0 = engine.counters()
    _kill(lambda: _source(data, ck=ck).sum().cache())
    c1 = engine.counters()
    assert checkpoint.stream_pending(ck)         # the watermark survived
    assert c1["checkpoint_bytes"] > c0["checkpoint_bytes"]
    assert c1["checkpoint_seconds"] > c0["checkpoint_seconds"]
    got = _a(_source(data, ck=ck).sum())
    c2 = engine.counters()
    assert _bits(got, clean)                     # BIT-identical
    assert np.array_equal(got, data.sum(axis=0))
    assert np.array_equal(got, _a(_ref_source(data, mesh).sum()))
    assert c2["stream_resumes"] - c1["stream_resumes"] == 1
    assert c2["stream_chunks"] - c1["stream_chunks"] < 8
    assert not checkpoint.stream_pending(ck)     # success cleared it


def test_resume_multi_stat_bit_identical(mesh, tmp_path):
    data = _randdata()
    ck = str(tmp_path / "ck")

    def run(ckdir=None):
        out = _source(data, ck=ckdir).stats("sum", "var")
        return {k: _a(v) for k, v in out.items()}

    clean = run()
    _kill(lambda: [v.cache() for v in _source(data, ck=ck).stats(
        "sum", "var").values()])
    assert checkpoint.stream_pending(ck)
    got = run(ckdir=ck)
    want = {k: _a(v) for k, v in _ref_source(data, mesh).stats(
        "sum", "var").items()}
    for k in clean:
        assert _bits(got[k], clean[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    assert not checkpoint.stream_pending(ck)


def test_resume_var_through_resumable_scope(mesh, tmp_path):
    data = _intdata()
    ck = str(tmp_path / "ck")
    clean = _a(_source(data).var())

    def failing():
        with stream.resumable(ck):
            _source(data).var().cache()
    _kill(failing)
    assert checkpoint.stream_pending(ck)
    with stream.resumable(ck):
        got = _a(_source(data).var())
    assert _bits(got, clean)
    np.testing.assert_allclose(got, _a(_ref_source(data, mesh).var()),
                               rtol=1e-12)
    assert not checkpoint.stream_pending(ck)


def test_resume_fromiter_reiterable(mesh, tmp_path):
    data = _intdata()
    blocks = [data[:8], data[8:16], data[16:24], data[24:]]
    ck = str(tmp_path / "ck")

    def make(ckdir=None):
        return bolt.fromiter(blocks, SHAPE, CPU, dtype=np.float64,
                             checkpoint=ckdir)

    clean = _a(make().mean())
    chaos.inject("stream.upload", nth=3)
    with pytest.raises(chaos.ChaosError):
        make(ck).mean().cache()
    chaos.clear()
    assert checkpoint.stream_pending(ck)
    c0 = engine.counters()
    got = _a(make(ck).mean())
    c1 = engine.counters()
    assert _bits(got, clean)
    assert c1["stream_resumes"] - c0["stream_resumes"] == 1
    assert c1["stream_chunks"] - c0["stream_chunks"] < 4
    np.testing.assert_allclose(got, data.mean(axis=0), rtol=1e-12)


def test_resume_fromiter_layout_drift_refused(tmp_path):
    data = _intdata()
    ck = str(tmp_path / "ck")
    blocks = [data[:8], data[8:16], data[16:24], data[24:]]
    chaos.inject("stream.upload", nth=3)
    with pytest.raises(chaos.ChaosError):
        bolt.fromiter(blocks, SHAPE, CPU, dtype=np.float64,
                      checkpoint=ck).sum().cache()
    chaos.clear()
    assert checkpoint.stream_pending(ck)
    # a DIFFERENT block layout cannot satisfy the record watermark
    drifted = [data[:16], data[16:]]
    with pytest.raises(RuntimeError, match="drifted|ended after"):
        bolt.fromiter(drifted, SHAPE, CPU, dtype=np.float64,
                      checkpoint=ck).sum().cache()


def test_stale_checkpoint_other_pipeline_ignored(mesh, tmp_path):
    data = _intdata()
    ck = str(tmp_path / "ck")
    _kill(lambda: _source(data, ck=ck).sum().cache())
    assert checkpoint.stream_pending(ck)
    c0 = engine.counters()
    got = _a(_source(data, ck=ck).mean())
    c1 = engine.counters()
    assert c1["stream_resumes"] == c0["stream_resumes"]   # no resume
    assert c1["stream_chunks"] - c0["stream_chunks"] == 8  # full stream
    assert np.array_equal(got, _a(ref.array(data, mesh).mean()))


def test_checkpoint_write_failure_surfaces_then_heals(tmp_path):
    data = _intdata()
    ck = str(tmp_path / "ck")
    chaos.inject("stream.checkpoint", nth=1)
    with pytest.raises(chaos.ChaosError):
        _source(data, ck=ck).sum().cache()
    chaos.clear()
    got = _a(_source(data, ck=ck).sum())
    assert np.array_equal(got, data.sum(axis=0))
    assert not checkpoint.stream_pending(ck)


def test_resumed_run_zero_new_compiles_second_resume(tmp_path):
    data = _intdata()
    ck = str(tmp_path / "ck")
    clean = _a(_source(data).sum())
    # first kill at upload 5 of 8; the SECOND run resumes and is killed
    # again at its upload 2
    for nth in (5, 2):
        _kill(lambda: _source(data, ck=ck).sum().cache(), nth=nth)
    c0 = engine.counters()
    got = _a(_source(data, ck=ck).sum())
    c1 = engine.counters()
    assert _bits(got, clean)
    assert c1["misses"] - c0["misses"] <= 2      # the program cache
    assert c1["stream_resumes"] - c0["stream_resumes"] == 1


# ---------------------------------------------------------------------
# every terminal, every cadence: bit for bit
# ---------------------------------------------------------------------

TERMINALS = {
    "sum": lambda s: s.sum(),
    "mean": lambda s: s.mean(),
    "var": lambda s: s.var(),
    "std": lambda s: s.std(),
    "min": lambda s: s.min(),
    "max": lambda s: s.max(),
    "reduce": lambda s: s.reduce(np.add),
    "reduce_max": lambda s: s.reduce(np.maximum),
    "map_sum": lambda s: s.map(lambda v: v * 2 + 1).sum(),
    "filter_mean": lambda s: s.filter(lambda v: v.mean() > 0).mean(),
}


@pytest.mark.parametrize("name", sorted(TERMINALS))
@pytest.mark.parametrize("every,nth", [(1, 4), (2, 5), (3, 7)])
def test_resume_terminal_bit_identical(mesh, tmp_path, name, every, nth):
    data = _randdata(seed=7)
    ck = str(tmp_path / "ck")
    fn = TERMINALS[name]
    clean = _a(fn(_source(data)))

    def failing():
        with stream.resumable(ck, every=every):
            fn(_source(data)).cache()
    _kill(failing, nth=nth)
    assert checkpoint.stream_pending(ck)
    c0 = engine.counters()
    with stream.resumable(ck, every=every):
        got = _a(fn(_source(data)))
    c1 = engine.counters()
    assert _bits(got, clean)
    assert c1["stream_resumes"] - c0["stream_resumes"] == 1
    assert c1["stream_chunks"] - c0["stream_chunks"] < 8
    assert not checkpoint.stream_pending(ck)
    want = _a(fn(_ref_source(data, mesh)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_resume_group_of_every_member_bit_identical(mesh, tmp_path):
    data = _randdata(seed=8)
    ck = str(tmp_path / "ck")
    names = ("sum", "mean", "var", "std", "min", "max", "ptp")

    def group(s):
        return [getattr(s, m)() for m in names]

    clean = [_a(r) for r in bolt.compute(*group(_source(data)))]
    _kill(lambda: [r.cache() for r in bolt.compute(
        *group(_source(data, ck=ck)))], nth=6)
    got = [_a(r) for r in bolt.compute(*group(_source(data, ck=ck)))]
    want = [_a(r) for r in ref.compute(*group(_ref_source(data, mesh)))]
    for m, g, c, w in zip(names, got, clean, want):
        assert _bits(g, c), m
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def test_resume_int8_codec_and_a_changed_codec_restarts(tmp_path):
    data = _intdata().astype(np.float32)
    ck = str(tmp_path / "ck")
    clean = _a(_source(data, codec="int8").sum())
    _kill(lambda: _source(data, ck=ck, codec="int8").sum().cache())
    meta = checkpoint._read_meta(ck)
    assert meta["codec"] == "int8"
    # the same pipeline under another codec is another run: from scratch
    c0 = engine.counters()
    raw = _a(_source(data, ck=ck).sum())
    c1 = engine.counters()
    assert c1["stream_resumes"] == c0["stream_resumes"]
    assert c1["stream_chunks"] - c0["stream_chunks"] == 8
    assert np.array_equal(raw, data.sum(axis=0))
    # and the int8 run resumes from its own checkpoint
    _kill(lambda: _source(data, ck=ck, codec="int8").sum().cache())
    got = _a(_source(data, ck=ck, codec="int8").sum())
    assert _bits(got, clean)


def test_resume_with_the_decode_kernel_toggled_restarts(tmp_path,
                                                        monkeypatch):
    # the fused_decode_sum route and the plain decode differ in their
    # last bits: a run killed on one route never resumes on the other
    data = _intdata().astype(np.float32)
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("BOLT_CODEC_KERNEL", "1")
    armed = _a(_source(data, codec="int8").sum())
    _kill(lambda: _source(data, ck=ck, codec="int8").sum().cache())
    monkeypatch.delenv("BOLT_CODEC_KERNEL")
    c0 = engine.counters()
    plain = _a(_source(data, ck=ck, codec="int8").sum())
    c1 = engine.counters()
    assert c1["stream_resumes"] == c0["stream_resumes"]
    assert c1["stream_chunks"] - c0["stream_chunks"] == 8
    assert _bits(plain, _a(_source(data, codec="int8").sum()))
    # armed again, the run resumes from its own route's checkpoint
    monkeypatch.setenv("BOLT_CODEC_KERNEL", "1")
    _kill(lambda: _source(data, ck=ck, codec="int8").sum().cache())
    c0 = engine.counters()
    got = _a(_source(data, ck=ck, codec="int8").sum())
    assert engine.counters()["stream_resumes"] == c0["stream_resumes"] + 1
    assert _bits(got, armed)


def test_abort_watermark_counts_only_folded_slabs(tmp_path):
    # a dispatch that fails is not retired: the abort checkpoint's
    # watermark stops before it, and the resume re-runs it
    data = _randdata(seed=9)
    ck = str(tmp_path / "ck")
    clean = _a(_source(data).sum())
    _kill(lambda: _source(data, ck=ck).sum().cache(), nth=4,
          seam="stream.dispatch")
    meta = checkpoint._read_meta(ck)
    assert meta["slabs"] == 3 and meta["records"] == 12
    got = _a(_source(data, ck=ck).sum())
    assert _bits(got, clean)


def test_no_write_after_the_last_slab_of_a_known_size_stream(tmp_path):
    data = _intdata()
    ck = str(tmp_path / "ck")
    writes = []
    real = checkpoint.stream_save

    def counted(path, fp, slabs, *a, **k):
        writes.append(slabs)
        return real(path, fp, slabs, *a, **k)

    checkpoint.stream_save = counted
    try:
        with stream.resumable(ck, every=2):
            _source(data).sum().cache()
    finally:
        checkpoint.stream_save = real
    assert writes == [2, 4, 6]                   # not 8
    assert not checkpoint.stream_pending(ck)


def test_reference_checkpoint_in_the_directory_is_not_adopted(mesh,
                                                              tmp_path):
    from bolt_tpu import _chaos as ref_chaos
    from bolt_tpu import stream as ref_stream
    data = _intdata()
    ck = str(tmp_path / "ck")
    ref_chaos.inject("stream.upload", nth=5)
    try:
        with pytest.raises(ref_chaos.ChaosError), ref_stream.uploaders(1):
            ref.fromcallback(lambda idx: data[idx], SHAPE, mesh,
                             dtype=np.float64, chunks=4,
                             checkpoint=ck).sum().cache()
    finally:
        ref_chaos.clear()
    assert checkpoint.stream_pending(ck)         # the reference's meta
    c0 = engine.counters()
    got = _a(_source(data, ck=ck).sum())
    c1 = engine.counters()
    assert c1["stream_resumes"] == c0["stream_resumes"]
    assert np.array_equal(got, data.sum(axis=0))


# ---------------------------------------------------------------------
# the kill-mid-run proof, subprocess kill -9 variant
# ---------------------------------------------------------------------

_CHILD = """
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import bolt_tpu_torch as bolt
from bolt_tpu_torch import engine, stream
n = 40
data = ((np.arange(n * 6 * 4) % 13) - 6).astype(np.float64).reshape(n, 6, 4)
c0 = engine.counters()
with stream.uploaders(1):
    s = bolt.fromcallback(lambda idx: data[idx], data.shape,
                          torch.device("cpu"), dtype=np.float64, chunks=4,
                          checkpoint=sys.argv[2]).sum().toarray()
c1 = engine.counters()
np.save(sys.argv[3], s)
print(json.dumps({k: c1[k] - c0[k] for k in ("stream_resumes",
                                             "stream_chunks")}))
"""


def _child(ck, out, chaos_env=None):
    env = {k: v for k, v in os.environ.items() if k != "BOLT_CHAOS"}
    if chaos_env:
        env["BOLT_CHAOS"] = chaos_env
    return subprocess.run([sys.executable, "-c", _CHILD, ROOT, ck, out],
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_subprocess_kill9_resume_bit_identical(tmp_path):
    import json
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "sum.npy")
    clean_out = str(tmp_path / "clean.npy")
    assert _child(str(tmp_path / "clean_ck"), clean_out).returncode == 0
    # killed in the consumer thread, at its 6th slab: the checkpoints of
    # slabs 2 and 4 are whole.  An uploader-thread kill can land between
    # the two renames of a write, and that torn pair is refused by design
    killed = _child(ck, out, "stream.dispatch:6:kill")
    assert killed.returncode != 0                # SIGKILL, not an exit
    assert checkpoint.stream_pending(ck)
    p = _child(ck, out)
    assert p.returncode == 0, p.stderr
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["stream_resumes"] == 1              # resumed, not restarted
    assert r["stream_chunks"] < 10
    assert _bits(np.load(out), np.load(clean_out))
    assert not checkpoint.stream_pending(ck)


# ---------------------------------------------------------------------
# the checkpoint layer: write order, torn pairs, corruption
# ---------------------------------------------------------------------

def test_stream_meta_written_last_state_first(tmp_path, monkeypatch):
    calls = []
    real_replace = os.replace

    def tracing_replace(a, b):
        calls.append(os.path.basename(b))
        return real_replace(a, b)

    monkeypatch.setattr(os, "replace", tracing_replace)
    checkpoint.stream_save(str(tmp_path), ("fp",), 2, 8,
                           ([np.ones(3)], None))
    assert calls == ["stream_state.npz", "stream_meta.json"]


def test_stream_clear_removes_meta_first(tmp_path, monkeypatch):
    checkpoint.stream_save(str(tmp_path), ("fp",), 2, 8,
                           ([np.ones(3)], None))
    removed = []
    real_remove = os.remove

    def tracing_remove(p):
        removed.append(os.path.basename(p))
        return real_remove(p)

    monkeypatch.setattr(os, "remove", tracing_remove)
    checkpoint.stream_clear(str(tmp_path))
    assert removed == ["stream_meta.json", "stream_state.npz"]
    checkpoint.stream_clear(str(tmp_path))       # idempotent


def test_torn_meta_state_pair_refused(tmp_path):
    fp = ("fp",)
    checkpoint.stream_save(str(tmp_path), fp, 2, 8, ([np.ones(3)], None))
    meta = os.path.join(str(tmp_path), "stream_meta.json")
    shutil.copy(meta, meta + ".old")
    checkpoint.stream_save(str(tmp_path), fp, 4, 16,
                           ([np.full(3, 2.0)], None))
    assert checkpoint.stream_load(str(tmp_path), fp) is not None
    os.replace(meta + ".old", meta)      # the torn window, reproduced
    assert checkpoint.stream_load(str(tmp_path), fp) is None
    checkpoint.stream_save(str(tmp_path), fp, 6, 24, ([np.ones(3)], None))
    assert checkpoint.stream_load(str(tmp_path), fp)[0] == 6


def test_kill_between_the_renames_keeps_the_previous_checkpoint(tmp_path):
    fp = ("fp",)
    checkpoint.stream_save(str(tmp_path), fp, 2, 8, ([np.ones(3)], None))
    chaos.inject("checkpoint.meta", nth=1)
    with pytest.raises(chaos.ChaosError):
        checkpoint.stream_save(str(tmp_path), fp, 4, 16,
                               ([np.full(3, 2.0)], None))
    chaos.clear()
    # the new state landed, the old meta stayed: refused as a torn pair
    assert checkpoint.stream_pending(str(tmp_path))
    assert checkpoint.stream_load(str(tmp_path), fp) is None


def test_corrupt_state_refused_pointedly(tmp_path):
    data = _intdata()
    ck = str(tmp_path / "ck")
    chaos.inject("checkpoint.corrupt", nth=1)
    try:
        with stream.resumable(ck, every=2):
            _source(data).sum().cache()
    finally:
        chaos.clear()
    # the run succeeded (and cleared); a corrupt file left behind is not
    fp = ("fp",)
    chaos.inject("checkpoint.corrupt", nth=1)
    try:
        checkpoint.stream_save(ck, fp, 2, 8, ([np.ones(64)], None))
    finally:
        chaos.clear()
    with pytest.raises(checkpoint.CheckpointCorruptError, match="corrupt"):
        checkpoint.stream_load(ck, fp)
    # a resumed run over it refuses too, rather than seeding the fold
    _kill(lambda: _source(data, ck=ck).sum().cache())
    state = os.path.join(ck, "stream_state.npz")
    with open(state, "r+b") as f:
        f.seek(os.path.getsize(state) // 2)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(checkpoint.CheckpointCorruptError):
        _source(data, ck=ck).sum().cache()


def test_meta_without_a_digest_refused(tmp_path):
    # every meta the port writes holds the state's digest: one without it
    # was edited by hand or written by another tool
    fp = ("fp",)
    checkpoint.stream_save(str(tmp_path), fp, 2, 8, ([np.ones(3)], None))
    meta = os.path.join(str(tmp_path), "stream_meta.json")
    with open(meta) as f:
        rec = json.load(f)
    del rec["digest"]
    with open(meta, "w") as f:
        json.dump(rec, f)
    with pytest.raises(checkpoint.CheckpointCorruptError, match="digest"):
        checkpoint.stream_load(str(tmp_path), fp)


def test_edited_pipeline_fingerprint_refused(tmp_path):
    data = _intdata()
    ck = str(tmp_path / "ck")
    _kill(lambda: _source(data, ck=ck).map(lambda v: v + 1).sum().cache())
    assert checkpoint.stream_pending(ck)
    c0 = engine.counters()
    got = _a(_source(data, ck=ck).map(lambda v: v * 2).sum())
    c1 = engine.counters()
    assert c1["stream_resumes"] == c0["stream_resumes"]   # refused
    assert np.array_equal(got, (data * 2).sum(axis=0))    # correct


def test_failed_and_resumed_runs_leak_no_spans(tmp_path):
    data = _intdata()
    ck = str(tmp_path / "ck")
    obs.clear()
    obs.enable()
    try:
        _kill(lambda: _source(data, ck=ck).sum().cache())
        assert obs.active_count() == 0           # failed run: no leaks
        _source(data, ck=ck).sum().cache()
        assert obs.active_count() == 0           # resumed run: no leaks
        names = {s.name for s in obs.spans()}
        assert "stream.checkpoint" in names
        resumes = [e for e in obs.spans() if e.name == "stream.resume"]
        assert resumes and resumes[-1].kind == "I"
        assert resumes[-1].attrs["slabs"] > 0
    finally:
        obs.disable()
        obs.clear()


def test_spilled_swap_resume_counts_a_resume(tmp_path):
    data = np.arange(16 * 6 * 4, dtype=np.int64).reshape(16, 6, 4)
    spill = str(tmp_path / "spill")

    def swapped():
        return bolt.fromcallback(lambda idx: data[idx], data.shape, CPU,
                                 dtype=np.int64, chunks=4).swap((0,), (0,))

    want = np.asarray(bolt.array(data, CPU).swap((0,), (0,)).toarray())
    chaos.inject("stream.spill", nth=7)
    with pytest.raises(chaos.ChaosError):
        with stream.spill(spill, budget=1 << 8), stream.uploaders(1):
            swapped().sum().cache()
    chaos.clear()
    assert checkpoint.spill_pending(spill)
    c0 = engine.counters()
    with stream.spill(spill, budget=1 << 8):
        b = swapped()
        got = _a(b.sum())
        data_back = np.asarray(b.toarray())
    c1 = engine.counters()
    assert c1["stream_resumes"] - c0["stream_resumes"] >= 1
    assert np.array_equal(got, want.sum(axis=0))
    assert np.array_equal(data_back, want)
    checkpoint.spill_clear(spill)
