"""The port's streaming executor (``bolt_tpu_torch/stream.py``) against the
reference's (``bolt_tpu/stream.py``).

The same seeded numpy sources stream through ``bolt_tpu`` (the 8-device
CPU mesh) and through the port with ``context=torch.device("cpu")``, where
the executor runs with plain host tensors and ``fused_decode_sum`` takes
its plain version.  Tolerances, as ``test_stream.py`` and
``test_codec.py`` hold the reference:

* integer-valued f64 sources make ``sum``/``mean`` exact under any fold
  order: bit for bit, for slabs of 1, 4, 5 and 16 records;
* ``var``/``std`` of random f64: ``rtol=atol=1e-12``;
* ``min``/``max``, ``reduce(add)`` on integer values and the lossless
  ``delta-f32`` codec: bit for bit;
* ``bf16``/``f16``: the documented envelope (``codec_bound``); ``int8``:
  half a quantisation step a record, ``(max - min) / 255 / 2 * n``;
* the armed int8 route against the unarmed one: ``rtol=1e-5, atol=1e-3``.
"""

import operator
import threading

import numpy as np
import pytest
import torch

import bolt_tpu as ref
from bolt_tpu import engine as ref_engine
import bolt_tpu_torch as bolt
from bolt_tpu_torch import _precision, engine, stream
from bolt_tpu_torch.ops import kernels as K

CPU = torch.device("cpu")
N, V0, V1 = 16, 6, 4
SHAPE = (N, V0, V1)

ADD1 = lambda v: v + 1.0       # noqa: E731


def _intdata(shape=SHAPE):
    """Integer-valued float64: sums are exact under any fold order."""
    return ((np.arange(np.prod(shape)) % 13) - 6).astype(
        np.float64).reshape(shape)


def _posdata(shape=(64, 16, 8)):
    rs = np.random.RandomState(7)
    return (np.abs(rs.randn(*shape)) + 0.5).astype(np.float32)


def _mine(x, chunks=None, codec=None, dtype=None, axis=(0,)):
    return bolt.fromcallback(lambda idx: x[idx], x.shape, CPU, axis=axis,
                             dtype=dtype or x.dtype, chunks=chunks,
                             codec=codec)


def _theirs(x, mesh, chunks=None, codec=None, dtype=None):
    return ref.fromcallback(lambda idx: x[idx], x.shape, mesh,
                            dtype=dtype or x.dtype, chunks=chunks,
                            codec=codec)


def _a(b):
    return np.asarray(b.toarray())


def _chan_mean(x, chunks):
    """The streamed mean's arithmetic in numpy f64: slab partials ``(n, mu,
    M2)``, merged level 0 first, then the binary-counter tree."""
    def part(s):
        mu = s.sum(axis=0) / float(s.shape[0])
        return float(s.shape[0]), mu, ((s - mu) ** 2).sum(axis=0)

    def comb(a, b):
        n1, mu1, m21 = a
        n2, mu2, m22 = b
        n = n1 + n2
        d = mu2 - mu1
        return n, mu1 + d * (n2 / n), m21 + m22 + d * d * (n1 * n2 / n)

    parts = [part(x[i:i + chunks]) for i in range(0, len(x), chunks)]
    leaves = [comb(parts[i], parts[i + 1]) if i + 1 < len(parts)
              else parts[i] for i in range(0, len(parts), 2)]
    levels = []
    for leaf in leaves:
        lvl = 0
        while lvl < len(levels) and levels[lvl] is not None:
            leaf = comb(levels[lvl], leaf)
            levels[lvl] = None
            lvl += 1
        if lvl == len(levels):
            levels.append(leaf)
        else:
            levels[lvl] = leaf
    acc = None
    for lv in levels:
        if lv is not None:
            acc = lv if acc is None else comb(lv, acc)
    return acc[1]


# ---------------------------------------------------------------------------
# parity with the reference's streamed terminals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunks", [1, 4, 5, 16])
def test_stream_sum_mean_bit_exact(mesh, chunks):
    data = _intdata()
    src = _mine(data, chunks)
    assert src.streaming and src.shape == SHAPE and src.split == 1
    got_sum = _a(src.map(ADD1).sum())
    got_mean = _a(_mine(data, chunks).map(ADD1).mean())
    want_sum = _a(_theirs(data, mesh, chunks).map(ADD1).sum())
    want_mean = _a(_theirs(data, mesh, chunks).map(ADD1).mean())
    assert got_sum.dtype == want_sum.dtype == np.float64
    assert np.array_equal(got_sum, want_sum)
    assert np.array_equal(got_sum, (data + 1).sum(axis=0))
    # the mean is the pairwise Chan fold of the slab partials, bit for bit
    assert np.array_equal(got_mean, _chan_mean(data + 1, chunks))
    if N % chunks == 0:
        # power-of-two slabs: every Chan denominator is exact
        assert np.array_equal(got_mean, want_mean)
    else:
        # ragged slabs (5, 5, 5, 1): the reference's compiled merge rounds
        # its formula differently by an ulp (ROADMAP C), as its own suite
        # allows against its materialised mean
        np.testing.assert_allclose(got_mean, want_mean, rtol=1e-14,
                                   atol=1e-14)


@pytest.mark.parametrize("chunks", [1, 3, 4])
def test_stream_var_std(mesh, chunks):
    data = np.random.RandomState(3).randn(*SHAPE)
    for name, kw in (("var", {}), ("std", {}), ("var", {"ddof": 1}),
                     ("std", {"ddof": 1})):
        got = _a(getattr(_mine(data, chunks), name)(**kw))
        want = _a(getattr(_theirs(data, mesh, chunks), name)(**kw))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got, getattr(np, name)(data, axis=0,
                                                          **kw),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["min", "max"])
def test_stream_order_statistics(mesh, name):
    data = np.random.RandomState(4).randn(*SHAPE).astype(np.float32)
    c0 = engine.counters()["stream_chunks"]
    got = _a(getattr(_mine(data, 4), name)())
    assert engine.counters()["stream_chunks"] - c0 == 4      # streamed
    assert np.array_equal(got, _a(getattr(_theirs(data, mesh, 4), name)()))
    assert np.array_equal(got, getattr(data, name)(axis=0))


@pytest.mark.parametrize("chunks", [3, 16])
def test_stream_reduce_add(mesh, chunks):
    data = _intdata()
    got = _mine(data, chunks).map(ADD1).reduce(operator.add)
    want = _theirs(data, mesh, chunks).map(ADD1).reduce(operator.add)
    assert got.shape == (V0, V1)
    assert np.array_equal(_a(got), _a(want))


def test_stream_map_and_cast_stages(mesh):
    data = _intdata()
    got = _mine(data, 4).map(lambda v: v * 2.0).map(
        lambda v: v[:, :2], dtype=np.float32)
    want = _theirs(data, mesh, 4).map(lambda v: v * 2.0).map(
        lambda v: v[:, :2], dtype=np.float32)
    assert got.streaming and got.shape == want.shape == (N, V0, 2)
    assert got.dtype == want.dtype == np.float32
    for name in ("sum", "mean"):
        assert np.array_equal(_a(getattr(got, name)()),
                              _a(getattr(want, name)()))
    # a scalar operand joins the chain as a stage too
    assert np.array_equal(_a((_mine(data, 4) + 1).sum()),
                          (data + 1).sum(axis=0))


def test_stream_two_key_axes():
    data = _intdata((4, 4, V0, V1))
    src = _mine(data, chunks=3, axis=(0, 1))
    assert src.split == 2
    assert np.array_equal(_a(src.sum()), data.sum(axis=(0, 1)))
    c0 = engine.counters()["stream_chunks"]
    assert np.array_equal(_a(_mine(data, 3, axis=(0, 1)).reduce(
        operator.add, axis=(0, 1))), data.sum(axis=(0, 1)))
    assert engine.counters()["stream_chunks"] - c0 == 2


def test_stream_other_axes_and_keepdims_materialise():
    data = _intdata()
    src = _mine(data, 4)
    assert np.array_equal(_a(src.sum(axis=1)), data.sum(axis=1))
    assert not src.streaming          # adopted its materialised tensor
    assert np.array_equal(_a(_mine(data, 4).sum(keepdims=True)),
                          data.sum(axis=0, keepdims=True))


# ---------------------------------------------------------------------------
# constructors, laziness, materialisation
# ---------------------------------------------------------------------------

def test_fromiter_streams_and_matches_reference(mesh):
    data = _intdata()
    blocks = [data[i:i + 5] for i in range(0, N, 5)]
    got = bolt.fromiter(blocks, SHAPE, CPU, dtype=np.float64)
    assert got.streaming
    want = ref.fromiter(blocks, SHAPE, mesh, dtype=np.float64)
    assert np.array_equal(_a(got.sum()), _a(want.sum()))
    assert np.array_equal(got.toarray(), data)    # re-iterable: again


def test_fromiter_generator_is_one_shot_like_reference(mesh):
    data = _intdata()

    def gen():
        for i in range(0, N, 4):
            yield data[i:i + 4]

    errs = []
    for make in (lambda g: bolt.fromiter(g, SHAPE, CPU, dtype=np.float64),
                 lambda g: ref.fromiter(g, SHAPE, mesh, dtype=np.float64)):
        src = make(gen())
        assert np.array_equal(_a(src.sum()), data.sum(axis=0))
        with pytest.raises(RuntimeError) as ei:
            _a(src.sum())
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and "exhausted" in errs[0]


def test_fromiter_requires_dtype_and_checks_coverage(mesh):
    with pytest.raises(ValueError, match="explicit dtype"):
        bolt.fromiter([], SHAPE, CPU)
    short = [_intdata()[:10]]
    errs = []
    for src in (bolt.fromiter(short, SHAPE, CPU, dtype=np.float64),
                ref.fromiter(short, SHAPE, mesh, dtype=np.float64)):
        with pytest.raises(ValueError) as ei:
            _a(src.sum())
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and "cover only 10 of 16" in errs[0]


def test_fromcallback_shape_mismatch_like_reference(mesh):
    data = _intdata()
    errs = []
    for src in (bolt.fromcallback(lambda idx: data[idx][:, :2], SHAPE, CPU,
                                  dtype=np.float64, chunks=4),
                ref.fromcallback(lambda idx: data[idx][:, :2], SHAPE, mesh,
                                 dtype=np.float64, chunks=4)):
        with pytest.raises(ValueError) as ei:
            _a(src.sum())
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and "returned shape (4, 2, 4)" in errs[0]


def test_fromcallback_without_dtype_uploads_at_once():
    data = _intdata()
    calls = []
    b = bolt.fromcallback(lambda idx: (calls.append(idx), data[idx])[1],
                          SHAPE, CPU)
    assert not b.streaming and len(calls) == 1
    assert b.dtype == np.float64 and np.array_equal(b.toarray(), data)
    b.totorch()[0] = 99.0               # the array never aliases the block
    assert data[0, 0, 0] != 99.0


def test_stream_is_lazy_until_a_terminal():
    data = _intdata()
    calls = []

    def fn(idx):
        calls.append(idx)
        return data[idx]

    src = bolt.fromcallback(fn, SHAPE, CPU, dtype=np.float64, chunks=4)
    mapped = src.map(ADD1).map(lambda v: v * 2)
    assert calls == [] and mapped.streaming
    assert mapped.shape == SHAPE and mapped.dtype == np.float64
    assert "streaming" in repr(mapped)
    total = mapped.sum()
    assert calls == []              # the terminal is lazy too
    total.cache()
    assert len(calls) == 4          # one call a slab


def test_materialisation_equals_local_oracle():
    data = _intdata()
    chain = lambda b: b.map(ADD1).map(lambda v: v * v)   # noqa: E731
    src = chain(_mine(data, 5))
    want = chain(bolt.array(data)).toarray()
    assert np.array_equal(src.toarray(), want)
    assert not src.streaming        # adopted: a second read is resident
    assert np.array_equal(src.toarray(), want)
    # a swap and a chunk().map() stay lazy stages of the stream until
    # toarray() resolves them (the swap by the two-phase shuffle); the
    # StatCounter form of stats() materialises the source first
    assert np.array_equal(_mine(data, 4).swap((0,), (0,)).toarray(),
                          np.transpose(data, (1, 0, 2)))
    st = _mine(data, 4).stats()
    np.testing.assert_allclose(st.mean(), data.mean(axis=0), rtol=1e-12)
    assert np.array_equal(st.max(), data.max(axis=0))
    ch = _mine(data, 4).chunk(size=(3,), axis=(0,)).map(
        lambda blk: blk * 2).unchunk()
    assert np.array_equal(ch.toarray(), data * 2)


def test_failed_materialisation_keeps_the_stream():
    data = _intdata()
    state = {"fail": True}

    def fn(idx):
        if state["fail"]:
            raise OSError("transient read error")
        return data[idx]

    src = bolt.fromcallback(fn, SHAPE, CPU, dtype=np.float64, chunks=4)
    with pytest.raises(OSError, match="transient"):
        src.toarray()
    assert src.streaming
    state["fail"] = False
    assert np.array_equal(src.toarray(), data)


# ---------------------------------------------------------------------------
# codecs through the stream
# ---------------------------------------------------------------------------

def test_delta_f32_bit_identical(mesh):
    x = np.random.RandomState(3).randn(64, 16, 8).astype(np.float32)
    x[5, 2, 3] = np.inf
    for chunks in (8, 5, 1):
        raw = _a(_mine(x, chunks).sum())
        enc = _a(_mine(x, chunks, codec="delta-f32").sum())
        assert np.array_equal(raw.view(np.uint32), enc.view(np.uint32))
        assert np.array_equal(enc.view(np.uint32), _a(_theirs(
            x, mesh, chunks, codec="delta-f32").sum()).view(np.uint32))
    # the inf makes NaN means: the bits still agree
    assert np.array_equal(
        _a(_mine(x, 8).mean()).view(np.uint32),
        _a(_mine(x, 8, codec="delta-f32").mean()).view(np.uint32))


@pytest.mark.parametrize("name,terminal", [("bf16", "sum"), ("f16", "mean"),
                                           ("bf16", "mean")])
def test_half_codecs_within_envelope(mesh, name, terminal):
    x = _posdata()
    raw = _a(getattr(_mine(x, 8), terminal)())
    enc = _a(getattr(_mine(x, 8, codec=name), terminal)())
    _, bound = _precision.codec_bound(name)
    np.testing.assert_allclose(enc, raw, rtol=bound)
    assert not np.array_equal(enc, raw)          # genuinely lossy
    want = _a(getattr(_theirs(x, mesh, 8, codec=name), terminal)())
    np.testing.assert_allclose(enc, want, rtol=1e-6)


def test_int8_within_step_bound_and_wire_ratio(mesh):
    x = _posdata()
    c0 = engine.counters()
    raw = _a(_mine(x, 8).sum())
    c1 = engine.counters()
    enc = _a(_mine(x, 8, codec="int8").sum())
    c2 = engine.counters()
    step = (x.max() - x.min()) / 255.0
    assert np.max(np.abs(enc - raw)) <= step / 2 * x.shape[0] + 1e-4
    np.testing.assert_allclose(
        enc, _a(_theirs(x, mesh, 8, codec="int8").sum()), rtol=1e-6,
        atol=1e-4)
    assert c1["stream_chunks"] - c0["stream_chunks"] == 8
    assert c2["stream_chunks"] - c1["stream_chunks"] == 8
    raw_b = c2["codec_bytes_raw"] - c1["codec_bytes_raw"]
    wire_b = c2["codec_bytes_wire"] - c1["codec_bytes_wire"]
    assert raw_b == x.nbytes and wire_b / raw_b == 0.25
    # the link carried the wire plus 8 sidecar bytes a slab
    assert c1["transfer_bytes"] - c0["transfer_bytes"] == x.nbytes
    assert c2["transfer_bytes"] - c1["transfer_bytes"] == wire_b + 8 * 8


@pytest.mark.parametrize("name,terminal", [("bf16", "min"), ("int8", "max"),
                                           ("f16", "min")])
def test_lossy_codec_refuses_order_statistics_like_reference(mesh, name,
                                                             terminal):
    x = _posdata()
    errs = []
    for src in (_mine(x, 8, codec=name), _theirs(x, mesh, 8, codec=name)):
        with pytest.raises(ValueError) as ei:
            _a(getattr(src, terminal)())
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and "order-statistic" in errs[0]
    assert np.array_equal(_a(_mine(x, 8, codec="delta-f32").min()),
                          x.min(axis=0))


def test_lossy_codec_refuses_integer_stream_like_reference(mesh):
    x = (np.arange(np.prod(SHAPE)) % 7).astype(np.int32).reshape(SHAPE)
    errs = []
    for src in (_mine(x, 4, codec="bf16"), _theirs(x, mesh, 4, codec="bf16")):
        with pytest.raises(ValueError) as ei:
            _a(src.sum())
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and "int32" in errs[0]
    # the lossless dict codec takes integer pipelines
    got = _a(_mine(x, 4, codec="dict").sum())
    assert got.dtype == np.int64 and np.array_equal(got, x.sum(axis=0))


def test_unknown_codec_refused_at_scope_and_source():
    with pytest.raises(ValueError, match="unknown codec"):
        with stream.codec("zstd"):
            pass
    with pytest.raises(ValueError, match="unknown codec"):
        _mine(_intdata(), 4, codec="zstd")
    with pytest.raises(ValueError, match="unknown codec"):
        stream.set_codec("zstd")


def test_codec_scopes_thread_local_and_source_wins():
    x = _posdata()
    seen = {}
    with stream.codec("bf16"):
        assert stream.resolve_codec(_mine(x)._stream).name == "bf16"
        assert stream.resolve_codec(
            _mine(x, codec="f16")._stream).name == "f16"

        def other():
            seen["codec"] = stream.current_codec()
            seen["uploaders"] = stream.upload_threads()

        with stream.uploaders(3):
            t = threading.Thread(target=other)
            t.start()
            t.join()
            assert stream.upload_threads() == 3
    assert seen == {"codec": None, "uploaders": 0}
    assert stream.resolve_codec(_mine(x)._stream) is None


# ---------------------------------------------------------------------------
# the armed int8 route: fused_decode_sum
# ---------------------------------------------------------------------------

def _count_decode_sum(monkeypatch):
    calls = []
    real = K.fused_decode_sum

    def counted(q, scale, zp):
        calls.append(tuple(q.shape))
        return real(q, scale, zp)
    monkeypatch.setattr(K, "fused_decode_sum", counted)
    return calls


def test_armed_int8_route_against_unarmed(mesh, monkeypatch):
    x = (np.random.RandomState(9).rand(32, 256) * 10).astype(np.float32)
    calls = _count_decode_sum(monkeypatch)
    monkeypatch.delenv("BOLT_CODEC_KERNEL", raising=False)
    off = _a(_mine(x, 8, codec="int8").sum())
    assert calls == []
    monkeypatch.setenv("BOLT_CODEC_KERNEL", "1")
    on = _a(_mine(x, 8, codec="int8").sum())
    assert calls == [(8, 256)] * 4          # once a slab
    np.testing.assert_allclose(on, off, rtol=1e-5, atol=1e-3)
    ref_on = _a(_theirs(x, mesh, 8, codec="int8").sum())
    np.testing.assert_allclose(on, ref_on, rtol=1e-5, atol=1e-3)
    # the reference's conditions: a map stage, another terminal or another
    # codec keeps the decode route
    _mine(x, 8, codec="int8").map(ADD1).sum()
    _mine(x, 8, codec="int8").mean()
    _mine(x, 8, codec="bf16").sum()
    assert len(calls) == 4


def test_armed_route_raises_when_the_kernel_fails(monkeypatch):
    x = (np.random.RandomState(9).rand(32, 256) * 10).astype(np.float32)

    def broken(q, scale, zp):
        raise RuntimeError("fused_decode_sum launch failed: CUDA error 98")
    monkeypatch.setattr(K, "fused_decode_sum", broken)
    monkeypatch.setenv("BOLT_CODEC_KERNEL", "1")
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        _mine(x, 8, codec="int8").sum().cache()


# ---------------------------------------------------------------------------
# the pool: counters, concurrency, failures
# ---------------------------------------------------------------------------

def test_counters_track_the_run():
    data = _intdata((40, V0, V1))
    c0 = engine.counters()
    with stream.uploaders(4), stream.prefetch(3):
        _mine(data, 4).sum().cache()
    c1 = engine.counters()
    assert c1["stream_chunks"] - c0["stream_chunks"] == 10
    assert c1["transfer_bytes"] - c0["transfer_bytes"] == data.nbytes
    assert c1["stream_prefetch_depth"] >= 3
    assert 1 <= c1["stream_upload_threads"] <= 4
    assert c1["stream_inflight_high_water"] <= 3 + 4     # the ring
    assert c1["stream_wall_seconds"] > c0["stream_wall_seconds"]
    assert set(c1) >= set(k for k in ref_engine.counters()
                          if k.startswith(("stream_", "transfer_",
                                           "codec_"))) - {
        "stream_retries", "stream_resumes"}


def test_pool_uploads_concurrently():
    data = _intdata((32, V0, V1))
    barrier = threading.Barrier(4, timeout=10)

    def fn(idx):
        if idx[0].start < 16:
            barrier.wait()          # four slabs in hand at once
        return data[idx]

    with stream.uploaders(4):
        got = _a(bolt.fromcallback(fn, data.shape, CPU, dtype=np.float64,
                                   chunks=4).sum())
    assert np.array_equal(got, data.sum(axis=0))
    assert engine.counters()["stream_upload_threads"] >= 4


def test_pool_stress_more_workers_than_cores():
    # 16 uploaders, one-record slabs and a short switch interval: a lost
    # update in the re-sequencer, the permits or the counters would show
    # as a wrong sum, a wrong slab count or a hang (bounded by the pool's
    # joins)
    import sys
    data = _intdata((96, V0, V1)).astype(np.float32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            c0 = engine.counters()["stream_chunks"]
            with stream.uploaders(16), stream.prefetch(1):
                got = _a(_mine(data, 1, codec="delta-f32").sum())
            assert np.array_equal(got, data.sum(axis=0))
            assert engine.counters()["stream_chunks"] - c0 == 96
            assert not any(t.is_alive() for t in stream._LAST_POOL)
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("nwork", [1, 4])
def test_worker_failure_surfaces_original_and_joins_pool(nwork):
    data = _intdata((40, V0, V1))

    class Boom(Exception):
        pass

    def fn(idx):
        if idx[0].start == 20:
            raise Boom("slab at record 20")
        return data[idx]

    with stream.uploaders(nwork):
        with pytest.raises(Boom, match="record 20"):
            bolt.fromcallback(fn, data.shape, CPU, dtype=np.float64,
                              chunks=4).sum().cache()
    assert len(stream._LAST_POOL) == nwork + 1
    assert not any(t.is_alive() for t in stream._LAST_POOL)


def test_iterator_failure_surfaces_original():
    def gen():
        yield _intdata()[:8]
        raise KeyError("cursor lost")

    with pytest.raises(KeyError, match="cursor lost"):
        bolt.fromiter(gen(), SHAPE, CPU, dtype=np.float64).sum().cache()
    assert not any(t.is_alive() for t in stream._LAST_POOL)


def test_dead_pool_thread_is_a_pointed_error():
    t = threading.Thread(target=lambda: None, name="bolt-stream-upload-0")
    t.start()
    t.join()
    with pytest.raises(RuntimeError, match="bolt-stream-upload-0.*slab 0"):
        stream._Reseq().next([t])


# ---------------------------------------------------------------------
# analysis: streaming plans under check() and strict()
# ---------------------------------------------------------------------

DOUBLE = lambda blk: blk * 2          # noqa: E731
POSSUM = lambda v: v.sum() > 0        # noqa: E731


def test_analysis_check_streaming_plan_no_build(mesh):
    from bolt_tpu import analysis as ref_analysis
    from bolt_tpu_torch import analysis
    data = _intdata()
    p = (_mine(data, 4).chunk(size=(3,), axis=(0,)).map(DOUBLE)
         .filter(POSSUM))
    c0 = engine.counters()
    rep = analysis.check(p)
    c1 = engine.counters()
    assert all(c1[k] == c0[k] for k in ("misses", "aot_compiles",
                                        "dispatches", "transfer_bytes"))
    want = ref_analysis.check(_theirs(data, mesh, 4).chunk(
        size=(3,), axis=(0,)).map(DOUBLE).filter(POSSUM))
    assert "streaming" in rep.target and rep.dynamic and rep.has("BLT008")
    assert rep.shape == want.shape == (None, V0, V1)
    assert np.dtype(rep.dtype) == np.dtype(want.dtype) == np.float64
    assert len(rep.stages) == len(want.stages) == 3
    rep2 = analysis.check(_mine(data, 4).map(ADD1))
    assert rep2.shape == SHAPE and not rep2.dynamic


def test_analysis_strict_gates_streamed_terminal():
    from bolt_tpu_torch import analysis
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    data = _intdata()
    base = _mine(data, 4)
    # a hand-appended NON-SCALAR predicate (the public filter() refuses
    # it at the call): strict refuses the streamed terminal before any
    # upload or build
    arr = BoltArrayGPU._streamed(base._stream.with_stage(
        ("filter", lambda v: v > 0)))
    rep = analysis.check(arr)
    assert rep.has("BLT007") and rep.has("BLT008") and not rep.ok
    c0 = engine.counters()
    with analysis.strict():
        with pytest.raises(analysis.PipelineError, match="BLT007"):
            arr.sum()
    c1 = engine.counters()
    assert c1["strict_rejections"] - c0["strict_rejections"] == 1
    assert c1["misses"] == c0["misses"]
    assert c1["transfer_bytes"] == c0["transfer_bytes"]
    # a healthy streamed terminal passes the gate, bit for bit
    want = _mine(data, 4).sum().toarray()
    with analysis.strict():
        out = _mine(data, 4).sum().toarray()
    assert out.dtype == want.dtype and np.array_equal(out, want)
    assert np.array_equal(out, data.sum(axis=0))
