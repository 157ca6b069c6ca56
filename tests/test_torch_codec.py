"""The port's ingest codecs (``bolt_tpu_torch/gpu/codec.py``) and its
decode-and-reduce kernel's plain version against the reference.

The same seeded numpy slabs go through ``bolt_tpu/tpu/codec.py`` and the
port.  Every codec's wire block and sidecar must equal the reference's bit
for bit, and so must its decode (the delta codec with NaN payloads, and
with an all-key-axes source that skips the delta; bf16 without
``ml_dtypes``).  ``fused_decode_sum`` runs its plain PyTorch version here
(the tensors lie on the CPU) and is held against the reference's Pallas
kernel in interpret mode, as ``test_codec.py`` runs it, within
``rtol=1e-6, atol=1e-4`` (another summation order).  The CUDA kernel is
held against the plain version on the card by ``test_torch_card.py``.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bolt_tpu import _precision as ref_precision
from bolt_tpu.ops.kernels import fused_decode_sum as ref_decode_sum
from bolt_tpu.tpu import codec as R
from bolt_tpu_torch import _precision
from bolt_tpu_torch.gpu import codec as P
from bolt_tpu_torch.ops import kernels as K


def _bits(a):
    """A wire block (numpy or torch) as unsigned integer bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float16):
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.kind in "fV" or a.dtype.name == "bfloat16":
        return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[
            a.dtype.itemsize])
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[
        a.dtype.itemsize])


def _ref_decode(name, wire, side, dtype, delta_ok=True):
    return np.asarray(R.get(name).decode(
        jnp.asarray(wire), tuple(jnp.asarray(s) for s in side), dtype,
        delta_ok))


def _port_decode(name, wire, side, dtype, delta_ok=True):
    from bolt_tpu_torch.gpu.array import torch_dtype
    out = P.get(name).decode(wire, tuple(torch.as_tensor(np.asarray(s))
                                         for s in side),
                             torch_dtype(dtype), delta_ok)
    return out.numpy()


def _slab(dtype, seed=0, shape=(6, 5, 16), nan=False):
    rs = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.floating):
        x = (rs.randn(*shape) * 10.0 ** rs.randint(-3, 4, shape)).astype(
            dtype)
        x.flat[3] = np.inf
        if nan:
            x.flat[7] = np.nan
            x.view(np.uint32 if x.itemsize == 4 else np.uint64).flat[11] \
                |= np.array(0x7FC00123 if x.itemsize == 4
                            else 0x7FF8000000000123, x.dtype.str.replace(
                                "f", "u"))
        return x
    if dtype == np.bool_:
        return rs.rand(*shape) > 0.5
    return rs.randint(-40, 40, size=shape).astype(dtype)


# ---------------------------------------------------------------------------
# the registry and the contract tables
# ---------------------------------------------------------------------------

def test_registry_names_and_pointed_unknown():
    assert P.names() == R.names()
    with pytest.raises(ValueError) as mine:
        P.get("zstd")
    with pytest.raises(ValueError) as ref:
        R.get("zstd")
    assert str(mine.value) == str(ref.value)
    c = P.get("bf16")
    assert P.get(c) is c


@pytest.mark.parametrize("name", ["bf16", "f16", "int8", "delta-f32"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wire_ratios_match_reference(name, dtype):
    if name == "delta-f32" and dtype == np.float64:
        pytest.raises(ValueError, P.get(name).ratio, dtype)
        return
    assert P.get(name).ratio(dtype) == R.get(name).ratio(dtype)


@pytest.mark.parametrize("name,dtype", [
    ("bf16", np.int32), ("f16", np.int32), ("int8", np.int32),
    ("f16", np.float16), ("delta-f32", np.float64), ("dict", np.float32),
    ("int8", np.bool_)])
def test_refusals_match_reference(name, dtype):
    with pytest.raises(ValueError) as mine:
        P.get(name).wire_dtype(dtype)
    with pytest.raises(ValueError) as ref:
        R.get(name).wire_dtype(dtype)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("name", ["bf16", "f16", "int8", "delta-f32",
                                  "dict", "no-such"])
def test_codec_bound_table_matches_reference(name):
    assert _precision.CODEC_BOUNDS == ref_precision.CODEC_BOUNDS
    assert _precision.codec_bound(name) == ref_precision.codec_bound(name)
    assert P.codec_bound is _precision.codec_bound


def test_kernel_switch(monkeypatch):
    monkeypatch.delenv("BOLT_CODEC_KERNEL", raising=False)
    assert not P.kernel_enabled()
    for on in ("1", "true", "TRUE"):
        monkeypatch.setenv("BOLT_CODEC_KERNEL", on)
        assert P.kernel_enabled() == R.kernel_enabled() is True
    monkeypatch.setenv("BOLT_CODEC_KERNEL", "0")
    assert not P.kernel_enabled()


# ---------------------------------------------------------------------------
# wire, sidecar and decode bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dtype,nan,delta_ok", [
    ("delta-f32", np.float32, True, True),
    ("delta-f32", np.float32, True, False),
    ("bf16", np.float32, False, True),
    ("bf16", np.float64, False, True),
    ("f16", np.float32, True, True),
    ("f16", np.float64, True, True),
    ("int8", np.float32, False, True),
    ("int8", np.float64, False, True),
    ("dict", np.int32, False, True),
    ("dict", np.uint8, False, True),
    ("dict", np.bool_, False, True)])
def test_wire_sidecar_and_decode_bit_for_bit(name, dtype, nan, delta_ok):
    x = _slab(dtype, nan=nan)
    if name == "int8":
        x[np.isinf(x)] = 3.5           # the codec's finite-values contract
    if not delta_ok:
        x = x.reshape(-1)              # an all-key-axes source: no value axis
    rwire, rside = R.get(name).encode(x, delta_ok)
    wire, side = P.get(name).encode(x, delta_ok)
    assert isinstance(wire, torch.Tensor) and tuple(wire.shape) == x.shape
    assert wire.dtype == P.get(name).wire_dtype(x.dtype)
    assert np.array_equal(_bits(wire), _bits(rwire))
    assert len(side) == len(rside)
    for s, rs in zip(side, rside):
        assert np.asarray(s).dtype == np.asarray(rs).dtype
        assert np.array_equal(_bits(np.asarray(s)), _bits(np.asarray(rs)))
    got = _port_decode(name, wire, side, x.dtype, delta_ok)
    want = _ref_decode(name, rwire, rside, x.dtype, delta_ok)
    assert got.dtype == want.dtype
    assert np.array_equal(_bits(got), _bits(want))
    if P.get(name).lossless:
        assert np.array_equal(_bits(got), _bits(x))


def test_delta_decode_wraps_across_the_sign_bit():
    # neighbouring values whose bits straddle 2**31 make the deltas wrap
    x = np.array([[1.0, -1.0, np.nan, -np.inf, 0.0, -0.0, 3e38, -3e38]],
                 np.float32)
    x.view(np.uint32)[0, 2] = 0xFFC00001     # a negative NaN payload
    wire, side = P.get("delta-f32").encode(x)
    back = _port_decode("delta-f32", wire, side, np.float32)
    assert np.array_equal(back.view(np.uint32), x.view(np.uint32))


def test_int8_constant_slab_is_exact():
    x = np.full((4, 8), 3.25, np.float32)
    wire, side = P.get("int8").encode(x)
    assert np.array_equal(_port_decode("int8", wire, side, np.float32), x)


def test_dict_refuses_high_cardinality_like_reference():
    x = np.arange(300, dtype=np.int64).reshape(3, 100)
    with pytest.raises(ValueError) as mine:
        P.get("dict").encode(x)
    with pytest.raises(ValueError) as ref:
        R.get("dict").encode(x)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bf16_wire_bits_equal_reference(dtype):
    # the reference's ml_dtypes cast, bit for bit: NaN and -NaN keep their
    # sign as 0x7FC0/0xFFC0 (a payload or signalling NaN too), infinities,
    # zeros, subnormals, ties to even either way, the largest finite f32
    # rounding up to inf; an f64 block rounds through f32 as the
    # reference's does: +-(1 + 2^-8 + 2^-40) rounds to the f32 tie
    # 1 + 2^-8, then to even (1.0), where one rounding would go up
    bits = np.array([0x7FC00000, 0xFFC00000, 0x7F812345, 0xFF812345,
                     0x7F800001, 0x7F800000, 0xFF800000, 0x00000000,
                     0x80000000, 0x00000001, 0x80000001, 0x00408000,
                     0x007FFFFF, 0x3F808000, 0x3F818000, 0x3F808001,
                     0xBF808000, 0x7F7FFFFF], np.uint32)
    above_tie = 1 + 2.0 ** -8 + 2.0 ** -40
    x = np.concatenate([bits.view(np.float32).astype(dtype),
                        np.array([above_tie, -above_tie], dtype)])
    x = x.reshape(4, 5)
    wire, _ = P.get("bf16").encode(x)
    rwire, _ = R.get("bf16").encode(x)
    assert np.array_equal(_bits(wire), _bits(rwire))
    back = _port_decode("bf16", wire, (), np.float32)
    assert np.array_equal(np.isnan(back), np.isnan(x))


# ---------------------------------------------------------------------------
# fused_decode_sum: the plain version against the reference kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_fused_decode_sum_matches_reference_kernel(dtype):
    info = np.iinfo(dtype)
    q = np.random.RandomState(8).randint(info.min, info.max + 1,
                                         size=(16, 8, 128)).astype(dtype)
    want = ref_decode_sum(jnp.asarray(q), 0.031, -2.25, interpret=True)
    assert want is not None
    got = K.fused_decode_sum(torch.from_numpy(q), 0.031, -2.25)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-4)


def test_fused_decode_sum_north_star_records():
    # the north-star record (200, 64, 64) on two records: the reference's
    # kernel declines its 64-wide minor axis and the reference decodes with
    # XLA there; the port's kernel has no such gate
    x = np.random.RandomState(9).randn(2, 200, 64, 64).astype(np.float32)
    q, (scale, zp) = R.get("int8").encode(x)
    assert ref_decode_sum(jnp.asarray(q), scale, zp, interpret=True) is None
    want = np.asarray(jnp.sum(R.get("int8").decode(
        jnp.asarray(q), (jnp.float32(scale), jnp.float32(zp)),
        np.float32), axis=0))
    got = K.fused_decode_sum(torch.from_numpy(q), torch.tensor(scale),
                             torch.tensor(zp))
    assert tuple(got.shape) == (200, 64, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def test_fused_decode_sum_none_contract_and_devices():
    assert K.fused_decode_sum(torch.zeros((16, 128)), 1.0, 0.0) is None
    assert K.fused_decode_sum(torch.zeros(128, dtype=torch.uint8),
                              1.0, 0.0) is None
    # no geometry gate: an unaligned minor axis is served
    out = K.fused_decode_sum(torch.ones((16, 100), dtype=torch.uint8),
                             2.0, 0.5)
    assert torch.equal(out, torch.full((100,), 40.0))
    before = dict(K.LAUNCHES)
    K.fused_decode_sum(torch.ones((4, 8), dtype=torch.uint8), 1.0, 0.0)
    assert K.LAUNCHES == before         # the CPU runs no kernel
    with pytest.raises(ValueError):
        K.fused_decode_sum(torch.empty((4, 8), dtype=torch.uint8,
                                       device="meta"), 1.0, 0.0)


@pytest.mark.parametrize("n,columns,vec,plan", [
    # the streamed slab: 51200 groups of 16 columns over 264 blocks (two
    # an SM) of 194 groups, 224 threads; every row loaded ahead
    (20, 819200, 16, K.DecodePlan("rows", 264, 224, 194, 1, 20, 1)),
    (1, 819200, 16, K.DecodePlan("rows", 264, 224, 194, 1, 1, 1)),
    # the whole wire: one lane, and five chunks of 640 rows, the 1000
    # blocks that 132 SMs of 2048 threads hold in one wave
    (3200, 819200, 16, K.DecodePlan("lanes", 0, 256, 0, 1, 640, 5)),
    # 25 rows: one more than the short form loads ahead
    (25, 819200, 16, K.DecodePlan("lanes", 0, 256, 0, 1, 25, 1)),
    # (300, 4096) int8: 256 column threads, 18 chunks of 17 rows
    (300, 4096, 16, K.DecodePlan("lanes", 0, 256, 0, 1, 17, 18)),
    # narrow: 64 column threads, four lanes, one chunk
    (16, 1024, 16, K.DecodePlan("lanes", 0, 256, 0, 4, 16, 1)),
    # too few groups for a warp an SM, and loads narrower than 16 bytes
    (20, 65536, 16, K.DecodePlan("lanes", 0, 256, 0, 1, 20, 1)),
    (20, 819208, 8, K.DecodePlan("lanes", 0, 256, 0, 1, 20, 1)),
])
def test_decode_sum_plan(n, columns, vec, plan):
    got = K.decode_sum_plan(n, columns, vec, 132)
    assert got == plan
    if got.kind == "rows":
        groups = columns // 16
        assert got.blocks % 132 == 0 and got.threads % 32 == 0
        assert got.span <= got.threads <= 256
        assert (got.blocks - 1) * got.span < groups <= got.blocks * got.span


@pytest.mark.parametrize("columns,vec", [(1024, 16), (819200, 16),
                                         (1000, 8), (1004, 4), (1001, 1)])
def test_byte_vec_follows_alignment_and_width(columns, vec):
    q = torch.zeros((2, columns + 16), dtype=torch.uint8)
    assert q.data_ptr() % 16 == 0       # torch aligns its allocations
    assert K._byte_vec(q, columns) == vec
    assert K._byte_vec(q.reshape(-1)[1:], columns) == 1


def _figures(msg):
    """The byte figures of a diagnostic's message, in order."""
    return re.findall(r"(\d+(?:\.\d+)?) (GB|MB|MiB|B)\b", msg)


# ---------------------------------------------------------------------
# analysis: BLT016
# ---------------------------------------------------------------------

_SHAPE16 = (32, 6, 4)


def _pos16():
    rs = np.random.RandomState(7)
    return (np.abs(rs.randn(*_SHAPE16)) + 0.5).astype(np.float32)


def _mine16(x, codec=None):
    import bolt_tpu_torch as bolt
    return bolt.fromcallback(lambda idx: x[idx], x.shape,
                             torch.device("cpu"), dtype=x.dtype, chunks=8,
                             codec=codec)


def _theirs16(x, mesh, codec=None):
    import bolt_tpu as ref
    return ref.fromcallback(lambda idx: x[idx], x.shape, mesh,
                            dtype=x.dtype, chunks=8, codec=codec)


def _blt016(rep):
    return next(d for d in rep.diagnostics if d.code == "BLT016")


@pytest.mark.parametrize("codec", ["bf16", "delta-f32", "int8"])
def test_blt016_forecasts_bytes_saved_as_the_reference(mesh, codec):
    from bolt_tpu import analysis as ref_analysis
    from bolt_tpu_torch import analysis, engine
    x = _pos16()
    arr = _mine16(x, codec).map(lambda v: v + 1)
    c0 = engine.counters()
    rep = analysis.check(arr)
    c1 = engine.counters()
    assert c1["misses"] == c0["misses"]
    assert c1["aot_compiles"] == c0["aot_compiles"]
    d = _blt016(rep)
    w = _blt016(ref_analysis.check(_theirs16(x, mesh, codec).map(
        lambda v: v + 1)))
    assert d.severity == w.severity == "info" and codec in d.message
    assert _figures(d.message) == _figures(w.message)
    ratio = re.search(r"\(([\d.]+)x\)", d.message).group(1)
    assert ratio == re.search(r"\(([\d.]+)x\)", w.message).group(1)
    if codec == "delta-f32":
        assert "bit-identical" in d.message


def test_blt016_warns_lossy_meets_order_member():
    from bolt_tpu_torch import analysis, stream
    x = np.random.RandomState(10).randn(*_SHAPE16).astype(np.float32)
    src = _mine16(x)
    s, h = src.sum(), src.min()         # one pending group, two members
    with stream.codec("bf16"):
        rep = analysis.check(h)
    d = _blt016(rep)
    assert d.severity == "warning" and "min" in d.message
    h.toarray()                             # scope gone: resolves raw


def test_blt016_info_for_lossless_order_member():
    from bolt_tpu_torch import analysis
    x = np.random.RandomState(11).randn(*_SHAPE16).astype(np.float32)
    src = _mine16(x, "delta-f32")
    s, h = src.sum(), src.min()         # lossless: allowed
    assert _blt016(analysis.check(h)).severity == "info"
    h.toarray()


def test_blt016_warns_unsupported_dtype_and_quiet_without_codec():
    from bolt_tpu_torch import analysis, stream
    x = (np.arange(np.prod(_SHAPE16)) % 7).astype(np.int32).reshape(
        _SHAPE16)
    with stream.codec("bf16"):
        rep = analysis.check(_mine16(x))
    d = _blt016(rep)
    assert d.severity == "warning" and "refuse" in d.message
    assert not analysis.check(_mine16(_pos16())).has("BLT016")
