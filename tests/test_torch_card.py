"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is ``gpu``-marked and skips without a CUDA device.

This file imports torch and the port only (no jax, no reference package),
so it runs on a machine with a card and without jax; the repo's
``tests/conftest.py`` imports jax, so skip it there::

    python -m pytest --noconftest -m gpu tests/test_torch_card.py -q

Tolerances: the window kernels equal their plain versions bit for bit in
f32 and f64 (the same products and sums in the same order) and within
``1.6e-2`` in f16/bf16 (both accumulate in f32 and round once); the moment
kernels sum in another order (f64 ``1e-10``, f32 ``1e-4``, f16/bf16
``1.6e-2``), and so do ``fused_decode_sum`` (f32 ``rtol=1e-5,
atol=1e-3``) and ``fused_map_reduce`` (as the moment kernels; its mapped
values equal the plain version's bit for bit for ``+ - * /`` and
``sqrt``, which a one-row column sum shows).
"""

import numpy as np
import pytest
import torch

from bolt_tpu_torch.ops import kernels as K

_MODES = ["constant", "edge", "reflect", "symmetric"]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((64, 256), torch.float32), ((3, 5, 7), torch.float32),
    ((1000, 333), torch.float32), ((257, 64, 64), torch.float64),
    ((128, 4096), torch.bfloat16), ((200, 1000), torch.float16),
    # narrow columns: row lanes in each block and many row chunks
    ((50000, 64), torch.float32), ((100000, 3), torch.float64),
    ((4097, 2), torch.float32), ((70000, 24), torch.float16)])
def test_kernels_match_plain_on_card(shape, dtype):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    x.reshape(shape[0], -1)[:, 1] = float("nan")
    tol = {torch.float64: 1e-10, torch.float32: 1e-4}.get(dtype, 1.6e-2)
    before = dict(K.LAUNCHES)
    for got, want in ((K.fused_welford(x), K._fused_welford_plain(x)),
                      (K.fused_stats(x), K._fused_stats_plain(x))):
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_.double(), w_.double(), rtol=tol,
                                       atol=tol, equal_nan=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_welford"] == before["fused_welford"] + 1
    assert K.LAUNCHES["fused_stats"] == before["fused_stats"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ax,w,dtype", [
    ((8, 300, 520), 1, 17, torch.float32),     # strided, ragged tiles
    ((8, 300, 520), 2, 17, torch.float32),     # last axis
    ((5, 70, 33), 0, 9, torch.float64),
    ((3, 2100), 1, 255, torch.float64),        # wide last-axis window
    ((4, 3, 7), 1, 41, torch.float32),         # radius past the axis
    ((2, 6000, 3), 1, 801, torch.float32),     # past the staged tile
    ((64, 256), 1, 13, torch.bfloat16),
    ((64, 256), 0, 13, torch.float16)])
def test_window_kernels_match_plain_on_card(shape, ax, w, dtype):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    taps = (torch.rand(w, generator=torch.Generator().manual_seed(w))
            - 0.3).tolist()
    name = "lane_band" if ax == len(shape) - 1 else "sepfilter1d"
    for mode in _MODES:
        before = K.LAUNCHES[name]
        got = K.sepfilter1d(x, taps, ax, mode=mode)
        want = K._sepfilter1d_plain(x, taps, ax, mode)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before + 1
        if dtype in (torch.float32, torch.float64):
            assert torch.equal(got, want), mode      # bit for bit
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=1.6e-2, atol=1.6e-2)
    if ax == len(shape) - 1:
        assert torch.equal(K.lane_band(x, taps),
                           K._lane_band_plain(x, taps))


@pytest.mark.gpu
def test_kernels_take_non_contiguous_on_card():
    dev = _cuda()
    x = torch.randn((64, 96), device=dev).t()     # a transposed view
    for got, want in ((K.fused_welford(x), K._fused_welford_plain(x)),
                      (K.fused_stats(x), K._fused_stats_plain(x))):
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)
    taps = [0.25, 0.5, 0.25]
    assert torch.equal(K.sepfilter1d(x, taps, 0, mode="reflect"),
                       K._sepfilter1d_plain(x, taps, 0, "reflect"))
    assert torch.equal(K.lane_band(x, taps), K._lane_band_plain(x, taps))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_window_kernels_take_misaligned_data_on_card(dtype):
    # a tensor that starts one element past a 16-byte boundary stages with
    # element loads; an aligned one with 16-byte loads: both bit for bit
    dev = _cuda()
    base = torch.randn(1 + 6 * 40 * 128, device=dev).to(dtype)
    taps = [0.1, -0.2, 0.4, 0.3, 0.05]
    for x in (base[1:].view(6, 40, 128), base[:-1].view(6, 40, 128)):
        assert x.is_contiguous()
        for ax in (1, 2):
            for mode in _MODES:
                got = K.sepfilter1d(x, taps, ax, mode=mode)
                want = K._sepfilter1d_plain(x, taps, ax, mode)
                if dtype == torch.bfloat16:
                    torch.testing.assert_close(got.float(), want.float(),
                                               rtol=1.6e-2, atol=1.6e-2)
                else:
                    assert torch.equal(got, want), (ax, mode)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((20, 819200), torch.uint8),       # the north-star slab
    ((16, 1024), torch.uint8),         # narrow: row lanes in one block
    ((1, 4096), torch.uint8),          # one row
    ((37, 1001), torch.uint8),         # C not a multiple of 16 (1-byte loads)
    ((33, 1000), torch.int8),          # 8-byte loads, signed
    ((50, 5, 3, 4), torch.int8),       # 4-byte loads, rank 4
    ((5000, 64), torch.uint8),         # many rows: row chunks + combine
    ((3200, 1024), torch.int8)])
def test_fused_decode_sum_matches_plain_on_card(shape, dtype):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(13)
    lo = -128 if dtype == torch.int8 else 0
    q = torch.randint(lo, lo + 256, shape, generator=g, device=dev,
                      dtype=torch.int32).to(dtype)
    scale = torch.tensor(0.0173, device=dev)
    zp = torch.tensor(-1.25, device=dev)
    before = K.LAUNCHES["fused_decode_sum"]
    got = K.fused_decode_sum(q, scale, zp)
    want = K._fused_decode_sum_plain(q, scale, zp)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_decode_sum"] == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape[1:]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
def test_fused_decode_sum_takes_misaligned_data_on_card():
    # a view one byte past a 16-byte boundary loads one byte at a time; a
    # transposed view is copied to a contiguous tensor first
    dev = _cuda()
    base = torch.randint(0, 256, (1 + 24 * 2048,), device=dev,
                         dtype=torch.int32).to(torch.uint8)
    for q in (base[1:].view(24, 2048), base[:-1].view(24, 2048),
              base[:-1].view(2048, 24).t()):
        got = K.fused_decode_sum(q, 0.5, 3.0)
        want = K._fused_decode_sum_plain(q, 0.5, 3.0)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("codec", [None, "delta-f32", "bf16", "int8"])
def test_stream_on_card(codec, monkeypatch):
    # the card's half of the executor: pinned ring, copy streams and events
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import stream
    dev = _cuda()
    x = np.random.RandomState(3).rand(64, 16, 136).astype(np.float32)
    monkeypatch.setenv("BOLT_CODEC_KERNEL", "1")
    K.reset_launches()
    with stream.uploaders(4):
        src = bolt.fromcallback(lambda idx: x[idx], x.shape, dev,
                                dtype=np.float32, chunks=8, codec=codec)
        got = src.sum().toarray()
        mean = bolt.fromcallback(lambda idx: x[idx], x.shape, dev,
                                 dtype=np.float32, chunks=8,
                                 codec=codec).map(lambda v: v * 2).mean()
    want = x.astype(np.float64).sum(axis=0)
    if codec == "int8":
        assert K.LAUNCHES["fused_decode_sum"] == 8      # once a slab
        step = (x.max() - x.min()) / 255.0
        assert np.abs(got - want).max() <= step / 2 * 64 + 1e-3
    else:
        assert K.LAUNCHES["fused_decode_sum"] == 0
        rtol = 1e-2 if codec == "bf16" else 1e-5
        np.testing.assert_allclose(got, want, rtol=rtol)
        np.testing.assert_allclose(mean.toarray(), 2 * x.mean(axis=0),
                                   rtol=rtol)


def _mr_programs():
    from bolt_tpu_torch.ops import mapexpr as M
    return M, {
        "identity": lambda v: v,
        "v+1": lambda v: v + 1,
        "v*2+1": lambda v: v * 2 + 1,
        "where": lambda v: torch.where(v > 0.1, v, 0.0) + torch.clamp(
            v, -0.5, 0.5),
        "live": lambda v: (lambda c: torch.where(c, v, 1.0) + torch.where(
            c, 2.0, v))(v > 0) * (v + 1),
        "trans": lambda v: torch.exp(-v * v) * 0.5 + torch.sigmoid(v)
        + torch.sin(v) + torch.abs(v) ** 1.7}


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((257, 4096), torch.float32), ((3, 5, 7), torch.float32),
    ((1000, 333), torch.float32), ((257, 64, 64), torch.float64),
    ((128, 4096), torch.bfloat16), ((200, 1000), torch.float16),
    # narrow columns: row lanes in each block and many row chunks
    ((50000, 64), torch.float32), ((4097, 2), torch.float64)])
def test_fused_map_reduce_matches_plain_on_card(shape, dtype):
    # both forms against the plain version (evaluate, then a torch sum):
    # the sums run in another order (f64 1e-10, f32 1e-4, f16/bf16 1.6e-2)
    M, programs = _mr_programs()
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    x2 = x.reshape(shape[0], -1)
    tol = {torch.float64: 1e-10, torch.float32: 1e-4}.get(dtype, 1.6e-2)
    for name, f in programs.items():
        cols = M.compile((f,), tuple(x2.shape[1:]), dtype)
        full = M.compile((f,), tuple(x.shape), dtype)
        before = K.LAUNCHES["fused_map_reduce"]
        got = K.fused_map_reduce_cols(x2, cols)
        want = K._fused_map_reduce_plain(x2, cols, cols=True)
        gf = K.fused_map_reduce_program(x, full)
        wf = K._fused_map_reduce_plain(x, full)
        torch.cuda.synchronize()
        assert K.LAUNCHES["fused_map_reduce"] == before + 2
        assert got.dtype == dtype and gf.dtype == dtype and gf.shape == ()
        torch.testing.assert_close(got.double(), want.double(), rtol=tol,
                                   atol=tol)
        # an f16 sum of 200000 values overflows to inf in both
        mag = float(M.evaluate(full, x).abs().sum(dtype=torch.float64))
        assert float(gf) == float(wf) or \
            abs(float(gf) - float(wf)) <= tol * (1 + mag), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_fused_map_reduce_elementwise_values_exact_on_card(dtype):
    # one row: the column sums are the mapped values themselves, and + - * /
    # (by a number: times its reciprocal, as torch) and sqrt round alike
    from bolt_tpu_torch.ops import mapexpr as M
    dev = _cuda()
    x = torch.randn((1, 4099), generator=torch.Generator(
        device=dev).manual_seed(18), device=dev).to(dtype)
    for f in (lambda v: v + 1, lambda v: v * 2 + 1, lambda v: 0.3 - v / 3,
              lambda v: (v * 1.1 + 0.2) * (v - 0.3) / (torch.abs(v) + 1),
              lambda v: torch.sqrt(torch.abs(v)) - v * v):
        program = M.compile((f,), (4099,), dtype)
        got = K.fused_map_reduce_cols(x, program)
        assert torch.equal(got, K._fused_map_reduce_plain(x, program,
                                                          cols=True))


@pytest.mark.gpu
def test_fused_map_reduce_masks_and_misaligned_views_on_card():
    from bolt_tpu_torch.ops import mapexpr as M
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(19)
    x = torch.randn((64, 4096), generator=g, device=dev)
    x[5] = float("nan")
    keep = torch.ones(64, dtype=torch.bool, device=dev)
    keep[5] = keep[9] = False
    program = M.compile((lambda v: v + 1,), (4096,), torch.float32)
    got = K.fused_map_reduce_cols(x, program, keep)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, K._fused_map_reduce_plain(
        x, program, keep, cols=True), rtol=1e-5, atol=1e-4)
    base = torch.randn(1 + 37 * 1001, generator=g, device=dev)
    for view in (base[1:].view(37, 1001), base[:-1].view(1001, 37).t()):
        program = M.compile((lambda v: v * 2 + 1,), (view.shape[1],),
                            torch.float32)
        torch.testing.assert_close(
            K.fused_map_reduce_cols(view, program),
            K._fused_map_reduce_plain(view, program, cols=True),
            rtol=1e-5, atol=1e-4)
        full = M.compile((lambda v: v * 2 + 1,), tuple(view.shape),
                         torch.float32)
        torch.testing.assert_close(
            K.fused_map_reduce_program(view, full),
            K._fused_map_reduce_plain(view, full), rtol=1e-5, atol=1e-2)


@pytest.mark.gpu
def test_map_sum_and_filter_sum_launch_on_card():
    import bolt_tpu_torch as bolt
    dev = _cuda()
    b = bolt.randn((64, 8, 16), dev, dtype=np.float32, seed=3)
    x = b.toarray().astype(np.float64)
    K.reset_launches()
    s = b.map(lambda v: v * 2 + 1).sum().toarray()
    assert K.LAUNCHES["fused_map_reduce"] == 1
    np.testing.assert_allclose(s, (x * 2 + 1).sum(0), rtol=1e-5, atol=1e-4)
    f = b.map(lambda v: v + 1).filter(lambda v: v.mean() > 1)
    keep = x[(x + 1).reshape(64, -1).mean(1) > 1]
    np.testing.assert_allclose(f.sum().toarray(), (keep + 1).sum(0),
                               rtol=1e-5, atol=1e-4)
    assert K.LAUNCHES["fused_map_reduce"] == 2
    np.testing.assert_allclose(
        b.map(lambda v: v + 1).filter(lambda v: v.mean() > 1).mean()
        .toarray(), (keep + 1).mean(0), rtol=1e-5, atol=1e-5)
    assert K.LAUNCHES["fused_map_reduce"] == 3


@pytest.mark.gpu
def test_fused_map_reduce_launch_failure_raises(monkeypatch):
    # a failing launch raises; no plain-version result takes its place
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch.ops import mapexpr as M
    dev = _cuda()

    class Failing:
        def __getattr__(self, name):
            return lambda *a: 98          # cudaErrorInvalidDeviceFunction

    monkeypatch.setattr(K, "_mapreduce_lib", lambda: Failing())
    x = torch.ones((8, 16), device=dev)
    program = M.compile((lambda v: v + 1,), (16,), torch.float32)
    for call in (lambda: K.fused_map_reduce_cols(x, program),
                 lambda: K.fused_map_reduce(x, lambda v: v + 1),
                 lambda: bolt.ones((8, 16), dev).map(lambda v: v + 1).sum(),
                 lambda: bolt.ones((8, 16), dev).filter(
                     lambda v: v.sum() > 0).sum()):
        with pytest.raises(RuntimeError, match="fused_map_reduce launch "
                                               "failed: CUDA error 98"):
            call()


# ---------------------------------------------------------------------------
# the redesigned kernels' tiles, register files, grids and conversion
# ---------------------------------------------------------------------------

def _product8(v):
    # eight registers live at once: the register file holds all eight
    t = [v + i * 0.25 for i in range(1, 8)]
    out = t[0]
    for u in t[1:]:
        out = out * u
    return out + v


def _reuse3(v):
    a = v + 1
    b = v * 2
    return (a * b + v) * a - b


# programs whose register files hold 0, 1, 3 and 8 registers (the tile
# halves above seven), and one that calls the math library
_FILE_PROGRAMS = {
    0: lambda v: v * 2 + 1,
    1: lambda v: v * (v + 1),
    3: _reuse3,
    8: _product8,
    "calls": lambda v: torch.sin(v) * torch.cos(v) + torch.abs(v) ** 1.5
    + v}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16])
@pytest.mark.parametrize("nfile", sorted(_FILE_PROGRAMS, key=str))
def test_fused_map_reduce_tiles_and_register_files_on_card(dtype, nfile):
    # every file size and tile width, on row counts that are not a multiple
    # of the tile's rows (and so leave part of the last tile empty), in
    # both forms, against the plain version
    from bolt_tpu_torch.ops import mapexpr as M
    dev = _cuda()
    f = _FILE_PROGRAMS[nfile]
    g = torch.Generator(device=dev).manual_seed(21)
    tol = {torch.float64: 1e-10, torch.float32: 1e-4}.get(dtype, 1.6e-2)
    for shape in ((1027, 4096), (3, 8192), (4099, 64), (1, 16)):
        x = (torch.rand(shape, generator=g, device=dev) + 0.1).to(dtype)
        cols = M.compile((f,), shape[1:], dtype)
        if nfile != "calls":
            assert K._program_struct(cols).nfile == nfile
        got = K.fused_map_reduce_cols(x, cols)
        want = K._fused_map_reduce_plain(x, cols, cols=True)
        torch.testing.assert_close(got.double(), want.double(), rtol=tol,
                                   atol=tol)
        full = M.compile((f,), shape, dtype)
        gf, wf = K.fused_map_reduce_program(x, full), \
            K._fused_map_reduce_plain(x, full)
        mag = float(M.evaluate(full, x).abs().sum(dtype=torch.float64))
        assert float(gf) == float(wf) or \
            abs(float(gf) - float(wf)) <= tol * (1 + mag), (shape, nfile)


@pytest.mark.gpu
def test_fused_map_reduce_mask_inside_one_tile_on_card():
    # rows 4..7 would form one tile of the lane: drop two of them, one
    # full of NaN, and the last, ragged row too (a tile then takes the next
    # kept rows); every kernel variant
    from bolt_tpu_torch.ops import mapexpr as M
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn((11, 8192), generator=g, device=dev)
    x[5] = float("nan")
    keep = torch.ones(11, dtype=torch.bool, device=dev)
    keep[5] = keep[6] = keep[10] = False
    alternate = torch.arange(11, device=dev) % 2 == 0
    alternate[10] = False
    none = torch.zeros(11, dtype=torch.bool, device=dev)
    for f in _FILE_PROGRAMS.values():
        program = M.compile((f,), (8192,), torch.float32)
        for mask in (keep, alternate, none):
            got = K.fused_map_reduce_cols(x, program, mask)
            assert bool(torch.isfinite(got).all())
            torch.testing.assert_close(got, K._fused_map_reduce_plain(
                x, program, mask, cols=True), rtol=1e-5, atol=1e-4)
        assert not bool(K.fused_map_reduce_cols(x, program, none).any())


@pytest.mark.gpu
def test_fused_map_reduce_calls_variant_loads_packs_on_card():
    # a program that calls the math library runs on 16-byte packs like the
    # others (and on single elements through a misaligned view)
    from bolt_tpu_torch.ops import mapexpr as M
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(23)
    base = torch.randn(1 + 300 * 4096, generator=g, device=dev)
    f = _FILE_PROGRAMS["calls"]
    for x in (base[:-1].view(300, 4096), base[1:].view(300, 4096),
              base[1:1 + 37 * 1001].view(37, 1001)):
        program = M.compile((f,), tuple(x.shape[1:]), torch.float32)
        assert K._calls(program)
        assert K._vec(x, x.shape[1]) == (4 if x.data_ptr() % 16 == 0
                                         else 1)
        torch.testing.assert_close(
            K.fused_map_reduce_cols(x, program),
            K._fused_map_reduce_plain(x, program, cols=True), rtol=1e-4,
            atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_fused_decode_sum_conversion_exact_on_all_bytes_on_card(dtype):
    # one row: each sum is one decoded value, so the byte permute's
    # conversion and the decode equal the plain version bit for bit on
    # every byte value, through both plans (the short-slab form at
    # 819200 columns, row lanes at 4096)
    dev = _cuda()
    lo = -128 if dtype == torch.int8 else 0
    every = torch.arange(lo, lo + 256, device=dev, dtype=torch.int32).to(
        dtype)
    for cols in (819200, 4096):
        q = every.repeat(cols // 256).view(1, cols)
        # ordinary scales, then zero, negative and very large ones
        for scale, zp in ((1.0, 0.0), (0.0431, -5.37), (3.7e-3, 0.125),
                          (0.0, 1.5), (-0.25, 3.0), (3e31, -1.0)):
            s = torch.tensor(scale, device=dev)
            z = torch.tensor(zp, device=dev)
            assert torch.equal(K.fused_decode_sum(q, s, z),
                               K._fused_decode_sum_plain(q, s, z))


@pytest.mark.gpu
def test_fused_decode_sum_plans_on_card():
    # the slab and one row take the short-slab form, the rest row lanes:
    # the whole wire, (300, 4096) int8, 1001 columns, a misaligned view
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(24)
    wire = torch.randint(0, 256, (3200, 819200), generator=g, device=dev,
                         dtype=torch.uint8)
    signed = torch.randint(-128, 128, (300, 4096), generator=g, device=dev,
                           dtype=torch.int8)
    flat = wire.view(-1)
    sm = K._sm_count(dev)
    cases = [(wire[:20], "rows"), (wire[:1], "rows"), (wire, "lanes"),
             (signed, "lanes"), (flat[:37 * 1001].view(37, 1001), "lanes"),
             (flat[1:1 + 20 * 81920].view(20, 81920), "lanes")]
    scale = torch.tensor(0.0173, device=dev)
    zp = torch.tensor(-1.25, device=dev)
    for q, kind in cases:
        n, cols = q.shape
        assert K.decode_sum_plan(n, cols, K._byte_vec(q, cols),
                                 sm).kind == kind
        before = K.LAUNCHES["fused_decode_sum"]
        got = K.fused_decode_sum(q, scale, zp)
        want = K._fused_decode_sum_plain(q, scale, zp)
        torch.cuda.synchronize()
        assert K.LAUNCHES["fused_decode_sum"] == before + 1
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
