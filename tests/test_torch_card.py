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

The engine's tests on the card: a donated materialisation written into
its base's own storage with a peak growth under two blocks, the clone and
view refusals, the program cache's hits with one ``fused_map_reduce``
launch a call, ``stacked`` with a ragged tail against the local oracle
(``rtol=1e-5, atol=1e-6`` in f32), ``profile.memory_stats()``'s keys,
``profile.debug_nans`` raising, and the persistent cache of the
``nvcc``-built libraries (a build counts a miss, a reload a hit).

The ops library on the card (no kernel of its own): ``jacobi_eigh`` at
n = 7, 16 and 64 in f32/f64 against numpy f64, ``svdvals`` at a batch that
takes the Jacobi route and under the chunk map's nested ``vmap`` with no
host fallback, ``segment_reduce``'s two forms against each other, and
``topk``'s ties and NaNs and ``unique``'s NaN collapse.

The streamed stages on the card: a filter, a chunked and a stacked map
and a five-member stat group over a small stream (integer-valued f32, so
sums are exact under any fold order: bit for bit against numpy; each
group member bit for bit against its standalone streamed terminal), a
resident and a spilled swap bit for bit against the materialised swap,
and an injected upload fault retried on the card's copy streams with the
same bits as the run with no fault.

Unsigned records and resume on the card: ``uint16``, ``uint32`` and
``uint64`` arrays through operators, stat terminals, ``reduce``,
``cumsum``, ``clip``, a group and a streamed ``sum``/``max``, values
and dtypes equal to numpy's, and callables that wrap and order on
them; an armed int8 stream killed by an injected
upload fault and resumed bit for bit, ``fused_decode_sum`` once for
each slab streamed after the resume.

Serving on the card: ``fused_map_reduce_lanes`` in both forms, 1, 2, 5
and 16 lanes, f32/f64/bf16/f16, at the serving shape ``(128, 32)`` and
at ``(257, 33)`` (a numel that is not a multiple of the pack, ragged
columns), each lane bit for bit against its standalone launch in one
lanes launch, and a misaligned view lane taking a launch of its own; 130
lanes in three launches (a launch's table holds 64); config 14's call one
launch of one kernel that allocates only its output; standalone small
shapes on each side of the plan's floor of packs a thread, in all four
dtypes, against the plain version; a batched serve of ``sum``, ``mean``, ``var``, ``std``, ``min``, ``max``,
``prod``, ``reduce(add)`` and chain materialisation, each lane bit for
bit against its standalone result; a child process started with
``Server(start_warm=dir)`` running no ``nvcc``.

The benchmark's four cells on the card, one pass each at its own size
under ``torch.cuda.set_sync_debug_mode("warn")``: every synchronising
call the pass makes is one ``host_syncs`` of the engine's counters
(``engine.host_sync``), and every counted sync is one such call.

The analysis layer on the card: ``analysis.check`` of a CUDA map chain, a
pending filter, a stat group and a stream allocates no device byte
(``torch.cuda.memory_allocated`` and ``max_memory_allocated`` flat) and
builds and launches nothing; ``strict()`` refuses a broken chain on the
card before any build and passes a clean ``map(v + 1).sum()`` bit for bit;
``hbm_check`` reads ``torch.cuda.mem_get_info`` as a known limit.
"""

import os

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
        mean = mean.toarray()           # read inside the uploaders scope
    want = x.astype(np.float64).sum(axis=0)
    if codec == "int8":
        assert K.LAUNCHES["fused_decode_sum"] == 8      # once a slab
        step = (x.max() - x.min()) / 255.0
        assert np.abs(got - want).max() <= step / 2 * 64 + 1e-3
    else:
        assert K.LAUNCHES["fused_decode_sum"] == 0
        rtol = 1e-2 if codec == "bf16" else 1e-5
        np.testing.assert_allclose(got, want, rtol=rtol)
        np.testing.assert_allclose(mean, 2 * x.mean(axis=0), rtol=rtol)


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
                 lambda: bolt.ones((8, 16), dev).map(lambda v: v + 1).sum()
                 .toarray(),
                 lambda: bolt.ones((8, 16), dev).filter(
                     lambda v: v.sum() > 0).sum().toarray()):
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


# ---------------------------------------------------------------------------
# the array surface and the fused stat groups on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_group_members_equal_standalone_terminals_on_card():
    import bolt_tpu_torch as bolt
    dev = _cuda()
    b = bolt.randn((256, 16, 64), dev, dtype=np.float32, seed=21)
    names = ("sum", "mean", "var", "std", "min", "max", "ptp")

    def chain():
        return np.exp(-(b ** 2)) * 0.5

    c = chain()
    group = bolt.compute(*(getattr(c, n)() for n in names))
    for name, got in zip(names, group):
        want = getattr(chain(), name)().totorch()
        assert torch.equal(got.totorch(), want), name
    out = b.stats("sum", "std", "ptp")
    for name in out:
        assert torch.equal(out[name].totorch(),
                           getattr(b, name)().totorch()), name


@pytest.mark.gpu
def test_blocked_chain_stats_on_card(monkeypatch):
    # a chain longer than one block folds its blocks' partials: members
    # equal their standalone terminals bit for bit, and the values equal
    # the whole chain's (min/max exactly, the moments within f32 rounding)
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch.gpu import array as garray
    dev = _cuda()
    b = bolt.randn((97, 16, 64), dev, dtype=np.float32, seed=26)
    names = ("mean", "var", "std", "min", "max", "ptp")

    def chain():
        return np.exp(-(b ** 2)) * 0.5

    whole = [getattr(chain(), n)().totorch() for n in names]
    monkeypatch.setattr(garray, "_BLOCK_BYTES", 7 * 16 * 64 * 4)
    group = bolt.compute(*(getattr(chain(), n)() for n in names))
    for name, got, want in zip(names, group, whole):
        got = got.totorch()
        assert torch.equal(got, getattr(chain(), name)().totorch()), name
        if name in ("min", "max", "ptp"):
            assert torch.equal(got, want), name
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
def test_ufunc_chain_sum_launches_fused_map_reduce_on_card():
    import bolt_tpu_torch as bolt
    dev = _cuda()
    b = bolt.randn((128, 8, 64), dev, dtype=np.float32, seed=22)
    x = b.toarray().astype(np.float64)
    K.reset_launches()
    s = (np.exp(-(b ** 2)) * 0.5).sum().toarray()
    assert K.LAUNCHES["fused_map_reduce"] == 1
    np.testing.assert_allclose(s, (np.exp(-(x ** 2)) * 0.5).sum(0),
                               rtol=1e-5, atol=1e-5)
    cnt = (b > 0).sum().toarray()
    assert np.array_equal(cnt, (x > 0).sum(0))
    assert bool((b == b).all().toarray().all())


@pytest.mark.gpu
def test_quantile_above_2_24_elements_on_card():
    import bolt_tpu_torch as bolt
    dev = _cuda()
    b = bolt.randn((64, 1 << 19), dev, dtype=np.float32, seed=23)
    assert b.size > 1 << 24
    x = b.toarray()
    np.testing.assert_allclose(b.median().toarray(), np.median(x, axis=0),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.quantile([0.1, 0.9]).toarray(),
                               np.quantile(x, [0.1, 0.9], axis=0),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_eq_array_protocol_and_hash_on_card():
    import bolt_tpu_torch as bolt
    dev = _cuda()
    b = bolt.randn((16, 5, 4), dev, dtype=np.float32, seed=24)
    x = b.toarray()
    eq = b == b
    assert eq.dtype == np.bool_ and eq.totorch().is_cuda
    assert bool(eq.toarray().all()) and not (b != b).toarray().any()
    assert np.array_equal((b == 1).toarray(), x == 1)
    assert (b == None) is False                       # noqa: E711
    with pytest.raises(TypeError):
        hash(b)
    a = np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, x)
    assert np.allclose(b, x)


@pytest.mark.gpu
def test_blocked_filter_mask_equals_whole_mask_on_card(monkeypatch):
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch.gpu import array as garray
    dev = _cuda()
    b = bolt.randn((97, 8, 32), dev, dtype=np.float32, seed=25)

    def f():
        return b.map(lambda v: v + 1).filter(lambda v: v.mean() > 1)

    whole_mask = garray._pred_mask(lambda v: v.mean() > 1,
                                   b.totorch() + 1)
    whole = (f().toarray(), f().sum().totorch(), f().var().totorch())
    monkeypatch.setattr(garray, "_BLOCK_BYTES", 5 * 8 * 32 * 4)
    fp = f()._fpending
    blocked = torch.cat([garray._pred_mask(fp[2], recs) for _, _, recs in
                         garray._filter_blocks(fp, torch.float32)])
    assert torch.equal(blocked, whole_mask)
    assert np.array_equal(f().toarray(), whole[0])
    assert torch.equal(f().sum().totorch(), whole[1])
    torch.testing.assert_close(f().var().totorch(), whole[2], rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the engine, donation, stacked and profile on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_inplace_donation_on_card(monkeypatch):
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import engine
    from bolt_tpu_torch.gpu import array as garray
    dev = _cuda()
    shape = (64, 256, 1024)                  # 64 MiB of f32
    block = 8 * 256 * 1024 * 4               # 8 records a block
    monkeypatch.setattr(garray, "_BLOCK_BYTES", block)
    # one op a record: a block's result is the only temporary
    with engine.donation(None):
        want = bolt.randn(shape, dev, dtype=np.float32, seed=31).map(
            lambda v: v + 1).cache().totorch().clone()
    torch.cuda.synchronize()
    with engine.donation(0):
        d = bolt.randn(shape, dev, dtype=np.float32, seed=31).map(
            lambda v: v + 1)
        ptr = d._chain[0].data_ptr()
        n0 = engine.counters()["donations"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        d.cache()
        torch.cuda.synchronize()
        growth = torch.cuda.max_memory_allocated(dev) - before
    assert engine.counters()["donations"] == n0 + 1
    assert d.totorch().data_ptr() == ptr
    assert growth < 2 * block, growth
    assert torch.equal(d.totorch(), want)


@pytest.mark.gpu
def test_clone_and_view_refuse_donation_on_card():
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import engine
    dev = _cuda()
    x = np.random.RandomState(32).randn(16, 64, 32).astype(np.float32)
    with engine.donation(0):
        n0 = engine.counters()["donations"]
        b = bolt.array(x, dev).map(lambda v: v + 1)
        c = b._clone()
        b.cache()
        v = bolt.array(x, dev).reshape(16, 2048).map(lambda r: r * 3)
        v.sum().toarray()
        v.cache()
        assert engine.counters()["donations"] == n0
        assert np.array_equal(c.toarray(), x + 1)
        assert np.array_equal(b.toarray(), x + 1)
        assert np.array_equal(v.toarray(), x.reshape(16, 2048) * 3)


@pytest.mark.gpu
def test_engine_hits_and_map_reduce_launches_on_card():
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import engine, profile
    dev = _cuda()
    b = bolt.randn((256, 64, 64), dev, dtype=np.float32, seed=33)
    f = lambda v: v * 0.5 + 1
    K.reset_launches()
    c0 = engine.counters()
    with profile.instrument() as stats:
        outs = [b.map(f).sum().toarray() for _ in range(3)]
    c1 = engine.counters()
    assert c1["misses"] - c0["misses"] == 1
    assert c1["hits"] - c0["hits"] == 2
    assert K.LAUNCHES["fused_map_reduce"] == 3
    assert stats["stat"] == {"calls": 3, "builds": 1,
                             "dispatch_s": stats["stat"]["dispatch_s"]}
    x = b.toarray().astype(np.float64)
    for o in outs:
        np.testing.assert_allclose(o, (x * 0.5 + 1).sum(0), rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.gpu
def test_stacked_ragged_tail_on_card():
    import bolt_tpu_torch as bolt
    dev = _cuda()
    x = np.random.RandomState(34).randn(103, 16, 8).astype(np.float32)
    f = lambda blk: blk - blk.mean(0, keepdim=True)
    out = bolt.array(x, dev).stacked(10).map(f).unstack()
    assert out.totorch().is_cuda and out.shape == x.shape
    local = bolt.array(x).stacked(10).map(
        lambda blk: blk - blk.mean(0, keepdims=True)).unstack().toarray()
    np.testing.assert_allclose(out.toarray(), local, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_memory_stats_keys_on_card():
    from bolt_tpu_torch import profile
    dev = _cuda()
    t = torch.empty(1 << 20, device=dev)
    s = profile.memory_stats()
    assert set(s) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert all(isinstance(v, int) for v in s.values())
    assert s["bytes_in_use"] >= t.numel() * 4
    assert s["peak_bytes_in_use"] >= s["bytes_in_use"]
    assert s["bytes_limit"] >= s["peak_bytes_in_use"]


@pytest.mark.gpu
def test_debug_nans_raises_on_card():
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import profile
    dev = _cuda()
    b = bolt.array(np.array([[1.0, -1.0], [4.0, 9.0]], np.float32), dev)
    profile.debug_nans(True)
    try:
        with pytest.raises(FloatingPointError):
            b.map(lambda v: torch.sqrt(v)).sum().toarray()
    finally:
        profile.debug_nans(False)


@pytest.mark.gpu
def test_persistent_cache_roundtrip_on_card(tmp_path):
    # the port's persistent artifacts are the nvcc-built libraries: a
    # build counts a miss; loading it again from the directory, with no
    # nvcc, counts a hit (and a warm hit under warm_start)
    from bolt_tpu_torch import engine
    from bolt_tpu_torch.ops import _build
    _cuda()
    d = str(tmp_path / "kernel-cache")
    try:
        assert engine.persistent_cache(d) == d
        m0 = engine.counters()["persistent_misses"]
        _build.build(["codec.cu"])
        assert engine.counters()["persistent_misses"] == m0 + 1
        assert any(f.endswith(".so") for f in os.listdir(d))
        c0 = engine.counters()
        assert engine.warm_start(d) == d
        c1 = engine.counters()
        assert c1["persistent_hits"] - c0["persistent_hits"] >= 1
        assert c1["persistent_warm_hits"] - c0["persistent_warm_hits"] >= 1
        assert c1["persistent_misses"] == c0["persistent_misses"]
    finally:
        engine.persistent_cache(enable=False)


# ---------------------------------------------------------------------
# the ops library on the card (ops/linalg.py, ops/group.py): no kernel of
# its own, torch ops on CUDA tensors; the oracles are numpy f64 on the
# host (eigenvalues to 1e-4 of the largest in f32, 1e-10 in f64)
# ---------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [7, 16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_jacobi_eigh_on_card(n, dtype):
    from bolt_tpu_torch.ops import jacobi_eigh
    dev = _cuda()
    rs = np.random.RandomState(n)
    x = rs.randn(6, 3 * n, n)
    g = np.einsum("bni,bnj->bij", x, x)
    w, v = jacobi_eigh(torch.from_numpy(g).to(dev, dtype), vectors=True)
    assert w.device.type == "cuda" and w.dtype == dtype
    want = np.linalg.eigvalsh(g)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert np.max(np.abs(w.double().cpu().numpy() - want) / scale) < tol
    vh = v.double().cpu().numpy()
    wh = w.double().cpu().numpy()
    assert np.max(np.abs(g @ vh - vh * wh[..., None, :]) / scale[..., None]) \
        < 10 * tol


@pytest.mark.gpu
def test_jacobi_route_at_batch_on_card():
    # a batch big enough for the Jacobi route: svdvals of (4096, 256, 16)
    # f32 blocks through the Gram against numpy f64 on a sample
    from bolt_tpu_torch.ops import linalg, svdvals
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((4096, 256, 16), generator=gen, device=dev)
    assert linalg._use_jacobi(torch.zeros((4096, 16, 16), device=dev))
    got = svdvals(x).cpu().numpy()
    xs = x[::512].double().cpu().numpy()
    want = np.stack([np.linalg.svd(m, compute_uv=False) for m in xs])
    assert np.allclose(got[::512], want, rtol=0, atol=1e-4 * want[:, :1])


@pytest.mark.gpu
def test_svdvals_nested_vmap_on_card():
    # config 5b's per-chunk form: svdvals under the chunk map's nested
    # vmaps takes the Jacobi route on the card, with no host fallback
    import warnings

    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import ops
    dev = _cuda()
    b = bolt.randn((4, 8192, 16), context=dev, dtype=np.float32, seed=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error", bolt.HostFallbackWarning)
        out = b.chunk(size=(256,), axis=(0,)).map(
            lambda blk: ops.svdvals(blk)[None, :]).unchunk()
    assert out.shape == (4, 32, 16)
    got = out.toarray()
    x = b.toarray().astype(np.float64)
    for k, i in ((0, 0), (3, 31), (2, 17)):
        want = np.linalg.svd(x[k, 256 * i:256 * (i + 1)], compute_uv=False)
        assert np.allclose(got[k, i], want, rtol=0, atol=1e-4 * want[0])


@pytest.mark.gpu
def test_segment_reduce_forms_agree_on_card():
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch.ops import segment_reduce
    dev = _cuda()
    b = bolt.randn((2048, 16, 8), context=dev, dtype=np.float32, seed=4)
    lab = torch.randint(0, 37, (2048,), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
    for op in ("sum", "mean"):
        s = segment_reduce(b, lab, num_segments=40, op=op,
                           method="scatter").totorch()
        m = segment_reduce(b, lab, num_segments=40, op=op,
                           method="matmul").totorch()
        assert s.device.type == "cuda"
        torch.testing.assert_close(m, s, rtol=1e-5, atol=1e-5)
    mx = segment_reduce(b, lab, num_segments=40, op="max").toarray()
    x, la = b.toarray(), lab.cpu().numpy()
    assert np.array_equal(mx[3], x[la == 3].max(axis=0))
    assert np.all(np.isneginf(mx[38]))                   # an empty group


@pytest.mark.gpu
def test_topk_ties_and_nan_on_card():
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch.ops import topk
    dev = _cuda()
    x = np.array([[1.0, 3.0, 3.0, np.nan, 2.0, 3.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    v, i = topk(bolt.array(x, dev), 3)
    assert np.array_equal(i.toarray(), [[3, 1, 2], [0, 1, 2]])
    assert np.array_equal(v.toarray(), [[np.nan, 3.0, 3.0], [0, 0, 0]],
                          equal_nan=True)
    u = np.array([[5, 0, 5, 7]], dtype=np.uint32)
    v, i = topk(bolt.array(u, dev), 2)
    assert np.array_equal(v.toarray(), [[7, 5]])
    assert np.array_equal(i.toarray(), [[3, 0]])


@pytest.mark.gpu
def test_unique_nan_collapse_on_card():
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch.ops import unique
    dev = _cuda()
    x = np.array([[1.0, np.nan, 2.0], [np.nan, 1.0, np.nan]])
    u, c = unique(bolt.array(x, dev), return_counts=True)
    assert u.shape == (3,) and np.isnan(u[-1]) and list(u[:2]) == [1.0, 2.0]
    assert list(c) == [2, 1, 3]


def _spd_stack(dev, n, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(n, d, d, generator=g, device=dev)
    return a @ a.mT + d * torch.eye(d, device=dev)


@pytest.mark.gpu
def test_linalg_numpy_surface_large_batch_on_card():
    # config 5b's Gram-stack size: cuSOLVER's batched symmetric solver
    # refuses 32768 matrices, so np.linalg.eigvalsh runs in slices; the
    # results match numpy f64 on a sample
    import bolt_tpu_torch as bolt
    dev = _cuda()
    a = _spd_stack(dev, 32768, 16, 11)
    b = bolt.array(a, dev)
    w = np.linalg.eigvalsh(b).totorch()
    inv = np.linalg.inv(b).totorch()
    assert w.shape == (32768, 16) and inv.shape == (32768, 16, 16)
    pick = torch.arange(0, 32768, 257, device=dev)
    a64 = a[pick].double().cpu().numpy()
    np.testing.assert_allclose(w[pick].double().cpu().numpy(),
                               np.linalg.eigvalsh(a64), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(inv[pick].double().cpu().numpy(),
                               np.linalg.inv(a64), rtol=1e-3, atol=1e-5)


@pytest.mark.gpu
def test_linalg_inv_of_a_singular_batch_neither_raises_nor_syncs():
    import bolt_tpu_torch as bolt
    dev = _cuda()
    s = torch.zeros(64, 4, 4, device=dev)
    s[:, 0, 0] = 1.0
    b = bolt.array(s, dev)
    np.linalg.inv(bolt.array(torch.eye(4, device=dev)[None], dev)).totorch()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = np.linalg.inv(b).totorch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not bool(torch.isfinite(out).all())


@pytest.mark.gpu
def test_einsum_precision_modes_on_card():
    import bolt_tpu_torch as bolt
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(64, 32, 256, generator=g, device=dev)
    w = np.random.RandomState(4).randn(256, 128).astype(np.float32)
    b = bolt.array(x, dev)
    want = torch.einsum("ijk,kl->ijl", x.double(),
                        torch.from_numpy(w).double().to(dev))
    hi = np.einsum("ijk,kl->ijl", b, w).totorch()
    with bolt.precision("default"):
        lo = np.einsum("ijk,kl->ijl", b, w).totorch()
    scale = float(want.abs().max())
    err_hi = float((hi.double() - want).abs().max()) / scale
    err_lo = float((lo.double() - want).abs().max()) / scale
    # full f32 at "highest": within f32 rounding of a 256-term sum
    assert err_hi <= 1e-5, err_hi
    # TF32 (10-bit mantissa) under "default": not held to f32, only to
    # its own format
    assert err_lo <= 1e-2, err_lo


@pytest.mark.gpu
def test_fft_dtypes_on_card():
    import bolt_tpu_torch as bolt
    dev = _cuda()
    xi = (np.arange(4 * 64) % 9).astype(np.int32).reshape(4, 64)
    gi = np.fft.rfft(bolt.array(xi, dev))
    gf = np.fft.rfft(bolt.array(xi.astype(np.float32), dev))
    assert gi.dtype == np.complex64 and gf.dtype == np.complex64
    np.testing.assert_allclose(gi.toarray(), np.fft.rfft(xi), rtol=1e-5,
                               atol=1e-4)
    g64 = np.fft.rfft(bolt.array(xi.astype(np.float64), dev))
    assert g64.dtype == np.complex128


def _int_stream_data(shape=(64, 16, 36), seed=11):
    """Integer-valued f32: sums are exact in any order."""
    return np.random.RandomState(seed).randint(-8, 9, size=shape).astype(
        np.float32)


@pytest.mark.gpu
def test_streamed_stages_on_card():
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import engine, stream
    dev = _cuda()
    x = _int_stream_data()

    def src():
        return bolt.fromcallback(lambda idx: x[idx], x.shape, dev,
                                 dtype=np.float32, chunks=8)

    with stream.uploaders(4):
        f = src().map(lambda v: v + 1).filter(lambda v: v.mean() > 1)
        assert f.streaming
        keep = (x + 1)[(x + 1).reshape(64, -1).mean(1) > 1]
        assert np.array_equal(f.sum().toarray(), keep.sum(0))
        np.testing.assert_allclose(
            src().map(lambda v: v + 1).filter(lambda v: v.mean() > 1)
            .mean().toarray(), keep.mean(0), rtol=1e-6, atol=1e-6)
        ch = src().chunk((4, 12)).map(lambda c: c * 2)
        assert ch.unchunk().streaming
        assert np.array_equal(ch.sum().toarray(), 2 * x.sum(0))
        st = src().stacked(8).map(lambda blk: blk - blk.min(0)[0]).unstack()
        assert st.streaming
        blocks = x.reshape(8, 8, 16, 36)
        assert np.array_equal(st.sum().toarray(),
                              (blocks - blocks.min(1, keepdims=True))
                              .reshape(x.shape).sum(0))
        s = src()
        c0 = engine.counters()["stream_chunks"]
        names = ("sum", "mean", "var", "min", "max")
        group = bolt.compute(*[getattr(s, n)() for n in names])
        group = [g.toarray() for g in group]
        assert engine.counters()["stream_chunks"] - c0 == 8   # one pass
        for name, got in zip(names, group):
            alone = getattr(src(), name)().toarray()
            assert np.array_equal(got, alone), name
        assert np.array_equal(group[0], x.sum(0))


@pytest.mark.gpu
def test_streamed_swap_resident_and_spilled_on_card(tmp_path):
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import checkpoint, engine, stream
    dev = _cuda()
    x = _int_stream_data((40, 12, 20))
    want = bolt.array(x, context=dev).swap((0,), (0,)).toarray()
    assert np.array_equal(want, np.transpose(x, (1, 0, 2)))

    def src():
        return bolt.fromcallback(lambda idx: x[idx], x.shape, dev,
                                 dtype=np.float32, chunks=8)

    with stream.uploaders(2):
        res = src().swap((0,), (0,))
        assert res.streaming
        assert np.array_equal(res.toarray(), want)
        c0 = engine.counters()
        with stream.spill(dir=str(tmp_path), budget=1):
            sp = src().swap((0,), (0,))
            total = sp.sum().toarray()
            assert sp.streaming             # phase 2 streams the buckets
            assert np.array_equal(sp.toarray(), want)
        assert engine.counters()["spill_bytes"] > c0["spill_bytes"]
        assert np.array_equal(total, want.sum(0))
    checkpoint.spill_clear(str(tmp_path))
    assert not checkpoint.spill_pending(str(tmp_path))


@pytest.mark.gpu
def test_upload_fault_retried_on_card():
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import _chaos, engine, stream
    dev = _cuda()
    x = np.random.RandomState(12).rand(64, 16, 36).astype(np.float32)

    def run():
        with stream.uploaders(4):
            return bolt.fromcallback(lambda idx: x[idx], x.shape, dev,
                                     dtype=np.float32, chunks=8).sum() \
                .toarray()

    clean = run()
    _chaos.inject("stream.upload", nth=3)
    try:
        c0 = engine.counters()["stream_retries"]
        with stream.retries(1):
            got = run()
    finally:
        _chaos.clear()
    assert engine.counters()["stream_retries"] - c0 == 1
    assert np.array_equal(got.view(np.int32), clean.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64])
def test_unsigned_records_on_card(dtype):
    # the unsigned dtypes torch leaves kernels out of compute in their
    # carriers on the card too: every call against numpy, values and dtype
    import bolt_tpu_torch as bolt
    dev = _cuda()
    x = np.random.RandomState(13).randint(0, 17, (64, 6, 5)).astype(dtype)
    b = bolt.array(x, dev)
    cases = [
        (b + 1, x + 1), (b > 3, x > 3), (b // 2, x // 2),
        (b.map(lambda v: v + 1).sum(), (x + 1).sum(0)),
        (b.min(), x.min(0)), (b.max(), x.max(0)),
        (b.reduce(np.maximum), x.max(0)), (b.clip(2, 9), np.clip(x, 2, 9)),
        (bolt.compute(b.sum(), b.max())[1], x.max(0))]
    for got, want in cases:
        g = np.asarray(got.toarray())
        assert g.dtype == want.dtype and np.array_equal(g, want)
    red = np.asarray(b.reduce(np.add).toarray())
    assert red.dtype == x.dtype and np.array_equal(red, x.sum(0))
    cum = np.asarray(b.cumsum(axis=0).toarray())
    assert cum.dtype == x.dtype and np.array_equal(cum, np.cumsum(x, 0))
    st = b.stats()
    assert np.array_equal(st.min(), x.min(0))
    assert np.array_equal(st.max(), x.max(0))
    np.testing.assert_allclose(st.mean(), x.mean(0), rtol=1e-6)
    src = bolt.fromcallback(lambda idx: x[idx], x.shape, dev, dtype=dtype,
                            chunks=8)
    for got, want in ((src.sum(), x.sum(0)), (src.max(), x.max(0))):
        g = np.asarray(got.toarray())
        assert g.dtype == want.dtype and np.array_equal(g, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64])
def test_unsigned_callables_on_card(dtype):
    # a callable torch's CUDA build has no unsigned kernel for runs on the
    # carriers: wraps and orderings inside it give numpy's answers, and a
    # uint64 division there refuses rather than read the carrier signed
    import bolt_tpu_torch as bolt
    dev = _cuda()
    x = np.random.RandomState(14).randint(0, 17, (64, 6, 5)).astype(dtype)
    if dtype == np.uint64:
        x.reshape(-1)[::7] += np.uint64(2 ** 63)
    b = bolt.array(x, dev)
    keep = (x[:, 0, 0] - dtype(5)) > 3
    cases = [(b.map(lambda v: (v - 5) > 3), (x - dtype(5)) > 3),
             (b.map(lambda v: v > 5), x > 5),
             (b.filter(lambda v: (v[0, 0] - 5) > 3), x[keep]),
             (b.filter(lambda v: (v[0, 0] - 5) > 3).max(), x[keep].max(0)),
             (b.filter(lambda v: (v[0, 0] - 5) > 3).sum(), x[keep].sum(0)),
             (b.reduce(lambda a, c: a * (a > c) + c * (a <= c)), x.max(0))]
    src = bolt.fromcallback(lambda idx: x[idx], x.shape, dev, dtype=dtype,
                            chunks=8).filter(lambda v: v[0, 0] > 9)
    cases.append((src.sum(), x[x[:, 0, 0] > 9].sum(0)))
    if dtype != np.uint64:
        cases.append((b.map(lambda v: (v - 5) // 2), (x - dtype(5)) // 2))
    else:
        with pytest.raises(TypeError, match="uint64"):
            b.map(lambda v: (v - 5) // 2).toarray()
    for got, want in cases:
        g = np.asarray(got.toarray())
        assert g.dtype == want.dtype and np.array_equal(g, want)


@pytest.mark.gpu
def test_resumed_int8_stream_launches_decode_sum_on_card(tmp_path,
                                                         monkeypatch):
    # a streamed int8 sum killed at its 5th upload resumes on the card bit
    # for bit, launching fused_decode_sum once for each slab it streams
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import _chaos, checkpoint, engine, stream
    dev = _cuda()
    monkeypatch.setenv("BOLT_CODEC_KERNEL", "1")
    x = np.random.RandomState(14).randint(-8, 9, (64, 16, 36)).astype(
        np.float32)
    ck = str(tmp_path / "ck")

    def run(ckdir=None):
        with stream.uploaders(1):
            return bolt.fromcallback(lambda idx: x[idx], x.shape, dev,
                                     dtype=np.float32, chunks=8,
                                     codec="int8", checkpoint=ckdir).sum() \
                .toarray()

    clean = run()
    _chaos.inject("stream.upload", nth=5)
    try:
        with pytest.raises(_chaos.ChaosError):
            run(ck)
    finally:
        _chaos.clear()
    assert checkpoint.stream_pending(ck)
    c0 = engine.counters()
    before = K.LAUNCHES["fused_decode_sum"]
    got = run(ck)
    c1 = engine.counters()
    slabs = c1["stream_chunks"] - c0["stream_chunks"]
    assert c1["stream_resumes"] - c0["stream_resumes"] == 1 and slabs < 8
    assert K.LAUNCHES["fused_decode_sum"] - before == slabs
    assert np.array_equal(got.view(np.int32), clean.view(np.int32))
    assert not checkpoint.stream_pending(ck)


# ---------------------------------------------------------------------
# serving on the card: the lane-batched map-reduce kernel, batched serve
# terminals, and the warm start of a fresh process
# ---------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("cols", [False, True], ids=["full", "cols"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16])
@pytest.mark.parametrize("lanes", [1, 2, 16, 5])
def test_fused_map_reduce_lanes_bit_for_bit_on_card(lanes, dtype, cols):
    # each lane equals the standalone launch on its base bit for bit (the
    # same plan, so the same partition and order), in one launch; the
    # serving shape (128, 32), a numel that is not a multiple of the pack
    # and ragged columns (257, 33)
    M, programs = _mr_programs()
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(31)
    tol = {torch.float64: 1e-10, torch.float32: 1e-4}.get(dtype, 1.6e-2)
    for shape in ((128, 32), (257, 33)):
        xs = [torch.randn(shape, generator=g, device=dev).to(dtype)
              for _ in range(lanes)]
        for name in ("v+1", "where", "trans"):
            prog = M.compile((programs[name],),
                             shape[1:] if cols else shape, dtype)
            b_lanes = K.LAUNCHES["fused_map_reduce_lanes"]
            b_one = K.LAUNCHES["fused_map_reduce"]
            out = K.fused_map_reduce_lanes(xs, prog, cols=cols)
            torch.cuda.synchronize()
            assert K.LAUNCHES["fused_map_reduce_lanes"] == b_lanes + 1
            assert K.LAUNCHES["fused_map_reduce"] == b_one
            assert out.shape == ((lanes,) + shape[1:] if cols
                                 else (lanes,)) and out.dtype == dtype
            for i, x in enumerate(xs):
                one = K.fused_map_reduce_cols(x, prog) if cols else \
                    K.fused_map_reduce_program(x, prog)
                assert torch.equal(out[i], one), (name, shape, i)
            want = K._fused_map_reduce_lanes_plain(xs, prog, cols)
            mag = float(want.double().abs().max())
            assert float((out.double() - want.double()).abs().max()) \
                <= tol * (1 + mag) * (1 if cols else shape[0]), name


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [False, True], ids=["full", "cols"])
def test_fused_map_reduce_lanes_misaligned_view_lane_on_card(cols):
    # a lane that starts 4 bytes past a 16-byte boundary loads one element
    # at a time, as its standalone launch does: it takes a launch of its
    # own, and every lane still equals its standalone launch bit for bit
    from bolt_tpu_torch.ops import mapexpr as M
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(32)
    shape = (130, 64)
    raw = torch.randn(1 + 130 * 64, generator=g, device=dev)
    xs = [torch.randn(shape, generator=g, device=dev),
          raw[1:].view(shape),
          torch.randn(shape, generator=g, device=dev)]
    prog = M.compile((lambda v: v * 2 + 1,), shape[1:] if cols else shape,
                     torch.float32)
    before = K.LAUNCHES["fused_map_reduce_lanes"]
    out = K.fused_map_reduce_lanes(xs, prog, cols=cols)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_map_reduce_lanes"] == before + 2
    for i, x in enumerate(xs):
        one = K.fused_map_reduce_cols(x, prog) if cols else \
            K.fused_map_reduce_program(x, prog)
        assert torch.equal(out[i], one), i


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [False, True], ids=["full", "cols"])
def test_fused_map_reduce_lanes_wider_than_the_table_on_card(cols):
    # 130 lanes, more than a launch's table holds (64): three launches of
    # 64, 64 and 2 lanes, every lane bit for bit its standalone launch
    M, programs = _mr_programs()
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(34)
    shape = (128, 32)
    xs = [torch.randn(shape, generator=g, device=dev) for _ in range(130)]
    prog = M.compile((programs["v*2+1"],), shape[1:] if cols else shape,
                     torch.float32)
    before = K.LAUNCHES["fused_map_reduce_lanes"]
    out = K.fused_map_reduce_lanes(xs, prog, cols=cols)
    torch.cuda.synchronize()
    assert K._MAX_LANES == 64
    assert K.LAUNCHES["fused_map_reduce_lanes"] == before + 3
    for i, x in enumerate(xs):
        one = K.fused_map_reduce_cols(x, prog) if cols else \
            K.fused_map_reduce_program(x, prog)
        assert torch.equal(out[i], one), i


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [False, True], ids=["full", "cols"])
def test_fused_map_reduce_lanes_one_kernel_no_scratch_on_card(cols):
    # config 14, 16 lanes of (128, 32) f32: one launch of one kernel (the
    # plan is direct: one block a lane writes its output), and the call
    # allocates its output and nothing else
    M, programs = _mr_programs()
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(35)
    shape = (128, 32)
    xs = [torch.randn(shape, generator=g, device=dev) for _ in range(16)]
    prog = M.compile((programs["v+1"],), shape[1:] if cols else shape,
                     torch.float32)
    K.fused_map_reduce_lanes(xs, prog, cols=cols)       # plans once
    torch.cuda.synchronize()
    rec = K._record(K._encoded(prog), cols, shape if cols else 4096,
                    torch.float32, xs[0].device, 4)
    assert rec.kernels == 1 and rec.part == 0
    stats = torch.cuda.memory_stats(dev)
    n0 = stats["allocation.all.allocated"]
    b0 = stats["allocated_bytes.all.allocated"]
    before = K.LAUNCHES["fused_map_reduce_lanes"]
    out = K.fused_map_reduce_lanes(xs, prog, cols=cols)
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats(dev)
    assert K.LAUNCHES["fused_map_reduce_lanes"] == before + 1
    assert stats["allocation.all.allocated"] - n0 == 1
    assert stats["allocated_bytes.all.allocated"] - b0 == 512 * -(
        -out.numel() * 4 // 512)
    for i, x in enumerate(xs):
        one = K.fused_map_reduce_cols(x, prog) if cols else \
            K.fused_map_reduce_program(x, prog)
        assert torch.equal(out[i], one), i


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16])
def test_fused_map_reduce_small_plans_match_plain_on_card(dtype):
    # standalone small shapes on each side of the floor of packs a thread
    # (one direct block; two blocks and their combine), both forms,
    # against the plain version (f64 1e-10, f32 1e-4, f16/bf16 1.6e-2)
    M, programs = _mr_programs()
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(36)
    tol = {torch.float64: 1e-10, torch.float32: 1e-4}.get(dtype, 1.6e-2)
    vec = 16 // dtype.itemsize
    # rows a block at the floor, where 32 columns leave lanes idle threads
    edge = K._lanes(32, vec) * K._MIN_PACKS
    for shape in ((edge, 32), (edge + 1, 32), (3, 35), (128, 32)):
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        for name in ("v+1", "where", "trans"):
            prog = M.compile((programs[name],), shape[1:], dtype)
            got = K.fused_map_reduce_cols(x, prog)
            want = K._fused_map_reduce_plain(x, prog, cols=True)
            torch.testing.assert_close(got.double(), want.double(),
                                       rtol=tol, atol=tol)
        rec = K._record(K._encoded(prog), True, shape, dtype, x.device,
                        K._vec(x, shape[1]))
        assert (rec.kernels == 1) == (shape != (edge + 1, 32)), shape
    per_block = K._MIN_PACKS * 256 * vec
    for numel in (per_block, per_block + 1, 4096):
        x = torch.randn(numel, generator=g, device=dev).to(dtype)
        prog = M.compile((programs["v+1"],), (numel,), dtype)
        got = K.fused_map_reduce_program(x, prog)
        want = K._fused_map_reduce_plain(x, prog)
        mag = float(M.evaluate(prog, x).abs().sum(dtype=torch.float64))
        assert abs(float(got) - float(want)) <= tol * (1 + mag), numel
        rec = K._record(K._encoded(prog), False, numel, dtype, x.device,
                        K._vec(x, 0))
        assert (rec.kernels == 1) == (numel != per_block + 1), numel


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sum", "mean", "var", "std", "min", "max",
                                  "prod", "reduce", "chain"])
def test_batched_serve_terminals_bit_for_bit_on_card(name):
    # four queued requests of one batch key coalesce into one batched
    # dispatch whose every lane equals the standalone result on the card;
    # a compiled sum runs one lanes launch and no standalone launch
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import engine, serve
    import threading
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(33)
    bases = [bolt.array(torch.randn((128, 32), generator=g, device=dev)
                        * 0.1 + 1.0, dev) for _ in range(4)]

    def add1(v):
        return v + 1

    def make(i):
        m = bases[i].map(add1)
        if name == "chain":
            return m
        if name == "reduce":
            return m.reduce(torch.add)
        return getattr(m, name)()

    with serve.serving(workers=1, batching={"max_batch": 4,
                                            "linger": 0.05}) as sv:
        want = [make(i).totorch() for i in range(4)]
        torch.cuda.synchronize()
        gate = threading.Event()
        blocker = sv.submit(gate.wait)
        futs = [sv.submit(make(i)) for i in range(4)]
        c0 = engine.counters()
        b_lanes = K.LAUNCHES["fused_map_reduce_lanes"]
        b_one = K.LAUNCHES["fused_map_reduce"]
        gate.set()
        outs = [f.result(timeout=120).totorch() for f in futs]
        blocker.result(timeout=30)
        torch.cuda.synchronize()
        c1 = engine.counters()
    assert all(f.batch_width == 4 for f in futs)
    assert c1["batched_dispatches"] - c0["batched_dispatches"] == 1
    for got, w in zip(outs, want):
        assert got.dtype == w.dtype and torch.equal(got, w), name
    if name == "sum":
        assert K.LAUNCHES["fused_map_reduce_lanes"] - b_lanes == 1
        assert K.LAUNCHES["fused_map_reduce"] == b_one


@pytest.mark.gpu
def test_start_warm_child_runs_no_nvcc(tmp_path):
    # a fresh process started with Server(start_warm=dir) over libraries
    # an earlier process built loads them without nvcc: no persistent
    # miss, at least one warm hit, and its first request launches B1
    import json
    import shutil
    import subprocess
    import sys
    from bolt_tpu_torch.ops import _build
    _cuda()
    d = str(tmp_path / "warm-kernels")
    os.makedirs(d)
    for name, path in _build.build().items():   # the checkout's builds
        shutil.copy(path, d)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import json, sys, numpy as np, torch\n"
        "sys.path.insert(0, %r)\n"
        "import bolt_tpu_torch as bolt\n"
        "from bolt_tpu_torch import engine, serve\n"
        "from bolt_tpu_torch.ops import kernels as K\n"
        "dev = torch.device('cuda', 0)\n"
        "x = np.arange(128 * 32, dtype=np.float32).reshape(128, 32)\n"
        "with serve.serving(workers=1, start_warm=%r) as sv:\n"
        "    out = sv.submit(bolt.array(x, dev).map(lambda v: v + 1)"
        ".sum()).result(120).toarray()\n"
        "c = engine.counters()\n"
        "print(json.dumps({'misses': c['persistent_misses'], "
        "'warm': c['persistent_warm_hits'], 'b1': "
        "K.LAUNCHES['fused_map_reduce'], 'ok': bool(np.array_equal("
        "out, (x + 1).sum(0)))}))\n" % (root, d))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"misses": 0, "warm": got["warm"], "b1": 1, "ok": True}
    assert got["warm"] >= 1


def _flat_device_and_counters(fn):
    """Run ``fn`` and return the change of the card's allocated bytes,
    its peak, the engine's builds/dispatches and the kernel launches."""
    from bolt_tpu_torch import engine
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    c0, l0 = engine.counters(), dict(K.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    c1 = engine.counters()
    moved = {"allocated": torch.cuda.memory_allocated() - a0,
             "peak": torch.cuda.max_memory_allocated() - a0}
    moved.update({k: c1[k] - c0[k] for k in ("misses", "aot_compiles",
                                             "dispatches")})
    moved.update({k: v - l0.get(k, 0) for k, v in K.LAUNCHES.items()})
    return out, {k: v for k, v in moved.items() if v}


@pytest.mark.gpu
def test_check_on_card_allocates_and_launches_nothing():
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import analysis
    dev = _cuda()
    x = np.random.RandomState(0).randn(64, 32, 16).astype(np.float32)
    b = bolt.array(x, dev)
    m = b.map(lambda v: v + 1)
    f = m.filter(lambda v: v.mean() > 1)
    s, v = m.sum(), m.var()
    src = bolt.fromcallback(lambda i: x[i], x.shape, dev, dtype=np.float32,
                            chunks=8)
    for obj in (m, f, s, m.chunk(size=(8,), axis=(0,)),
                src.map(lambda v: v + 1).swap((0,), (0,))):
        rep, moved = _flat_device_and_counters(lambda: analysis.check(obj))
        assert rep.ok and moved == {}, (rep, moved)
        assert all(st.spec == dev or st.spec == torch.device("cuda", 0)
                   for st in rep.stages)
    assert s._spending is not None and f.pending


@pytest.mark.gpu
def test_strict_refuses_on_card_before_a_build():
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import analysis
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    dev = _cuda()
    x = np.random.RandomState(1).randn(64, 32, 16).astype(np.float32)
    base = bolt.array(x, dev)._data
    bad = BoltArrayGPU._deferred(
        base, (lambda v: v @ torch.ones((99, 2), device=v.device),), 1,
        dev, (64, 2), np.float32)

    def refused():
        with analysis.strict():
            with pytest.raises(analysis.PipelineError, match="BLT001"):
                bad.sum()
    _, moved = _flat_device_and_counters(refused)
    assert moved == {}
    want = bolt.array(x, dev).map(lambda v: v + 1).sum().toarray()
    with analysis.strict():
        got = bolt.array(x, dev).map(lambda v: v + 1).sum().toarray()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.gpu
def test_hbm_check_reads_mem_get_info_on_card(monkeypatch):
    from bolt_tpu_torch.gpu import array as garray
    dev = _cuda()
    monkeypatch.delenv("BOLT_HBM_BYTES", raising=False)
    monkeypatch.setattr(garray, "_HBM_LIMIT_OVERRIDE", None)
    monkeypatch.setattr(garray, "_HBM_DEVICE_REPORT", {})
    limit, known = garray._hbm_limit(dev)
    assert known and limit == torch.cuda.mem_get_info(
        torch.cuda.current_device())[1]
    with pytest.raises(MemoryError, match="sort"):
        garray.hbm_check("sort", limit + 1, "test", dev)
    garray.hbm_check("sort", limit // 2, "test", dev)


# ---------------------------------------------------------------------------
# pods of ranks on the card (bolt_tpu_torch/parallel/harness.py)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_nccl_refuses_two_ranks_on_one_card():
    """Two NCCL ranks on one card raise the pointed ValueError before
    NCCL is touched (the harness names the rank that died of it)."""
    _cuda()
    from bolt_tpu_torch.parallel import harness
    with pytest.raises(RuntimeError, match="distinct GPU per rank"):
        harness.run_cluster("sleep", nproc=2, timeout=120,
                            args={"seconds": 0}, device="cuda",
                            backend="nccl")


@pytest.mark.gpu
def test_gloo_pod_on_one_card_runs_the_dry_run():
    """The multichip dry run on two gloo ranks sharing the card: every
    collective stages through the host, and the answers equal numpy's."""
    _cuda()
    from bolt_tpu_torch.parallel import harness
    res = harness.run_cluster("dryrun", nproc=2, timeout=300,
                              device="cuda", backend="gloo")
    shape = tuple(res[0]["result"]["shape"])
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    for r in res:
        np.testing.assert_array_equal(r["result"]["sum"],
                                      (x * 2.0 + 1.0).sum(axis=(0, 1)))


@pytest.mark.gpu
def test_nccl_pod_across_distinct_cards():
    """Two NCCL ranks, each on its own card: the dry run's swap, stats,
    sum, gather and filter.  Needs two cards (the one-card machine skips
    it; not verified there)."""
    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from bolt_tpu_torch.parallel import harness
    res = harness.run_cluster("dryrun", nproc=2, timeout=300,
                              device="cuda:rank", backend="nccl")
    shape = tuple(res[0]["result"]["shape"])
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    for r in res:
        np.testing.assert_array_equal(r["result"]["sum"],
                                      (x * 2.0 + 1.0).sum(axis=(0, 1)))


@pytest.mark.gpu
def test_reform_on_card_keeps_device_and_builds_nothing():
    """The 3 -> 2 reform of gloo ranks sharing the card: every survivor
    comes back up on the same ``cuda:0`` with the same backend, no
    kernel library is rebuilt, and the resumed sum equals the unkilled
    two-rank run's bits."""
    _cuda()
    from bolt_tpu_torch.parallel import harness
    r = harness.run_reform_bench(device="cuda", backend="gloo",
                                 args={"stats": False})
    assert r["victim_rc"] == -9 and r["survivors"] == 2
    assert r["bit_identical"] and r["stale_checkpoint_files"] == []
    for s in r["killed"]:
        if s is not None:
            assert s["new_device"] == "cuda:0", s
            assert s["new_backend"] == "gloo" and s["reform_builds"] == 0


@pytest.mark.gpu
def test_nccl_refused_for_two_ranks_on_one_card_after_reform():
    """A one-rank NCCL pod and a replacement process reforming into two
    NCCL ranks on the one card: both refuse with the pointed error, and
    the failed bring-up heals; nothing falls back to gloo."""
    _cuda()
    import tempfile
    from bolt_tpu_torch.parallel import harness
    with tempfile.TemporaryDirectory() as d:
        res, rcs = harness.run_cluster(
            "nccl_reform", 1, timeout=300, device="cuda", backend="nccl",
            args={"store": os.path.join(d, "store")}, extra=[{}])
    assert rcs == [0, 0]
    assert res[0]["before"] == "nccl"
    for r in res:
        assert "distinct GPU per rank" in (r["refused"] or ""), r
        assert r["healed"] is True and r["pod_up"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["ns.fused", "img.path", "ns.series",
                                  "img.pca"])
def test_host_syncs_count_each_sync_of_a_pass_on_card(cell):
    import sys
    import warnings
    dev = _cuda()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import bolt_tpu_torch as bolt
    from benchmark import harness
    from benchmark.pipeline import Pass
    from bolt_tpu_torch import engine
    seed = 2 ** 31 + 22
    _, config, traffic, _, _ = harness.load_cell(cell)
    x, _ = harness.make_data(torch, config, seed, dev)
    data = bolt.array(x, context=dev, axis=tuple(sorted(config["key_axes"])))
    del x
    run = Pass(traffic, data, seed)
    for _ in range(2):                  # every program built and warm
        run()
        torch.cuda.synchronize()
    c0 = engine.counters()["host_syncs"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            outs = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counted = engine.counters()["host_syncs"] - c0
    torch.cuda.synchronize()
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == counted, (cell, [str(w.message) for w in syncs])
    del outs, run, data
