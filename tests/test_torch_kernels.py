"""The port's moment kernels against the reference's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the
tensors lie on the CPU); the reference's kernels run in interpret mode,
as ``test_ops_kernels.py`` runs them.  Inputs come from a seeded numpy
generator and go through both.  Tolerances:

* f64: ``rtol=1e-10`` — the summation order differs;
* f32: mean ``rtol=1e-5``, m2 ``rtol=1e-4, atol=1e-4`` as in
  ``test_ops_kernels.py``; sums ``rtol=1e-4`` as in its ``fused_stats``
  tests;
* bf16: results are bf16, so two bf16 steps (``rtol=atol=1.6e-2``);
* min/max and integer sums: exact.

The CUDA kernels are held against their plain versions on the card by
``test_torch_card.py``.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bolt_tpu.ops.kernels import fused_stats as ref_stats
from bolt_tpu.ops.kernels import fused_welford as ref_welford
from bolt_tpu_torch.ops import kernels as K

_TOL = {"float64": dict(rtol=1e-10, atol=0),
        "float32": dict(rtol=1e-4, atol=1e-4),
        "bfloat16": dict(rtol=1.6e-2, atol=1.6e-2)}


def _inputs(shape, dtype, seed=1, nan_col=False):
    x = np.random.RandomState(seed).randn(*shape)
    if nan_col:
        x.reshape(shape[0], -1)[:, 3] = np.nan
    if dtype == "bfloat16":
        return (jnp.asarray(x, dtype=jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    x = x.astype(dtype)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(v):
    """A reference or port result as a float64 numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(v, dtype=jnp.float64))


def _check_moments(got, want, dtype):
    mu, m2, mn, mx = (_np(v) for v in got)
    rmu, rm2, rmn, rmx = (_np(v) for v in want)
    tol = _TOL[dtype]
    mtol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else tol
    np.testing.assert_allclose(mu, rmu, equal_nan=True, **mtol)
    np.testing.assert_allclose(m2, rm2, equal_nan=True, **tol)
    np.testing.assert_array_equal(mn, rmn)
    np.testing.assert_array_equal(mx, rmx)


# shapes of test_ops_kernels.py::test_fused_welford_direct, where the
# reference kernel engages
@pytest.mark.parametrize("shape", [(64, 256), (128, 4, 128), (96, 8, 2, 128)])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_fused_welford_matches_reference(shape, dtype):
    xj, xt = _inputs(shape, dtype)
    want = ref_welford(xj)
    assert want is not None
    got = K.fused_welford(xt)
    assert all(v.dtype == xt.dtype and tuple(v.shape) == shape[1:]
               for v in got)
    _check_moments(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_fused_welford_nan_column(dtype):
    xj, xt = _inputs((64, 256), dtype, nan_col=True)
    got = K.fused_welford(xt)
    _check_moments(got, ref_welford(xj), dtype)
    assert all(np.isnan(_np(v)[3]) for v in got)


@pytest.mark.parametrize("shape", [(64, 100), (3, 5, 7), (37, 6)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_welford_where_reference_declines(shape, dtype):
    # the reference returns None off its TPU tiling plan; the port's
    # kernel takes any shape, so it is held to numpy
    xj, xt = _inputs(shape, dtype, seed=2)
    assert ref_welford(xj) is None
    x = xt.numpy()
    mu = x.mean(axis=0)
    want = (mu, ((x - mu) ** 2).sum(axis=0), x.min(axis=0), x.max(axis=0))
    _check_moments(K.fused_welford(xt), want, dtype)


@pytest.mark.parametrize("x", [
    torch.zeros((64, 128), dtype=torch.int32),   # not floating
    torch.zeros(128),                            # 1-d
    torch.zeros((1, 128)),                       # one row
], ids=["int32", "1d", "one_row"])
def test_fused_welford_none_contract(x):
    assert K.fused_welford(x) is None
    assert ref_welford(jnp.asarray(x.numpy())) is None


@pytest.mark.parametrize("shape", [(16, 128), (32, 256), (5, 7)])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_fused_stats_matches_reference(shape, dtype):
    xj, xt = _inputs(shape, dtype, seed=3)
    got = [_np(v) for v in K.fused_stats(xt)]
    want = [_np(v) for v in ref_stats(xj)]
    assert all(v.dtype == xt.dtype and v.dim() == 0
               for v in K.fused_stats(xt))
    tol = dict(_TOL[dtype])
    if dtype == "float32":
        tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[:2], want[:2], **tol)
    assert got[2:] == want[2:]


def test_fused_stats_nan():
    xj, xt = _inputs((16, 128), "float32", nan_col=True)
    got = [_np(v) for v in K.fused_stats(xt)]
    want = [_np(v) for v in ref_stats(xj)]
    assert all(np.isnan(got)) and all(np.isnan(want))


def test_fused_stats_integers():
    # integer inputs are computed outside the kernel, as the reference does
    x = np.arange(16 * 128, dtype=np.int32).reshape(16, 128)
    got = K.fused_stats(torch.from_numpy(x))
    want = ref_stats(jnp.asarray(x))
    for g, w in zip(got, want):
        assert g.item() == int(w)
        assert K._sum_dtype(torch.int32) == torch.int64


def test_fused_stats_empty_raises():
    with pytest.raises(ValueError):
        K.fused_stats(torch.zeros((0, 4)))


def test_wrappers_refuse_other_devices():
    # only a CPU tensor takes the plain version; any other non-CUDA
    # device is refused, never computed on the host
    x = torch.empty((8, 16), device="meta")
    with pytest.raises(ValueError):
        K.fused_welford(x)
    with pytest.raises(ValueError):
        K.fused_stats(x)


# the ids name the first cases as the plan without row lanes did
@pytest.mark.parametrize("n,columns,vec,lanes,chunks", [
    # north-star stats(): wide, so one lane and two row chunks
    pytest.param(3200, 819200, 4, 1, 2, id="3200-819200-4-2"),
    # narrow: 64 column threads leave 4 lanes of 16 rows in one chunk
    pytest.param(64, 256, 4, 4, 1, id="64-256-4-4"),
    pytest.param(20, 256, 4, 4, 1, id="20-256-4-1"),    # too few rows
    pytest.param(3, 35, 1, 4, 1, id="3-35-1-1"),
    # the imaging path's stats(): 16 column threads, 16 lanes, and the
    # rows split until the blocks fill 132 SMs
    pytest.param(8388608, 64, 4, 16, 1056, id="imaging-pixels"),
])
def test_welford_row_plan(n, columns, vec, lanes, chunks):
    got_lanes, rpc, got = K.welford_rows(n, columns, vec, sm_count=132)
    assert (got_lanes, got) == (lanes, chunks)
    assert (got - 1) * rpc < n <= got * rpc
    assert rpc >= min(n, K._MIN_CHUNK_ROWS * lanes)


@pytest.mark.parametrize("element_size,vec,nregs,rows", [
    (4, 4, 0, 4), (4, 4, 7, 4), (4, 4, 8, 2), (4, 4, 9, 2),   # f32
    (8, 2, 3, 4), (8, 2, 8, 2),                              # f64
    (2, 8, 1, 2), (2, 8, 7, 2), (2, 8, 8, 1),                # f16/bf16
    (4, 1, 8, 4), (2, 1, 0, 4)])                             # one element
def test_map_reduce_tile_rows(element_size, vec, nregs, rows):
    # the wide tile is 16 values (8 in f64), 16 KB a register a block;
    # it halves when the file would pass 112 KB (seven registers)
    assert K.tile_rows(element_size, vec, nregs) == rows


@pytest.mark.parametrize("n,columns,vec,resident,plan", [
    # the north-star: 800 column blocks of 1024 columns, 2.56e6 row units
    # over 396 resident blocks (three an SM) of 6464-6465 units, each
    # touching at most 4 column blocks
    (3200, 819200, 4, 396, K.MapReducePlan(1, 396, 4, False)),
    (200, 819200, 4, 396, K.MapReducePlan(1, 396, 4, False)),     # config 1
    (3200, 819200, 4, 1056, K.MapReducePlan(1, 1056, 2, False)),
    # one row of 4099 single elements: 17 column blocks, each a block
    (1, 4099, 1, 396, K.MapReducePlan(1, 17, 1, True)),
    # 16 column threads: 16 lanes, one column block split by rows
    (50000, 64, 4, 264, K.MapReducePlan(16, 264, 2, False)),
    # fewer units than the floor's one block: one block (4 row lanes of
    # 64 column threads) holds the column block whole and writes it
    (3, 35, 1, 264, K.MapReducePlan(4, 1, 1, True)),
    # config 14's (128, 32) f32 at any resident count: 32 row lanes of 4
    # packs each, one block, direct (no scratch, no combine kernel)
    (128, 32, 4, 264, K.MapReducePlan(32, 1, 1, True)),
    (128, 32, 4, 528, K.MapReducePlan(32, 1, 1, True)),
    # the floor's edge at 32 lanes: 256 rows (8 packs a thread) are one
    # block, 257 take two blocks and scratch
    (256, 32, 4, 264, K.MapReducePlan(32, 1, 1, True)),
    (257, 32, 4, 264, K.MapReducePlan(32, 2, 2, False)),
    # and where it stops binding: 263 blocks of 256 rows below 264 * 256
    # units, the whole wave at it
    (67328, 32, 4, 264, K.MapReducePlan(32, 263, 2, False)),
    (67584, 32, 4, 264, K.MapReducePlan(32, 264, 2, False)),
    # one lane: 8 rows a block, 395 blocks, then the wave of 396
    (3160, 1024, 4, 396, K.MapReducePlan(1, 395, 2, False)),
    (3168, 1024, 4, 396, K.MapReducePlan(1, 396, 2, False)),
    # one row of 800 column blocks, more than the wave: the floor never
    # takes a block below one column block's share
    (1, 819200, 4, 396, K.MapReducePlan(1, 396, 4, False)),
])
def test_map_reduce_plan(n, columns, vec, resident, plan):
    assert K.map_reduce_plan(n, columns, vec, resident) == plan


@pytest.mark.parametrize("numel,vec,resident,blocks", [
    # config 14's 4096 elements, and up to 8 packs a thread: one block,
    # which writes the output (no scratch, no fold kernel)
    (4096, 4, 264, 1), (8192, 4, 264, 1), (1, 4, 264, 1),
    (8193, 4, 264, 2),                      # past the floor: two blocks
    (4097, 1, 264, 3),                      # single elements: 17 rows
    (3200 * 819200, 4, 396, 396),           # the north-star: one wave
    (64 * 8 * 256 * 4, 4, 264, 64),          # 64 blocks at the floor
    (65 * 8 * 256 * 4, 4, 264, 65)])
def test_map_reduce_full_plan(numel, vec, resident, blocks):
    assert K._full_plan(numel, vec, resident) == blocks


@pytest.mark.parametrize("vecs,capacity,launches", [
    ([4] * 16, 64, [(4, list(range(16)))]),          # serving default
    ([4, 1, 4], 64, [(4, [0, 2]), (1, [1])]),          # a misaligned lane
    ([1, 4, 1, 4], 64, [(1, [0, 2]), (4, [1, 3])]),
    ([4] * 130, 64, [(4, list(range(64))), (4, list(range(64, 128))),
                     (4, [128, 129])]),               # wider than the table
    ([4, 1] * 3, 2, [(4, [0, 2]), (4, [4]), (1, [1, 3]), (1, [5])]),
    ([2], 64, [(2, [0])])])
def test_lane_launches_split_by_pack_width_and_capacity(vecs, capacity,
                                                        launches):
    assert K.lane_launches(vecs, capacity) == launches


def test_lanes_table_mirror_layout():
    # kernels.py's _Lanes mirrors mapreduce.cu's Lanes: kMaxLanes input
    # pointers, then kMaxLanes output pointers, and the launch's
    # parameters (the Program, the table and the scalars) stay within 4 KB
    import ctypes
    import os
    import re
    src = open(os.path.join(os.path.dirname(K.__file__), "csrc",
                            "mapreduce.cu")).read()
    cap = int(re.search(r"constexpr int kMaxLanes = (\d+);", src).group(1))
    assert cap == K._MAX_LANES
    assert ctypes.sizeof(K._Lanes) == 2 * 8 * K._MAX_LANES
    assert K._Lanes.inp.offset == 0 and K._Lanes.out.offset == 8 * cap
    assert ctypes.sizeof(K._Program) + ctypes.sizeof(K._Lanes) + 64 <= 4096
    t = K._Lanes()
    t.inp[:2] = [16, 32]
    t.out[:2] = [1 << 40, (1 << 40) + 128]
    assert list(t.inp[:3]) == [16, 32, None]
    assert t.out[1] == (1 << 40) + 128


def test_launch_record_is_planned_once(monkeypatch):
    # a launch record holds the plan and the C entry points' arguments
    # from the shape on; it is made on first use and reused, so a launch
    # asks the occupancy API and plans nothing
    from bolt_tpu_torch.ops import mapexpr
    asked = []

    def resident(device, form, lanes, dtype, vec, rows, calls, nfile):
        asked.append(form)
        return 264

    monkeypatch.setattr(K, "_resident", resident)
    dev = torch.device("cuda", 0)
    prog = mapexpr.compile((lambda v: v + 1,), (32,), torch.float32)
    full = mapexpr.compile((lambda v: v + 1,), (128, 32), torch.float32)
    for p in (prog, full):
        p.kernel = None
    enc, encf = K._encoded(prog), K._encoded(full)
    rec = K._record(enc, True, (128, 32), torch.float32, dev, 4)
    # config 14: 32 lanes, one block, one segment, f32 (code 0), 16-byte
    # packs, the wide tile; no scratch and one kernel
    assert rec == K._Launch((128, 32, 32, 1, 1, 0, 4, 4), 0, 1)
    assert K._record(enc, True, (128, 32), torch.float32, dev, 4) is rec
    assert K._record(encf, False, 4096, torch.float32, dev, 4) == \
        K._Launch((4096, 1, 0, 4, 4), 0, 1)
    assert asked == [0, 1]
    # a larger lane: 256 blocks of 4 lanes, their partials combined
    big = K._record(enc, True, (8192, 256), torch.float32, dev, 4)
    assert big.args[:5] == (8192, 256, 4, 256, 2) and big.kernels == 2
    assert big.part == 256 * 2 * 64 * 4
    # a misaligned base loads single elements: a record of its own
    one = K._record(enc, True, (128, 32), torch.float32, dev, 1)
    assert one.args[6:] == (1, 4) and one is not rec
    assert asked == [0, 1, 0, 0]
    for p in (prog, full):
        p.kernel = None


def _cols_grid(n, columns, vec, plan):
    """mapreduce.cu's column form in Python: the row units each block
    takes (mr_cols_kernel) and the partials each column adds
    (mr_cols_combine_kernel), as ``{column: [rows in order]}``."""
    cw = K._THREADS // plan.lanes * vec
    G = -(-columns // cw)
    W = G * n
    P = plan.blocks
    slots, written = {}, set()
    for b in range(P):
        u0, u1 = b * W // P, (b + 1) * W // P
        assert u1 > u0                      # no block is empty
        g, s = u0 // n, 0
        while g * n < u1:
            ra, rb = max(u0, g * n) - g * n, min(u1, g * n + n) - g * n
            assert s < plan.segs
            # a direct block writes its column block's output itself
            slot = ("out", g) if plan.direct else (b, s)
            assert slot not in written
            written.add(slot)
            slots[(g, b)] = (slot, list(range(ra, rb)))
            g, s = g + 1, s + 1
    rows = {}
    for c in range(columns):
        g = c // cw
        b0 = ((g * n + 1) * P - 1) // W
        b1 = ((g * n + n) * P - 1) // W
        got = []
        for b in range(b0, b1 + 1):
            slot, rr = slots[(g, b)]
            assert slot == (("out", g) if plan.direct
                            else (b, g - (b * W // P) // n))
            # every block past the first starts inside this column block:
            # the combine kernel reads its segment 0 without dividing
            assert b == b0 or (b * W // P) // n == g
            got += rr
        rows[c] = got
    return rows


@pytest.mark.parametrize("n,columns,vec,resident", [
    (3200, 8192, 4, 396), (200, 20480, 4, 396), (7, 4099, 1, 132),
    (1, 4099, 1, 396), (50000, 64, 4, 264), (3, 35, 1, 264),
    (1000, 333, 1, 528), (64, 4096, 4, 1056), (128, 32, 4, 264),
    (257, 32, 4, 264), (67328, 32, 4, 264), (3160, 1024, 4, 396)])
def test_map_reduce_grid_adds_every_row_once_in_order(n, columns, vec,
                                                      resident):
    plan = K.map_reduce_plan(n, columns, vec, resident)
    rows = _cols_grid(n, columns, vec, plan)
    assert all(r == list(range(n)) for r in rows.values())


def test_launch_counters_reset():
    K.LAUNCHES["fused_welford"] = 5
    K.LAUNCHES["lane_band"] = 2
    K.reset_launches()
    assert K.LAUNCHES == {"fused_welford": 0, "fused_stats": 0,
                          "sepfilter1d": 0, "lane_band": 0,
                          "fused_decode_sum": 0, "fused_map_reduce": 0,
                          "fused_map_reduce_lanes": 0}


# ---------------------------------------------------------------------------
# window kernels: sepfilter1d and lane_band
# ---------------------------------------------------------------------------

_MODES = ["constant", "edge", "reflect", "symmetric"]


def _np_window(a, ax, taps, mode):
    """numpy oracle: pad the whole axis with ``np.pad``, sum the shifted
    slices in tap order (test_ops_kernels.py's oracle)."""
    a = np.asarray(a)
    pad = [(0, 0)] * a.ndim
    pad[ax] = (len(taps) // 2,) * 2
    ap = np.pad(a, pad, mode=mode)
    out = None
    for off, t in enumerate(taps):
        sl = [slice(None)] * a.ndim
        sl[ax] = slice(off, off + a.shape[ax])
        piece = ap[tuple(sl)] * t
        out = piece if out is None else out + piece
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("mode", _MODES)
def test_pad_index_matches_np_pad(n, mode):
    x = np.arange(10, 10 + n)
    for left in range(21):
        for right in (0, left, 20 - left):
            got = np.concatenate([x, [0]])[K.pad_index(n, left, right, mode)]
            np.testing.assert_array_equal(
                got, np.pad(x, (left, right), mode=mode), (left, right))


@pytest.mark.parametrize("mode", _MODES)
def test_halo_pad_matches_np_pad_on_every_axis(mode):
    x = np.random.RandomState(8).randn(3, 4, 5)
    for ax in range(3):
        for left, right in ((2, 2), (7, 7), (0, 9)):
            pad = [(0, 0)] * 3
            pad[ax] = (left, right)
            got = K.halo_pad(torch.from_numpy(x), ax, left, right, mode)
            np.testing.assert_array_equal(got.numpy(),
                                          np.pad(x, pad, mode=mode))


@pytest.mark.parametrize("ax", [0, 1, 2])
@pytest.mark.parametrize("mode", _MODES)
def test_sepfilter1d_matches_reference(ax, mode):
    # test_ops_kernels.py::test_sepfilter1d_parity_all_axes inputs; the
    # reference's Pallas kernel in interpret mode
    from bolt_tpu.ops.kernels import sepfilter1d as ref_sep
    x = np.random.RandomState(60).randn(6, 16, 256).astype(np.float32)
    taps = [0.25, 0.5, 0.25]
    want = ref_sep(jnp.asarray(x), taps, ax, mode=mode, interpret=True)
    assert want is not None
    got = K.sepfilter1d(torch.from_numpy(x), taps, ax, mode=mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _np_window(x, ax, taps, mode),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,w", [((4, 6, 256), 17), ((3, 128), 11),
                                     ((2, 256), 255)])
def test_lane_band_matches_reference(shape, w):
    # test_ops_kernels.py::test_lane_band_paths inputs, in f64
    from bolt_tpu.ops.kernels import lane_band_pallas
    rs = np.random.RandomState(63)
    x = rs.randn(*shape)
    taps = tuple((rs.rand(w) / w).tolist())
    want = lane_band_pallas(jnp.asarray(x), taps, interpret=True)
    got = K.lane_band(torch.from_numpy(x), taps)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    via_sep = K.sepfilter1d(torch.from_numpy(x), taps, len(shape) - 1)
    np.testing.assert_array_equal(via_sep.numpy(), got.numpy())


@pytest.mark.parametrize("shape,ax,w,mode", [
    ((4, 100, 250), 2, 15, "reflect"),     # the reference declines all three
    ((4, 100, 250), 2, 15, "constant"),
    ((4, 100, 256), 2, 17, "symmetric"),
    ((3, 5), 1, 31, "reflect"),            # radius wider than the axis
    ((7, 3, 2), 1, 21, "symmetric"),
    ((9, 1), 0, 5, "edge"),
    ((5,), 0, 4, "constant"),              # an even window
], ids=["wide_unaligned_reflect", "wide_unaligned_constant",
        "wide_symmetric", "radius_past_axis", "strided_past_axis",
        "one_column", "even_taps"])
def test_sepfilter1d_where_reference_declines(shape, ax, w, mode):
    # the port's kernels take every geometry; held to numpy (and to the
    # reference's shifted-slice body where its kernel declines)
    from bolt_tpu.ops.overlap import _filter1d as ref_filter1d
    rs = np.random.RandomState(64)
    x = rs.randn(*shape)
    taps = (rs.rand(w) - 0.3).tolist()
    got = K.sepfilter1d(torch.from_numpy(x), taps, ax, mode=mode).numpy()
    np.testing.assert_allclose(got, ref_filter1d(x, ax, taps, mode, np),
                               rtol=1e-12, atol=1e-12)
    if w % 2:
        np.testing.assert_allclose(got, _np_window(x, ax, taps, mode),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_window_half_types_accumulate_in_f32(dtype):
    x = np.random.RandomState(65).randn(4, 16, 128).astype(np.float32)
    taps = [0.1, 0.2, 0.4, 0.2, 0.1]
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = _np_window(xt.float().numpy().astype(np.float64), 1, taps,
                      "reflect")
    got = K.sepfilter1d(xt, taps, 1, mode="reflect")
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1.6e-2,
                               atol=1.6e-2)
    # accumulated in f32 and rounded once, exactly as the plain f32 body
    f32 = K.sepfilter1d(xt.float(), taps, 1, mode="reflect")
    assert torch.equal(got, f32.to(xt.dtype))


def test_window_signed_zeros_and_nan_positions():
    # every tap is multiplied, zero pads and zero taps too: -0.0 survives
    # and inf * 0 is NaN, as in the reference's body
    from bolt_tpu.ops.overlap import _filter1d as ref_filter1d
    cases = [(np.array([[-0.0, -0.0, np.inf, 1.0, np.nan, 2.0, -0.0]]),
              [0.0, -1.0, 0.5]),
             (np.full((2, 5), -0.0), [0.5, 1.0, 0.5])]
    for x, taps in cases:
        for mode in _MODES:
            got = K.sepfilter1d(torch.from_numpy(x), taps, 1,
                                mode=mode).numpy()
            want = np.asarray(ref_filter1d(jnp.asarray(x), 1, taps, mode,
                                           jnp))
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            fin = ~np.isnan(want)
            np.testing.assert_array_equal(got[fin], want[fin])
            np.testing.assert_array_equal(np.signbit(got[fin]),
                                          np.signbit(want[fin]), mode)
    edge = K.sepfilter1d(torch.from_numpy(cases[1][0]), cases[1][1], 1,
                         mode="edge").numpy()
    assert np.signbit(edge).all()        # -0 * t + -0 * t ... stays -0


def test_window_none_contract_and_refusals():
    before = dict(K.LAUNCHES)
    xi = torch.ones((8, 256), dtype=torch.int32)
    assert K.sepfilter1d(xi, [1.0], 0) is None
    assert K.lane_band(xi, [0.5] * 11) is None
    x = torch.ones((8, 16))
    with pytest.raises(ValueError):
        K.sepfilter1d(x, [1.0], 0, mode="wrap")
    with pytest.raises(ValueError):
        K.sepfilter1d(x, [], 0)
    with pytest.raises(ValueError):
        K.sepfilter1d(x, [1.0], 2)
    with pytest.raises(ValueError):
        K.sepfilter1d(torch.ones(()), [1.0], 0)
    with pytest.raises(ValueError, match="precision mode"):
        K.sepfilter1d(x, [1.0], 0, precision="bf16")
    meta = torch.empty((8, 16), device="meta")
    with pytest.raises(ValueError):
        K.sepfilter1d(meta, [0.5, 0.5, 0.5], 0)
    with pytest.raises(ValueError):
        K.lane_band(meta, [0.5, 0.5, 0.5])
    assert K.LAUNCHES == before             # nothing was launched


def test_window_precision_modes_agree():
    x = torch.from_numpy(np.random.RandomState(66).randn(3, 8, 128)
                         .astype(np.float32))
    taps = [0.2] * 5
    want = K.sepfilter1d(x, taps, 2)
    for mode in ("default", "high", "highest"):
        assert torch.equal(K.sepfilter1d(x, taps, 2, precision=mode), want)
        assert torch.equal(K.lane_band(x, taps, precision=mode), want)


# ---------------------------------------------------------------------------
# the build: one compiler process per source, raise on failure
# ---------------------------------------------------------------------------

def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(0o755)
    return str(path)


def test_build_raises_on_compiler_failure(tmp_path, monkeypatch):
    from bolt_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    # the script is written once: rewriting it while an earlier process
    # still reads it would hand that process an empty script
    nvcc = _fake_nvcc(tmp_path,
                      "echo 'moments.cu(1): error: simulated' ; exit 2")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="simulated"):
        _build.build()
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "out"))


def test_build_writes_a_library_per_source_once(tmp_path, monkeypatch):
    from bolt_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    # the fake compiler writes its -o argument and counts its runs
    script = ('while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"; '
              'echo run >> %s' % (tmp_path / "runs"))
    nvcc = _fake_nvcc(tmp_path, script)
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    built = _build.build()
    assert sorted(built) == _build.sources() == ["codec.cu", "mapreduce.cu",
                                                 "moments.cu", "window.cu"]
    assert all(os.path.exists(p) and "-" in os.path.basename(p)
               for p in built.values())
    assert _build.build() == built          # present: not rebuilt
    assert (tmp_path / "runs").read_text().count("run") == 4
