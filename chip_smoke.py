#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bolt_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result):

1. set-up: build every ``bolt_tpu_torch/ops/csrc/*.cu`` with nvcc (one
   process per source, all started together) and print the card's name
   and power limit;
2. the main path at BASELINE config 1, ``(200, 200, 64, 64)`` f32:
   ``ones().map(v + 1).sum()`` (one ``fused_map_reduce`` launch)
   bit-exact against the local oracle, the stat terminals and ``stats()``
   against numpy, ``swap`` against ``np.transpose``, ``chunk().map()``
   with a halo and with a per-chunk SVD (config 5), and config 4's
   ``filter``: ``toarray()`` bit-exact against the local oracle with the
   same survivor count, ``reduce(add)`` against the oracle;
3. the main path at the north-star ``(3200, 200, 64, 64)`` f32 (10.49 GB)
   built on the card with ``randn``: ``map(v + 1).sum()`` through one
   ``fused_map_reduce`` launch (its wall and peak-memory growth beside the
   torch path's, which materialises the chain; under 1 GB), the
   ``ops.fused_map_reduce`` export (full form), a chain that does not
   compile taking the torch path, ``reduce(add)``, ``stats()``, the
   ``ops.fused_stats`` export and ``swap``, against f64 references
   computed on the card; then config 4 at the same width:
   ``map(v + 1).filter(v.mean() > 1)`` with ``sum()`` and ``mean()``
   (one masked ``fused_map_reduce`` launch each) against f64 references
   of the same mask, and an all-False filter (shape ``(0, ...)``, a zero
   ``sum()``, ``max()`` raising ``ValueError``);
4. the imaging path at the full width of ``fam_halo_gaussian``
   (``scripts/perf_regress.py``), ``(64, 2048, 4096)`` f32 (2.15 GB) built
   on the card with ``randn`` (seed 6, split 1): ``ops.gaussian(sigma=2,
   axis=(0, 1))`` bit for bit against the window kernels' plain versions
   and on four records against ``scipy.ndimage.correlate1d`` in f64;
   ``ops.smooth`` (reflect) and ``ops.convolve`` (symmetric) on the same
   records against scipy; ``ops.median_filter`` of four frames against
   ``scipy.ndimage.median_filter`` exactly; then ``swap`` to pixel time
   series, ``zscore(detrend(...))`` on 1024 seeded pixels against numpy f64
   and ``stats()`` against numpy on the downloaded series;
5. each kernel against its plain PyTorch version on the card, at the
   main-path shapes (``fused_welford`` also at the ``(8388608, 64)``
   pixel series that the imaging path's ``stats()`` hands it;
   ``fused_decode_sum`` at the streamed slab ``(20, 819200)`` and the whole
   north-star wire ``(3200, 819200)`` uint8; ``fused_map_reduce`` in both
   forms at the north-star in f32 and a bf16 copy and at config 1 in f64)
   and at odd shapes (ragged rows and columns, f64, bf16, f16, a NaN
   column; every boundary mode of the window kernels; int8, one row, a
   width that is not a multiple of 16, a misaligned view, the narrow
   ``(16, 1024)``; for ``fused_map_reduce`` a masked NaN record and
   programs that together use every opcode, and one that fills the
   register file), then timed beside its plain version, one PyTorch
   library call for the same function where there is one (for
   ``fused_decode_sum`` the decode route's torch expression instead) and
   its bound; ``fused_map_reduce`` also by program length, with the
   programs of ``tools/mapreduce_probe.py``; ``fused_decode_sum``'s decoded
   values bit for bit on all 256 byte values of uint8 and int8, and its
   slab time three ways (the launch loop, the device time, the host's
   share);
6. the streamed north-star: ``fromcallback(cb, (3200, 200, 64, 64),
   mode="gpu", dtype=float32)`` with the default slabs (20 records, 160
   slabs), each record from ``np.random.default_rng(seed + record)``, under
   ``stream.uploaders(4)``: uncompressed ``map(v + 1).sum()``, ``mean()``
   and ``var()`` against f64 references of the same source materialised on
   the card (then freed); ``delta-f32`` ``sum()`` bit for bit against the
   uncompressed one; ``bf16`` ``mean()`` within ``codec_bound("bf16")``;
   ``int8`` ``sum()`` armed (``BOLT_CODEC_KERNEL=1``, one
   ``fused_decode_sum`` launch a slab) and unarmed, both within the int8
   step bound; the lossy codec's refusal of ``min()``; each streamed run
   under 2 GB of peak device memory.

The launch counters are zeroed just before each path (phases 2–3, phase
4 and phase 6) and read just after it: each path must have launched every
kernel it runs.  The last two lines are a ``{"kernels": [...]}`` JSON
object and ``{"ok": true, "device": {...}}``.  A fuller report goes to
``chiprun_out/chip_smoke.json``.
"""

import itertools
import json
import math
import os
import subprocess
import sys
import time
import warnings
from operator import add

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3; 67 TFLOP/s f32 and
# 34 TFLOP/s f64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12,
            "float16": 67e12}
# operations per element: welford = 2 sub + 2 fma (2 each) + min + max;
# stats = add + fma (2) + min + max; a window of w taps = w products and
# w - 1 sums; decode_sum = multiply + add + the sum's add
# map_reduce (the main path's v + 1) = the map's add + the sum's add
OPS_PER_ELEMENT = {"fused_welford": 8, "fused_stats": 5,
                   "fused_decode_sum": 3, "fused_map_reduce": 2}
REPLACES = {"fused_welford": "bolt_tpu/ops/kernels.py:188",
            "fused_stats": "bolt_tpu/ops/kernels.py:141",
            "sepfilter1d": "bolt_tpu/ops/kernels.py:534",
            "lane_band": "bolt_tpu/ops/kernels.py:395",
            "fused_decode_sum": "bolt_tpu/ops/kernels.py:308",
            "fused_map_reduce": "bolt_tpu/ops/kernels.py:110"}
SOURCE = {"fused_welford": "bolt_tpu_torch/ops/csrc/moments.cu",
          "fused_stats": "bolt_tpu_torch/ops/csrc/moments.cu",
          "sepfilter1d": "bolt_tpu_torch/ops/csrc/window.cu",
          "lane_band": "bolt_tpu_torch/ops/csrc/window.cu",
          "fused_decode_sum": "bolt_tpu_torch/ops/csrc/codec.cu",
          "fused_map_reduce": "bolt_tpu_torch/ops/csrc/mapreduce.cu"}
CONFIG1 = (200, 200, 64, 64)
NORTH_STAR = (3200, 200, 64, 64)
# fam_halo_gaussian (scripts/perf_regress.py): gaussian(sigma=2.0,
# axis=(0, 1), size="64") over a (64, 2048, 4096) f32 stack, seed 6
IMAGING = (64, 2048, 4096)
WINDOW_MODES = ("constant", "reflect", "edge", "symmetric")
# numpy.pad mode -> scipy.ndimage's name for it
SCIPY_MODE = {"constant": "constant", "reflect": "mirror", "edge": "nearest",
              "symmetric": "reflect"}
# the streamed north-star: records of the default 64 MiB slab and the seed
# of each record's generator (np.random.default_rng(STREAM_SEED + record))
SLAB_RECORDS = 20
STREAM_SEED = 7
# peak device memory a streamed run of the 10.49 GB source may reach
STREAM_PEAK_BYTES = 2e9
# peak device memory growth allowed to the north-star map(v + 1).sum()
FUSED_SUM_PEAK_BYTES = 1e9


def check(cond, what):
    if not cond:
        raise AssertionError("chip_smoke check failed: %s" % what)


def log(msg):
    print(msg, flush=True)


def card_line():
    """``name, power.limit`` as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: %s" % out.stderr)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_us(fn):
    """``fn()`` under ``torch.profiler``: its result, and the device time
    in microseconds of the kernels and of the copies it ran on any
    stream (``None`` where the profiler saw none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kern = copy = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue        # host ops: their kernels are rows of their own
        if "memcpy" in e.key.lower():
            copy += e.self_device_time_total
        else:
            kern += e.self_device_time_total
    return out, kern or None, copy or None


def f64_column_refs(x, chunk=4096):
    """Column-wise sums of ``v + 1``, ``|v + 1|``, ``|2v + 1|`` and ``|v|``,
    sums of squares, mean, var, min and max of an (n, C) tensor over axis
    0, in f64 on the card, ``chunk`` columns at a time."""
    import torch
    parts = {k: [] for k in ("sum1", "abs1", "abs21", "abs", "sq", "mean",
                             "var", "min", "max")}
    for j in range(0, x.shape[1], chunk):
        d = x[:, j:j + chunk].double()
        parts["sum1"].append((d + 1).sum(0))
        parts["abs1"].append((d + 1).abs().sum(0))
        parts["abs21"].append((2 * d + 1).abs().sum(0))
        parts["abs"].append(d.abs().sum(0))
        parts["sq"].append((d * d).sum(0))
        parts["mean"].append(d.mean(0))
        parts["var"].append(d.var(0, correction=0))
        parts["min"].append(d.amin(0))
        parts["max"].append(d.amax(0))
        del d
    return {k: torch.cat(v, 0) for k, v in parts.items()}


def close(got, want, rtol, atol, what):
    got = got.double()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    check(not bool(bad.any()), "%s: max abs err %.3g" % (what, err.max()))
    return float(err.max())


def sum_close(got, ref, n, what):
    """An f32 sum of ``v + 1`` over ``n`` terms per element against its f64
    reference: |err| <= 4 sqrt(n) 2^-24 sum|v + 1| (a few standard
    deviations of the rounding error of any summation order)."""
    err = (got.double() - ref["sum1"]).abs()
    tol = 4 * math.sqrt(n) * 2.0 ** -24 * ref["abs1"]
    check(bool((err <= tol).all()), "%s: max abs err %.3g"
          % (what, float(err.max())))
    return float(err.max())


def gaussian_taps(sigma, truncate=4.0):
    """``ops.gaussian``'s taps (scipy.ndimage's construction)."""
    import numpy as np
    radius = int(truncate * sigma + 0.5)
    grid = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = np.exp(-0.5 * (grid / sigma) ** 2)
    return [float(t) for t in taps / taps.sum()]


def scipy_records(x, recs, taps_per_axis, mode):
    """``scipy.ndimage.correlate1d`` over the value axes of records
    ``recs`` of the card tensor ``x``, in f64 on the host."""
    import numpy as np
    from scipy import ndimage
    out = []
    for k in recs:
        r = x[k].double().cpu().numpy()
        for ax, taps in taps_per_axis:
            r = ndimage.correlate1d(r, np.asarray(taps), axis=ax,
                                    mode=SCIPY_MODE[mode])
        out.append(r)
    return np.stack(out)


def measured(torch, fn):
    """``fn()``, its synchronised wall in seconds and the growth of peak
    device memory over what was allocated before it, in bytes."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, torch.cuda.max_memory_allocated() \
        - base


def north_star_map_reduce(bolt, ops, K, torch, b, x, ref, report):
    """Phase 3's ``fused_map_reduce`` steps at the north-star: the main
    path's ``map(v + 1).sum()`` (one launch; wall and peak growth beside the
    torch path's), the full-form export and a chain that does not compile;
    returns the largest error."""
    from bolt_tpu_torch.gpu.array import _reduce_stat
    n = NORTH_STAR[0]

    def plus1(v):
        return v + 1

    before = K.LAUNCHES["fused_map_reduce"]
    s, wall, grow = measured(torch, lambda: b.map(plus1).sum())
    check(K.LAUNCHES["fused_map_reduce"] == before + 1,
          "north-star map(v+1).sum() launched fused_map_reduce %d times"
          % (K.LAUNCHES["fused_map_reduce"] - before))
    # the same callable again: its program comes from the compiler's cache,
    # so this wall has no trace in it
    _, cached_wall, _ = measured(torch, lambda: b.map(plus1).sum())
    check(s.shape == NORTH_STAR[1:] and s.split == 0, "map-sum shape")
    err = sum_close(s.totorch().reshape(-1), ref, n,
                    "north-star map(v+1).sum()")
    check(grow < FUSED_SUM_PEAK_BYTES, "north-star map(v+1).sum() grew the "
          "peak device memory by %.3f GB" % (grow / 1e9))
    del s
    # the same sum through the torch path (the chain under vmap, then
    # torch.sum), as the port ran it before fused_map_reduce
    m = b.map(lambda v: v + 1)
    t, twall, tgrow = measured(torch, lambda: _reduce_stat(
        m._mapped(), "sum", (0,), False, None, m.dtype))
    sum_close(t.reshape(-1), ref, n, "north-star torch-path map-sum")
    del t, m
    report["map_sum"] = {"fused_wall_s": wall, "fused_cached_wall_s":
                         cached_wall, "fused_peak_growth_gb": grow / 1e9,
                         "torch_path_wall_s": twall,
                         "torch_path_peak_growth_gb": tgrow / 1e9}
    log("north-star map(v+1).sum(): fused_map_reduce %.4f s (%.4f s with "
        "the program cached), peak growth %.4f GB; torch path (vmap chain + "
        "torch.sum) %.4f s, peak growth %.4f GB"
        % (wall, cached_wall, grow / 1e9, twall, tgrow / 1e9))
    # the ops export, full form: sum(2v + 1) = 2 sum(v + 1) - numel, within
    # 1e-6 of sum|2v + 1|
    before = K.LAUNCHES["fused_map_reduce"]
    full = float(ops.fused_map_reduce(x, lambda v: v * 2 + 1))
    check(K.LAUNCHES["fused_map_reduce"] == before + 1,
          "ops.fused_map_reduce did not launch its kernel once")
    want = 2 * float(ref["sum1"].sum()) - x.numel()
    d = abs(full - want)
    check(d <= 1e-6 * float(ref["abs21"].sum()),
          "north-star ops.fused_map_reduce: err %.3g of %.6g" % (d, want))
    err = max(err, d / float(ref["abs21"].sum()))
    # a chain that does not compile (a reduction inside the map) takes the
    # torch path: same sum as an f64 reference, no launch
    before = K.LAUNCHES["fused_map_reduce"]
    c = b.map(lambda v: v - v.mean()).sum().totorch().reshape(-1)
    check(K.LAUNCHES["fused_map_reduce"] == before,
          "a chain that does not compile launched fused_map_reduce")
    xv = x.view(n, -1)
    rowmean = torch.cat([xv[i:i + 200].double().mean(1)
                         for i in range(0, n, 200)])
    cref = (ref["sum1"] - n) - float(rowmean.sum())
    cerr = (c.double() - cref).abs()
    tol = 4 * math.sqrt(n) * 2.0 ** -24 * (ref["abs"] + float(
        rowmean.abs().sum()))
    check(bool((cerr <= tol).all()), "north-star map(v - v.mean()).sum(): "
          "max abs err %.3g" % float(cerr.max()))
    return err


def config4_north_star(bolt, K, torch, b, x, report):
    """Config 4 at the north-star: ``map(v + 1).filter(v.mean() > 1)`` with
    ``sum()`` and ``mean()`` through one masked ``fused_map_reduce`` launch
    each, against f64 references of the same mask; an all-False filter."""
    from bolt_tpu_torch.gpu.array import _pred_mask
    n = NORTH_STAR[0]

    def pred(v):
        return v.mean() > 1

    mask = _pred_mask(pred, x + 1)
    count = int(mask.sum())
    check(0 < count < n, "config 4 survivors: %d of %d" % (count, n))
    xv = x.view(n, -1)
    rsum, rabs = [], []
    for j in range(0, xv.shape[1], 4096):
        d = xv[mask, j:j + 4096].double() + 1
        rsum.append(d.sum(0))
        rabs.append(d.abs().sum(0))
        del d
    ref = {"sum1": torch.cat(rsum), "abs1": torch.cat(rabs)}
    out = {}
    for name in ("sum", "mean"):
        before = K.LAUNCHES["fused_map_reduce"]
        got, wall, grow = measured(torch, lambda: getattr(
            b.map(lambda v: v + 1).filter(pred), name)())
        check(K.LAUNCHES["fused_map_reduce"] == before + 1,
              "config 4 filter().%s() launched fused_map_reduce %d times"
              % (name, K.LAUNCHES["fused_map_reduce"] - before))
        check(got.shape == NORTH_STAR[1:], "config 4 %s shape" % name)
        g = got.totorch().reshape(-1)
        out[name] = {"wall_s": wall, "peak_growth_gb": grow / 1e9,
                     "max_abs_err": float((g.double() - (
                         ref["sum1"] if name == "sum"
                         else ref["sum1"] / count)).abs().max())}
        if name == "sum":
            sum_close(g, ref, count, "config 4 filter().sum()")
        else:
            sum_close(g * count, ref, count, "config 4 filter().mean()")
        del got, g
    # every record dropped: (0, ...) shape, a zero sum, max() refused
    def never(v):
        return v.mean() > 1e9

    zero = b.filter(never).sum().totorch()
    check(bool((zero == 0).all()), "all-False filter().sum() is not zero")
    try:
        b.filter(never).max()
    except ValueError:
        pass
    else:
        check(False, "all-False filter().max() did not raise ValueError")
    check(b.filter(never).shape == (0,) + NORTH_STAR[1:],
          "all-False filter shape")
    report["config4_north_star"] = {"survivors": count, "runs": out}
    log("config 4 at the north-star: %d of %d records survive; %s"
        % (count, n, json.dumps(out)))


def every_opcode_programs(torch):
    """Functions whose programs together use every opcode of
    ``bolt_tpu_torch/ops/mapexpr.py`` (a program holds at most 32
    instructions, fewer than the opcodes)."""
    def arith(v):
        a = torch.abs(v) + 0.5
        w = (v * 1.5 - 0.25) * (v - a) / (a + 1) - (0.75 - v) / 3 - v
        return torch.maximum(w, v) + torch.minimum(w, -v)

    def unary(v):
        a = torch.abs(v) + 0.5
        w = torch.sqrt(a) + torch.rsqrt(a) + torch.exp(-v * v) + torch.log(a)
        w = w + torch.tanh(v) + torch.sigmoid(v) + 2 / a + a ** 1.5
        return torch.clamp(w, -50.0, 50.0) + torch.relu(v)

    def trig(v):
        return torch.sin(v) * torch.cos(v) + v ** 2 + v ** 3

    def compare(v):
        w = v * 0.5
        c = v > 0.25
        out = torch.where(c, v, 1.0) + torch.where(c, 2.0, w)
        out = out + torch.where(v >= w, v, w) + torch.where(v < w, 1.0, w)
        out = out + torch.where(v <= w, w, v) + torch.where(v == w, v, 0.0)
        return out + torch.where(v != w, w, 0.5)

    def compare_number(v):
        w = v * 0.5
        out = torch.where(v >= 0.5, v, w) + torch.where(v < -0.5, v, w)
        out = out + torch.where(v <= 0.1, w, v) + torch.where(v == 0.0, w, v)
        return out + torch.where(v != 1.0, v, w) + torch.where(v > w, w, v)

    return {"arith": arith, "unary": unary, "trig": trig, "compare": compare,
            "compare_number": compare_number}


def map_reduce_cases(K, mapexpr, torch, dev, xv, report):
    """``fused_map_reduce`` in both forms against its plain version: at the
    north-star in f32 and a bf16 copy, at config 1 in f64, at an odd ``n``
    and width through a misaligned view, with a masked NaN record, and on
    programs that together use every opcode (f32 ``rtol=1e-5, atol=1e-3``,
    f64 ``1e-10``, bf16 ``1.6e-2``: the kernel sums in another order; full
    forms within ``1e-6`` of the sum of magnitudes).  Returns the largest
    column difference and the rows of the cases."""
    gen = torch.Generator(device=dev).manual_seed(15)
    flat = torch.randn(1 + 37 * 1001, generator=gen, device=dev)
    nanx = torch.randn((64, 4096), generator=gen, device=dev)
    nanx[5] = float("nan")
    keep = torch.ones(64, dtype=torch.bool, device=dev)
    keep[5] = False
    keep[9] = False
    v1 = lambda v: v + 1            # noqa: E731
    v21 = lambda v: v * 2 + 1       # noqa: E731
    cases = [("north_star", xv, v1, None), ("north_star_bf16",
             xv.to(torch.bfloat16), v1, None),
             ("config1_f64", xv[:200].double(), v21, None),
             ("misaligned_37x1001", flat[1:].view(37, 1001), v21, None),
             ("masked_nan_64x4096", nanx, v1, keep)]
    for name, f in every_opcode_programs(torch).items():
        cases.append(("opcodes_%s" % name, xv[:64, :8192], f, None))

    def product8(v):
        # eight registers live at once: the largest register file, and so
        # the narrower tile
        t = [v + i * 0.25 for i in range(1, 8)]
        out = t[0]
        for u in t[1:]:
            out = out * u
        return out + v

    # rows that are not a multiple of any tile's
    cases.append(("file8_1027x8192", xv[:1027, :8192], product8, None))
    used, err, rows = set(), 0.0, []
    tol = {torch.float32: (1e-5, 1e-3), torch.float64: (1e-10, 1e-9),
           torch.bfloat16: (1.6e-2, 1.6e-2)}
    for label, xt, f, mask in cases:
        prog = mapexpr.compile((f,), tuple(xt.shape[1:]), xt.dtype)
        check(prog is not None, "%s: the map does not compile" % label)
        used.update(i.op for i in prog.instrs)
        before = K.LAUNCHES["fused_map_reduce"]
        got = K.fused_map_reduce_cols(xt, prog, mask)
        want = K._fused_map_reduce_plain(xt, prog, mask, cols=True)
        fprog = mapexpr.compile((f,), tuple(xt.shape), xt.dtype)
        gfull = float(K.fused_map_reduce_program(xt, fprog))
        wfull = float(K._fused_map_reduce_plain(xt, fprog))
        torch.cuda.synchronize()
        check(K.LAUNCHES["fused_map_reduce"] == before + 2,
              "%s: not one launch a form" % label)
        rtol, atol = tol[xt.dtype]
        d = (got.double() - want.double()).abs()
        check(bool(torch.isfinite(got).all())
              and bool((d <= atol + rtol * want.double().abs()).all()),
              "fused_map_reduce %s: max abs diff %.3g" % (label,
                                                           float(d.max())))
        if mask is None:       # (the masked case's full form sums a NaN)
            mag = float(mapexpr.evaluate(fprog, xt).abs().sum(
                dtype=torch.float64))
            fd = abs(gfull - wfull)
            check(fd <= max(1e-6, rtol) * mag + atol,
                  "fused_map_reduce %s full form: %r vs %r" % (label, gfull,
                                                              wfull))
        err = max(err, float(d.max()))
        rows.append({"case": label, "shape": list(xt.shape),
                     "dtype": str(xt.dtype), "max_abs_err": float(d.max()),
                     "full": gfull, "full_plain": wfull,
                     "instructions": len(prog.instrs)})
        log("fused_map_reduce %-22s max_abs_diff %.3g full %r vs %r"
            % (label, float(d.max()), gfull, wfull))
        del got, want
    missing = sorted(set(range(len(mapexpr.OPS))) - used)
    check(not missing, "opcodes no case used: %s"
          % [mapexpr.OPS[i] for i in missing])
    del cases, flat, nanx
    return err, rows


def probe_tool():
    """``tools/mapreduce_probe.py`` as a module: its programs time the
    kernel by program length."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "mapreduce_probe", os.path.join(ROOT, "tools", "mapreduce_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def map_reduce_timings(K, mapexpr, torch, xv, launches, report):
    """``fused_map_reduce`` timed at the north-star: the column form with the
    main path's ``v + 1`` beside its plain version, ``torch.sum(x, 0)`` (the
    library call for the identity) and the two-call ``(x + 1).sum(0)``; the
    full form with ``v * 2 + 1`` beside its plain version and
    ``torch.sum(x)``; then the column form by program length, with the
    programs of ``tools/mapreduce_probe.py`` (into the report's
    ``map_reduce_by_program``)."""
    n_el = xv.numel()
    cols = mapexpr.compile((lambda v: v + 1,), tuple(xv.shape[1:]),
                           xv.dtype)
    full = mapexpr.compile((lambda v: v * 2 + 1,), tuple(xv.shape),
                           xv.dtype)
    out = {}
    for label, run, plain, library, out_bytes, ops in (
            ("north_star_cols", lambda: K.fused_map_reduce_cols(xv, cols),
             lambda: K._fused_map_reduce_plain(xv, cols, cols=True),
             lambda: torch.sum(xv, 0), 4 * xv.shape[1], 2),
            ("north_star_full", lambda: K.fused_map_reduce_program(xv, full),
             lambda: K._fused_map_reduce_plain(xv, full),
             lambda: torch.sum(xv), 4, 3)):
        t_bytes = (4 * n_el + out_bytes) / HBM_BYTES_PER_S
        t_ops = ops * n_el / PEAK_OPS["float32"]
        row = {"ms": timed_ms(run, 10), "plain_ms": timed_ms(plain, 3),
               "library_ms": timed_ms(library, 10),
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if label == "north_star_cols":
            row["two_call_ms"] = timed_ms(lambda: (xv + 1).sum(0), 5)
        out[("fused_map_reduce", label)] = row
        log("fused_map_reduce %-15s kernel_ms %.4f plain_ms %.4f library_ms "
            "%.4f%s bound_ms %.4f (%s) launches %d" % (
                label, row["ms"], row["plain_ms"], row["library_ms"],
                " two_call_ms %.4f" % row["two_call_ms"]
                if "two_call_ms" in row else "", row["bound_ms"],
                row["bound_by"], launches["fused_map_reduce"]))
    gen = torch.Generator(device=xv.device).manual_seed(0)
    rows = probe_tool().map_reduce_rows(torch, K, mapexpr, xv, gen)
    report["map_reduce_by_program"] = rows
    for row in rows:
        log("fused_map_reduce by program %-16s instructions %s ms %.4f "
            "bound_ms %.4f" % (row["map"] if "map" in row else row["kernel"],
                               row.get("instructions", "-"), row["ms"],
                               row["bound_ms"]))
    return out


def imaging_phase(bolt, ops, K, torch, np, dev, report):
    """Phase 4, the imaging path at full width; returns its launches, the
    input tensor (for the kernel timings), the gaussian's taps and the
    pixel series ``z`` as the ``(pixels, 64)`` input its ``stats()`` gave
    ``fused_welford``."""
    from scipy import ndimage, signal
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    b = bolt.randn(IMAGING, mode="gpu", dtype=np.float32, seed=6)
    x = b.totorch()
    torch.cuda.synchronize()
    recs = [int(k) for k in np.random.RandomState(6).choice(
        IMAGING[0], 4, replace=False)]
    taps = gaussian_taps(2.0)
    check(len(taps) == 17, "gaussian sigma 2 has 17 taps")

    steps = {}

    def step(name, fn):
        """Run one step of the path and keep its wall time, synchronised
        (the breakdown of PERF.md section 5)."""
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t
        return out

    conv_taps = [0.05, -0.1, 0.2, 0.6, 0.15, 0.06, 0.04]
    K.reset_launches()
    g = step("gaussian", lambda: ops.gaussian(b, sigma=2.0, axis=(0, 1),
                                              size="64"))
    sm = step("smooth", lambda: ops.smooth(b, 5, mode="reflect"))
    cv = step("convolve", lambda: ops.convolve(b, conv_taps,
                                               mode="symmetric"))
    med = step("median_filter", lambda: ops.median_filter(b[:4], 3,
                                                          axis=(0, 1)))
    s = step("swap", lambda: g.swap((0,), (0, 1)))
    z = step("detrend_zscore", lambda: ops.zscore(ops.detrend(s, order=1),
                                                  epsilon=1e-9))
    st = step("stats", z.stats)       # runs the deferred detrend + zscore
    launches = dict(K.LAUNCHES)
    wall = sum(steps.values())
    log("imaging path launches: %s" % json.dumps(launches))
    for name in ("sepfilter1d", "lane_band", "fused_welford"):
        check(launches[name] >= 1, "imaging path never launched %s" % name)

    # gaussian against the plain versions applied per axis, bit for bit
    gt = g.totorch()
    check(g.shape == IMAGING and g.split == 1 and gt.dtype == torch.float32,
          "imaging gaussian shape/dtype")
    want = K._sepfilter1d_plain(K._sepfilter1d_plain(x, taps, 1, "constant"),
                                taps, 2, "constant")
    check(torch.equal(gt, want), "imaging gaussian differs from its plain "
          "versions (max abs diff %.3g)" % float((gt - want).abs().max()))
    del want
    errs = {}
    for label, got, tpa, mode in (
            ("gaussian", gt, [(0, taps), (1, taps)], "constant"),
            ("smooth", sm.totorch(), [(0, [0.2] * 5), (1, [0.2] * 5)],
             "reflect"),
            ("convolve", cv.totorch(), [(0, conv_taps), (1, conv_taps)],
             "symmetric")):
        ref = scipy_records(x, recs, tpa, mode)
        mine = got[recs].double().cpu().numpy()
        np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-6,
                                   err_msg="imaging %s vs scipy" % label)
        errs[label] = float(np.abs(mine - ref).max())
    del sm, cv
    x4 = x[:4].cpu().numpy()
    med_ref = np.stack([ndimage.median_filter(r, size=3, mode="reflect")
                        for r in x4])
    check(med.shape == (4,) + IMAGING[1:]
          and np.array_equal(med.toarray(), med_ref),
          "imaging median_filter vs scipy")
    del med, med_ref, x4

    # pixel time series: swap, detrend + zscore, stats
    check(s.shape == (IMAGING[1], IMAGING[2], IMAGING[0]) and s.split == 2,
          "imaging swap shape/split")
    zt = z.totorch()
    rs = np.random.RandomState(6)
    ii = rs.randint(0, IMAGING[1], 1024)
    jj = rs.randint(0, IMAGING[2], 1024)
    series = s.totorch()[ii, jj].double().cpu().numpy()
    d = signal.detrend(series, axis=1, type="linear")
    zref = (d - d.mean(axis=1, keepdims=True)) / (d.std(axis=1,
                                                          keepdims=True)
                                                   + 1e-9)
    zmine = zt[ii, jj].double().cpu().numpy()
    np.testing.assert_allclose(zmine, zref, rtol=1e-4, atol=1e-5,
                               err_msg="imaging zscore(detrend) vs numpy")
    errs["zscore_detrend"] = float(np.abs(zmine - zref).max())
    # stats() against numpy f64 on the downloaded series, two passes in
    # row chunks; mean and variance within a few standard deviations of
    # the f32 rounding of n terms (4 sqrt(n) 2^-24 of the mean magnitude)
    zh = zt.cpu().numpy().reshape(-1, IMAGING[0])
    n = zh.shape[0]
    tot, mn, mx, absm = 0.0, None, None, 0.0
    for i in range(0, n, 1 << 20):
        c = zh[i:i + (1 << 20)].astype(np.float64)
        tot = tot + c.sum(axis=0)
        absm = absm + np.abs(c).sum(axis=0)
        mn = c.min(axis=0) if mn is None else np.minimum(mn, c.min(axis=0))
        mx = c.max(axis=0) if mx is None else np.maximum(mx, c.max(axis=0))
    mean = tot / n
    m2, sq = 0.0, 0.0
    for i in range(0, n, 1 << 20):
        c = zh[i:i + (1 << 20)].astype(np.float64)
        m2 = m2 + ((c - mean) ** 2).sum(axis=0)
        sq = sq + (c * c).sum(axis=0)
    bound = 4 * math.sqrt(n) * 2.0 ** -24
    check(st.count() == n, "imaging stats count")
    check(bool((np.abs(st.mean() - mean) <= bound * absm / n + 1e-7).all()),
          "imaging stats mean: max abs err %.3g"
          % float(np.abs(st.mean() - mean).max()))
    check(bool((np.abs(st.variance() - m2 / n) <= bound * sq / n + 1e-7)
               .all()), "imaging stats variance: max abs err %.3g"
          % float(np.abs(st.variance() - m2 / n).max()))
    check(np.array_equal(st.min(), mn.astype(np.float32))
          and np.array_equal(st.max(), mx.astype(np.float32)),
          "imaging stats min/max")
    errs["stats_mean"] = float(np.abs(st.mean() - mean).max())
    errs["stats_var"] = float(np.abs(st.variance() - m2 / n).max())
    zv = zt.reshape(n, IMAGING[0])
    del zh, zt, z, s, g, gt, st
    torch.cuda.synchronize()
    report["imaging"] = {"path_s": wall, "steps_s": steps, "errors": errs,
                         "launches": launches,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    report["phases"]["imaging_s"] = time.perf_counter() - t0
    log("imaging phase ok in %.1f s (path %.3f s, peak %.1f GB): %s"
        % (report["phases"]["imaging_s"], wall,
           report["imaging"]["peak_gb"], json.dumps(errs)))
    log("imaging path steps (s, synchronised): %s" % json.dumps(steps))
    return launches, b, taps, zv


def window_cases(K, torch, dev, x, taps):
    """Both window kernels against their plain versions: at full width in
    every mode (f32, bit for bit), and in f64 (bit for bit) and bf16
    (1.6e-2) at a smaller size; returns the largest difference of each."""
    gen = torch.Generator(device=dev).manual_seed(12)
    small = torch.randn((8, 512, 1000), generator=gen, device=dev)
    cases = [("imaging_f32", x), ("8x512x1000_f64", small.double()),
             ("8x512x1000_bf16", small.to(torch.bfloat16))]
    err = {"sepfilter1d": 0.0, "lane_band": 0.0}
    rows = []
    for label, xt in cases:
        for ax, name in ((1, "sepfilter1d"), (2, "lane_band")):
            for mode in WINDOW_MODES:
                got = K.sepfilter1d(xt, taps, ax, mode=mode)
                want = K._sepfilter1d_plain(xt, taps, ax, mode)
                torch.cuda.synchronize()
                d = float((got.double() - want.double()).abs().max())
                if xt.dtype in (torch.float32, torch.float64):
                    check(torch.equal(got, want), "%s %s %s: not bit for bit "
                          "(max abs diff %.3g)" % (name, label, mode, d))
                else:
                    check(d <= 1.6e-2 * (1 + float(want.abs().max())),
                          "%s %s %s: max abs diff %.3g" % (name, label,
                                                           mode, d))
                err[name] = max(err[name], d)
                rows.append({"kernel": name, "case": label, "mode": mode,
                             "max_abs_err": d})
                del got, want
            log("%s %-16s every mode ok" % (name, label))
    lb = K.lane_band(x, taps)
    check(torch.equal(lb, K._lane_band_plain(x, taps)), "lane_band entry")
    del lb, small, cases
    return err, rows


def decode_sum_cases(K, torch, dev):
    """``fused_decode_sum`` against its plain version at the streamed
    slab, the whole north-star wire and the odd shapes (f32 ``rtol=1e-5,
    atol=1e-3``: the kernel sums in another order), then timed at the slab
    and the wire beside its plain version, the decode route's torch
    expression (decode, then ``sum(0)``: no single PyTorch call computes
    the function) and its bound.  Returns the largest difference, the
    cases and the timings by shape."""
    from bolt_tpu_torch.gpu import codec as C
    gen = torch.Generator(device=dev).manual_seed(14)
    n, cols = NORTH_STAR[0], math.prod(NORTH_STAR[1:])
    wire = torch.randint(0, 256, (n, cols), generator=gen, device=dev,
                         dtype=torch.uint8)
    flat = wire.view(-1)
    signed = torch.randint(-128, 128, (300, 4096), generator=gen,
                           device=dev, dtype=torch.int8)
    scale = torch.tensor(0.0431, device=dev)
    zp = torch.tensor(-5.37, device=dev)
    cases = [("slab", wire[:SLAB_RECORDS]), ("wire", wire),
             ("int8_300x4096", signed), ("one_row", wire[:1]),
             ("ragged_37x1001", flat[:37 * 1001].view(37, 1001)),
             ("misaligned_64x1000", flat[1:1 + 64 * 1000].view(64, 1000)),
             ("narrow_16x1024", flat[:16 * 1024].view(16, 1024))]
    # one row of every byte value: each sum is one decoded value, so the
    # conversion equals the plain version's bit for bit (the short-slab
    # form at the slab's width, row lanes at 4096)
    for dt, lo in ((torch.uint8, 0), (torch.int8, -128)):
        every = torch.arange(lo, lo + 256, device=dev,
                             dtype=torch.int32).to(dt)
        for width in (cols, 4096):
            q = every.repeat(width // 256).view(1, width)
            check(torch.equal(K.fused_decode_sum(q, scale, zp),
                              K._fused_decode_sum_plain(q, scale, zp)),
                  "fused_decode_sum %s conversion of every byte at %d "
                  "columns" % (dt, width))
    log("fused_decode_sum decoded values equal the plain version's bit for "
        "bit on all 256 byte values of uint8 and int8")
    err, rows = 0.0, []
    for label, q in cases:
        got = K.fused_decode_sum(q, scale, zp)
        want = K._fused_decode_sum_plain(q, scale, zp)
        torch.cuda.synchronize()
        d = float((got - want).abs().max())
        check(got.shape == q.shape[1:] and bool(torch.allclose(
            got, want, rtol=1e-5, atol=1e-3)),
            "fused_decode_sum %s: max abs diff %.3g" % (label, d))
        err = max(err, d)
        rows.append({"case": label, "shape": list(q.shape),
                     "dtype": str(q.dtype), "max_abs_err": d})
        log("fused_decode_sum %-20s max_abs_diff %.3g" % (label, d))
        del got, want
    int8 = C.get("int8")
    timings = {}
    # the slab case walks the wire's 160 slabs in turn, so every launch
    # reads its slab from device memory (a slab fits in the 50 MB L2)
    slabs = [wire[i:i + SLAB_RECORDS] for i in range(0, n, SLAB_RECORDS)]
    for label, qs, reps in (("slab", slabs, 50), ("wire", [wire], 5)):
        q = qs[0]
        turn = itertools.cycle(qs)
        t_bytes = (q.numel() + 4 * q[0].numel()) / HBM_BYTES_PER_S
        t_ops = OPS_PER_ELEMENT["fused_decode_sum"] * q.numel() / PEAK_OPS[
            "float32"]
        row = {"ms": timed_ms(lambda: K.fused_decode_sum(
                   next(turn), scale, zp), reps),
               "plain_ms": timed_ms(lambda: K._fused_decode_sum_plain(
                   next(turn), scale, zp), reps),
               "decode_route_ms": timed_ms(lambda: int8.decode(
                   next(turn), (scale, zp), torch.float32).sum(0), reps),
               "library_ms": None,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        # the kernels' own device time, beside the launch loop's ms
        _, dev_us, _ = device_us(lambda: [K.fused_decode_sum(
            next(turn), scale, zp) for _ in range(reps)])
        row["device_ms"] = None if dev_us is None else dev_us / reps / 1e3
        # the launch loop's share that the device does not account for:
        # the host's (Python, ctypes, the launch itself)
        row["host_share"] = None if dev_us is None else \
            1.0 - row["device_ms"] / row["ms"]
        timings[label] = row
        log("fused_decode_sum %-5s %s kernel_ms %.4f (device %s, host share "
            "%s) plain_ms %.4f decode_route_ms %.4f bound_ms %.4f (%s)" % (
                label, "x".join(map(str, q.shape)), row["ms"],
                "not measured" if row["device_ms"] is None
                else "%.4f" % row["device_ms"],
                "not measured" if row["host_share"] is None
                else "%.3f" % row["host_share"], row["plain_ms"],
                row["decode_route_ms"], row["bound_ms"], row["bound_by"]))
    del wire, flat, signed, cases, slabs
    return err, rows, timings


def stream_phase(bolt, K, torch, np, dev, report):
    """Phase 6, the streamed north-star; returns the path's launches."""
    from bolt_tpu_torch import engine, stream
    from bolt_tpu_torch._precision import codec_bound
    t0 = time.perf_counter()
    rec = NORTH_STAR[1:]

    def cb(index):
        lo, hi = index[0].start, index[0].stop
        out = np.empty((hi - lo,) + rec, np.float32)
        for r in range(lo, hi):
            out[r - lo] = np.random.default_rng(STREAM_SEED + r) \
                .standard_normal(rec, dtype=np.float32)
        return out

    def source(codec=None):
        return bolt.fromcallback(cb, NORTH_STAR, mode="gpu",
                                 dtype=np.float32, codec=codec)

    n = NORTH_STAR[0]
    nslabs = len(source()._stream.slab_ranges())
    check(source()._stream.slab == SLAB_RECORDS and nslabs == -(
        -n // SLAB_RECORDS), "streamed north-star slab plan")
    with stream.uploaders(4):
        # the f64 references of the same source, materialised on the card
        # (the pool produces its slabs) and freed before the streamed runs
        t = time.perf_counter()
        mat = source()
        x = mat.totorch()
        check(tuple(x.shape) == NORTH_STAR and not mat.streaming,
              "streamed source materialised")
        ref = f64_column_refs(x.view(n, -1))
        lo_all, hi_all = float(ref["min"].min()), float(ref["max"].max())
        del x, mat
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        report["stream_materialise_s"] = time.perf_counter() - t
        log("streamed source materialised and its f64 references taken in "
            "%.1f s; %.3f GB resident after freeing it"
            % (report["stream_materialise_s"],
               torch.cuda.memory_allocated() / 1e9))

        runs = {}

        def run(label, fn, profiled=False):
            """One streamed run: its result, and its wall, bytes, link
            seconds, overlap share and peak device memory; ``profiled``
            also takes the device's busy time (kernels and copies) from
            ``torch.profiler``."""
            c0 = engine.counters()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            if profiled:
                out, kern_us, copy_us = device_us(
                    lambda: fn().totorch().reshape(-1))
            else:
                out, kern_us, copy_us = fn().totorch().reshape(-1), None, None
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            c1 = engine.counters()
            d = {k: c1[k] - c0[k] for k in c1}
            peak = torch.cuda.max_memory_allocated()
            runs[label] = {
                "wall_s": wall, "slabs": d["stream_chunks"],
                "raw_bytes": d["codec_bytes_raw"] or 4 * math.prod(
                    NORTH_STAR),
                "wire_bytes": d["transfer_bytes"],
                "link_s": d["transfer_seconds"],
                "ingest_s": d["stream_ingest_seconds"],
                "compute_s": d["stream_compute_seconds"],
                "overlap_share": d["stream_overlap_seconds"]
                / max(d["stream_ingest_seconds"], 1e-12),
                "peak_gb": peak / 1e9, "resident_before_gb": base / 1e9,
                "device_kernel_s": kern_us and kern_us / 1e6,
                "device_copy_s": copy_us and copy_us / 1e6}
            if profiled:
                log("stream %-12s device busy (profiled, kernels + copies "
                    "on any stream): kernels %s s, copies %s s of %.3f s "
                    "wall" % (label, runs[label]["device_kernel_s"],
                              runs[label]["device_copy_s"], wall))
            log("stream %-12s wall %.3f s, %d slabs, raw %.3f GB, wire "
                "%.3f GB, link %.3f s (summed over workers), overlap share "
                "%.3f, peak %.3f GB (%.3f GB resident before)" % (
                    label, wall, d["stream_chunks"],
                    runs[label]["raw_bytes"] / 1e9, d["transfer_bytes"] / 1e9,
                    d["transfer_seconds"], runs[label]["overlap_share"],
                    peak / 1e9, base / 1e9))
            check(d["stream_chunks"] == nslabs, "%s streamed %d slabs, not "
                  "%d" % (label, d["stream_chunks"], nslabs))
            check(peak < STREAM_PEAK_BYTES, "%s peak device memory %.3f GB"
                  % (label, peak / 1e9))
            return out

        K.reset_launches()
        os.environ.pop("BOLT_CODEC_KERNEL", None)
        errs = {}
        s1 = run("map_sum", lambda: source().map(lambda v: v + 1).sum())
        errs["map_sum"] = sum_close(s1, ref, n, "streamed map(v+1).sum()")
        errs["mean"] = close(run("mean", lambda: source().mean()),
                             ref["mean"], 1e-5, 1e-6, "streamed mean()")
        errs["var"] = close(run("var", lambda: source().var()),
                            ref["var"], 1e-4, 1e-5, "streamed var()")
        raw = run("sum", lambda: source().sum(), profiled=True)
        delta = run("delta_sum", lambda: source("delta-f32").sum())
        check(torch.equal(raw.view(torch.int32), delta.view(torch.int32)),
              "delta-f32 sum() is not bit-identical to the uncompressed "
              "sum()")
        # bf16 mean: within the codec's relative envelope of the mean
        # magnitude (the means of zero-mean data are themselves near 0)
        mb = run("bf16_mean", lambda: source("bf16").mean())
        _, env = codec_bound("bf16")
        dm = (mb.double() - ref["mean"]).abs()
        check(bool((dm <= env * ref["abs"] / n).all()),
              "bf16 mean outside codec_bound: max abs err %.3g"
              % float(dm.max()))
        errs["bf16_mean"] = float(dm.max())
        # int8 sum: half a quantisation step a record, against the raw sum
        bound = (hi_all - lo_all) / 255.0 / 2 * n + 1e-2
        raw_sum = ref["sum1"] - n
        before = K.LAUNCHES["fused_decode_sum"]
        os.environ["BOLT_CODEC_KERNEL"] = "1"
        try:
            armed = run("int8_armed", lambda: source("int8").sum(),
                        profiled=True)
        finally:
            os.environ.pop("BOLT_CODEC_KERNEL", None)
        check(K.LAUNCHES["fused_decode_sum"] - before == nslabs,
              "armed int8 sum launched fused_decode_sum %d times for %d "
              "slabs" % (K.LAUNCHES["fused_decode_sum"] - before, nslabs))
        before = K.LAUNCHES["fused_decode_sum"]
        unarmed = run("int8_decode", lambda: source("int8").sum())
        check(K.LAUNCHES["fused_decode_sum"] == before,
              "the unarmed int8 sum launched fused_decode_sum")
        for label, got in (("int8_armed", armed), ("int8_decode", unarmed)):
            d = float((got.double() - raw_sum).abs().max())
            check(d <= bound, "%s sum: max abs err %.3g > step bound %.3g"
                  % (label, d, bound))
            errs[label] = d
        d = float((armed - unarmed).abs().max())
        check(d <= bound, "armed and unarmed int8 sums differ by %.3g" % d)
        errs["int8_armed_vs_decode"] = d
        try:
            source("bf16").min()
        except ValueError as exc:
            check("order-statistic" in str(exc), "lossy min() refusal text")
        else:
            check(False, "a bf16 stream's min() was not refused")
    launches = dict(K.LAUNCHES)
    check(launches["fused_decode_sum"] == nslabs,
          "streamed path launched fused_decode_sum %d times"
          % launches["fused_decode_sum"])
    report["stream"] = {"runs": runs, "errors": errs, "slabs": nslabs,
                        "launches": launches,
                        "int8_step_bound": bound}
    report["phases"]["stream_s"] = time.perf_counter() - t0
    log("stream phase ok in %.1f s: %s" % (report["phases"]["stream_s"],
                                            json.dumps(errs)))
    log("streamed path launches: %s" % json.dumps(launches))
    return launches


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import bolt_tpu_torch as bolt
    except ImportError as exc:
        print("chip_smoke: bolt_tpu_torch not importable from %s (%s): run "
              "from the root of a checkout" % (ROOT, exc), file=sys.stderr)
        return 2
    import numpy as np
    from bolt_tpu_torch import ops
    from bolt_tpu_torch.ops import _build
    from bolt_tpu_torch.ops import kernels as K
    from bolt_tpu_torch.ops import mapexpr

    warnings.simplefilter("error", bolt.HostFallbackWarning)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"phases": {}}
    t_start = time.perf_counter()

    # ---- phase 1: set-up --------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    report["build_s"] = time.perf_counter() - t0
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("ptxas %s: %s" % (name, line.strip()))
    card = card_line()
    log("card: %s" % card)
    log("built %s in %.1f s" % (sorted(built), report["build_s"]))
    kind = torch.cuda.get_device_name(0)
    report["card"] = card
    dev = torch.device("cuda", 0)

    # ---- phase 2: main path, BASELINE config 1 ----------------------------
    K.reset_launches()
    t0 = time.perf_counter()
    ones = bolt.ones(CONFIG1, mode="gpu", dtype=np.float32)
    s1 = ones.map(lambda v: v + 1).sum().toarray()
    lo = bolt.ones(CONFIG1, dtype=np.float32).map(lambda v: v + 1)
    lo_sum = np.asarray(lo).sum(axis=0)
    bit_exact = bool(np.array_equal(s1, lo_sum))
    total = float(s1.sum(dtype=np.float64))
    log("config1 map(v+1).sum(): total %.1f, bit-exact vs local oracle: %s"
        % (total, bit_exact))
    check(bit_exact and total == 2.0 * np.prod(CONFIG1), "config1 map-sum")
    check(K.LAUNCHES["fused_map_reduce"] == 1,
          "config1 map(v+1).sum() did not launch fused_map_reduce once")
    del ones, lo, lo_sum

    b1 = bolt.randn(CONFIG1, mode="gpu", dtype=np.float32, seed=1)
    xh = b1.toarray()
    want = {"mean": xh.mean(axis=0, dtype=np.float64),
            "var": xh.var(axis=0, dtype=np.float64),
            "min": xh.min(axis=0), "max": xh.max(axis=0)}
    want["std"] = np.sqrt(want["var"])
    for name, (rtol, atol) in (("mean", (1e-5, 1e-6)), ("var", (1e-4, 1e-5)),
                               ("std", (1e-4, 1e-5)), ("min", (0, 0)),
                               ("max", (0, 0))):
        got = getattr(b1, name)().toarray()
        check(got.dtype == np.float32, "config1 %s dtype" % name)
        np.testing.assert_allclose(got, want[name], rtol=rtol, atol=atol)
    st = b1.stats()
    check(st.count() == CONFIG1[0], "config1 stats count")
    np.testing.assert_allclose(st.mean(), want["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.variance(), want["var"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(st.stdev(), want["std"], rtol=1e-4, atol=1e-5)
    check(np.array_equal(st.min(), want["min"])
          and np.array_equal(st.max(), want["max"]), "config1 stats min/max")
    s_fs = [v.item() for v in ops.fused_stats(b1.totorch())]
    np.testing.assert_allclose(s_fs[1], float((xh.astype(np.float64) ** 2)
                                              .sum()), rtol=1e-5)
    sw = b1.swap((0,), (0,))
    check(sw.split == 1 and np.array_equal(sw.toarray(),
                                           np.transpose(xh, (1, 0, 2, 3))),
          "config1 swap")
    del sw
    # the general (halo) chunk path: value blocks (50, 32, 64) with a
    # 2-element halo on the two chunked axes
    halo = b1.chunk(size=(50, 32), axis=(0, 1), padding=(2, 2)).map(
        lambda blk: blk * 2 - blk.mean()).unchunk()
    check(halo.shape == CONFIG1, "config1 halo chunk map shape")
    got = halo.toarray()
    padded = xh[:, 48:102, 0:34]       # block (1, 0) with its halo
    np.testing.assert_allclose(
        got[:, 50:100, 0:32], xh[:, 50:100, 0:32] * 2
        - padded.mean(axis=(1, 2, 3), keepdims=True), rtol=1e-4, atol=1e-4)
    del halo, got, padded
    b5 = bolt.randn((64, 4096, 32), mode="gpu", dtype=np.float32, seed=5)
    sv = b5.chunk(size=(512,), axis=(0,)).map(
        lambda blk: torch.linalg.svdvals(blk)[None, :]).unchunk()
    check(sv.shape == (64, 8, 32), "config5 per-chunk svd shape")
    x5 = b5.toarray()[:2].astype(np.float64)
    want5 = np.stack([[np.linalg.svd(x5[k, 512 * i:512 * (i + 1)],
                                     compute_uv=False) for i in range(8)]
                      for k in range(2)])
    np.testing.assert_allclose(sv.toarray()[:2], want5, rtol=1e-4, atol=1e-4)
    del b5, sv
    # config 4: filter on the keyed axis, against the local oracle
    local4 = bolt.array(xh).filter(lambda v: v.mean() > 0)
    f4 = b1.filter(lambda v: v.mean() > 0)
    check(f4.pending, "config 4 filter is not pending")
    got4 = f4.toarray()
    check(got4.shape == local4.shape and 0 < got4.shape[0] < CONFIG1[0]
          and np.array_equal(got4, local4.toarray()),
          "config 4 filter().toarray() vs the local oracle")
    r4 = b1.filter(lambda v: v.mean() > 0).reduce(add).toarray()
    np.testing.assert_allclose(r4, local4.reduce(add).toarray(), rtol=1e-5,
                               atol=1e-5)
    report["config4_survivors"] = int(got4.shape[0])
    log("config 4 filter at config 1: %d of %d records survive"
        % (got4.shape[0], CONFIG1[0]))
    del b1, xh, f4, got4, r4, local4
    torch.cuda.synchronize()
    report["phases"]["config1_s"] = time.perf_counter() - t0
    log("config1 phase ok in %.1f s" % report["phases"]["config1_s"])

    # ---- phase 3: main path, north-star (10.49 GB) -------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    b = bolt.randn(NORTH_STAR, mode="gpu", dtype=np.float32, seed=0)
    x = b.totorch()
    n = NORTH_STAR[0]
    xv = x.view(n, -1)
    ref = f64_column_refs(xv)
    err_sum = north_star_map_reduce(bolt, ops, K, torch, b, x, ref, report)
    r = b.map(lambda v: v + 1).reduce(add).totorch().reshape(-1)
    err_red = sum_close(r, ref, n, "north-star map(v+1).reduce(add)")
    del r
    before = K.LAUNCHES["fused_welford"]
    st = b.stats()
    check(K.LAUNCHES["fused_welford"] == before + 1,
          "stats() did not launch fused_welford")
    mu = torch.from_numpy(st.mean()).to(dev).reshape(-1)
    var = torch.from_numpy(st.variance()).to(dev).reshape(-1)
    err_mu = close(mu, ref["mean"], 1e-5, 1e-6, "north-star stats mean")
    err_var = close(var, ref["var"], 1e-4, 1e-5, "north-star stats var")
    check(np.array_equal(st.min().reshape(-1), ref["min"].float().cpu()
                         .numpy()) and np.array_equal(
        st.max().reshape(-1), ref["max"].float().cpu().numpy()),
        "north-star stats min/max")
    close(b.mean().totorch().reshape(-1), ref["mean"], 1e-5, 1e-6,
          "north-star mean()")
    close(b.var().totorch().reshape(-1), ref["var"], 1e-4, 1e-5,
          "north-star var()")
    # the ops export over the whole array: sum within 1e-6 of sum|v| (the
    # sum of 2.6e9 zero-mean values is small beside it), sum of squares to
    # rtol 1e-5, extrema exact
    fs = ops.fused_stats(x)
    tot = float(ref["sum1"].sum()) - x.numel()
    check(abs(float(fs[0]) - tot) <= 1e-6 * float(ref["abs1"].sum()),
          "north-star fused_stats sum")
    sq = float(ref["sq"].sum())
    check(abs(float(fs[1]) - sq) <= 1e-5 * sq, "north-star fused_stats sumsq")
    check(float(fs[2]) == float(ref["min"].min())
          and float(fs[3]) == float(ref["max"].max()),
          "north-star fused_stats min/max")
    sw = b.swap((0,), (0,))
    check(sw.shape == (NORTH_STAR[1], n) + NORTH_STAR[2:]
          and sw.totorch().is_contiguous()
          and torch.equal(sw.totorch(), x.permute(1, 0, 2, 3)),
          "north-star swap")
    del sw, st, mu, var
    config4_north_star(bolt, K, torch, b, x, report)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    report["main_path_launches"] = launches
    report["phases"]["north_star_s"] = time.perf_counter() - t0
    report["north_star_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("north-star phase ok in %.1f s (peak %.1f GB): sum err %.3g, "
        "reduce err %.3g, stats mean err %.3g, var err %.3g"
        % (report["phases"]["north_star_s"], report["north_star_peak_gb"],
           err_sum, err_red, err_mu, err_var))
    log("main-path launches: %s" % json.dumps(launches))
    for name in ("fused_welford", "fused_stats", "fused_map_reduce"):
        check(launches[name] > 0, "main path never launched %s" % name)

    # ---- phase 4: the imaging path at full width -------------------------
    img_launches, bimg, taps, zimg = imaging_phase(bolt, ops, K, torch, np,
                                                   dev, report)
    ximg = bimg.totorch()

    # ---- phase 5: kernels against their plain versions --------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = [("north_star", xv), ("config1", xv[:200])]
    for shape, dt in (((64, 100), torch.float32), ((3, 5, 7), torch.float32),
                      ((1000, 333), torch.float32),
                      ((257, 4096), torch.float64),
                      ((256, 4096), torch.bfloat16),
                      ((200, 1000), torch.float16)):
        cases.append(("%s_%s" % ("x".join(map(str, shape)),
                                 str(dt).split(".")[1]),
                      torch.randn(shape, generator=gen, device=dev).to(dt)))
    nan = torch.randn((64, 256), generator=gen, device=dev)
    nan[:, 3] = float("nan")
    cases.append(("64x256_nan_column", nan))
    # the imaging path's input to fused_welford: z.stats() reduces the
    # (2048, 4096) pixel axes of z, so the kernel sees (8388608, 64), whose
    # 64 columns take row lanes, row chunks and the combining kernel
    cases.append(("imaging_z", zimg))
    case_kernels = {"imaging_z": ("fused_welford",)}
    tol = {torch.float64: 1e-10, torch.float32: 1e-4}
    kern = {"fused_welford": (K.fused_welford, K._fused_welford_plain),
            "fused_stats": (K.fused_stats, K._fused_stats_plain)}
    max_err = {k: 0.0 for k in kern}
    report["cases"] = []
    for label, xt in cases:
        for name, (fn, plain) in kern.items():
            if name not in case_kernels.get(label, kern):
                continue
            got, want_ = fn(xt), plain(xt)
            torch.cuda.synchronize()
            err = 0.0
            t = tol.get(xt.dtype, 1.6e-2)
            for g_, w_ in zip(got, want_):
                g_, w_ = g_.double(), w_.double()
                check(torch.equal(g_.isnan(), w_.isnan()),
                      "%s %s: NaN positions differ" % (name, label))
                fin = ~w_.isnan()
                # equal values (an f16 sum of squares overflowing to inf
                # in both) differ by nothing
                d = torch.where(g_[fin] == w_[fin], 0.0,
                                (g_[fin] - w_[fin]).abs())
                if d.numel():
                    check(bool((d <= t + t * w_[fin].abs()).all()),
                          "%s %s: max abs err %.3g" % (name, label,
                                                       float(d.max())))
                    err = max(err, float(d.max()))
            max_err[name] = max(max_err[name], err)
            report["cases"].append({"kernel": name, "case": label,
                                    "shape": list(xt.shape),
                                    "dtype": str(xt.dtype),
                                    "max_abs_err": err})
            log("%s %-22s max_abs_diff %.3g" % (name, label, err))
    del nan

    library = {
        "fused_welford": lambda a: (torch.var_mean(a, 0, correction=0),
                                    torch.aminmax(a, dim=0)),
        "fused_stats": lambda a: (a.sum(), (a * a).sum(),
                                  torch.aminmax(a)),
    }
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    lanes, rpc, chunks = K.welford_rows(zimg.shape[0], zimg.shape[1], 4,
                                        sm_count)
    log("fused_welford imaging_z plan: %d row chunks of %d rows, %d row "
        "lanes a block, then the combining kernel" % (chunks, rpc, lanes))
    report["imaging_welford_plan"] = {"lanes": lanes, "rows_per_chunk": rpc,
                                      "chunks": chunks}
    timings = {}
    path_of = {"north_star": launches, "config1": launches,
               "imaging_z": img_launches}
    for label, xt, reps in (("north_star", xv, 5), ("config1", xv[:200], 20),
                            ("imaging_z", zimg, 10)):
        n_el = xt.numel()
        for name, (fn, plain) in kern.items():
            if name not in case_kernels.get(label, kern):
                continue
            out_bytes = (4 * xt[0].numel() if name == "fused_welford" else 4) \
                * xt.element_size()
            t_bytes = (n_el * xt.element_size() + out_bytes) / HBM_BYTES_PER_S
            t_ops = OPS_PER_ELEMENT[name] * n_el / PEAK_OPS[
                str(xt.dtype).split(".")[1]]
            row = {"ms": timed_ms(lambda: fn(xt), reps),
                   "plain_ms": timed_ms(lambda: plain(xt), reps),
                   "library_ms": timed_ms(lambda: library[name](xt), reps),
                   "bound_ms": 1e3 * max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            timings[(name, label)] = row
            log("%s %-10s kernel_ms %.4f plain_ms %.4f library_ms %.4f "
                "bound_ms %.4f (%s) launches %d" % (
                    name, label, row["ms"], row["plain_ms"],
                    row["library_ms"], row["bound_ms"], row["bound_by"],
                    path_of[label][name]))
    del xt, cases
    max_err["fused_map_reduce"], report["map_reduce_cases"] = \
        map_reduce_cases(K, mapexpr, torch, dev, xv, report)
    timings.update(map_reduce_timings(K, mapexpr, torch, xv, launches,
                                       report))
    del b, x, xv, zimg

    # the window kernels: every mode against the plain versions, then
    # timed at the imaging path's full width
    win_err, report["window_cases"] = window_cases(K, torch, dev, ximg, taps)
    max_err.update(win_err)
    wt = torch.tensor(taps, device=dev)
    n_img = ximg.shape[0]
    win_library = {
        "sepfilter1d": lambda a: torch.nn.functional.conv2d(
            a.view(n_img, 1, *a.shape[1:]), wt.view(1, 1, -1, 1),
            padding=(len(taps) // 2, 0)),
        "lane_band": lambda a: torch.nn.functional.conv1d(
            a.view(-1, 1, a.shape[-1]), wt.view(1, 1, -1),
            padding=len(taps) // 2),
    }
    for name, ax in (("sepfilter1d", 1), ("lane_band", 2)):
        lib_out = win_library[name](ximg).view(ximg.shape)
        check(bool(torch.allclose(lib_out, K.sepfilter1d(ximg, taps, ax),
                                  rtol=1e-4, atol=1e-5)),
              "%s library yardstick computes another function" % name)
        del lib_out
        n_el = ximg.numel()
        t_bytes = 2 * n_el * ximg.element_size() / HBM_BYTES_PER_S
        t_ops = (2 * len(taps) - 1) * n_el / PEAK_OPS["float32"]
        row = {"ms": timed_ms(lambda: K.sepfilter1d(ximg, taps, ax), 10),
               "plain_ms": timed_ms(lambda: K._sepfilter1d_plain(
                   ximg, taps, ax, "constant"), 2),
               "library_ms": timed_ms(lambda: win_library[name](ximg), 5),
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        timings[(name, "imaging")] = row
        log("%s %-10s kernel_ms %.4f plain_ms %.4f library_ms %.4f "
            "bound_ms %.4f (%s) launches %d" % (
                name, "imaging", row["ms"], row["plain_ms"],
                row["library_ms"], row["bound_ms"], row["bound_by"],
                img_launches[name]))
    del bimg, ximg, wt
    max_err["fused_decode_sum"], report["decode_sum_cases"], ds_t = \
        decode_sum_cases(K, torch, dev)
    for label, row in ds_t.items():
        timings[("fused_decode_sum", label)] = row
    report["timings"] = {"%s@%s" % k: v for k, v in timings.items()}
    report["phases"]["kernels_s"] = time.perf_counter() - t0

    # ---- phase 6: the streamed north-star --------------------------------
    stream_launches = stream_phase(bolt, K, torch, np, dev, report)
    report["total_s"] = time.perf_counter() - t_start

    # each kernel's launches are those of the path that runs it: the moment
    # kernels' and fused_map_reduce's from phases 2-3, the window kernels'
    # from phase 4, fused_decode_sum's from phase 6 (timed at the slab it is
    # given there)
    kernels = []
    for name, path_launches, label in (
            ("fused_welford", launches, "north_star"),
            ("fused_stats", launches, "north_star"),
            ("sepfilter1d", img_launches, "imaging"),
            ("lane_band", img_launches, "imaging"),
            ("fused_decode_sum", stream_launches, "slab"),
            ("fused_map_reduce", launches, "north_star_cols")):
        row = timings[(name, label)]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCE[name], "replaces": REPLACES[name],
                        "launches": path_launches[name],
                        "max_abs_err": max_err[name], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    report["kernels"] = kernels
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log("total %.1f s" % report["total_s"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
