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
   ``ones().map(v + 1).sum()`` bit-exact against the local oracle, the
   stat terminals and ``stats()`` against numpy, ``swap`` against
   ``np.transpose``, ``chunk().map()`` with a halo and with a per-chunk
   SVD (config 5);
3. the main path at the north-star ``(3200, 200, 64, 64)`` f32 (10.49 GB)
   built on the card with ``randn``: ``map(v + 1).sum()``,
   ``reduce(add)``, ``stats()``, the ``ops.fused_stats`` export and
   ``swap``, against f64 references computed on the card;
4. each kernel against its plain PyTorch version on the card, at both
   main-path shapes and at odd shapes (ragged rows and columns, f64,
   bf16, f16, a NaN column), then timed beside its plain version, one
   PyTorch library call for the same function and its bound.

The launch counters are zeroed just before phase 2 and read just after
phase 3: the main path must have launched every kernel.  The last two
lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``.  A fuller report goes to
``chiprun_out/chip_smoke.json``.
"""

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
# stats = add + fma (2) + min + max
OPS_PER_ELEMENT = {"fused_welford": 8, "fused_stats": 5}
REPLACES = {"fused_welford": "bolt_tpu/ops/kernels.py:188",
            "fused_stats": "bolt_tpu/ops/kernels.py:141"}
SOURCE = "bolt_tpu_torch/ops/csrc/moments.cu"
CONFIG1 = (200, 200, 64, 64)
NORTH_STAR = (3200, 200, 64, 64)


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


def f64_column_refs(x, chunk=4096):
    """Column-wise sums of ``v + 1`` and ``|v + 1|``, sums of squares,
    mean, var, min and max of an (n, C) tensor over axis 0, in f64 on the
    card, ``chunk`` columns at a time."""
    import torch
    parts = {k: [] for k in ("sum1", "abs1", "sq", "mean", "var", "min",
                             "max")}
    for j in range(0, x.shape[1], chunk):
        d = x[:, j:j + chunk].double()
        parts["sum1"].append((d + 1).sum(0))
        parts["abs1"].append((d + 1).abs().sum(0))
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
    del b5, sv, b1, xh
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
    s = b.map(lambda v: v + 1).sum().totorch().reshape(-1)
    err_sum = sum_close(s, ref, n, "north-star map(v+1).sum()")
    r = b.map(lambda v: v + 1).reduce(add).totorch().reshape(-1)
    err_red = sum_close(r, ref, n, "north-star map(v+1).reduce(add)")
    del s, r
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
    for name in K.LAUNCHES:
        check(launches[name] > 0, "main path never launched %s" % name)

    # ---- phase 4: kernels against their plain versions --------------------
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
    tol = {torch.float64: 1e-10, torch.float32: 1e-4}
    kern = {"fused_welford": (K.fused_welford, K._fused_welford_plain),
            "fused_stats": (K.fused_stats, K._fused_stats_plain)}
    max_err = {k: 0.0 for k in kern}
    report["cases"] = []
    for label, xt in cases:
        for name, (fn, plain) in kern.items():
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
    timings = {}
    for label, xt, reps in (("north_star", xv, 5), ("config1", xv[:200], 20)):
        n_el = xt.numel()
        for name, (fn, plain) in kern.items():
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
                    launches[name]))
    report["timings"] = {"%s@%s" % k: v for k, v in timings.items()}
    report["phases"]["kernels_s"] = time.perf_counter() - t0
    report["total_s"] = time.perf_counter() - t_start
    del b, x, xv, cases

    kernels = []
    for name in kern:
        row = timings[(name, "north_star")]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name],
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
