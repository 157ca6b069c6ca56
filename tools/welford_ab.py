#!/usr/bin/env python3
"""Time the port's ``fused_welford`` kernel on one CUDA card at the shapes
the port's paths hand it, beside its plain PyTorch version and one library
call, for the checkout at ``--root`` (default: this checkout).

Run it for two checkouts one after the other on the same card to compare
them::

    python3 tools/welford_ab.py --root /path/to/parent
    python3 tools/welford_ab.py

Each shape prints one JSON line with the card's name and power limit,
the times (mean of CUDA-event runs after a warm-up), the bound (bytes read
once over 3.35 TB/s) and the largest difference from the plain version.
Where the checkout's ``fused_welford`` takes ``with_sum``, the line adds
the instantiation with the column sum (``sum_ms``; ``sum_err``, its
largest difference from the f64 sum, beside ``torch_sum_err``,
``torch.sum``'s).  At the north-star it also times the array surface: the
six-member key-axis group ``stats("sum", "mean", "var", "std", "min",
"max")`` (``group_ms``) and a lone ``sum()`` (``lone_sum_ms``), each
read back with ``totorch()``.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys

# (rows, columns) f32: the imaging path's stats() over (2048, 4096) pixel
# series of 64 frames, the north-star and BASELINE config 1
SHAPES = {"imaging_pixels": (8388608, 64), "north_star": (3200, 819200),
          "config1": (200, 819200)}
HBM_BYTES_PER_S = 3.35e12


def timed_ms(torch, fn, reps):
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


def surface_ms(torch, x, reps):
    """The group's and a lone ``sum()``'s times through the array
    surface over ``x`` (its rows the records)."""
    import bolt_tpu_torch as bolt
    b = bolt.array(x, x.device)
    names = ("sum", "mean", "var", "std", "min", "max")
    return {"group_ms": timed_ms(torch, lambda: [
                v.totorch() for v in b.stats(*names).values()], reps),
            "lone_sum_ms": timed_ms(torch, lambda: b.sum().totorch(), reps)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose port is timed")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("welford_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from bolt_tpu_torch.ops import _build, kernels as K
    _build.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    for label, shape in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(shape, generator=gen, device=dev)
        got, want = K.fused_welford(x), K._fused_welford_plain(x)
        for g, w in zip(got, want):
            if not torch.allclose(g, w, rtol=1e-4, atol=1e-4):
                raise AssertionError("%s: kernel differs from its plain "
                                     "version" % label)
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want))
        row = {"root": os.path.abspath(args.root), "card": card,
               "shape": label, "rows_columns": list(shape),
               "ms": timed_ms(torch, lambda: K.fused_welford(x), args.reps),
               "plain_ms": timed_ms(
                   torch, lambda: K._fused_welford_plain(x), 3),
               "library_ms": timed_ms(torch, lambda: (
                   torch.var_mean(x, 0, correction=0),
                   torch.aminmax(x, dim=0)), 5),
               "bound_ms": 1e3 * 4 * (x.numel() + 4 * shape[1])
               / HBM_BYTES_PER_S,
               "max_abs_err": err}
        if "with_sum" in inspect.signature(K.fused_welford).parameters:
            total = K.fused_welford(x, with_sum=True)[4]
            row["sum_ms"] = timed_ms(
                torch, lambda: K.fused_welford(x, with_sum=True), args.reps)
            # each sum's largest error against the f64 sum, beside
            # torch.sum's
            exact = x.double().sum(0)
            row["sum_err"] = float((total.double() - exact).abs().max())
            row["torch_sum_err"] = float((x.sum(0).double() - exact)
                                         .abs().max())
            del total, exact
        if label == "north_star":
            row.update(surface_ms(torch, x, args.reps))
        print(json.dumps(row), flush=True)
        del x, got, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
