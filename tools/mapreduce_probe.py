#!/usr/bin/env python3
"""Time the ``fused_map_reduce`` and ``fused_decode_sum`` kernels on one
CUDA card at the north-star width, ``(3200, 819200)`` (10.49 GB in f32).

    python3 tools/mapreduce_probe.py [--root CHECKOUT] [--label NAME]

``fused_map_reduce``: the column form runs the programs of maps of 0 to 6
instructions (the identity, ``v + 1``, ``v * 2 + 1``, a five-op arithmetic
chain, a ``where``/``clamp`` chain, ``exp(-v * v) * 0.5``, and ``sin(v)``,
which takes the kernel's variant for programs that call the math library,
and products of 4 to 8 shifted copies, whose register files hold 4 to 8
registers), then ``v + 1`` with a mask that drops about half the records, and the full
form with ``v * 2 + 1``, beside ``torch.sum(x, 0)`` and the bound (the
bytes read once over 3.35 TB/s).  ``fused_decode_sum``: the launch loop
over the wire's 160 streamed slabs ``(20, 819200)`` uint8, their device
time (``torch.profiler``), the whole wire, and the host's cost of each
step of the slab's launch path.  Then the north-star ``map(v + 1).sum()``
walls through the public API.

``--root`` imports ``bolt_tpu_torch`` from another checkout (for example
the parent commit unpacked under the git-ignored ``build/``), so one call
on the card can time parent, change, change, parent.  ``--rows`` forces
the map-reduce kernel's tile to that many packs a thread (4 or 2 in f32),
to time the tile width; ``--maps`` times only the named programs' column
form.  Each line is one
JSON object with the card's name and power limit and the label; times are
the mean of ten launches (fifty at the slab) by CUDA events after a
warm-up.
"""

import argparse
import itertools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (3200, 819200)
SLAB_ROWS = 20
HBM_BYTES_PER_S = 3.35e12


def timed_ms(torch, fn, reps=10):
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


def device_ms(torch, fn, reps):
    """Mean device time of the kernels ``fn`` runs, by ``torch.profiler``
    (``None`` where the profiler saw none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3 if us else None


def product(k):
    """A map with ``k`` values live at once (``k - 1`` shifted copies of
    ``v`` multiplied, plus ``v``): the kernel's register file holds ``k``
    registers (4 <= k <= 8)."""
    def f(v):
        t = [v + i * 0.25 for i in range(1, k)]
        out = t[0]
        for u in t[1:]:
            out = out * u
        return out + v
    return f


def map_reduce_rows(torch, K, mapexpr, x, gen, only=None):
    """The kernel on the f32 ``(n, C)`` tensor ``x`` by program, one dict
    a row (``only``: just the column form of the named maps)."""
    n, cols = x.shape
    bound = 1e3 * 4 * (x.numel() + cols) / HBM_BYTES_PER_S
    maps = {
        "identity": (),
        "v+1": (lambda v: v + 1,),
        "v*2+1": (lambda v: v * 2 + 1,),
        "arith5": (lambda v: ((v * 1.1 + 0.2) * (v - 0.3)) / 3 + v,),
        "where_clamp": (lambda v: torch.where(v > 0.1, v, 0.0)
                        + torch.clamp(v, -0.5, 0.5),),
        "exp": (lambda v: torch.exp(-v * v) * 0.5,),
        "sin": (lambda v: torch.sin(v),),
    }
    maps.update({"product%d" % k: (product(k),) for k in range(4, 9)})
    rows = []
    for label, funcs in maps.items():
        if only is not None and label not in only:
            continue
        program = mapexpr.compile(funcs, (cols,), x.dtype)
        rows.append({"kernel": "fused_map_reduce", "map": label,
                     "instructions": len(program.instrs),
                     "calls_math_library": K._calls(program),
                     "stored_registers": K._program_struct(program).nfile,
                     "ms": timed_ms(torch, lambda: K.fused_map_reduce_cols(
                         x, program)), "bound_ms": bound})
    if only is not None:
        return rows
    half = torch.rand(n, generator=gen, device=x.device) > 0.5
    program = mapexpr.compile(maps["v+1"], (cols,), x.dtype)
    rows.append({"kernel": "fused_map_reduce", "map": "v+1 masked",
                 "instructions": 1, "records_kept": int(half.sum()),
                 "ms": timed_ms(torch, lambda: K.fused_map_reduce_cols(
                     x, program, half)), "bound_ms": bound})
    full = mapexpr.compile(maps["v*2+1"], (n, cols), x.dtype)
    rows.append({"kernel": "fused_map_reduce", "map": "v*2+1 full form",
                 "instructions": 2, "ms": timed_ms(
                     torch, lambda: K.fused_map_reduce_program(x, full)),
                 "bound_ms": 1e3 * 4 * (x.numel() + 1) / HBM_BYTES_PER_S})
    rows.append({"kernel": "torch.sum(x, 0)",
                 "ms": timed_ms(torch, lambda: torch.sum(x, 0)),
                 "bound_ms": bound})
    return rows


def decode_sum_rows(torch, K, x, gen):
    # a uint8 wire of the north-star's shape, cut into the stream's slabs;
    # the launch loop walks them in turn, so every launch reads from
    # device memory (a slab fits in the 50 MB L2)
    wire = torch.randint(0, 256, SHAPE, generator=gen, device=x.device,
                         dtype=torch.uint8)
    scale = torch.tensor(0.0431, device=x.device)
    zp = torch.tensor(-5.37, device=x.device)
    slabs = [wire[i:i + SLAB_ROWS] for i in range(0, SHAPE[0], SLAB_ROWS)]
    turn = itertools.cycle(slabs)
    slab_bound = 1e3 * (SLAB_ROWS * SHAPE[1] + 4 * SHAPE[1]) \
        / HBM_BYTES_PER_S
    rows = [{"kernel": "fused_decode_sum", "case": "slab",
             "shape": [SLAB_ROWS, SHAPE[1]],
             "ms": timed_ms(torch, lambda: K.fused_decode_sum(
                 next(turn), scale, zp), 50),
             "device_ms": device_ms(torch, lambda: K.fused_decode_sum(
                 next(turn), scale, zp), 50),
             "bound_ms": slab_bound},
            {"kernel": "fused_decode_sum", "case": "wire",
             "shape": list(SHAPE),
             "ms": timed_ms(torch, lambda: K.fused_decode_sum(
                 wire, scale, zp)),
             "device_ms": device_ms(torch, lambda: K.fused_decode_sum(
                 wire, scale, zp), 10),
             "bound_ms": 1e3 * (wire.numel() + 4 * SHAPE[1])
             / HBM_BYTES_PER_S}]
    # the floor of a launch from Python: the slab's C entry point called
    # through ctypes with its arguments made once (the wrapper's checks,
    # plan and allocation left out)
    # (a checkout without the short-slab form has no such entry point)
    q = slabs[0]
    out = torch.empty(SHAPE[1], dtype=torch.float32, device=x.device)
    plan = K.decode_sum_plan(SLAB_ROWS, SHAPE[1], 16, K._sm_count(
        x.device)) if hasattr(K, "decode_sum_plan") else None
    if plan is not None and plan.kind == "rows":
        lib = K._lib("codec.cu")
        args = (q.data_ptr(), out.data_ptr(), scale.data_ptr(),
                zp.data_ptr(), SLAB_ROWS, SHAPE[1], plan.blocks,
                plan.threads, plan.span, 0,
                K._stream(x.device))
        rows.append({"kernel": "fused_decode_sum", "case": "slab ctypes",
                     "shape": [SLAB_ROWS, SHAPE[1]],
                     "ms": timed_ms(torch, lambda: lib.
                                    bolt_fused_decode_sum_rows(*args), 50),
                     "bound_ms": slab_bound})
        rows.append(dict({"kernel": "fused_decode_sum",
                          "case": "slab host steps (us, host clock)"},
                         **host_steps(torch, K, q, scale, zp)))
    return rows


def host_steps(torch, K, q, scale, zp, reps=2000):
    """Host microseconds of each step of the wrapper's launch path at the
    slab, each repeated ``reps`` times alone (host clock; the card runs
    only the last step's kernels)."""
    import time
    dev = q.device
    steps = {
        "contiguous": lambda: q.contiguous(),
        "empty": lambda: torch.empty(q.shape[1:], dtype=torch.float32,
                                     device=dev),
        "sidecar": lambda: (K._sidecar(scale, dev), K._sidecar(zp, dev)),
        "byte_vec": lambda: K._byte_vec(q, SHAPE[1]),
        "plan": lambda: K.decode_sum_plan(SLAB_ROWS, SHAPE[1], 16,
                                          K._sm_count(dev)),
        "stream": lambda: K._stream(dev),
        "on_device": lambda: K._on_device(dev),
        "wrapper": lambda: K.fused_decode_sum(q, scale, zp),
    }
    out = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t) / reps * 1e6
        torch.cuda.synchronize()
    return out


def map_sum_walls(torch, dev, reps=7):
    """The north-star ``b.map(fn).sum()`` through the public API, as
    medians of ``reps`` synchronised host-clock walls in ms: with the
    callable's program cached, ``sum()`` of an already made map, ``map()``
    alone, and a fresh lambda each call (which ``make_fx`` traces anew)."""
    import time
    import numpy as np
    import bolt_tpu_torch as bolt
    b = bolt.randn((SHAPE[0], 200, 64, 64), dev, dtype=np.float32, seed=0)

    def plus1(v):
        return v + 1

    def wall(fn):
        ws = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ws.append(time.perf_counter() - t)
        return sorted(ws)[reps // 2] * 1e3

    wall(lambda: b.map(plus1).sum())        # compiles and caches plus1
    made = b.map(plus1)
    return {"kernel": "map(v+1).sum() walls (ms, host clock)",
            "cached": wall(lambda: b.map(plus1).sum()),
            "sum_of_made_map": wall(lambda: made.sum()),
            "map_alone": wall(lambda: b.map(plus1)),
            "fresh_lambda": wall(lambda: b.map(lambda v: v + 1).sum())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose bolt_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--rows", type=int, default=None,
                    help="force the map-reduce kernel's tile rows (4 or 2 "
                         "in f32), to time the tile width")
    ap.add_argument("--maps", default=None,
                    help="comma-separated map labels: time only their "
                         "column form (for example product4,product8)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mapreduce_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from bolt_tpu_torch.ops import _build
    from bolt_tpu_torch.ops import kernels as K
    from bolt_tpu_torch.ops import mapexpr
    _build.build(["mapreduce.cu", "codec.cu"])
    if args.rows is not None:
        K.tile_rows = lambda *a: args.rows
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(SHAPE, generator=gen, device=dev)
    only = None if args.maps is None else set(args.maps.split(","))
    rows = map_reduce_rows(torch, K, mapexpr, x, gen, only)
    if only is None:
        rows += decode_sum_rows(torch, K, x, gen)
        del x
        rows.append(map_sum_walls(torch, dev))
    label = args.label or os.path.basename(os.path.abspath(args.root))
    for row in rows:
        row.update({"card": card, "label": label, "shape": row.get(
            "shape", list(SHAPE))})
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
