#!/usr/bin/env python3
"""Time the ``fused_map_reduce`` kernel on one CUDA card at the north-star
width, ``(3200, 819200)`` f32 (10.49 GB), by the length of its program.

    python3 tools/mapreduce_probe.py

The column form runs the programs of maps of 0 to 6 instructions (the
identity, ``v + 1``, ``v * 2 + 1``, a five-op arithmetic chain, a
``where``/``clamp`` chain, ``exp(-v * v) * 0.5``, and ``sin(v)``, which
takes the kernel's one-element variant for programs that call the math
library), then ``v + 1`` with a mask that drops about half the records,
beside ``torch.sum(x, 0)`` and the bound (the bytes read once over
3.35 TB/s).  Each line is one JSON object with the card's name and power
limit; times are the mean of ten launches by CUDA events after a warm-up.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (3200, 819200)
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("mapreduce_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from bolt_tpu_torch.ops import _build
    from bolt_tpu_torch.ops import kernels as K
    from bolt_tpu_torch.ops import mapexpr
    _build.build(["mapreduce.cu"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(SHAPE, generator=gen, device=dev)
    bound = 1e3 * 4 * (x.numel() + SHAPE[1]) / HBM_BYTES_PER_S
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
    rows = []
    for label, funcs in maps.items():
        program = mapexpr.compile(funcs, SHAPE[1:], x.dtype)
        rows.append({"map": label, "instructions": len(program.instrs),
                     "calls_math_library": K._calls(program),
                     "ms": timed_ms(torch, lambda: K.fused_map_reduce_cols(
                         x, program))})
    half = torch.rand(SHAPE[0], generator=gen, device=dev) > 0.5
    program = mapexpr.compile(maps["v+1"], SHAPE[1:], x.dtype)
    rows.append({"map": "v+1 masked", "instructions": 1,
                 "records_kept": int(half.sum()),
                 "ms": timed_ms(torch, lambda: K.fused_map_reduce_cols(
                     x, program, half))})
    rows.append({"map": "torch.sum(x, 0)",
                 "ms": timed_ms(torch, lambda: torch.sum(x, 0))})
    for row in rows:
        row.update({"card": card, "shape": list(SHAPE), "bound_ms": bound})
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
