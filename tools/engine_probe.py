#!/usr/bin/env python3
"""Time the host cost the engine's caches remove, and the device memory
a donated materialisation needs, at the north-star on one CUDA card.

    python3 tools/engine_probe.py [--root CHECKOUT] [--label NAME]
                                  [--reps N]

At the north-star ``(3200, 200, 64, 64)`` f32 (10.49 GB, ``randn`` seed 0)
it times, through the public API, each step synchronised:

* ``map_sum_cached``: ``b.map(f).sum()`` read with ``cache()``, one
  callable ``f`` used again (one ``fused_map_reduce`` launch a call);
* ``map_sum_first``: the same with a new callable each time (the trace
  of the chain and the shape inference of the map);
* ``map_call``: ``b.map(f)`` alone, the host time of recording a map;
* ``chain_cache``: ``randn(...).map(v + 1).cache()`` with nothing else
  owning the base (a donated, in-place materialisation in a checkout
  that donates), with its peak device-memory growth.

``--root`` imports ``bolt_tpu_torch`` from another checkout (the parent
commit unpacked under the git-ignored ``build/``), so one call on the
card can time parent, change, change, parent.  Each line is one JSON
object with the card's name and power limit, the label, the step, its
host-clock wall in ms (median and least of ``--reps`` runs after a
warm-up) and its peak device-memory growth in GB.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORTH_STAR = (3200, 200, 64, 64)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi failed"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        sys.exit("engine_probe needs a CUDA card")
    _build.build(["mapreduce.cu"])      # set-up: no step pays for nvcc
    name = card()

    def emit(step, walls, grow=None):
        walls = sorted(walls)
        print(json.dumps({"card": name, "label": args.label, "step": step,
                          "median_ms": walls[len(walls) // 2] * 1e3,
                          "min_ms": walls[0] * 1e3, "runs": len(walls),
                          "peak_growth_gb": grow}), flush=True)

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    b = bolt.randn(NORTH_STAR, mode="gpu", dtype=np.float32, seed=0)

    def f(v):
        return v + 1

    wall(lambda: b.map(f).sum().cache())
    emit("map_sum_cached", [wall(lambda: b.map(f).sum().cache())[1]
                            for _ in range(args.reps)])
    emit("map_sum_first", [wall(lambda: b.map(lambda v: v + 1).sum()
                                .cache())[1] for _ in range(5)])
    emit("map_call", [wall(lambda: b.map(f))[1] for _ in range(args.reps)])
    del b
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    walls, grows = [], []
    for _ in range(3):
        d = bolt.randn(NORTH_STAR, mode="gpu", dtype=np.float32,
                       seed=0).map(f)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, w = wall(d.cache)
        grows.append((torch.cuda.max_memory_allocated() - base) / 1e9)
        walls.append(w)
        del d
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    emit("chain_cache", walls, max(grows))


if __name__ == "__main__":
    main()
