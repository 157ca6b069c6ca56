#!/usr/bin/env python3
"""Time the north-star terminals that apply a map chain over blocks of
records, at several block sizes, on one CUDA card.

    python3 tools/block_probe.py [--root CHECKOUT] [--label NAME]
                                 [--blocks MB,MB,...] [--reps N]

At the north-star ``(3200, 200, 64, 64)`` f32 (10.49 GB, ``randn`` seed 0)
it times, through the public API:

* config 4, ``map(v + 1).filter(v.mean() > 1)`` with ``sum()`` and
  ``mean()`` (one masked ``fused_map_reduce`` launch each);
* the standalone ``mean()``, ``var()``, ``std()`` and ``max()`` of the
  chain ``v ** 2``, ``-v``, ``exp``, ``* 0.5`` written as four maps (a
  chain every checkout of the port serves), and beside them the same four
  terminals by the whole-tensor path: the chain applied to the whole base
  at once, then one torch reduction;
* where the checkout has them, the same chain as numpy ufuncs
  (``np.exp(-(b ** 2)) * 0.5``) and its seven-member ``bolt.compute``
  group.

Each is timed at every block size of ``--blocks`` (MB, set through
``gpu/array.py``'s ``_BLOCK_BYTES``; a checkout without it runs once, as
block ``null``).  ``--root`` imports ``bolt_tpu_torch`` from another
checkout (for example the parent commit unpacked under the git-ignored
``build/``), so one call on the card can time parent, change, change,
parent.  Each line is one JSON object with the card's name and power
limit, the label, the block size, the step, its host-clock wall in ms
(median and least of ``--reps`` runs after a warm-up, each synchronised)
and its peak device-memory growth in GB; the chain's ``mean``/``var`` also
carry their largest difference from the whole-tensor path.
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
    ap.add_argument("--blocks", default="128,256,512,768,1024")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch.gpu import array as garray

    if not torch.cuda.is_available():
        sys.exit("block_probe needs a CUDA card")
    name = card()
    b = bolt.randn(NORTH_STAR, mode="gpu", dtype=np.float32, seed=0)

    def resolved(r):
        for x in r if isinstance(r, (tuple, list)) else (r,):
            if hasattr(x, "cache"):
                x.cache()
        return r

    def timed(fn):
        """Median and least wall (ms) and the largest peak growth (GB)."""
        resolved(fn())
        walls, grow = [], 0
        for _ in range(args.reps):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            resolved(fn())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            grow = max(grow, torch.cuda.max_memory_allocated() - base)
        walls.sort()
        return walls[len(walls) // 2], walls[0], grow / 1e9

    def emit(block, step, fn, **extra):
        med, low, grow = timed(fn)
        print(json.dumps(dict(card=name, label=args.label, block_mb=block,
                              step=step, wall_ms=med, least_ms=low,
                              peak_growth_gb=grow, **extra)), flush=True)

    def pred(v):
        return v.mean() > 1

    def sq(v):
        return v ** 2

    def neg(v):
        return -v

    def half(v):
        return v * 0.5

    def maps():
        return b.map(sq).map(neg).map(torch.exp).map(half)

    def whole(stat):
        c = maps()
        base, funcs = c._chain
        return garray._reduce_stat(garray._chain_apply(funcs, 1, base),
                                   stat, (0,), False, None, c.dtype)

    wholes = {}
    for stat in ("mean", "var", "std", "max"):
        emit(None, "maps4 %s (whole-tensor path)" % stat,
             lambda: whole(stat))
        wholes[stat] = whole(stat)
    ufuncs = getattr(garray, "_chain_stats", None) is not None
    blocks = [int(m) for m in args.blocks.split(",")] \
        if hasattr(garray, "_BLOCK_BYTES") else [None]
    for mb in blocks:
        if mb is not None:
            garray._BLOCK_BYTES = mb << 20
        for stat in ("sum", "mean"):
            emit(mb, "config4 filter().%s()" % stat, lambda: getattr(
                b.map(lambda v: v + 1).filter(pred), stat)())
        for stat in ("mean", "var", "std", "max"):
            extra = {}
            if stat in ("mean", "var"):
                got = resolved(getattr(maps(), stat)()).totorch()
                extra["max_abs_diff_vs_whole"] = float(
                    (got - wholes[stat]).abs().max())
            emit(mb, "maps4 %s()" % stat,
                 lambda: getattr(maps(), stat)(), **extra)
        if ufuncs:
            names = ("sum", "mean", "var", "std", "min", "max", "ptp")
            for stat in ("mean", "var"):
                emit(mb, "ufunc chain %s()" % stat, lambda: getattr(
                    np.exp(-(b ** 2)) * 0.5, stat)())

            def group():
                c = np.exp(-(b ** 2)) * 0.5
                return bolt.compute(*(getattr(c, n)() for n in names))
            emit(mb, "ufunc chain compute(7 members)", group)


if __name__ == "__main__":
    main()
