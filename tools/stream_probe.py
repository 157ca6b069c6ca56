#!/usr/bin/env python3
"""Time the port's streaming executor on one CUDA card at the north-star
width, ``(3200, 200, 64, 64)`` f32 (10.49 GB, 160 slabs of 20 records),
with the host's producer taken out of the way, and once with it.

    python3 tools/stream_probe.py

The ``cached`` source returns the same pre-drawn 20-record block for every
slab, so a run measures the executor itself: the uploader pool, the pinned
ring, the link, the codecs' host encoders and the slab programs.  The
``drawn`` source draws every record from ``np.random.default_rng(7 +
record)``, as ``chip_smoke.py`` phase 6 does.  Each run prints one JSON
line with the card's name and power limit, its wall (host clock, ending
in a synchronise), the engine counters' deltas (ingest and compute
seconds, link seconds summed over the workers, the overlap share) and its
peak device memory.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORTH_STAR = (3200, 200, 64, 64)


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("stream_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import engine, stream
    from bolt_tpu_torch.ops import _build
    from bolt_tpu_torch.ops import kernels as K

    _build.build()      # set-up: no run pays for the kernels' nvcc build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    rec = NORTH_STAR[1:]
    block = np.random.default_rng(0).standard_normal((20,) + rec,
                                                     dtype=np.float32)

    def cached(index):
        return block[:index[0].stop - index[0].start]

    def drawn(index):
        lo, hi = index[0].start, index[0].stop
        out = np.empty((hi - lo,) + rec, np.float32)
        for r in range(lo, hi):
            out[r - lo] = np.random.default_rng(7 + r).standard_normal(
                rec, dtype=np.float32)
        return out

    runs = (("cached", None, "sum", False), ("cached", None, "mean", False),
            ("cached", "delta-f32", "sum", False),
            ("cached", "bf16", "mean", False),
            ("cached", "int8", "sum", True), ("cached", "int8", "sum", False),
            ("drawn", None, "sum", False))
    with stream.uploaders(4):
        for src, codec, terminal, armed in runs:
            os.environ["BOLT_CODEC_KERNEL"] = "1" if armed else "0"
            K.reset_launches()
            c0 = engine.counters()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            b = bolt.fromcallback(cached if src == "cached" else drawn,
                                  NORTH_STAR, mode="gpu", dtype=np.float32,
                                  codec=codec)
            getattr(b, terminal)().totorch()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            d = {k: v - c0[k] for k, v in engine.counters().items()}
            print(json.dumps({
                "card": card, "source": src, "codec": codec,
                "terminal": terminal, "armed": armed, "wall_s": wall,
                "slabs": d["stream_chunks"],
                "wire_gb": d["transfer_bytes"] / 1e9,
                "ingest_s": d["stream_ingest_seconds"],
                "encode_s": d["codec_encode_seconds"],
                "compute_s": d["stream_compute_seconds"],
                "link_s": d["transfer_seconds"],
                "overlap_share": d["stream_overlap_seconds"]
                / max(d["stream_ingest_seconds"], 1e-12),
                "decode_sum_launches": K.LAUNCHES["fused_decode_sum"],
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}),
                flush=True)
    os.environ.pop("BOLT_CODEC_KERNEL", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
