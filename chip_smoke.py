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
   of the same mask, the port's blocked mask held against the predicate
   over the whole ``x + 1`` (equal, or apart only within rounding of the
   bound), and an all-False filter (shape ``(0, ...)``, a zero
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
   under 2 GB of peak device memory;
7. the array surface and the stat groups: at the north-star (rebuilt from
   phase 3's seed) ``(np.exp(-(b ** 2)) * 0.5).sum()`` through one
   ``fused_map_reduce`` launch against f64 column sums of the chain's f32
   values; ``bolt.compute`` of its seven stat terminals, each equal to its
   standalone terminal bit for bit, timed against the sum of those
   terminals, with at most one mapped temporary (10.49 GB) plus 1 GB of
   peak growth; ``b.stats("sum", "std", "ptp")``; ``(b > 0).sum()``
   exactly; ``(b == b).all()``; config 4's ``filter(...).sum()``/``mean()``
   under 1 GB of peak growth (the blocked mask); then at config 1
   ``np.asarray`` beside ``toarray``, ``median``/``quantile``,
   ``argmax``/``argmin``, ``sort``/``argsort`` along the last axis,
   ``cumsum``, ``take``, ``nonzero``, ``searchsorted``, ``repeat``,
   ``diagonal``/``trace`` and ``b @ w``, each against numpy on the host;
8. the engine, donation, ``stacked`` and ``profile``: at the north-star
   (phase 3's seed) ``map(v + 1).sum()`` three times with one callable
   (a miss, then two hits with no new build, one ``fused_map_reduce``
   launch each, equal to f64 column sums), ``profile.instrument()``'s
   ``"stat"`` family (one build for one callable, three for three fresh
   lambdas), the shape inference a cached call skips, ``stats()``
   through the cache (one ``fused_welford`` launch) and ``profile.timeit``;
   donation, each case under its own peak window: a sole-owned
   ``randn(...).map(v + 1)``'s ``cache()`` written into its base's storage
   (one grant, under 1 GB of growth, records against f64 references
   regenerated from the seed), its ``stacked(1000).map(blk -
   blk.mean(0))`` (one grant, in place, under two stack blocks of growth,
   two whole blocks against f64, the source consumed), its ``mean()``
   (one grant, the base freed when the terminal returns), and the
   refusals of a ``_clone``d chain and of a live parent (no grant, both
   readable and exact); ``stacked`` at config 1 with a block size that
   divides the records and one that leaves a tail, bit for bit against
   the local oracle; ``profile.memory_stats()``'s keys,
   ``profile.trace`` writing under ``chiprun_out/``, and, with the tracer
   armed, a map-sum and an 8-slab stream leaving no open span and a
   Chrome export whose B/E pairs balance.  The lock witness is armed over
   phases 3 and 6 and must record no violation;
9. the ops library and the numpy surface, with a host fallback an
   error: BASELINE config 5b at full width, ``(8, 4194304, 16)`` f32,
   ``chunk(size=(1024,), axis=(0,)).map(ops.svdvals(blk)[None, :])``
   taking the Jacobi route (true batch 32768), 512 chunks from both ends
   of both axes against numpy f64 SVD (1e-4 of each chunk's largest
   value), its wall beside config 5's ``torch.linalg.svdvals`` per chunk,
   and its split: the batched Gram beside its bound, ``jacobi_eigh`` on
   the ``(32768, 16, 16)`` Grams beside ``torch.linalg.eigvalsh``; ``pca``
   (``k=4, center=True``), ``cov`` and ``corrcoef`` of ``(33554432, 16)``
   f32 with feature scales 1..4, plain and through ``map(v * 2 + 1)``,
   against f64 statistics built block by block on the card (singular
   values to 1e-4, components to 1e-3 up to sign, peak growth under the
   scores plus 1 GB); at config 1 ``histogram`` (64 bins; counts against
   an independent count on the card), ``bincount`` and ``unique`` of an
   integer view and ``topk``, against numpy; ``np.sum``, ``np.mean(axis=
   0)``, ``np.histogram`` and ``np.cov`` with ``toarray``/``__array__``
   made to raise; ``segment_reduce`` of ``(8192, 1024, 64)`` f32 into 256
   segments, scatter and matmul for sum and mean and the scatter max,
   against f64 sums built block by block on the card, with the walls
   behind ``ops/group.py``'s auto constants;
10. the rest of the numpy surface (``gpu/npdispatch.py``), with
   ``toarray``/``__array__`` made to raise and a host fallback an error,
   each call's wall, peak growth and serving library call logged: at the
   north-star under ``map(where(v > 2, nan, v))`` (about 2.3% NaN)
   ``np.nansum``, ``np.nanmean(axis=0)``, ``np.nanstd(axis=0)`` and
   ``np.nanmax``, folding block partials (the chain stays unmaterialised,
   peak growth under 1 GB beside each result), against f64 column
   references on the card (the sum within 1e-6 of the sum of |v|, mean
   rtol 1e-5, std rtol 1e-4, max exact); at config 1 ``np.stack``,
   ``np.pad`` (reflect), ``np.roll``, ``np.tile`` and ``np.broadcast_to``
   exactly on three sampled records, ``np.einsum("ijkl,lm->ijkm", b, w)``
   with a host ``(64, 64)`` ``w`` at ``"highest"`` (within ``64 * 2^-24``
   of ``|x||w|`` against f64) and under a ``"default"`` scope (TF32:
   ``2 * 2^-11 + 64 * 2^-24``), ``np.tensordot``, ``np.nanmedian``/
   ``np.nanquantile`` over axis 0 (two columns against numpy, rtol 1e-6 /
   1e-5), ``np.take_along_axis`` of ``np.argsort`` exactly, and
   ``np.fft.rfft2`` with its ``irfft2`` round trip (1e-5 of the largest
   value); config 5b's Gram stack ``(32768, 16, 16)`` through
   ``np.linalg.eigvalsh`` (in slices: cuSOLVER's batched solver refuses
   the whole stack), ``inv``, ``slogdet``, ``cholesky``, ``solve``, ``qr``
   and ``svd`` against numpy f64 on 512 sampled matrices (1e-4 of the
   largest value); the imaging width's ``np.fft.rfft`` along the last
   axis and its ``irfft`` round trip (1e-5);
11. the streamed stages, stream groups, the shuffle and retries, under
   ``stream.uploaders(4)``: at the streamed north-star of phase 6 (f64
   references and the materialised swap taken once from a copy
   materialised on the card, then freed) ``swap((0,), (0,))`` resolved
   resident by the two-phase shuffle, bit for bit against the
   materialised swap, its peak growth under its 10.49 GB result plus
   2 GB; config 4's ``map(v + 1).filter(v.mean() > 1)`` streamed through
   ``sum()`` and ``mean()`` (the f32 slab mask held against the f64 one
   within rounding; the sum within ``4 sqrt(kept) 2^-24 sum|v + 1|``,
   the mean ``rtol=1e-5, atol=1e-6``); the group of ``sum``/``mean``/
   ``var``/``min``/``max`` in one ingest pass (40 slabs), each member
   bit for bit against its standalone streamed terminal, its wall beside
   the sum of theirs; ``chunk((50, 32, 32)).map(c * 2).sum()`` and
   ``stacked(20).map(blk - blk.mean(0)).sum()`` against f64 (``8
   sqrt(n) 2^-24 sum|v|``); each north-star run under 2 GB of device
   memory.  At BASELINE config 1 with integer-valued records (sums exact
   in any order): ``swap`` resident and under ``stream.spill(build/...,
   budget=2^28)``, the sum over the spilled buckets bit for bit against
   the resident swap's (and the data), ``spill_bytes`` above 0 and no
   ``bolt-spill-*`` after ``spill_clear``; a ``sum`` with an injected
   ``stream.upload`` fault under ``stream.retries(1)`` bit for bit against
   the clean one with one retry; the armed int8 ``sum`` launching
   ``fused_decode_sum`` once a slab and, under a filter, not at all.
   One log line a run: wall, peak device memory, slabs, shuffle and
   spill bytes;
12. resume, checkpoints and unsigned records, under
   ``stream.uploaders(4)``: phase 6's ``map(v + 1).sum()`` under
   ``stream.resumable(build/..., every=2)``, killed by an injected
   ``stream.upload`` fault at its 80th upload and run again, resumed (one
   resume, fewer than 40 slabs, no checkpoint left), bit for bit against
   phase 6's sum, and once clean (its wall beside phase 6's); phase 11's
   group of five killed and resumed (``every=8``), each member bit for
   bit against phase 11's; config 1's armed int8 ``sum`` killed and
   resumed bit for bit against phase 11's, ``fused_decode_sum`` once for
   each slab streamed after the resume; a child process running config
   1's streamed sum under ``BOLT_CHAOS="stream.upload:6:kill"`` (it must
   die with a checkpoint pending) and a second child resuming it, bit for
   bit against phase 11's sum; config 1 through ``checkpoint.save``/
   ``load`` bit for bit (write and read rates logged), and
   ``map(v + 1).sum()`` and ``stats()`` of the loaded array launching
   ``fused_map_reduce`` and ``fused_welford`` once each and equal to the
   saved array's; config 1's records shifted to [0, 16] as ``uint16`` through
   ``+ 1``, ``>``, ``//``, ``map(v + 1).sum()``, ``min``, ``max``,
   ``stats()``, ``reduce(np.add)``, ``reduce(np.maximum)``, ``cumsum``,
   ``clip``, ``compute(sum, mean, max)`` and a streamed ``sum``/``max``,
   each equal to numpy in values and the reference's dtype.  One log line
   a run: wall, slabs, resumes, checkpoint bytes and seconds, peak;
13. serving (``bolt_tpu_torch.serve``), each path with its launches
   counted from 0: ``scripts/bench_all.py``'s config 9, four tenants each
   streaming ``(2048, 256, 64)`` f32 (128 MB, 16 slabs of 128 records,
   25 ms of sleep a slab) through ``map(v + 1).sum()`` under
   ``serving(workers=4, queue_limit=8)``, each result bit for bit against
   the single-tenant run, a cold four-tenant round building what one
   tenant builds (engine misses and nvcc builds), each tenant's
   ``transfer_bytes`` its own 128 MB, the queue's high-water at most 8,
   and the aggregate wall against the serialised one logged; config 1 in
   memory, four tenants' ``map(v + 1).sum()`` and ``stats()`` under a
   budget of 90% of ``torch.cuda.mem_get_info()``'s free bytes, bit for
   bit against their standalone runs with 4 ``fused_map_reduce`` and 4
   ``fused_welford`` launches; phase 11's armed int8 ``sum`` under a
   budget of one wire slab (the starvation valve), bit for bit against
   phase 11's, ``fused_decode_sum`` once a slab, the arbiter's high-water
   within its budget and nothing leased after; config 14, 256 requests of
   ``(128, 32)`` f32 ``map(v + 1).sum()`` over 8 bases on one worker,
   three saturated drains and the sparse p50 unbatched and under
   ``batching={"max_batch": 16, "linger": 0.002}`` after ``batched.warm``
   (every result bit for bit against its standalone run, no build in the
   steady state, ``fused_map_reduce_lanes`` once a batched dispatch and the
   standalone ``fused_map_reduce`` only for the requests that ran alone;
   req/s and the p50 ratio logged beside the reference's bench gates);
   then ``fused_map_reduce_lanes`` at config 14, bit for bit against
   the standalone launches at 1, 2, 5, 16 and 80 lanes (more than a
   launch's table of 64) in both forms, one kernel a call and no scratch
   at 16 lanes, timed beside 16 standalone launches (host-paced, and on
   the device alone with the calls queued behind ``torch.cuda._sleep``),
   its plain version, ``torch.sum`` of a stacked copy and its bound.
14. the analysis layer (``bolt_tpu_torch.analysis``), each path with its
   launches counted from 0: ``analysis.check`` of the north-star's
   ``map(v + 1).sum()``, ``stats()``, a seven-member group and config 4's
   filter, config 1's swap, config 5's ``chunk().map()`` with the
   per-chunk SVD (``ops.svdvals``), the streamed north-star's
   ``map(v + 1)``, config 1's armed int8 stream (BLT016), a resumable
   one-shot iterator (BLT011), config 1's streamed swap under a 256 MiB
   budget with and without a spill directory (BLT017), a pipeline under a
   server whose budget is half its slab (BLT010) and config 14 on a
   batching server (BLT015): each check holds the engine's builds, every
   launch counter, the kernel libraries and the card's allocated bytes
   and peak flat (host walls, first and cached, logged); then each
   pipeline under ``analysis.strict()``, its predicted shape and dtype
   equal to its result's and its result bit for bit its unguarded run's
   (the streamed and int8 sums against phases 6 and 11), the spill
   forecast equal to the spill decision, the BLT010 pipeline refused at
   ``submit`` and by ``strict()``, a hand-built broken chain refused
   (BLT001) with nothing built, launched or allocated; strict's extra
   host time on the cached north-star ``map(v + 1).sum()`` and the
   ``strict_checks``/``strict_rejections`` counts logged;
15. device meshes (``bolt_tpu_torch.parallel``): child pods of ranks on
   this one card through ``parallel/harness.py``, each result held
   against the single-device one this process computes first.  A
   one-rank NCCL pod at the north-star (``randn`` seed 0:
   ``map(v + 1).sum()``, ``stats()`` and ``swap`` bit for bit, nothing
   staged through the host); a two-rank gloo pod with the north-star
   split 1600 records a rank (crafted exact data, built on each rank's
   device: ``map(v + 1).sum()``, ``reduce(add)``, config 4's filter
   ``sum()``/``mean()`` bit for bit on both ranks, ``stats()`` and the
   fluent ``stats("sum", "mean", "var", "min", "max")`` group of
   constant columns bit for bit; ``randn`` within 2e-2 (sum), 2e-5
   (mean) and 1e-4 relative (var) of f64 references; then config 1's
   crafted ``swap`` through the ``all_to_all`` box by box and
   ``toarray()`` bit for bit against the single device, the swap also
   against ``np.transpose`` of the gather); a four-rank ``(2, 2)`` ``("k", "v")`` gloo pod at
   config 1 (the keys on ``"k"``, replicated on ``"v"``: the sum with no
   double count; ``chunk().shard("v")`` with a halo-padded map and
   ``ops.gaussian(..., axis=(0, 2), shard="v")``, each rank's box bit
   for bit through ``payloads.fingerprint``); and two NCCL ranks on one
   card refused.  Each path logs its wall, peak growth, launches per
   rank, collective bytes and host-staged bytes beside the card; each
   pod's first ``map(v + 1).sum()``/``stats()`` (library loads, the
   first trace) is the ``first_call`` path.  It needs no second card.
16. streamed pods (``fromcallback(per_process=True)``: each rank ingests
   its own rows of every slab, each slab's partial folded across the
   ranks).  Its paths ride phase 15's pods (paths ``s16_...``, so no pod
   start is paid twice): a. the streamed north-star at full width on the
   two gloo ranks, 160 slabs of 20 records (10 a rank) under four
   uploaders a rank: phase 6's seeded ``randn`` records'
   ``map(v + 1).sum()`` and fluent ``stats("sum", "mean", "var", "min",
   "max")`` within phase 6's tolerances of its f64 references, the
   crafted records' ``map(v + 1).sum()`` (twice: the second pass builds
   nothing) and the constant columns' group bit for bit against the
   single device's streamed runs, the same bits on both ranks, each rank
   producing and uploading 1600 records (5.24 GB) a pass under 2 GB of
   peak growth; b. crafted config 1 on the two ranks: the streamed
   ``swap`` through one ``all_to_all`` a slab box by box against phase
   15's single-device swap, a pod spill refused, ``delta-f32`` bit for
   bit and ``bf16`` at half the bytes, ``int8`` refused (its sidecar),
   an uneven slab refused with BLT012 and forecast by ``analysis.check``,
   a one-shot ``fromiter`` refused; on the four-rank ``(2, 2)`` pod a
   key extent ``(198, ...)`` the ``"v"`` axis replicates, streamed
   ``sum()`` with no double count, and a checkpointed run on a mesh of
   half the pod refused; c. a two-rank checkpointed crafted config 1
   pod killed -9 on every rank at its 7th upload (a shard a rank left),
   then restarted: one resume, fewer slabs, the clean run's bits, no
   file left; d. the one NCCL rank's armed int8 ``sum`` of config 1, one
   ``fused_decode_sum`` a slab, bit for bit against phase 11's.  The
   two-rank and four-rank pods launch no kernel.  Each path logs its
   wall, rows produced, transfer bytes, collective and host-staged
   bytes, peak growth, launches and engine misses per rank.
17. pod liveness and recovery (``recovery_phase``) and 18. the array
   surface and the ops library on a mesh (``surface_mesh_phase``, paths
   ``s18_...`` in phase 15's pods).
19. numpy's function table on a mesh (``numpy_mesh_phase``, paths
   ``s19_...`` in phase 15's pods): on the two ranks at the north-star
   ``np.sum(b * 2 + 1)`` (against its exact total) and ``np.mean(b,
   axis=0)``, one ``fused_map_reduce`` a rank each, and ``np.var`` of the
   constant columns, one ``fused_welford`` a rank; at config 1
   ``map(with_keys=True).sum()``, a host-predicate ``filter(...).sum()``
   and ``stats(accumulate="bf16")``; on the ``(2, 2)`` pod at config 1
   with both keys split (164 MB a box) ``einsum`` (a fold over a sharded
   axis), ``tensordot``, ``stack``, ``concatenate``, ``roll``,
   ``pad(mode="reflect")``, ``broadcast_to``, ``cov``, ``histogram``,
   ``where``, ``nanmean``, ``sort(axis=None)``, ``unique``, ``rfft``
   along a sharded axis, ``linalg.inv`` over the sharded batch and
   ``split``: every rank's box against the single device's (bit for bit
   where the crafted data keeps the arithmetic exact).

The launch counters are zeroed just before each path (phases 2–3, phase
4, phase 6, phase 7, phase 8, phase 11, phase 12 and each path of phases
13, 14, 15 and 16, phases 15's and 16's in every rank; phases 9 and 10
run no kernel of their own) and
read just after it: each path must
have launched every kernel it runs.  The last two lines are a ``{"kernels": [...]}`` JSON
object (each row's ``phase12_launches`` holds its launches in each path
of phase 12 that launched it: each run of the resumes, ``loaded_array``
and ``uint16``, every one counted from 0; ``phase13_launches`` the same
for phase 13's ``config9``, ``config1``, ``int8_c1`` and ``config14``;
``phase14_launches`` for phase 14's paths; ``phase15_launches`` a list
a path of phase 15, one count a rank; ``phase16_launches`` the same for
phase 16; ``phase17_launches`` to ``phase19_launches`` the same for
phases 17 to 19) and
``{"ok": true, "device": {...}}``.  A fuller report goes to
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
            "fused_map_reduce": "bolt_tpu/ops/kernels.py:110",
            # vmap's batch axis over _mr_kernel (:99, its pallas_call :129)
            "fused_map_reduce_lanes": "bolt_tpu/ops/kernels.py:129"}
SOURCE = {"fused_welford": "bolt_tpu_torch/ops/csrc/moments.cu",
          "fused_stats": "bolt_tpu_torch/ops/csrc/moments.cu",
          "sepfilter1d": "bolt_tpu_torch/ops/csrc/window.cu",
          "lane_band": "bolt_tpu_torch/ops/csrc/window.cu",
          "fused_decode_sum": "bolt_tpu_torch/ops/csrc/codec.cu",
          "fused_map_reduce": "bolt_tpu_torch/ops/csrc/mapreduce.cu",
          "fused_map_reduce_lanes": "bolt_tpu_torch/ops/csrc/mapreduce.cu"}
CONFIG1 = (200, 200, 64, 64)
# phase 9's shapes: BASELINE config 5b (scripts/bench_all.py), the pca
# family of scripts/perf_regress.py and ops/group.py's measured layout
CONFIG5B = (8, 4194304, 16)
PCA_SHAPE = (33554432, 16)
SEGMENT_SHAPE = (8192, 1024, 64)
NORTH_STAR = (3200, 200, 64, 64)
# the streamed north-star of phases 6, 11, 12 and 14: the same 3.3 MB
# records, 800 of them (40 slabs), so the streamed phases leave room in
# the time limit; phases 16 and 17 stream the full depth
STREAM_NS = (800,) + NORTH_STAR[1:]
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
# phase 11's resident ceiling for config 1's swap (0.66 GB): it spills
SPILL_BUDGET = 1 << 28
# results of phases 6 and 11 that phase 12's resumed runs must equal bit
# for bit (value-shaped tensors on the card)
KEEP = {}
# phase 13's serving configurations (scripts/bench_all.py): config 9's four
# tenants each stream 128 MB in 16 slabs of 128 records from a source that
# sleeps 25 ms a slab; config 14's 256 requests of (128, 32) f32 over 8
# bases
CONFIG9 = (2048, 256, 64)
CONFIG9_SLAB_RECORDS = 128
CONFIG9_LATENCY_S = 0.025
CONFIG14 = (128, 32)
SERVE_REQUESTS = 256
SERVE_BASES = 8


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


def queued_device_us(fn, reps=200):
    """Device microseconds a call of ``fn``: CUDA events around ``reps``
    calls queued behind ``torch.cuda._sleep``, so the card runs them back
    to back and never waits on the host (``timed_ms`` of a call the host
    paces measures the host).  ``(us, paced)``: ``paced`` when even the
    longest sleep tried ran out before the last call was queued."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000                 # about 10 ms at the H100's clock
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        paced = start.query()
        torch.cuda.synchronize()
        if not paced:
            break
        cycles *= 4
    return start.elapsed_time(stop) * 1e3 / reps, paced


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
    # a stat terminal is lazy: cache() resolves it inside the wall
    s, wall, grow = measured(torch, lambda: b.map(plus1).sum().cache())
    check(K.LAUNCHES["fused_map_reduce"] == before + 1,
          "north-star map(v+1).sum() launched fused_map_reduce %d times"
          % (K.LAUNCHES["fused_map_reduce"] - before))
    # the same callable again: its program comes from the compiler's cache,
    # so this wall has no trace in it
    _, cached_wall, _ = measured(torch, lambda: b.map(plus1).sum().cache())
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


def config4_mask(torch, x, f):
    """Config 4's mask, ``(x + 1).mean() > 1`` per record, held against
    the predicate over the whole ``x + 1`` at once (how the port took it
    before the filter ran over blocks of records): the blocked mask of the
    pending filter ``f`` must equal it, or differ only at records whose
    f64 mean lies within rounding of the bound.  Returns the blocked mask
    (what the port's terminals keep) and the number of records that
    differ."""
    from bolt_tpu_torch.gpu.array import _filter_blocks, _pred_mask
    fp = f._fpending
    whole = _pred_mask(fp[2], x + 1)
    blocked = torch.cat([_pred_mask(fp[2], recs) for _, _, recs in
                         _filter_blocks(fp, torch.float32)])
    differ = (whole != blocked).nonzero().flatten().tolist()
    xv = x.view(x.shape[0], -1)
    for i in differ:
        d = xv[i].double() + 1
        gap = abs(float(d.mean()) - 1)
        tol = 4 * math.sqrt(d.numel()) * 2.0 ** -24 * float(d.abs().mean())
        check(gap <= tol, "config 4: record %d's blocked and whole masks "
              "differ %.3g from the bound (rounding %.3g)" % (i, gap, tol))
    return blocked, len(differ)


def config4_north_star(bolt, K, torch, b, x, report):
    """Config 4 at the north-star: ``map(v + 1).filter(v.mean() > 1)`` with
    ``sum()`` and ``mean()`` through one masked ``fused_map_reduce`` launch
    each, against f64 references of the same mask; an all-False filter."""
    n = NORTH_STAR[0]

    def pred(v):
        return v.mean() > 1

    mask, differ = config4_mask(torch, x, b.map(lambda v: v + 1).filter(
        pred))
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
            b.map(lambda v: v + 1).filter(pred), name)().cache())
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
    report["config4_north_star"] = {"survivors": count, "runs": out,
                                    "mask_records_blocked_vs_whole": differ}
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
    cb = seeded_records(np, STREAM_NS[1:])

    def source(codec=None):
        return bolt.fromcallback(cb, STREAM_NS, mode="gpu",
                                 dtype=np.float32, codec=codec)

    n = STREAM_NS[0]
    nslabs = len(source()._stream.slab_ranges())
    check(source()._stream.slab == SLAB_RECORDS and nslabs == -(
        -n // SLAB_RECORDS), "streamed north-star slab plan")
    with stream.uploaders(4):
        # the f64 references of the same source, materialised on the card
        # (the pool produces its slabs) and freed before the streamed runs
        t = time.perf_counter()
        mat = source()
        x = mat.totorch()
        check(tuple(x.shape) == STREAM_NS and not mat.streaming,
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
                    STREAM_NS),
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
        KEEP["ns_map_sum"] = s1
        mean = run("mean", lambda: source().mean())
        errs["mean"] = close(mean, ref["mean"], 1e-5, 1e-6,
                             "streamed mean()")
        var = run("var", lambda: source().var())
        errs["var"] = close(var, ref["var"], 1e-4, 1e-5, "streamed var()")
        raw = run("sum", lambda: source().sum(), profiled=True)
        # phase 11 holds its group's sum, mean and var against these
        # standalone streamed terminals of the same source
        KEEP["ns_standalone"] = {"sum": raw, "mean": mean, "var": var}
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
            source("bf16").min().totorch()   # refused at the read
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


def surface_refs(torch, xv, pred_mask, chunk=4096):
    """Phase 7's references over the (n, C) north-star tensor ``xv``, in
    column chunks on the card: of the chain ``c = exp(-(v ** 2)) * 0.5``
    (its f32 values computed as the chain computes them, then summed in
    f64; min and max exact), of the raw values, the count of ``v > 0``,
    and of ``v + 1`` over the records kept by ``pred_mask``."""
    keys = ("c_sum", "c_mean", "c_var", "c_min", "c_max", "x_sum", "x_abs",
            "x_std", "x_min", "x_max", "pos", "f_sum", "f_abs")
    parts = {k: [] for k in keys}
    for j in range(0, xv.shape[1], chunk):
        xc = xv[:, j:j + chunk]
        c = (torch.exp(-(xc ** 2)) * 0.5)
        d = c.double()
        parts["c_sum"].append(d.sum(0))
        parts["c_mean"].append(d.mean(0))
        parts["c_var"].append(d.var(0, correction=0))
        parts["c_min"].append(c.amin(0))
        parts["c_max"].append(c.amax(0))
        d = xc.double()
        parts["x_sum"].append(d.sum(0))
        parts["x_abs"].append(d.abs().sum(0))
        parts["x_std"].append(d.std(0, correction=0))
        parts["x_min"].append(xc.amin(0))
        parts["x_max"].append(xc.amax(0))
        parts["pos"].append((xc > 0).sum(0))
        f = xc[pred_mask].double() + 1
        parts["f_sum"].append(f.sum(0))
        parts["f_abs"].append(f.abs().sum(0))
        del c, d, f
    return {k: torch.cat(v, 0) for k, v in parts.items()}


def surface_north_star(bolt, K, torch, np):
    """Phase 7 at the north-star: the ufunc chain's sum through
    ``fused_map_reduce``, the seven-member stat group against its
    standalone terminals (bit for bit, walls, peak growth), the fluent
    ``stats``, a comparison's count and ``==``, and config 4's filter
    under the blocked mask (peak growth under 1 GB)."""
    from bolt_tpu_torch import engine
    n = NORTH_STAR[0]
    out = {}
    b = bolt.randn(NORTH_STAR, mode="gpu", dtype=np.float32, seed=0)
    x = b.totorch()
    xv = x.view(n, -1)

    def pred(v):
        return v.mean() > 1

    mask, differ = config4_mask(torch, x, b.map(lambda v: v + 1).filter(
        pred))
    count = int(mask.sum())
    ref = surface_refs(torch, xv, mask)
    tol = 4 * math.sqrt(n) * 2.0 ** -24

    def chain():
        return np.exp(-(b ** 2)) * 0.5

    # the ufunc chain's sum: one fused_map_reduce launch from the base
    c = chain()
    check(c.deferred and len(c._chain[1]) == 4, "the ufunc chain is not one "
          "deferred chain of four entries")
    before = K.LAUNCHES["fused_map_reduce"]
    s, wall, grow = measured(torch, lambda: c.sum().cache())
    check(K.LAUNCHES["fused_map_reduce"] == before + 1,
          "np.exp(-(b ** 2)) * 0.5).sum() launched fused_map_reduce %d "
          "times" % (K.LAUNCHES["fused_map_reduce"] - before))
    err = (s.totorch().reshape(-1).double() - ref["c_sum"]).abs()
    check(bool((err <= tol * ref["c_sum"]).all()), "ufunc chain sum: max "
          "abs err %.3g" % float(err.max()))
    out["chain_sum"] = {"wall_s": wall, "peak_growth_gb": grow / 1e9,
                        "max_abs_err": float(err.max())}
    del s, c

    # the group against the sum of its standalone terminals
    names = ("sum", "mean", "var", "std", "min", "max", "ptp")
    c = chain()
    handles = [getattr(c, name)() for name in names]
    g0 = engine.counters()["fused_stat_groups"]
    before = K.LAUNCHES["fused_map_reduce"]
    _, gwall, ggrow = measured(torch, lambda: bolt.compute(*handles))
    check(engine.counters()["fused_stat_groups"] == g0 + 1,
          "bolt.compute of seven members counted %d groups"
          % (engine.counters()["fused_stat_groups"] - g0))
    check(K.LAUNCHES["fused_map_reduce"] == before + 1,
          "the group's sum did not launch fused_map_reduce once")
    check(ggrow <= x.numel() * 4 + 1e9, "the group grew the peak by %.3f GB"
          % (ggrow / 1e9))
    walls, grows = {}, {}
    for name, h in zip(names, handles):
        alone, walls[name], grows[name] = measured(
            torch, lambda: getattr(chain(), name)().cache())
        check(torch.equal(h.totorch(), alone.totorch()),
              "the group's %s differs from its standalone terminal" % name)
        del alone
    got = {name: h.totorch().reshape(-1) for name, h in zip(names, handles)}
    errs = {"sum": float((got["sum"].double() - ref["c_sum"]).abs().max())}
    check(bool(((got["sum"].double() - ref["c_sum"]).abs()
                <= tol * ref["c_sum"]).all()), "group sum")
    errs["mean"] = close(got["mean"], ref["c_mean"], 1e-5, 1e-7,
                         "group mean")
    errs["var"] = close(got["var"], ref["c_var"], 1e-4, 1e-7, "group var")
    errs["std"] = close(got["std"], ref["c_var"].sqrt(), 1e-4, 1e-7,
                        "group std")
    check(torch.equal(got["min"], ref["c_min"]) and torch.equal(
        got["max"], ref["c_max"]) and torch.equal(
        got["ptp"], ref["c_max"] - ref["c_min"]), "group min/max/ptp")
    del handles, got
    out["group"] = {"wall_s": gwall, "peak_growth_gb": ggrow / 1e9,
                    "standalone_walls_s": walls,
                    "standalone_sum_s": sum(walls.values()),
                    "standalone_peak_growth_gb": max(grows.values()) / 1e9,
                    "max_abs_err": errs}

    # the fluent form over the raw values
    st, swall, _ = measured(torch, lambda: b.stats("sum", "std", "ptp"))
    check(list(st) == ["sum", "std", "ptp"], "fluent stats keys")
    d = (st["sum"].totorch().reshape(-1).double() - ref["x_sum"]).abs()
    check(bool((d <= tol * ref["x_abs"]).all()), "fluent sum")
    close(st["std"].totorch().reshape(-1), ref["x_std"], 1e-4, 1e-6,
          "fluent std")
    check(torch.equal(st["ptp"].totorch().reshape(-1),
                      ref["x_max"] - ref["x_min"]), "fluent ptp")
    del st
    # a comparison's count, exact, and b == b
    pos, pwall, _ = measured(torch, lambda: (b > 0).sum().cache())
    check(torch.equal(pos.totorch().reshape(-1), ref["pos"]),
          "(b > 0).sum() against the count")
    eq, ewall, _ = measured(torch, lambda: (b == b).all().cache())
    check(bool(eq.totorch().all()), "(b == b).all()")
    del pos, eq
    out["fluent_wall_s"], out["count_wall_s"], out["eq_all_wall_s"] = \
        swall, pwall, ewall

    # config 4 under the blocked mask: no mapped temporary of the chain
    runs = {}
    for name in ("sum", "mean"):
        before = K.LAUNCHES["fused_map_reduce"]
        r, wall, grow = measured(torch, lambda: getattr(
            b.map(lambda v: v + 1).filter(pred), name)().cache())
        check(K.LAUNCHES["fused_map_reduce"] == before + 1,
              "config 4 filter().%s() did not launch fused_map_reduce once"
              % name)
        check(grow < FUSED_SUM_PEAK_BYTES, "config 4 filter().%s() grew the "
              "peak device memory by %.3f GB" % (name, grow / 1e9))
        g = r.totorch().reshape(-1).double() * (count if name == "mean"
                                                 else 1)
        d = (g - ref["f_sum"]).abs()
        check(bool((d <= 4 * math.sqrt(count) * 2.0 ** -24 * ref[
            "f_abs"]).all()), "config 4 filter().%s(): max abs err %.3g"
            % (name, float(d.max())))
        runs[name] = {"wall_s": wall, "peak_growth_gb": grow / 1e9}
        del r
    out["config4"] = {"survivors": count, "runs": runs,
                      "mask_records_blocked_vs_whole": differ}
    del b, x, xv, ref, mask
    return out


def surface_config1(bolt, torch, np):
    """Phase 7 at config 1: ``np.asarray`` beside ``toarray``, quantiles,
    arg-reductions, sorts, ``cumsum``, gathers, ``diagonal``/``trace`` and
    ``@``, each held against numpy on the host."""
    out = {}
    b = bolt.randn(CONFIG1, mode="gpu", dtype=np.float32, seed=1)

    def host(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    xh, out["toarray_s"] = host(b.toarray)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        a, out["asarray_s"] = host(lambda: np.asarray(b))
    check(a.dtype == b.dtype and np.array_equal(a, xh),
          "np.asarray(b) against toarray()")
    check(len(seen) <= 1, "np.asarray warned %d times" % len(seen))
    del a
    # quantiles over the key axis: 819200 slices of 200 (1.6e8 values)
    med, out["median_s"] = host(lambda: b.median().toarray())
    np.testing.assert_allclose(med, np.median(xh, axis=0), rtol=1e-6,
                               atol=1e-6)
    qs, out["quantile_s"] = host(lambda: b.quantile([0.1, 0.9]).toarray())
    np.testing.assert_allclose(qs, np.quantile(xh, [0.1, 0.9], axis=0),
                               rtol=1e-5, atol=1e-6)
    del med, qs
    for name in ("argmax", "argmin"):
        r, out[name + "_s"] = host(lambda: getattr(b, name)(axis=0)
                                   .toarray())
        check(np.array_equal(r, getattr(np, name)(xh, axis=0)),
              "%s over the key axis" % name)
    # sorts along the last axis: the first records against numpy, every
    # row through the gather of its indices
    srt = b.astype(np.float32)
    _, out["sort_s"] = host(lambda: srt.sort(axis=-1))
    s = srt.totorch()
    check(np.array_equal(s[:8].cpu().numpy(), np.sort(xh[:8], axis=-1)),
          "sort along the last axis")
    idx, out["argsort_s"] = host(lambda: b.argsort(axis=-1).totorch())
    check(torch.equal(torch.gather(b.totorch(), -1, idx), s)
          and np.array_equal(idx[:8].cpu().numpy(),
                             np.argsort(xh[:8], axis=-1, kind="stable")),
          "argsort along the last axis")
    del srt, s, idx
    cs, out["cumsum_s"] = host(lambda: b.cumsum(axis=3).toarray())
    want = np.cumsum(xh.astype(np.float64), axis=3)
    np.testing.assert_allclose(cs, want, rtol=1e-5, atol=1e-4)
    del cs, want
    picks = [0, CONFIG1[0] // 3, CONFIG1[0] - 1, -1]
    tk, out["take_s"] = host(lambda: b.take(picks, axis=0).toarray())
    check(np.array_equal(tk, xh.take(picks, axis=0)), "take")
    nz, out["nonzero_s"] = host(lambda: (b > 2).nonzero())
    check(all(np.array_equal(p, q) for p, q in zip(nz, np.nonzero(
        xh > 2))), "nonzero of b > 2")
    out["nonzero_count"] = int(nz[0].size)
    del nz, tk
    row = b[0].ravel()
    row.sort()
    v = np.linspace(-3, 3, 1001)
    ss, out["searchsorted_s"] = host(lambda: row.searchsorted(v))
    check(np.array_equal(ss, np.searchsorted(np.sort(xh[0].ravel()), v)),
          "searchsorted")
    rp, out["repeat_s"] = host(lambda: b[:4].repeat(2, axis=1).toarray())
    check(np.array_equal(rp, xh[:4].repeat(2, axis=1)), "repeat")
    dg, out["diagonal_s"] = host(lambda: b.diagonal(0, 2, 3).toarray())
    check(np.array_equal(dg, xh.diagonal(0, 2, 3)), "diagonal")
    tr, out["trace_s"] = host(lambda: b.trace(0, 2, 3).toarray())
    np.testing.assert_allclose(tr, xh.astype(np.float64).trace(0, 2, 3),
                               rtol=1e-5, atol=1e-4)
    del row, rp, dg, tr
    # b @ w with TF32 off: f32 products accumulated in f32, each element
    # within 64 * 2^-24 of sum |x||w| (a few times the rounding of 64 terms)
    w = np.random.default_rng(3).standard_normal((64, 64)).astype(np.float32)
    mm, out["matmul_s"] = host(lambda: (b @ w).totorch())
    got = mm[:4].double().cpu().numpy()
    x64 = xh[:4].astype(np.float64)
    err = np.abs(got - x64 @ w.astype(np.float64))
    check(bool((err <= 64 * 2.0 ** -24 * (np.abs(x64) @ np.abs(
        w.astype(np.float64))) + 1e-6).all()), "b @ w: max abs err %.3g"
        % err.max())
    out["matmul_max_abs_err"] = float(err.max())
    del b, xh, mm
    return out


def surface_phase(bolt, K, torch, np, report):
    """Phase 7, the array surface and the stat groups; returns the path's
    launches."""
    t0 = time.perf_counter()
    K.reset_launches()
    report["surface_north_star"] = surface_north_star(bolt, K, torch, np)
    report["surface_config1"] = surface_config1(bolt, torch, np)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check(launches["fused_map_reduce"] > 0,
          "the surface phase never launched fused_map_reduce")
    report["surface_launches"] = launches
    report["phases"]["surface_s"] = time.perf_counter() - t0
    ns = report["surface_north_star"]
    log("surface phase ok in %.1f s: group %.4f s against its standalone "
        "terminals %.4f s (peak growth %.3f GB); config 4 peak growth %s GB;"
        " np.asarray %.3f s against toarray %.3f s; launches %s"
        % (report["phases"]["surface_s"], ns["group"]["wall_s"],
           ns["group"]["standalone_sum_s"], ns["group"]["peak_growth_gb"],
           json.dumps({k: v["peak_growth_gb"]
                       for k, v in ns["config4"]["runs"].items()}),
           report["surface_config1"]["asarray_s"],
           report["surface_config1"]["toarray_s"], json.dumps(launches)))
    return launches


def donation_case(torch, label, fn):
    """One donation case under its own peak window: ``fn()``'s result,
    the grants it counted, its wall and the growth of peak device memory
    over what was allocated before it."""
    from bolt_tpu_torch import engine
    n0 = engine.counters()["donations"]
    out, wall, grow = measured(torch, fn)
    grants = engine.counters()["donations"] - n0
    log("donation %s: %d grant(s), %.4f s, peak growth %.4f GB"
        % (label, grants, wall, grow / 1e9))
    return out, grants, wall, grow


def consumed(arr):
    """True when reading ``arr`` raises the donation guard."""
    try:
        arr.toarray()
    except RuntimeError as exc:
        return "donated" in str(exc)
    return False


def engine_phase(bolt, K, torch, np, dev, report):
    """Phase 8: the engine's program cache, donation, ``stacked`` and
    ``profile``/``obs`` on the card; returns the path's launches."""
    from bolt_tpu_torch import engine, obs, profile
    from bolt_tpu_torch.gpu import array as garray
    t0 = time.perf_counter()
    n = NORTH_STAR[0]
    out = {}
    seed = 0                              # phase 3's seed

    def randn():
        return bolt.randn(NORTH_STAR, mode="gpu", dtype=np.float32,
                          seed=seed)

    def plus1(v):
        return v + 1

    # ---- the program cache at the north-star ------------------------------
    K.reset_launches()
    b = randn()
    xv = b.totorch().view(n, -1)
    ref = f64_column_refs(xv)
    calls = []
    for i in range(3):
        c0 = engine.counters()
        before = K.LAUNCHES["fused_map_reduce"]
        s, wall, _ = measured(torch, lambda: b.map(plus1).sum().cache())
        c1 = engine.counters()
        check(K.LAUNCHES["fused_map_reduce"] == before + 1,
              "cached map-sum call %d launched fused_map_reduce %d times"
              % (i, K.LAUNCHES["fused_map_reduce"] - before))
        calls.append({"wall_s": wall,
                      "misses": c1["misses"] - c0["misses"],
                      "hits": c1["hits"] - c0["hits"],
                      "aot_compiles": c1["aot_compiles"] - c0["aot_compiles"]})
        if i == 0:
            first = s.totorch()
        else:
            check(torch.equal(s.totorch(), first), "cached map-sum call %d "
                  "differs from the first" % i)
        del s
    check(calls[0]["misses"] >= 1, "the first map-sum did not miss")
    check(all(c["misses"] == 0 and c["hits"] == 1 and c["aot_compiles"] == 0
              for c in calls[1:]), "repeated map-sums did not hit the "
          "cache: %s" % calls)
    sum_close(first.reshape(-1), ref, n, "cached map-sum")
    del first
    def plus2(v):
        return v + 2

    with profile.instrument() as one:
        for _ in range(3):
            b.map(plus2).sum().cache()
    with profile.instrument() as fresh:
        for _ in range(3):
            b.map(lambda v: v + 1).sum().cache()
    check(one["stat"]["builds"] == 1 and one["stat"]["calls"] == 3,
          "instrument, one f: %s" % one.get("stat"))
    check(fresh["stat"]["builds"] == 3 and fresh["stat"]["calls"] == 3,
          "instrument, fresh lambdas: %s" % fresh.get("stat"))
    # the shape inference a cached call no longer pays
    vshape, dt = NORTH_STAR[1:], torch.float32
    tin = time.perf_counter()
    for _ in range(20):
        garray._infer_record(plus1, vshape, dt)
    infer_ms = (time.perf_counter() - tin) / 20 * 1e3
    tin = time.perf_counter()
    for _ in range(20):
        garray._infer_map(plus1, vshape, dt)
    cached_infer_ms = (time.perf_counter() - tin) / 20 * 1e3
    before = K.LAUNCHES["fused_welford"]
    st = b.stats()
    check(K.LAUNCHES["fused_welford"] == before + 1,
          "stats() did not launch fused_welford through the cache")
    close(torch.from_numpy(st.mean()).to(dev).reshape(-1), ref["mean"],
          1e-5, 1e-6, "phase 8 stats mean")
    _, timeit_s = profile.timeit(lambda: b.map(plus1).sum(), iters=5)
    out["cache"] = {
        "calls": calls, "cached_wall_s": min(c["wall_s"] for c in calls[1:]),
        "phase3_cached_wall_s": report["map_sum"]["fused_cached_wall_s"],
        "timeit_best_s": timeit_s, "instrument_one_f": one["stat"],
        "instrument_fresh": fresh["stat"],
        "shape_inference_ms": infer_ms,
        "cached_shape_inference_ms": cached_infer_ms}
    log("program cache: map-sum walls %s s (misses %s, hits %s), timeit "
        "best %.4f s; shape inference %.3f ms uncached, %.4f ms cached"
        % ([round(c["wall_s"], 5) for c in calls],
           [c["misses"] for c in calls], [c["hits"] for c in calls],
           timeit_s, infer_ms, cached_infer_ms))
    del b, xv, st, ref
    launches = dict(K.LAUNCHES)
    check(launches["fused_map_reduce"] > 0 and launches["fused_welford"] > 0,
          "phase 8 never launched fused_map_reduce or fused_welford")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- donation at the north-star ---------------------------------------
    rec_bytes = 4 * math.prod(NORTH_STAR[1:])
    block = garray._block_records(rec_bytes) * rec_bytes
    recs = (0, 1, n // 3, n - 1)
    don = {}
    # materialisation: the result lands in the base's storage
    dd = randn().map(plus1)
    ptr = dd._chain[0].data_ptr()
    _, grants, wall, grow = donation_case(torch, "cache()", dd.cache)
    check(grants == 1 and dd.totorch().data_ptr() == ptr,
          "a sole-owned chain's cache() was not donated in place")
    check(grow < 1e9, "donated cache() grew the peak by %.3f GB"
          % (grow / 1e9))
    r = randn().totorch()
    for k in recs:
        close(dd.totorch()[k], r[k].double() + 1, 2.0 ** -23, 0,
              "donated cache() record %d" % k)
    don["cache"] = {"grants": grants, "wall_s": wall,
                    "peak_growth_gb": grow / 1e9, "block_gb": block / 1e9}
    del dd, r
    # stacked(1000): one stack block is 1000 records (3.28 GB), so the
    # groups are single blocks and the growth is about two of them
    size = 1000
    dd = randn().map(plus1)
    ptr = dd._chain[0].data_ptr()
    st_out, grants, wall, grow = donation_case(
        torch, "stacked(%d).map()" % size,
        lambda: dd.stacked(size).map(
            lambda blk: blk - blk.mean(0, keepdim=True)).unstack())
    group = max(size, garray._block_records(rec_bytes) // size * size)
    check(grants == 1 and st_out.totorch().data_ptr() == ptr,
          "stacked().map() was not donated in place")
    check(grow < 2 * group * rec_bytes + (1 << 28), "donated stacked map "
          "grew the peak by %.3f GB (group %.3f GB)"
          % (grow / 1e9, group * rec_bytes / 1e9))
    check(consumed(dd), "the stacked map's source is still readable")
    r = randn().totorch().view(n, -1)
    got = st_out.totorch().view(n, -1)
    for lo in sorted({0, (n - 1) // size * size}):   # a block, the tail
        hi = min(lo + size, n)
        for j in range(0, r.shape[1], 1 << 16):
            want = r[lo:hi, j:j + (1 << 16)].double() + 1
            close(got[lo:hi, j:j + (1 << 16)],
                  want - want.mean(0, keepdim=True), 1e-5, 1e-5,
                  "stacked block at record %d" % lo)
        del want
    don["stacked"] = {"size": size, "grants": grants, "wall_s": wall,
                      "peak_growth_gb": grow / 1e9,
                      "group_gb": group * rec_bytes / 1e9}
    del dd, st_out, r, got
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # a stat: the base is dropped once read
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    dd = randn().map(plus1)
    m, grants, wall, grow = donation_case(
        torch, "mean()", lambda: dd.mean().cache())
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - alloc0
    check(grants == 1 and consumed(dd), "mean() was not donated")
    check(left < 64 << 20, "the donated mean() left %.3f GB allocated"
          % (left / 1e9))
    r = randn().totorch().view(n, -1)
    close(m.totorch().reshape(-1), f64_column_refs(r)["mean"] + 1, 1e-5,
          1e-6, "donated mean()")
    don["mean"] = {"grants": grants, "wall_s": wall,
                   "peak_growth_gb": grow / 1e9, "left_gb": left / 1e9}
    del dd, m, r
    # refusals: a clone shares the chain, a live parent owns the base
    dd = randn().map(plus1)
    cl = dd._clone()
    _, grants, _, _ = donation_case(torch, "clone refusal", dd.cache)
    check(grants == 0, "a chain shared with a clone was donated")
    r = randn().totorch()
    for k in recs:
        check(torch.equal(dd.totorch()[k], r[k] + 1) and torch.equal(
            cl.totorch()[k], r[k] + 1), "clone refusal record %d" % k)
    del dd, cl
    p = randn()
    e = p.map(plus1)
    _, grants, _, _ = donation_case(torch, "live-parent refusal", e.cache)
    check(grants == 0, "a chain whose parent is referenced was donated")
    for k in recs:
        check(torch.equal(p.totorch()[k], r[k]) and torch.equal(
            e.totorch()[k], r[k] + 1), "live-parent refusal record %d" % k)
    don["refusals"] = "clone and live parent: no grant, both readable"
    out["donation"] = don
    del p, e, r
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- stacked at config 1, against the local oracle ---------------------
    for size in (50, 64):
        got = bolt.ones(CONFIG1, mode="gpu", dtype=np.float32).map(
            plus1).stacked(size).map(
            lambda blk: blk * 3 - blk.mean(0)).unstack().toarray()
        want = bolt.ones(CONFIG1, dtype=np.float32).map(
            lambda v: v + 1).stacked(size).map(
            lambda blk: blk * 3 - blk.mean(0)).unstack().toarray()
        check(got.shape == want.shape and np.array_equal(got, want),
              "config 1 stacked(%d) against the local oracle" % size)
        del got, want
    # ---- profile and obs on the card ---------------------------------------
    ms = profile.memory_stats()
    check(set(ms) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
          and all(isinstance(v, int) for v in ms.values()),
          "memory_stats(): %s" % ms)
    b = randn()
    logdir = os.path.join(ROOT, "chiprun_out", "phase8_trace")
    with profile.trace(logdir):
        b.map(plus1).sum().cache()
    traces = [f for f in os.listdir(logdir) if f.endswith(".json")]
    check(traces, "profile.trace wrote no trace")
    path = os.path.join(ROOT, "chiprun_out", "phase8_timeline.json")
    rec = NORTH_STAR[1:]

    def cb(index):
        lo, hi = index[0].start, index[0].stop
        return np.stack([np.random.default_rng(STREAM_SEED + r)
                         .standard_normal(rec, dtype=np.float32)
                         for r in range(lo, hi)])

    short = (8 * SLAB_RECORDS,) + rec
    with obs.timeline(path):
        b.map(plus1).sum().cache()
        ssum = bolt.fromcallback(cb, short, mode="gpu",
                                 dtype=np.float32).sum().toarray()
    check(obs.active_count() == 0, "spans left open")
    pairs = chrome_pairs(path)
    want = np.zeros(rec, np.float64)
    for lo in range(0, short[0], SLAB_RECORDS):
        want += cb((slice(lo, lo + SLAB_RECORDS),)).sum(0, dtype=np.float64)
    np.testing.assert_allclose(ssum, want, rtol=1e-4, atol=1e-4)
    out["obs"] = {"memory_stats": ms, "trace_files": traces,
                  "chrome_pairs": pairs}
    del b
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    report["engine_phase"] = out
    log("engine phase ok in %.1f s: %s" % (out["phase_s"], json.dumps(
        {k: out[k] for k in ("cache", "donation")})))
    return launches


def chrome_pairs(path):
    """The B/E pairs of the Chrome export at ``path``, checked to balance
    with stack discipline on every thread; returns their count."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    stacks, pairs = {}, 0
    for e in evs:
        if e.get("ph") == "B":
            stacks.setdefault(e["tid"], []).append(e)
        elif e.get("ph") == "E":
            st = stacks.get(e["tid"])
            check(bool(st), "E without an open B on tid %s" % e["tid"])
            bev = st.pop()
            check(bev["name"] == e["name"], "B %s closed by E %s"
                  % (bev["name"], e["name"]))
            pairs += 1
    check(all(not st for st in stacks.values()), "unbalanced B events")
    names = {e["name"] for e in evs}
    check({"stream.run", "stream.ingest", "stream.compute",
           "engine.dispatch"} <= names, "timeline spans: %s" % sorted(names))
    return pairs


def wall_s(torch, fn, reps):
    """Mean synchronised wall seconds of ``fn()`` over ``reps`` runs after
    one warm-up run (host dispatch included)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps


def config5b_case(bolt, torch, np, out):
    """Phase 9's BASELINE config 5b at full width: the per-chunk Gram-route
    ``ops.svdvals`` over ``(8, 4194304, 16)`` f32, its route, a sample of
    chunks against numpy f64, its wall beside config 5's library SVD, and
    the split between the Gram and ``jacobi_eigh``."""
    from bolt_tpu_torch import ops
    from bolt_tpu_torch.ops import linalg
    keys, rows, d = CONFIG5B
    chunk = 1024
    grid = rows // chunk
    b = bolt.randn(CONFIG5B, mode="gpu", dtype=np.float32, seed=5)
    x = b.totorch()
    routes = []
    use = linalg._use_jacobi

    def recording(g):
        routed = use(g)
        routes.append((linalg._true_batch(g), routed))
        return routed

    def svd5b():
        return b.chunk(size=(chunk,), axis=(0,)).map(
            lambda blk: ops.svdvals(blk)[None, :]).unchunk().totorch()

    def svd5():
        return b.chunk(size=(chunk,), axis=(0,)).map(
            lambda blk: torch.linalg.svdvals(blk)[None, :]).unchunk(
        ).totorch()

    linalg._use_jacobi = recording
    try:
        got = svd5b()
    finally:
        linalg._use_jacobi = use
    check(tuple(got.shape) == (keys, grid, d), "config 5b shape %s"
          % (tuple(got.shape),))
    check((keys * grid, True) in routes and keys * grid * d >= 2048,
          "config 5b did not take the Jacobi route: %s" % routes)
    # 512 chunks across both ends of both axes against numpy f64
    half = min(128, grid // 2)
    ks, gs = (0, keys - 1), list(range(half)) + list(range(grid - half, grid))
    worst = 0.0
    for k in ks:
        blocks = x[k].view(grid, chunk, d)[gs].double().cpu().numpy()
        want = np.linalg.svd(blocks, compute_uv=False)
        err = np.abs(got[k, gs].double().cpu().numpy() - want) \
            / want[:, :1]
        worst = max(worst, float(err.max()))
    check(worst <= 1e-4, "config 5b against numpy f64: %.3g of s_max"
          % worst)
    out["config5b"] = {"sampled_chunks": len(ks) * len(gs),
                       "max_rel_err": worst,
                       "wall_s": wall_s(torch, svd5b, 3)}
    t = time.perf_counter()
    lib = svd5()
    torch.cuda.synchronize()
    out["config5_library_wall_s"] = time.perf_counter() - t
    check(bool(torch.allclose(lib, got, rtol=0, atol=1e-4 * float(
        got.max()))), "config 5 and 5b disagree")
    del lib, got
    # the split: the batched Gram (bound: the 2.15 GB read) and the
    # eigensolver alone on the (32768, 16, 16) Grams
    xb = x.view(keys * grid, chunk, d)
    gram = torch.matmul(xb.transpose(1, 2), xb)
    gram_ms = timed_ms(lambda: torch.matmul(xb.transpose(1, 2), xb), 5)
    jac_ms = timed_ms(lambda: ops.jacobi_eigh(gram), 3)
    try:
        eig_ms = timed_ms(lambda: torch.linalg.eigvalsh(gram), 3)
        out["eigvalsh_form"] = "one call on the (32768, 16, 16) batch"
    except torch._C._LinAlgError as exc:
        # the library refuses the whole batch: time it in slices of 4096
        out["eigvalsh_error"] = str(exc).splitlines()[0][:200]
        out["eigvalsh_form"] = "8 calls of 4096 (the whole batch refused)"
        eig_ms = timed_ms(lambda: [torch.linalg.eigvalsh(gram[s:s + 4096])
                                   for s in range(0, gram.shape[0], 4096)],
                          3)
    jac_wall = wall_s(torch, lambda: ops.jacobi_eigh(gram), 2)
    # as config 5b runs it: under the chunk map's vmaps (keys, grid)
    from torch.func import vmap
    grams = gram.view(keys, grid, d, d)
    out["jacobi_vmapped_ms"] = timed_ms(
        lambda: vmap(vmap(ops.jacobi_eigh))(grams), 3)
    _, dev_us, _ = device_us(lambda: ops.jacobi_eigh(gram))
    w = ops.jacobi_eigh(gram)
    wl = torch.cat([torch.linalg.eigvalsh(gram[s:s + 4096].double())
                    for s in range(0, gram.shape[0], 4096)])
    jerr = float(((w.double() - wl).abs() / wl.abs().amax(-1, keepdim=True)
                  ).max())
    check(jerr <= 1e-4, "jacobi_eigh against eigvalsh f64: %.3g" % jerr)
    out["gram_ms"] = gram_ms
    out["gram_bound_ms"] = x.numel() * 4 / HBM_BYTES_PER_S * 1e3
    out["jacobi_ms"] = jac_ms
    out["jacobi_wall_ms"] = jac_wall * 1e3
    out["jacobi_device_ms"] = None if dev_us is None else dev_us / 1e3
    out["jacobi_bound_ms"] = gram.numel() * 4 / HBM_BYTES_PER_S * 1e3
    out["eigvalsh_ms"] = eig_ms
    out["jacobi_max_rel_err"] = jerr
    del b, x, xb, gram, w, wl


def pca_case(bolt, torch, np, out):
    """Phase 9's ``pca`` (and ``cov``/``corrcoef``) of ``(33554432, 16)``
    f32 with distinct feature scales, plain and through a chain, against
    f64 statistics built block by block on the card."""
    from bolt_tpu_torch import ops
    n, d = PCA_SHAPE
    b = bolt.randn(PCA_SHAPE, mode="gpu", dtype=np.float32, seed=9)
    x = b.totorch()
    # distinct variances 1..16: the components are well conditioned
    x.mul_(torch.linspace(1.0, 4.0, d, device=x.device))

    def f64_stats(shift, scale):
        g = torch.zeros((d, d), dtype=torch.float64, device=x.device)
        s1 = torch.zeros(d, dtype=torch.float64, device=x.device)
        for s in range(0, n, 1 << 22):
            xd = x[s:s + (1 << 22)].double() * scale + shift
            g += xd.T @ xd
            s1 += xd.sum(0)
            del xd
        mu = s1 / n
        c = g - n * torch.outer(mu, mu)
        ev, vec = torch.linalg.eigh(c)
        return c / (n - 1), ev.flip(0).clamp(min=0).sqrt()[:4], \
            vec.flip(1)[:, :4]

    for label, arr, shift, scale in (
            ("plain", b, 0.0, 1.0),
            ("chain", b.map(lambda v: v * 2 + 1), 1.0, 2.0)):
        res, wall, peak = measured(torch, lambda: ops.pca(arr, k=4,
                                                          center=True))
        steady = wall_s(torch, lambda: ops.pca(arr, k=4, center=True), 2)
        scores, comps, sv = res
        cref, svref, vref = f64_stats(shift, scale)
        svref = svref.cpu().numpy()
        rel = float(np.max(np.abs(sv - svref) / svref))
        check(rel <= 1e-4, "pca %s singular values: %.3g" % (label, rel))
        vref = vref.cpu().numpy()
        cerr = 0.0
        for i in range(4):
            sgn = np.sign(np.dot(comps[:, i], vref[:, i])) or 1.0
            cerr = max(cerr, float(np.abs(sgn * comps[:, i]
                                          - vref[:, i]).max()))
        check(cerr <= 1e-3, "pca %s components: %.3g" % (label, cerr))
        check(tuple(scores.shape) == (n, 4), "pca scores shape")
        check(peak <= n * 4 * 4 + 1e9, "pca %s peak growth %.3f GB"
              % (label, peak / 1e9))
        c, cwall, cpeak = measured(torch, lambda: ops.cov(arr))
        cr = cref.cpu().numpy()
        cerr2 = float(np.max(np.abs(c - cr)) / np.abs(cr).max())
        check(cerr2 <= 1e-4, "cov %s: %.3g" % (label, cerr2))
        r, rwall, _ = measured(torch, lambda: ops.corrcoef(arr))
        sd = np.sqrt(np.diag(cr))
        rerr = float(np.max(np.abs(r - cr / np.outer(sd, sd))))
        check(rerr <= 1e-4, "corrcoef %s: %.3g" % (label, rerr))
        out["pca_" + label] = {
            "wall_s": wall, "steady_wall_s": steady,
            "peak_growth_gb": peak / 1e9,
            "sv_max_rel_err": rel, "component_max_err": cerr,
            "cov_wall_s": cwall, "cov_peak_growth_gb": cpeak / 1e9,
            "cov_max_rel_err": cerr2, "corrcoef_wall_s": rwall}
        log("pca %s: %.4f s first call, %.4f s cached, peak growth %.3f "
            "GB; cov %.4f s (%.3f GB); corrcoef %.4f s (%s)"
            % (label, wall, steady, peak / 1e9, cwall, cpeak / 1e9, rwall,
               out["card"]))
        del scores, res
    # fetch=False copies nothing to the host; count what still syncs
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ops.pca(b, k=4, center=True, fetch=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out["pca_fetch_false_syncs"] = sum(
        "synchroniz" in str(w.message) for w in caught)
    return b


def segment_case(bolt, torch, np, out):
    """Phase 9's ``segment_reduce`` at ``(8192, 1024, 64)`` f32 with 256
    segments: both forms of sum and mean, and the scatter max, against
    f64 (and exact) references built block by block on the card; the
    walls that set ``ops/group.py``'s auto constants."""
    from bolt_tpu_torch import ops
    from bolt_tpu_torch.ops import group
    nseg = 256
    b = bolt.randn(SEGMENT_SHAPE, mode="gpu", dtype=np.float32, seed=12)
    x = b.totorch()
    n = SEGMENT_SHAPE[0]
    gen = torch.Generator(device=x.device).manual_seed(13)
    lab = torch.randint(0, nseg, (n,), generator=gen, device=x.device)
    flat = x.view(n, -1)
    ref = torch.zeros((nseg, flat.shape[1]), dtype=torch.float64,
                      device=x.device)
    mag = torch.zeros_like(ref)
    mx = torch.full((nseg, flat.shape[1]), -float("inf"), device=x.device)
    for s in range(0, n, 512):
        blk = flat[s:s + 512].double()
        ref.index_add_(0, lab[s:s + 512], blk)
        mag.index_add_(0, lab[s:s + 512], blk.abs())
        li = lab[s:s + 512, None].expand(-1, flat.shape[1])
        mx.scatter_reduce_(0, li, flat[s:s + 512], reduce="amax")
        del blk
    cnt = torch.bincount(lab, minlength=nseg).double()[:, None].clamp(min=1)
    want = {"sum": (ref, mag), "mean": (ref / cnt, mag / cnt)}
    runs = {}
    for op in ("sum", "mean"):
        for method in ("scatter", "matmul"):
            got = ops.segment_reduce(b, lab, num_segments=nseg, op=op,
                                     method=method).totorch().view(nseg, -1)
            # an f32 sum of k terms: within k * 2^-24 of the sum of |x|
            w, m = want[op]
            err = float(((got.double() - w).abs() / (m + 1e-30)).max())
            check(err <= 64 * 2.0 ** -24, "segment %s %s: %.3g of sum|x|"
                  % (op, method, err))
            runs["%s_%s" % (op, method)] = {"max_err_of_abs_sum": err}
            del got
    gm = ops.segment_reduce(b, lab, num_segments=nseg, op="max").totorch()
    check(bool(torch.equal(gm.view(nseg, -1), mx)), "segment max")
    data_bytes = x.numel() * 4
    flops = 2.0 * nseg * x.numel()
    for method in ("scatter", "matmul"):
        t = wall_s(torch, lambda: ops.segment_reduce(
            b, lab, num_segments=nseg, method=method).totorch(), 3)
        runs["sum_" + method]["wall_s"] = t
    for pr in ("high", "default"):
        t = wall_s(torch, lambda: ops.segment_reduce(
            b, lab, num_segments=nseg, method="matmul",
            precision=pr).totorch(), 3)
        runs["sum_matmul_" + pr] = {"wall_s": t}
    runs["max_scatter"] = {"wall_s": wall_s(torch, lambda: ops.segment_reduce(
        b, lab, num_segments=nseg, op="max").totorch(), 3)}
    out["segment"] = {
        "runs": runs,
        "scatter_bytes_per_s": data_bytes / runs["sum_scatter"]["wall_s"],
        "matmul_flops_per_s": {
            "highest": flops / runs["sum_matmul"]["wall_s"],
            "high": flops / runs["sum_matmul_high"]["wall_s"],
            "default": flops / runs["sum_matmul_default"]["wall_s"]},
        "auto_constants": {"matmul": group._MATMUL_RATE,
                           "scatter": group._SCATTER_BYTES_PER_S}}
    log("segment_reduce (8192, 1024, 64) f32, 256 segments: scatter %.4f s,"
        " matmul %.4f s (high %.4f, default %.4f), max %.4f s (%s)"
        % (runs["sum_scatter"]["wall_s"], runs["sum_matmul"]["wall_s"],
           runs["sum_matmul_high"]["wall_s"],
           runs["sum_matmul_default"]["wall_s"],
           runs["max_scatter"]["wall_s"], out["card"]))
    del b, x, flat, ref, mag, mx, want


def config1_ops_case(bolt, torch, np, out):
    """Phase 9's ``histogram``, ``bincount``, ``unique`` and ``topk`` at
    config 1, each against numpy on the host."""
    from bolt_tpu_torch import ops
    b = bolt.randn(CONFIG1, mode="gpu", dtype=np.float32, seed=1)
    xh = b.toarray()
    walls = {}
    t = time.perf_counter()
    counts, edges = ops.histogram(b, bins=64)
    walls["histogram_s"] = time.perf_counter() - t
    _, en = np.histogram(xh, bins=64)
    check(np.allclose(edges, en, rtol=0, atol=1e-6 * np.abs(en).max()),
          "histogram edges")
    # the counts against an independent count on the card: values below
    # each edge, the last edge closing the last bin
    x = b.totorch()
    et = torch.from_numpy(edges).to(x.device)
    below = torch.stack([(x < e).sum() for e in et])
    want = torch.diff(below)
    want[-1] += (x == et[-1]).sum()
    check(np.array_equal(counts, want.cpu().numpy())
          and int(counts.sum()) == xh.size, "histogram counts")
    ib = b.map(lambda v: (v.abs() * 10).to(torch.int32))
    xi = (np.abs(xh) * 10).astype(np.int32).reshape(-1)
    bn = np.bincount(xi)
    t = time.perf_counter()
    bc = ops.bincount(ib)
    walls["bincount_s"] = time.perf_counter() - t
    check(np.array_equal(bc, bn), "bincount")
    t = time.perf_counter()
    u, c = ops.unique(ib, return_counts=True)
    walls["unique_s"] = time.perf_counter() - t
    # the uniques of non-negative integers are bincount's non-empty bins
    check(np.array_equal(u, np.nonzero(bn)[0])
          and np.array_equal(c, bn[bn > 0]), "unique")
    t = time.perf_counter()
    v, i = ops.topk(b, 5, axis=-1)
    vh = v.totorch()[:2].cpu().numpy()
    ih = i.totorch()[:2].cpu().numpy()
    walls["topk_s"] = time.perf_counter() - t
    sub = xh[:2]
    want_i = np.argsort(-sub, axis=-1, kind="stable")[..., :5]
    check(np.array_equal(ih, want_i) and np.array_equal(
        vh, np.take_along_axis(sub, want_i, -1)), "topk")
    del x, et, below, want, v, i
    out["config1_ops"] = walls
    log("config 1 ops: %s (%s)" % (json.dumps(walls), out["card"]))
    return b, xh


def numpy_surface_case(bolt, torch, np, b1, xh, bp, out):
    """Phase 9's numpy surface: ``np.sum``, ``np.mean(axis=0)``,
    ``np.histogram`` (config 1) and ``np.cov`` (the pca array) served on
    the card, with ``toarray`` and ``__array__`` made to raise."""
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    saved = BoltArrayGPU.toarray, BoltArrayGPU.__array__

    def gathered(*args, **kwargs):
        raise AssertionError("a numpy call copied a device array")

    BoltArrayGPU.toarray = BoltArrayGPU.__array__ = gathered
    try:
        t = time.perf_counter()
        s = np.sum(b1).totorch()
        m = np.mean(b1, axis=0).totorch()
        counts, _ = np.histogram(b1, bins=64)
        c = np.cov(bp, rowvar=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        BoltArrayGPU.toarray, BoltArrayGPU.__array__ = saved
    check(abs(float(s) - float(xh.sum(dtype=np.float64)))
          <= 1e-5 * float(np.abs(xh).sum(dtype=np.float64)), "np.sum")
    check(np.allclose(m.cpu().numpy(), xh.mean(axis=0, dtype=np.float64),
                      rtol=1e-5, atol=1e-6), "np.mean(axis=0)")
    check(int(counts.sum()) == xh.size, "np.histogram")
    check(c.shape == (PCA_SHAPE[1],) * 2 and np.all(np.isfinite(c)),
          "np.cov")
    out["numpy_surface_wall_s"] = wall


def ops_phase(bolt, torch, np, report):
    """Phase 9: the ops library and the numpy surface at full width, with
    a host fallback anywhere an error."""
    t0 = time.perf_counter()
    out = {"card": report.get("card") or card_line()}
    with warnings.catch_warnings():
        warnings.simplefilter("error", bolt.HostFallbackWarning)
        config5b_case(bolt, torch, np, out)
        torch.cuda.empty_cache()
        bp = pca_case(bolt, torch, np, out)
        b1, xh = config1_ops_case(bolt, torch, np, out)
        numpy_surface_case(bolt, torch, np, b1, xh, bp, out)
        del bp, b1, xh
        torch.cuda.empty_cache()
        segment_case(bolt, torch, np, out)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    report["ops_phase"] = out
    c5 = out["config5b"]
    log("config 5b (8, 4194304, 16) f32: %.4f s (config 5's library SVD "
        "%.4f s); %d chunks within %.3g of s_max (%s)" % (
            c5["wall_s"], out["config5_library_wall_s"],
            c5["sampled_chunks"], c5["max_rel_err"], out["card"]))
    log("config 5b split: Gram %.4f ms (bound %.4f), jacobi_eigh %.4f ms "
        "under the chunk map's vmaps; alone %.4f ms (wall %.4f, device %s, "
        "bound %.4f) against eigvalsh %.4f ms (%s) (%s)" % (
            out["gram_ms"], out["gram_bound_ms"], out["jacobi_vmapped_ms"],
            out["jacobi_ms"], out["jacobi_wall_ms"], out["jacobi_device_ms"],
            out["jacobi_bound_ms"], out["eigvalsh_ms"], out["eigvalsh_form"],
            out["card"]))
    log("pca fetch=False: %d syncs; numpy surface %.4f s (%s)"
        % (out["pca_fetch_false_syncs"], out["numpy_surface_wall_s"],
           out["card"]))
    log("ops phase ok in %.1f s" % out["phase_s"])


# ---------------------------------------------------------------------
# phase 10: the rest of the numpy surface at full width
# ---------------------------------------------------------------------

def tail_call(torch, out, name, fn, library=None):
    """``fn()`` (a numpy call on card arrays, its results read with
    ``totorch``): the synchronised wall of its first call (the program's
    build and the library's set-up included) and of a second one, and the
    first call's peak growth, logged and kept under ``out["calls"][name]``
    with the library call that served it."""
    res, wall, grow = measured(torch, fn)
    rbytes = sum(t.numel() * t.element_size()
                 for t in (res if isinstance(res, tuple) else (res,)))
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    again = time.perf_counter() - t
    out["calls"][name] = {"wall_s": wall, "cached_wall_s": again,
                          "growth_gb": grow / 1e9, "result_gb": rbytes / 1e9,
                          "library": library}
    log("phase 10 %s: %.4f s first, %.4f s cached, peak growth %.3f GB "
        "(result %.3f GB)%s (%s)"
        % (name, wall, again, grow / 1e9, rbytes / 1e9,
           "" if library is None else ", " + library, out["card"]))
    return res


def f64_nan_column_refs(x, chunk=4096):
    """Column-wise count, sum, sum of |v|, mean, variance (ddof 0) and max
    of the numbers of an (n, C) tensor under the chain that puts NaN where
    ``v > 2``, in f64 on the card, ``chunk`` columns at a time."""
    import torch
    parts = {k: [] for k in ("sum", "abs", "mean", "var", "max")}
    for j in range(0, x.shape[1], chunk):
        d = x[:, j:j + chunk].double()
        keep = d <= 2
        cnt = keep.sum(0)
        z = torch.where(keep, d, 0.0)
        s = z.sum(0)
        mean = s / cnt
        parts["sum"].append(s)
        parts["abs"].append(z.abs().sum(0))
        parts["mean"].append(mean)
        parts["var"].append((torch.where(keep, d - mean, 0.0) ** 2).sum(0)
                            / cnt)
        parts["max"].append(torch.where(keep, d, -math.inf).amax(0))
        del d, keep, z
    return {k: torch.cat(v, 0) for k, v in parts.items()}


def tail_north_star(bolt, torch, np, out):
    """The nan reductions of the north-star under a chain that puts NaN
    where ``v > 2``: each folds block partials of the chain, so the
    mapped 10.49 GB is never written (peak growth under 1 GB beside the
    result), against f64 column references."""
    b = bolt.randn(NORTH_STAR, mode="gpu", dtype=np.float32, seed=0)
    x = b.totorch()
    n = NORTH_STAR[0]
    ref = f64_nan_column_refs(x.view(n, -1))
    nan = float("nan")
    chain = b.map(lambda v: torch.where(v > 2, nan, v))
    s = tail_call(torch, out, "north-star nansum",
                  lambda: np.nansum(chain).totorch())
    m = tail_call(torch, out, "north-star nanmean(axis=0)",
                  lambda: np.nanmean(chain, axis=0).totorch())
    sd = tail_call(torch, out, "north-star nanstd(axis=0)",
                   lambda: np.nanstd(chain, axis=0).totorch())
    mx = tail_call(torch, out, "north-star nanmax",
                   lambda: np.nanmax(chain).totorch())
    check(chain.deferred, "the nan reductions materialised the chain")
    for name in ("north-star nansum", "north-star nanmean(axis=0)",
                 "north-star nanstd(axis=0)", "north-star nanmax"):
        c = out["calls"][name]
        check(c["growth_gb"] - c["result_gb"] < 1.0,
              "%s grew %.3f GB" % (name, c["growth_gb"]))
    tot = float(ref["sum"].sum())
    check(abs(float(s) - tot) <= 1e-6 * float(ref["abs"].sum()),
          "north-star nansum: %.6g against %.6g" % (float(s), tot))
    out["nansum_err"] = abs(float(s) - tot)
    out["nanmean_err"] = close(m.reshape(-1), ref["mean"], 1e-5, 1e-6,
                               "north-star nanmean")
    out["nanstd_err"] = close(sd.reshape(-1), ref["var"].sqrt(), 1e-4, 1e-5,
                              "north-star nanstd")
    check(float(mx) == float(ref["max"].max()), "north-star nanmax")
    out["nan_share"] = 1 - float((x <= 2).sum()) / x.numel()
    del b, x, chain, ref, s, m, sd, mx


def tail_config1(bolt, torch, np, out):
    """Config 1: the layout family, the contractions at both precision
    modes, the order statistics and the 2-d FFT, each against numpy on
    sampled records."""
    b = bolt.randn(CONFIG1, mode="gpu", dtype=np.float32, seed=1)
    x = b.totorch()
    recs = [0, 57, 199]
    xs = x[recs].cpu().numpy()

    def same(t, want, what):
        check(np.array_equal(t.cpu().numpy(), want), what)

    t = tail_call(torch, out, "config1 stack", lambda: np.stack(
        [b, b]).totorch())
    same(t[:, recs], np.stack([xs, xs]), "np.stack")
    pw = ((0, 0), (0, 0), (2, 2), (2, 2))
    t = tail_call(torch, out, "config1 pad reflect", lambda: np.pad(
        b, pw, mode="reflect").totorch())
    same(t[recs], np.pad(xs, pw, mode="reflect"), "np.pad reflect")
    t = tail_call(torch, out, "config1 roll", lambda: np.roll(
        b, 3, axis=2).totorch())
    same(t[recs], np.roll(xs, 3, axis=2), "np.roll")
    t = tail_call(torch, out, "config1 tile", lambda: np.tile(
        b, (1, 1, 1, 2)).totorch())
    same(t[recs], np.tile(xs, (1, 1, 1, 2)), "np.tile")
    t = tail_call(torch, out, "config1 broadcast_to", lambda: np.broadcast_to(
        b, (2,) + CONFIG1).totorch())
    same(t[1, recs], xs, "np.broadcast_to")
    del t
    w = np.random.RandomState(2).randn(64, 64).astype(np.float32)
    want = np.einsum("ijkl,lm->ijkm", xs.astype(np.float64),
                     w.astype(np.float64))
    scale = np.einsum("ijkl,lm->ijkm", np.abs(xs).astype(np.float64),
                      np.abs(w).astype(np.float64))
    # an f32 sum of 64 products: within 64 * 2^-24 of sum |x||w|; TF32
    # rounds each input to 10 mantissa bits: within 2 * 2^-11 + 64 * 2^-24
    # (torch's "medium" float32 precision is TF32 in cuBLAS; on a CPU
    # rehearsal oneDNN takes bf16, 7 bits)
    bits = 10 if x.is_cuda else 7
    hi = tail_call(torch, out, "config1 einsum highest", lambda: np.einsum(
        "ijkl,lm->ijkm", b, w).totorch(), "torch.einsum (cuBLAS, f32)")
    err_hi = float(np.max(np.abs(hi[recs].double().cpu().numpy() - want)
                          / scale))
    check(err_hi <= 64 * 2.0 ** -24, "einsum highest: %.3g" % err_hi)
    with bolt.precision("default"):
        lo = tail_call(torch, out, "config1 einsum default",
                       lambda: np.einsum("ijkl,lm->ijkm", b, w).totorch(),
                       "torch.einsum (cuBLAS, TF32)")
    err_lo = float(np.max(np.abs(lo[recs].double().cpu().numpy() - want)
                          / scale))
    check(err_lo <= 2 * 2.0 ** -(bits + 1) + 64 * 2.0 ** -24,
          "einsum default: %.3g" % err_lo)
    td = tail_call(torch, out, "config1 tensordot", lambda: np.tensordot(
        b, w, axes=([3], [0])).totorch(), "torch.tensordot (cuBLAS, f32)")
    err_td = float(np.max(np.abs(td[recs].double().cpu().numpy() - want)
                          / scale))
    check(err_td <= 64 * 2.0 ** -24, "tensordot: %.3g" % err_td)
    out["einsum_err"] = {"highest": err_hi, "default": err_lo,
                         "tensordot": err_td}
    del hi, lo, td
    cols = x[:, :2].double().cpu().numpy()
    med = tail_call(torch, out, "config1 nanmedian(axis=0)",
                    lambda: np.nanmedian(b, axis=0).totorch())
    check(np.allclose(med[:2].double().cpu().numpy(),
                      np.median(cols, axis=0), rtol=1e-6, atol=1e-7),
          "np.nanmedian")
    q = tail_call(torch, out, "config1 nanquantile(axis=0)",
                  lambda: np.nanquantile(b, [0.1, 0.9], axis=0).totorch())
    check(np.allclose(q[:, :2].double().cpu().numpy(),
                      np.quantile(cols, [0.1, 0.9], axis=0), rtol=1e-5,
                      atol=1e-6), "np.nanquantile")
    del med, q, cols
    srt = tail_call(torch, out, "config1 take_along_axis(argsort)",
                    lambda: np.take_along_axis(b, np.argsort(b, axis=-1),
                                               axis=-1).totorch())
    same(srt[recs], np.sort(xs, axis=-1), "np.take_along_axis")
    del srt
    f = np.fft.rfft2(xs.astype(np.float64))
    spec = tail_call(torch, out, "config1 rfft2", lambda: np.fft.rfft2(
        b).totorch(), "torch.fft.rfft2 (cuFFT)")
    err_f = float(np.max(np.abs(spec[recs].cpu().numpy() - f))
                  / np.max(np.abs(f)))
    check(err_f <= 1e-5, "rfft2: %.3g of max|F|" % err_f)
    bs = bolt.array(spec, x.device)
    back = tail_call(torch, out, "config1 irfft2", lambda: np.fft.irfft2(
        bs, s=(64, 64)).totorch(), "torch.fft.irfft2 (cuFFT)")
    err_b = float((back - x).abs().max()) / float(x.abs().max())
    check(err_b <= 1e-5, "irfft2 round trip: %.3g" % err_b)
    out["fft2_err"] = {"rfft2": err_f, "roundtrip": err_b}
    del b, x, spec, bs, back


def tail_gram_linalg(bolt, torch, np, out):
    """Config 5b's Gram stack, ``(32768, 16, 16)`` f32 (phase 9's data:
    the Grams of its 1024-row chunks), through ``np.linalg``, against
    numpy f64 on 512 sampled matrices."""
    x = bolt.randn(CONFIG5B, mode="gpu", dtype=np.float32, seed=5).totorch()
    xb = x.view(-1, 1024, CONFIG5B[2])
    g = torch.matmul(xb.mT, xb)            # f32: main() turns TF32 off
    del x, xb
    b = bolt.array(g, g.device)
    n = g.shape[0]
    pick = torch.linspace(0, n - 1, 512, device=g.device).long()
    a64 = g[pick].double().cpu().numpy()
    rhs = np.random.RandomState(8).randn(n, 16, 1).astype(np.float32)
    errs = {}

    def rel(got, want):
        return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))

    def host(t):
        return t[pick].double().cpu().numpy()

    w = tail_call(torch, out, "gram eigvalsh", lambda: np.linalg.eigvalsh(
        b).totorch(), "torch.linalg.eigvalsh (cuSOLVER syevBatched, "
        "in slices of 16384)")
    errs["eigvalsh"] = rel(host(w), np.linalg.eigvalsh(a64))
    inv = tail_call(torch, out, "gram inv", lambda: np.linalg.inv(
        b).totorch(), "torch.linalg.inv_ex")
    errs["inv"] = rel(host(inv), np.linalg.inv(a64))
    sl = tail_call(torch, out, "gram slogdet", lambda: tuple(
        r.totorch() for r in np.linalg.slogdet(b)), "torch.linalg.slogdet")
    esign, elog = np.linalg.slogdet(a64)
    check(np.array_equal(host(sl[0]), esign), "slogdet sign")
    errs["slogdet"] = rel(host(sl[1]), elog)
    ch = tail_call(torch, out, "gram cholesky", lambda: np.linalg.cholesky(
        b).totorch(), "torch.linalg.cholesky_ex")
    errs["cholesky"] = rel(host(ch), np.linalg.cholesky(a64))
    so = tail_call(torch, out, "gram solve", lambda: np.linalg.solve(
        b, rhs).totorch(), "torch.linalg.solve_ex")
    errs["solve"] = rel(host(so), np.linalg.solve(
        a64, rhs[pick.cpu().numpy()].astype(np.float64)))
    qr = tail_call(torch, out, "gram qr", lambda: tuple(
        r.totorch() for r in np.linalg.qr(b)), "torch.geqrf and a batched "
        "Householder product")
    errs["qr"] = rel(np.matmul(host(qr[0]), host(qr[1])), a64)
    errs["qr_r"] = rel(np.abs(host(qr[1])),
                       np.abs(np.linalg.qr(a64, mode="r")))
    sv = tail_call(torch, out, "gram svd", lambda: tuple(
        r.totorch() for r in np.linalg.svd(b)), "torch.linalg.svd")
    u, s, vh = (host(r) for r in sv)
    errs["svd_s"] = rel(s, np.linalg.svd(a64, compute_uv=False))
    errs["svd"] = rel(np.matmul(u * s[..., None, :], vh), a64)
    for k, v in errs.items():
        check(v <= 1e-4, "np.linalg %s: %.3g of the largest value" % (k, v))
    out["gram_err"] = errs
    log("phase 10 np.linalg on the Gram stack against numpy f64 on 512 "
        "matrices: %s" % json.dumps(errs))
    del g, b, w, inv, sl, ch, so, qr, sv


def tail_imaging_fft(bolt, torch, np, out):
    """The imaging width ``(64, 2048, 4096)`` f32: ``np.fft.rfft`` along the
    last axis against numpy f64 on sampled rows, and the ``irfft`` round
    trip."""
    b = bolt.randn(IMAGING, mode="gpu", dtype=np.float32, seed=6)
    x = b.totorch()
    spec = tail_call(torch, out, "imaging rfft", lambda: np.fft.rfft(
        b).totorch(), "torch.fft.rfft (cuFFT)")
    rows = x[[0, 31, 63]][:, [0, 1000, 2047]]
    f = np.fft.rfft(rows.double().cpu().numpy())
    got = spec[[0, 31, 63]][:, [0, 1000, 2047]].cpu().numpy()
    err_f = float(np.max(np.abs(got - f)) / np.max(np.abs(f)))
    check(err_f <= 1e-5, "imaging rfft: %.3g of max|F|" % err_f)
    bs = bolt.array(spec, x.device)
    back = tail_call(torch, out, "imaging irfft", lambda: np.fft.irfft(
        bs, n=IMAGING[2]).totorch(), "torch.fft.irfft (cuFFT)")
    err_b = float((back - x).abs().max()) / float(x.abs().max())
    check(err_b <= 1e-5, "imaging irfft round trip: %.3g" % err_b)
    out["imaging_fft_err"] = {"rfft": err_f, "roundtrip": err_b}
    del b, x, spec, bs, back


def numpy_tail_phase(bolt, torch, np, report):
    """Phase 10: the rest of the numpy surface at full width, with
    ``toarray`` and ``__array__`` made to raise and a host fallback an
    error; no kernel of its own."""
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    t0 = time.perf_counter()
    out = {"card": report.get("card") or card_line(), "calls": {}}
    saved = BoltArrayGPU.toarray, BoltArrayGPU.__array__

    def gathered(*args, **kwargs):
        raise AssertionError("a numpy call copied a card array to the host")

    BoltArrayGPU.toarray = BoltArrayGPU.__array__ = gathered
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", bolt.HostFallbackWarning)
            for case in (tail_north_star, tail_config1, tail_gram_linalg,
                         tail_imaging_fft):
                case(bolt, torch, np, out)
                torch.cuda.empty_cache()
    finally:
        BoltArrayGPU.toarray, BoltArrayGPU.__array__ = saved
    out["phase_s"] = time.perf_counter() - t0
    report["numpy_tail_phase"] = out
    log("numpy tail phase ok in %.1f s" % out["phase_s"])


# ---------------------------------------------------------------------------
# phase 11: the streamed stages, stream groups, the shuffle and retries
# ---------------------------------------------------------------------------

def seeded_records(np, rec, integers=False):
    """A ``fromcallback`` callback drawing each record from
    ``np.random.default_rng(STREAM_SEED + record)``: standard normals, or
    integers in [-8, 8] (sums of those are exact in f32 in any order)."""
    def cb(index):
        lo, hi = index[0].start, index[0].stop
        out = np.empty((hi - lo,) + rec, np.float32)
        for r in range(lo, hi):
            g = np.random.default_rng(STREAM_SEED + r)
            out[r - lo] = g.integers(-8, 9, rec) if integers else \
                g.standard_normal(rec, dtype=np.float32)
        return out
    return cb


def stage_refs(torch, x, mask, chunk=4096):
    """f64 column references of the north-star ``x`` (n, C) on the card,
    ``chunk`` columns at a time: the sum, |v| sum, mean, var, min and max
    of ``v``; the sum, |v| sum and mean of ``v + 1`` over the records
    ``mask`` keeps; and the sum of each 20-record block minus its mean."""
    n = x.shape[0]
    keep = mask.double()[:, None]
    kept = float(mask.sum())
    parts = {k: [] for k in ("sum", "abs", "mean", "var", "min", "max",
                             "fsum", "fabs", "fmean", "stack")}
    for j in range(0, x.shape[1], chunk):
        d = x[:, j:j + chunk].double()
        parts["sum"].append(d.sum(0))
        parts["abs"].append(d.abs().sum(0))
        parts["mean"].append(d.mean(0))
        parts["var"].append(d.var(0, correction=0))
        parts["min"].append(d.amin(0))
        parts["max"].append(d.amax(0))
        f = (d + 1) * keep
        parts["fsum"].append(f.sum(0))
        parts["fabs"].append(f.abs().sum(0))
        parts["fmean"].append(f.sum(0) / kept)
        blk = d.view(n // SLAB_RECORDS, SLAB_RECORDS, -1)
        parts["stack"].append((blk - blk.mean(1, keepdim=True)).sum((0, 1)))
        del d, f, blk
    return {k: torch.cat(v, 0) for k, v in parts.items()}


def stages_phase(bolt, K, torch, np, dev, report):
    """Phase 11: the streamed stages at the north-star and at config 1;
    returns the path's launches."""
    from bolt_tpu_torch import _chaos, checkpoint, engine, stream
    from bolt_tpu_torch.gpu.array import _pred_mask
    from bolt_tpu_torch.parallel import shuffle
    t0 = time.perf_counter()
    n = STREAM_NS[0]
    nslabs = -(-n // SLAB_RECORDS)
    cb = seeded_records(np, STREAM_NS[1:])
    pred = lambda v: v.mean() > 1           # noqa: E731  (config 4's)

    def source():
        return bolt.fromcallback(cb, STREAM_NS, mode="gpu",
                                 dtype=np.float32)

    runs = {}
    out = {"runs": runs}

    def run(label, fn, slabs, growth_gb=None, profiled=False):
        """One run: its result tensor, wall, peak device memory (and what
        was resident before it), slabs and shuffle/spill bytes, logged on
        one line; ``profiled`` also takes the device's busy time (kernels
        and copies on any stream) from ``torch.profiler``.  Checked: the
        slab count, and the peak under 2 GB, or its growth under
        ``growth_gb`` where that is given."""
        c0 = engine.counters()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res, kern_us, copy_us = device_us(fn) if profiled else \
            (fn(), None, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        d = {k: v - c0[k] for k, v in engine.counters().items()}
        peak = torch.cuda.max_memory_allocated()
        runs[label] = {"wall_s": wall, "peak_gb": peak / 1e9,
                       "resident_before_gb": base / 1e9,
                       "slabs": d["stream_chunks"],
                       "shuffle_bytes": d["shuffle_bytes"],
                       "shuffle_s": d["shuffle_seconds"],
                       "spill_bytes": d["spill_bytes"],
                       "retries": d["stream_retries"],
                       "device_kernel_s": kern_us and kern_us / 1e6,
                       "device_copy_s": copy_us and copy_us / 1e6}
        if profiled:
            log("phase 11 %-14s device busy (profiled, kernels + copies on "
                "any stream): kernels %s s, copies %s s of %.3f s wall"
                % (label, runs[label]["device_kernel_s"],
                   runs[label]["device_copy_s"], wall))
        log("phase 11 %-14s wall %.3f s, peak %.3f GB (%.3f GB resident "
            "before), %d slabs, shuffle %.3f GB in %.3f s, spill %.3f GB"
            % (label, wall, peak / 1e9, base / 1e9, d["stream_chunks"],
               d["shuffle_bytes"] / 1e9, d["shuffle_seconds"],
               d["spill_bytes"] / 1e9))
        check(d["stream_chunks"] == slabs, "phase 11 %s streamed %d slabs, "
              "not %d" % (label, d["stream_chunks"], slabs))
        check(peak < STREAM_PEAK_BYTES if growth_gb is None
              else peak - base < growth_gb * 1e9,
              "phase 11 %s peak device memory %.3f GB (%.3f GB before)"
              % (label, peak / 1e9, base / 1e9))
        return res

    with stream.uploaders(4):
        # the f64 references and the materialised swap, from one copy of
        # the source materialised on the card (then freed)
        t = time.perf_counter()
        mat = source()
        x = mat.totorch()
        xv = x.view(n, -1)
        mask = torch.cat([_pred_mask(pred, x[s:s + SLAB_RECORDS] + 1)
                          for s in range(0, n, SLAB_RECORDS)])
        m64 = (xv.double() + 1).mean(1) > 1
        for i in (mask != m64).nonzero().flatten().tolist():
            d64 = xv[i].double() + 1
            tol = 4 * math.sqrt(d64.numel()) * 2.0 ** -24 * float(
                d64.abs().mean())
            check(abs(float(d64.mean()) - 1) <= tol, "phase 11: record %d's "
                  "f32 mask differs from the f64 one beyond rounding" % i)
        ref = stage_refs(torch, xv, mask)
        kept = int(mask.sum())
        want_swap = mat.swap((0,), (0,)).totorch()
        del mat, x, xv
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out["materialise_s"] = time.perf_counter() - t
        log("phase 11 source materialised, f64 references and the "
            "materialised swap taken in %.1f s; %d of %d records pass "
            "config 4's filter" % (out["materialise_s"], kept, n))

        K.reset_launches()
        # the resident swap: phase 1 streams every slab into the swapped
        # output, bit for bit against the materialised swap
        sw = source().swap((0,), (0,))
        check(sw.streaming and sw.shape == (STREAM_NS[1], n)
              + STREAM_NS[2:],
              "swap on a stream is a lazy stage")
        got = run("swap_resident", lambda: sw.totorch(), 0,
                  growth_gb=want_swap.numel() * 4 / 1e9 + 2.0)
        check(torch.equal(got, want_swap), "the resident streamed swap is "
              "not bit-identical to the materialised swap")
        out["swap_resident_shuffle_s"] = runs["swap_resident"]["shuffle_s"]
        check(runs["swap_resident"]["shuffle_bytes"] == got.numel() * 4,
              "the resident swap moved %d bytes"
              % runs["swap_resident"]["shuffle_bytes"])
        del got, want_swap, sw
        torch.cuda.empty_cache()

        # config 4's filter, streamed: the mask folds into each slab
        f = source().map(lambda v: v + 1).filter(pred)
        fsum = run("filter_sum", lambda: f.sum().totorch().reshape(-1),
                   nslabs, profiled=True)
        check(f.streaming, "the filtered stream materialised")
        err = (fsum.double() - ref["fsum"]).abs()
        tol = 4 * math.sqrt(kept) * 2.0 ** -24 * ref["fabs"]
        check(bool((err <= tol).all()), "phase 11 filter sum: max abs err "
              "%.3g" % float(err.max()))
        errs = {"filter_sum": float(err.max())}
        fmean = run("filter_mean", lambda: source().map(lambda v: v + 1)
                    .filter(pred).mean().totorch().reshape(-1), nslabs)
        errs["filter_mean"] = close(fmean, ref["fmean"], 1e-5, 1e-6,
                                    "phase 11 filter mean")

        # the five-member group: one ingest pass, each member bit for bit
        # against its standalone streamed terminal
        names = ("sum", "mean", "var", "min", "max")

        def group():
            s = source()
            return [r.totorch().reshape(-1) for r in bolt.compute(
                *[getattr(s, m)() for m in names])]

        members = run("group", group, nslabs)
        # sum, mean and var ran standalone in phase 6 (the same source and
        # program): their results and walls are taken from there
        done6 = KEEP["ns_standalone"]
        for m in done6:
            runs[m] = report["stream"]["runs"][m]
        alone = [done6[m].reshape(-1) if m in done6 else
                 run(m, lambda m=m: getattr(source(), m)().totorch()
                     .reshape(-1), nslabs) for m in names]
        for m, g, a in zip(names, members, alone):
            check(torch.equal(g, a), "group member %s is not bit-identical "
                  "to its standalone streamed terminal" % m)
        gsum, gmean, gvar, gmin, gmax = members
        err = (gsum.double() - ref["sum"]).abs()
        check(bool((err <= 4 * math.sqrt(n) * 2.0 ** -24 * ref["abs"])
                   .all()), "phase 11 group sum: max abs err %.3g"
              % float(err.max()))
        errs["group_sum"] = float(err.max())
        errs["group_mean"] = close(gmean, ref["mean"], 1e-5, 1e-6,
                                   "phase 11 group mean")
        errs["group_var"] = close(gvar, ref["var"], 1e-4, 1e-5,
                                  "phase 11 group var")
        check(torch.equal(gmin.double(), ref["min"]) and torch.equal(
            gmax.double(), ref["max"]), "phase 11 group min/max not exact")
        KEEP["group"] = dict(zip(names, members))
        out["group_s"] = runs["group"]["wall_s"]
        out["standalone_s"] = sum(runs[m]["wall_s"] for m in names)
        log("phase 11 group of %d: %.3f s against %.3f s for its standalone "
            "terminals (%.2fx)" % (len(names), out["group_s"],
                                   out["standalone_s"],
                                   out["standalone_s"] / out["group_s"]))

        # the chunked and the stacked stages
        csum = run("chunk", lambda: source().chunk((50, 32, 32)).map(
            lambda c: c * 2).sum().totorch().reshape(-1), nslabs)
        err = (csum.double() - 2 * ref["sum"]).abs()
        check(bool((err <= 8 * math.sqrt(n) * 2.0 ** -24 * ref["abs"])
                   .all()), "phase 11 chunk sum: max abs err %.3g"
              % float(err.max()))
        errs["chunk"] = float(err.max())
        # doubling is exact and the slab sums run in the same order
        check(torch.equal(csum, 2 * gsum), "the chunked map's sum is not "
              "twice the streamed sum bit for bit")
        ssum = run("stacked", lambda: source().stacked(SLAB_RECORDS).map(
            lambda blk: blk - blk.mean(0)).unstack().sum().totorch()
            .reshape(-1), nslabs)
        err = (ssum.double() - ref["stack"]).abs()
        check(bool((err <= 8 * math.sqrt(n) * 2.0 ** -24 * ref["abs"])
                   .all()), "phase 11 stacked sum: max abs err %.3g"
              % float(err.max()))
        errs["stacked"] = float(err.max())
        del members, alone, gsum, gmean, gvar, gmin, gmax, fsum, fmean
        del csum, ssum, ref, mask, m64

        # BASELINE config 1 with integer-valued records: the spilled swap
        # (its sum over the bucket files equal to the resident one's),
        # retries and the decode-and-reduce kernel's gate
        cb1 = seeded_records(np, CONFIG1[1:], integers=True)
        n1 = CONFIG1[0]
        s1 = -(-n1 // SLAB_RECORDS)

        def source1(codec=None):
            return bolt.fromcallback(cb1, CONFIG1, mode="gpu",
                                     dtype=np.float32, chunks=SLAB_RECORDS,
                                     codec=codec)

        resident = source1().swap((0,), (0,))
        rsum = run("swap_c1_resident", lambda: resident.sum().totorch(), 0,
                   growth_gb=4 * math.prod(CONFIG1) / 1e9 + 2.0)
        check(not resident.streaming, "the config-1 swap did not resolve "
              "resident")
        spill_dir = os.path.join(ROOT, "build", "phase11_spill")
        os.makedirs(spill_dir, exist_ok=True)
        checkpoint.spill_clear(spill_dir)
        with stream.spill(spill_dir, budget=SPILL_BUDGET):
            spilled = source1().swap((0,), (0,))
            plan = shuffle.plan_shuffle(
                CONFIG1, np.float32, 1, (1, 0, 2, 3), 1, SLAB_RECORDS,
                SPILL_BUDGET, spill_dir)
            check(not plan.resident, "config 1's swap plan is resident")
            ssum = run("swap_c1_spill", lambda: spilled.sum().totorch(),
                       plan.nbuckets)
            check(spilled.streaming, "the spilled swap's sum materialised")
            check(torch.equal(ssum, rsum), "the sum over the spilled "
                  "buckets differs from the resident swap's")
            check(torch.equal(spilled.totorch(), resident.totorch()),
                  "the spilled swap's data differs from the resident one")
        check(runs["swap_c1_spill"]["spill_bytes"] > 0, "nothing spilled")
        out["spill_bytes"] = runs["swap_c1_spill"]["spill_bytes"]
        out["spill_shuffle_s"] = runs["swap_c1_spill"]["shuffle_s"]
        checkpoint.spill_clear(spill_dir)
        check(not checkpoint.spill_pending(spill_dir), "spill_clear left "
              "bolt-spill-* behind")
        del resident, spilled, rsum, ssum

        clean = run("sum_c1", lambda: source1().sum().totorch(), s1)
        KEEP["c1_sum"] = clean
        _chaos.inject("stream.upload", nth=3)
        try:
            with stream.retries(1):
                retried = run("sum_c1_retried",
                              lambda: source1().sum().totorch(), s1)
        finally:
            _chaos.clear()
        check(runs["sum_c1_retried"]["retries"] == 1, "the upload fault "
              "was retried %d times" % runs["sum_c1_retried"]["retries"])
        check(torch.equal(clean.view(torch.int32),
                          retried.view(torch.int32)),
              "the retried sum is not bit-identical to the clean one")

        os.environ["BOLT_CODEC_KERNEL"] = "1"
        try:
            KEEP["c1_int8"] = run("int8_c1_armed", lambda: source1(
                "int8").sum().totorch(), s1)
            check(K.LAUNCHES["fused_decode_sum"] == s1, "the armed int8 "
                  "sum launched fused_decode_sum %d times for %d slabs"
                  % (K.LAUNCHES["fused_decode_sum"], s1))
            run("int8_c1_filter", lambda: source1("int8").filter(
                lambda v: v.mean() > 0).sum().totorch(), s1)
            check(K.LAUNCHES["fused_decode_sum"] == s1, "an armed int8 "
                  "sum under a filter launched fused_decode_sum")
        finally:
            os.environ.pop("BOLT_CODEC_KERNEL", None)
    launches = dict(K.LAUNCHES)
    out.update(errors=errs, launches=launches, kept=kept)
    report["stages_phase"] = out
    report["phases"]["stages_s"] = time.perf_counter() - t0
    log("stages phase ok in %.1f s: %s" % (report["phases"]["stages_s"],
                                            json.dumps(errs)))
    log("phase 11 launches: %s" % json.dumps(launches))
    return launches


# ---------------------------------------------------------------------------
# phase 12: resumable streams, array checkpoints and unsigned records
# ---------------------------------------------------------------------------

# the cadence of phase 12's group checkpoints: six value-shaped tensors a
# tree level (sum, the moment triple, min, max) make a write several times
# the sum's, so the group writes every 8 retired slabs
GROUP_EVERY = 8


def resume_child(ckdir, out):
    """The kill -9 check's child: config 1's streamed ``sum`` (integer-
    valued records) on the card under ``stream.resumable(ckdir)``, one
    uploader; ``BOLT_CHAOS`` in its environment arms the fault.  Saves
    the sum to ``out`` and prints the run's counters as one JSON line."""
    import numpy as np
    sys.path.insert(0, ROOT)
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import engine, stream
    cb = seeded_records(np, CONFIG1[1:], integers=True)
    c0 = engine.counters()
    with stream.uploaders(1), stream.resumable(ckdir):
        s = bolt.fromcallback(cb, CONFIG1, mode="gpu", dtype=np.float32,
                              chunks=SLAB_RECORDS).sum().totorch()
    c1 = engine.counters()
    np.save(out, s.cpu().numpy())
    print(json.dumps({k: c1[k] - c0[k] for k in (
        "stream_resumes", "stream_chunks", "checkpoint_bytes")}))
    return 0


def child_run(ckdir, out, chaos=None):
    """:func:`resume_child` in a fresh process (``chaos``: its
    ``BOLT_CHAOS``); its ``CompletedProcess``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("BOLT_CHAOS", "BOLT_CODEC_KERNEL")}
    if chaos is not None:
        env["BOLT_CHAOS"] = chaos
    return subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.resume_child(sys.argv[1], sys.argv[2]))",
         ckdir, out], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)


def unsigned_cases(bolt, torch, np, dev, xh, out):
    """C5's calls on ``uint16`` records on the card against numpy: each
    result's dtype equal to the reference's and its values to numpy's."""
    b = bolt.array(xh, context=dev)
    walls = {}

    def case(label, got, want, dtype=None, exact=True):
        t = time.perf_counter()
        g = got()
        g = g if isinstance(g, np.ndarray) else np.asarray(g.toarray())
        walls[label] = time.perf_counter() - t
        w = want()
        check(g.dtype == np.dtype(dtype or w.dtype), "uint16 %s: dtype %s, "
              "not %s" % (label, g.dtype, dtype or w.dtype))
        ok = np.array_equal(g, w) if exact else np.allclose(
            g, w, rtol=1e-6, atol=1e-6)
        check(ok, "uint16 %s differs from numpy" % label)

    case("b + 1", lambda: b + 1, lambda: xh + 1)
    case("b > 3", lambda: b > 3, lambda: xh > 3)
    case("b // 2", lambda: b // 2, lambda: xh // 2)
    case("map(v + 1).sum()", lambda: b.map(lambda v: v + 1).sum(),
         lambda: (xh + 1).sum(0))
    case("min", lambda: b.min(), lambda: xh.min(0))
    case("max", lambda: b.max(), lambda: xh.max(0))
    st = b.stats()
    case("stats() min/max", lambda: np.stack([st.min(), st.max()]),
         lambda: np.stack([xh.min(0), xh.max(0)]))
    case("stats() mean", lambda: np.asarray(st.mean(), np.float64),
         lambda: xh.mean(0), exact=False)
    case("reduce(np.add)", lambda: b.reduce(np.add), lambda: xh.sum(0),
         dtype=np.uint16)
    case("reduce(np.maximum)", lambda: b.reduce(np.maximum),
         lambda: xh.max(0))
    case("cumsum(axis=0)", lambda: b.cumsum(axis=0),
         lambda: np.cumsum(xh, 0), dtype=np.uint16)
    case("clip(2, 9)", lambda: b.clip(2, 9), lambda: np.clip(xh, 2, 9))
    g = bolt.compute(b.sum(), b.mean(), b.max())
    case("compute sum", lambda: g[0], lambda: xh.sum(0))
    case("compute mean", lambda: g[1], lambda: xh.mean(0), dtype=np.float32,
         exact=False)
    case("compute max", lambda: g[2], lambda: xh.max(0))
    src = bolt.fromcallback(lambda idx: xh[idx], xh.shape, context=dev,
                            dtype=np.uint16, chunks=SLAB_RECORDS)
    case("streamed sum", lambda: src.sum(), lambda: xh.sum(0))
    case("streamed max", lambda: src.max(), lambda: xh.max(0))
    out["unsigned_walls_s"] = walls
    log("phase 12 uint16 calls on the card, each equal to numpy: %s"
        % json.dumps({k: round(v, 4) for k, v in walls.items()}))


def resume_phase(bolt, K, torch, np, dev, report):
    """Phase 12: resumed streams bit for bit against phases 6 and 11, the
    kill -9 resume, the array checkpoint and unsigned records at full
    width; returns the phase's launches."""
    import shutil
    from bolt_tpu_torch import _chaos, checkpoint, engine, stream
    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "phase12")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    n = STREAM_NS[0]
    nslabs = -(-n // SLAB_RECORDS)
    n1 = CONFIG1[0]
    s1 = -(-n1 // SLAB_RECORDS)
    cb = seeded_records(np, STREAM_NS[1:])
    cb1 = seeded_records(np, CONFIG1[1:], integers=True)

    def source():
        return bolt.fromcallback(cb, STREAM_NS, mode="gpu",
                                 dtype=np.float32)

    def source1(codec=None):
        return bolt.fromcallback(cb1, CONFIG1, mode="gpu", dtype=np.float32,
                                 chunks=SLAB_RECORDS, codec=codec)

    runs = {}
    launches = {}               # each path's own launches, by path
    out = {"runs": runs, "launches": launches}

    def run(label, fn, fault=None):
        """One run: its result, wall, slabs, resumes, checkpoint bytes and
        seconds, and peak device memory, logged on one line.  ``fault``
        (``(seam, nth)``) is armed for the run, which must raise it.  The
        launch counters are zeroed just before the run and read after it:
        the run's own launches."""
        c0 = engine.counters()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t = time.perf_counter()
        res = None
        if fault is None:
            res = fn()
        else:
            _chaos.inject(fault[0], nth=fault[1])
            try:
                fn()
            except _chaos.ChaosError:
                pass
            else:
                check(False, "phase 12 %s: the injected fault did not "
                      "abort the run" % label)
            finally:
                _chaos.clear()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[label] = dict(K.LAUNCHES)
        d = {k: v - c0[k] for k, v in engine.counters().items()}
        peak = torch.cuda.max_memory_allocated()
        runs[label] = {"wall_s": wall, "slabs": d["stream_chunks"],
                       "resumes": d["stream_resumes"],
                       "checkpoint_bytes": d["checkpoint_bytes"],
                       "checkpoint_s": d["checkpoint_seconds"],
                       "peak_gb": peak / 1e9,
                       "resident_before_gb": base / 1e9}
        log("phase 12 %-18s wall %.3f s, %d slabs, %d resumes, checkpoints "
            "%.3f GB in %.3f s, peak %.3f GB (%.3f GB resident before)"
            % (label, wall, d["stream_chunks"], d["stream_resumes"],
               d["checkpoint_bytes"] / 1e9, d["checkpoint_seconds"],
               peak / 1e9, base / 1e9))
        check(peak < STREAM_PEAK_BYTES, "phase 12 %s peak device memory "
              "%.3f GB" % (label, peak / 1e9))
        return res

    def resumed(label, total):
        r = runs[label]
        check(r["resumes"] == 1 and 0 < r["slabs"] < total,
              "phase 12 %s: %d resumes, %d of %d slabs streamed"
              % (label, r["resumes"], r["slabs"], total))

    def same(got, want, what):
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              "phase 12 %s is not bit-identical to the uninterrupted run"
              % what)

    with stream.uploaders(4):
        # the streamed north-star's map(v + 1).sum(), killed at its 80th
        # upload (of 40) and resumed, against phase 6's uninterrupted sum
        ck = os.path.join(root, "north_star")

        def mapsum():
            return source().map(lambda v: v + 1).sum().totorch().reshape(-1)

        with stream.resumable(ck, every=2):
            run("ns_faulted", mapsum, fault=("stream.upload", nslabs // 2))
            check(checkpoint.stream_pending(ck), "the faulted north-star "
                  "run left no checkpoint")
            same(run("ns_resumed", mapsum), KEEP["ns_map_sum"],
                 "resumed north-star map(v + 1).sum()")
            resumed("ns_resumed", nslabs)
            check(not checkpoint.stream_pending(ck), "the resumed run left "
                  "its checkpoint behind")
            same(run("ns_clean_resumable", mapsum), KEEP["ns_map_sum"],
                 "clean resumable north-star map(v + 1).sum()")
        check(runs["ns_clean_resumable"]["slabs"] == nslabs
              and runs["ns_clean_resumable"]["checkpoint_bytes"] > 0,
              "the clean resumable run wrote no checkpoint")
        out["ns_unresumable_wall_s"] = \
            report["stream"]["runs"]["map_sum"]["wall_s"]
        log("phase 12 clean resumable map(v + 1).sum() %.3f s against "
            "phase 6's unresumable %.3f s"
            % (runs["ns_clean_resumable"]["wall_s"],
               out["ns_unresumable_wall_s"]))

        # phase 11's group of five, killed and resumed, each member bit
        # for bit against phase 11's
        names = ("sum", "mean", "var", "min", "max")

        def group():
            s = source()
            return [r.totorch().reshape(-1) for r in bolt.compute(
                *[getattr(s, m)() for m in names])]

        ckg = os.path.join(root, "group")
        with stream.resumable(ckg, every=GROUP_EVERY):
            run("group_faulted", group, fault=("stream.upload", nslabs // 2))
            members = run("group_resumed", group)
        resumed("group_resumed", nslabs)
        for m, g in zip(names, members):
            same(g, KEEP["group"][m], "resumed group member %s" % m)
        check(not checkpoint.stream_pending(ckg), "the group's checkpoint "
              "was left behind")
        del members

        # config 1's armed int8 sum, resumed: fused_decode_sum once for
        # each slab streamed after the resume
        ck1 = os.path.join(root, "int8")
        os.environ["BOLT_CODEC_KERNEL"] = "1"
        try:
            with stream.resumable(ck1):
                run("int8_faulted", lambda: source1("int8").sum().totorch(),
                    fault=("stream.upload", s1 * 4 // 5))
                got = run("int8_resumed",
                          lambda: source1("int8").sum().totorch())
                launched = launches["int8_resumed"]["fused_decode_sum"]
        finally:
            os.environ.pop("BOLT_CODEC_KERNEL", None)
        same(got, KEEP["c1_int8"], "resumed armed int8 sum")
        resumed("int8_resumed", s1)
        check(launched == runs["int8_resumed"]["slabs"], "the resumed int8 "
              "sum launched fused_decode_sum %d times for %d slabs"
              % (launched, runs["int8_resumed"]["slabs"]))
        out["int8_resumed_launches"] = launched

    # kill -9: a child killed at its 6th upload, then a second child that
    # resumes its checkpoint
    ckk = os.path.join(root, "kill")
    outp = os.path.join(root, "kill_sum.npy")
    t = time.perf_counter()
    p = child_run(ckk, outp, chaos="stream.upload:6:kill")
    out["kill_child_s"] = time.perf_counter() - t
    killed_rc = p.returncode
    check(killed_rc != 0, "the killed child exited %d" % killed_rc)
    check(checkpoint.stream_pending(ckk), "the killed child left no "
          "checkpoint (rc %d): %s" % (p.returncode, p.stderr[-2000:]))
    t = time.perf_counter()
    p = child_run(ckk, outp)
    out["resume_child_s"] = time.perf_counter() - t
    check(p.returncode == 0, "the resuming child failed: %s"
          % p.stderr[-4000:])
    kc = json.loads(p.stdout.strip().splitlines()[-1])
    same(torch.from_numpy(np.load(outp)).to(dev), KEEP["c1_sum"],
         "kill -9 resumed sum")
    check(kc["stream_resumes"] == 1 and kc["stream_chunks"] < s1,
          "the resuming child: %s" % kc)
    check(not checkpoint.stream_pending(ckk), "the kill checkpoint was "
          "left behind")
    out["kill_resume"] = dict(kc, killed_rc=killed_rc)
    log("phase 12 kill -9: the child died (rc %s) in %.1f s; the resuming "
        "child streamed %d of %d slabs in %.1f s, bit for bit"
        % (out["kill_resume"]["killed_rc"], out["kill_child_s"],
           kc["stream_chunks"], s1, out["resume_child_s"]))

    # the array checkpoint: config 1 through save/load, and B1 and B3 on
    # the loaded array
    b = bolt.fromcallback(cb1, CONFIG1, mode="gpu")
    nbytes = b.totorch().numel() * 4
    cka = os.path.join(root, "array")
    torch.cuda.synchronize()
    t = time.perf_counter()
    checkpoint.save(cka, b)
    out["save_gb_s"] = nbytes / (time.perf_counter() - t) / 1e9
    t = time.perf_counter()
    lb = checkpoint.load(cka, context=dev)
    torch.cuda.synchronize()
    out["load_gb_s"] = nbytes / (time.perf_counter() - t) / 1e9
    check(lb.split == b.split and lb.shape == b.shape
          and lb.dtype == b.dtype and torch.equal(lb.totorch(), b.totorch()),
          "the loaded config-1 array is not the saved one bit for bit")
    log("phase 12 checkpoint.save %.3f GB/s, load %.3f GB/s (%.3f GB)"
        % (out["save_gb_s"], out["load_gb_s"], nbytes / 1e9))
    K.reset_launches()
    ms = lb.map(lambda v: v + 1).sum().totorch()
    st = lb.stats()
    torch.cuda.synchronize()
    launches["loaded_array"] = dict(K.LAUNCHES)
    for name in ("fused_map_reduce", "fused_welford"):
        check(launches["loaded_array"][name] == 1, "the loaded array's "
              "map(v + 1).sum()/stats() launched %s %d times, not once"
              % (name, launches["loaded_array"][name]))
    # the saved array's results, to compare with: after the path's read
    same(ms, b.map(lambda v: v + 1).sum().totorch(), "loaded map-sum")
    st_b = b.stats()
    for f in ("mean", "variance", "min", "max"):
        check(np.array_equal(getattr(st, f)(), getattr(st_b, f)()),
              "the loaded array's stats() %s differs" % f)
    # C5 on the card: config 1's records shifted to [0, 16] as uint16
    xh = (b.toarray() + 8).astype(np.uint16)
    del b, lb, ms, st, st_b
    K.reset_launches()
    unsigned_cases(bolt, torch, np, dev, xh, out)
    launches["uint16"] = dict(K.LAUNCHES)
    shutil.rmtree(root, ignore_errors=True)
    report["resume_phase"] = out
    report["phases"]["resume_s"] = time.perf_counter() - t0
    log("resume phase ok in %.1f s" % report["phases"]["resume_s"])
    log("phase 12 launches by path: %s" % json.dumps(
        {p: {k: v for k, v in c.items() if v} for p, c in launches.items()}))
    return launches


# ---------------------------------------------------------------------------
# phase 13: serving (the multi-tenant server, the arbiter, micro-batching)
# ---------------------------------------------------------------------------

def serve_config9(bolt, torch, np, dev, engine, serve, reg, add1, out):
    """Config 9 at its width: four tenants each stream 128 MB under
    ``serving(workers=4, queue_limit=8)``; returns the served results'
    check values."""
    tenants = ["c9-t%d" % i for i in range(4)]
    x9 = np.random.default_rng(9).standard_normal(CONFIG9, dtype=np.float32)
    nbytes = x9.nbytes

    def read9(idx):
        time.sleep(CONFIG9_LATENCY_S)     # the emulated storage fetch
        return x9[idx]

    def make9():
        return bolt.fromcallback(read9, CONFIG9, dev, dtype=np.float32,
                                 chunks=CONFIG9_SLAB_RECORDS).map(add1).sum()

    single = make9().totorch()           # builds the slab programs
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in tenants:
        make9().totorch()                # one at a time
    torch.cuda.synchronize()
    serial = time.perf_counter() - t
    reg.gauge("serve.queue_depth_high_water").reset()
    moved0 = {n: engine.tenant_counters(n)["transfer_bytes"]
              for n in tenants}
    with serve.serving(workers=4, queue_limit=8) as sv:
        t = time.perf_counter()
        futs = [sv.submit(make9(), tenant=n) for n in tenants]
        outs = [f.result(timeout=600).totorch() for f in futs]
        torch.cuda.synchronize()
        conc = time.perf_counter() - t
        depth_hw = sv.stats()["queue_depth_high_water"]
    lats = sorted(f.finished_s - f.submitted_s for f in futs)
    for n, o in zip(tenants, outs):
        check(torch.equal(o, single), "config 9 tenant %s differs from "
              "the single-tenant run" % n)
        moved = engine.tenant_counters(n)["transfer_bytes"] - moved0[n]
        check(moved == nbytes, "config 9 tenant %s moved %d bytes, not "
              "its %d" % (n, moved, nbytes))
    check(depth_hw <= 8, "config 9 queue depth high-water %d > 8"
          % depth_hw)

    def builds():
        c = engine.counters()
        return c["misses"], c["aot_compiles"], c["persistent_misses"]

    engine.clear()
    c0 = builds()
    with serve.serving(workers=4) as sv:
        [f.result(timeout=600) for f in
         [sv.submit(make9(), tenant=n) for n in tenants]]
    four = tuple(b - a for a, b in zip(c0, builds()))
    engine.clear()
    c0 = builds()
    make9().totorch()
    one = tuple(b - a for a, b in zip(c0, builds()))
    check(four == one, "a cold 4-tenant round built %s (misses, builds, "
          "nvcc), one tenant %s" % (four, one))
    out.update(serial_s=serial, concurrent_s=conc, ratio=serial / conc,
               aggregate_gbps=len(tenants) * nbytes / conc / 1e9,
               serialised_gbps=len(tenants) * nbytes / serial / 1e9,
               latency_p50_s=lats[len(lats) // 2], latency_max_s=lats[-1],
               queue_depth_high_water=depth_hw, cold_builds_4=four,
               cold_builds_1=one)
    log("phase 13 config9: %d tenants x %d MB, aggregate %.3f GB/s vs "
        "serialised %.3f GB/s (%.2fx; the reference's bench gate >= 2.5x), "
        "latency p50 %.3f s max %.3f s, queue depth high-water %d, cold "
        "builds 4 tenants %s == 1 tenant %s, per-slab latency %g s"
        % (len(tenants), nbytes >> 20, out["aggregate_gbps"],
           out["serialised_gbps"], out["ratio"], out["latency_p50_s"],
           out["latency_max_s"], depth_hw, four, one, CONFIG9_LATENCY_S))


def serve_config1(bolt, K, torch, np, dev, serve, add1, out):
    """Config 1 in memory: four tenants' ``map(v + 1).sum()`` and
    ``stats()`` under an explicit budget, each bit for bit against its
    standalone run; returns the served path's launches."""
    arrays = [bolt.randn(CONFIG1, mode="gpu", dtype=np.float32,
                         seed=130 + i) for i in range(4)]
    sums = [a.map(add1).sum().totorch() for a in arrays]
    stats = [a.stats() for a in arrays]
    free, _ = torch.cuda.mem_get_info()
    budget = int(free * 0.9)
    torch.cuda.synchronize()
    K.reset_launches()
    with serve.serving(workers=4, budget_bytes=budget) as sv:
        fs = [sv.submit(a.map(add1).sum(), tenant="c1-t%d" % i)
              for i, a in enumerate(arrays)]
        ft = [sv.submit(lambda a=a: a.stats(), tenant="c1-t%d" % i)
              for i, a in enumerate(arrays)]
        got_s = [f.result(timeout=600).totorch() for f in fs]
        got_t = [f.result(timeout=600) for f in ft]
        torch.cuda.synchronize()
        arb = sv.stats()["arbiter"]
    launches = dict(K.LAUNCHES)
    check(sv.arbiter.in_use() == 0, "config 1 leases were not returned")
    for i in range(4):
        check(torch.equal(got_s[i], sums[i]), "config 1 tenant %d's served "
              "sum differs from its standalone run" % i)
        a, b = got_t[i], stats[i]
        check(a.count() == b.count() and all(
            np.array_equal(getattr(a, m)(), getattr(b, m)())
            for m in ("mean", "variance", "min", "max")),
            "config 1 tenant %d's served stats() differs from its "
            "standalone run" % i)
    check(launches["fused_map_reduce"] == 4 and
          launches["fused_welford"] == 4, "config 1's served path launched "
          "fused_map_reduce %d and fused_welford %d times, not 4 and 4"
          % (launches["fused_map_reduce"], launches["fused_welford"]))
    out.update(budget_bytes=budget, arbiter=arb)
    return launches


def serve_int8(bolt, K, torch, np, stream, serve, reg, out):
    """Config 1's armed int8 streamed sum under a budget of one wire slab
    (the starvation valve shallows its ring); returns the launches."""
    cb1 = seeded_records(np, CONFIG1[1:], integers=True)
    s1 = -(-CONFIG1[0] // SLAB_RECORDS)
    wire_slab = SLAB_RECORDS * math.prod(CONFIG1[1:])     # uint8 records

    def source1():
        return bolt.fromcallback(cb1, CONFIG1, mode="gpu", dtype=np.float32,
                                 chunks=SLAB_RECORDS, codec="int8")

    ring = stream.prefetch_depth() + stream.pool_size(source1()._stream)
    hw = reg.gauge("serve.arbiter_in_use_high_water")
    hw.reset()
    waits0 = reg.counter("serve.arbiter_waits").value
    os.environ["BOLT_CODEC_KERNEL"] = "1"
    try:
        K.reset_launches()
        with serve.serving(workers=1, budget_bytes=wire_slab) as sv:
            got = sv.submit(source1().sum(), tenant="c1-int8").result(
                timeout=600).totorch()
            torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
    finally:
        os.environ.pop("BOLT_CODEC_KERNEL", None)
    waits = reg.counter("serve.arbiter_waits").value - waits0
    check(torch.equal(got.view(torch.int32), KEEP["c1_int8"].view(
        torch.int32)), "the served int8 sum differs from phase 11's")
    check(launches["fused_decode_sum"] == s1, "the served int8 sum "
          "launched fused_decode_sum %d times for %d slabs"
          % (launches["fused_decode_sum"], s1))
    check(0 < hw.value <= wire_slab, "the arbiter's high-water %d passed "
          "its budget %d" % (hw.value, wire_slab))
    check(waits > 0, "the one-slab budget never made the feeder wait")
    check(sv.arbiter.in_use() == 0, "the int8 lease was not returned")
    out.update(budget_bytes=wire_slab, ring_slabs=ring,
               high_water_bytes=hw.value, arbiter_waits=waits, slabs=s1)
    return launches


def serve_config14(bolt, K, torch, np, dev, engine, serve, batched, add1,
                   out):
    """Config 14 at its width: 256 requests of ``(128, 32)`` over 8 bases
    on one worker, unbatched and batched; returns the batched drains'
    launches."""
    import threading
    gen = torch.Generator(device=dev).manual_seed(140)
    b14 = [bolt.array(torch.randn(CONFIG14, generator=gen, device=dev),
                      dev) for _ in range(SERVE_BASES)]

    def make14(i=0):
        return b14[i % SERVE_BASES].map(add1).sum()

    refs = [make14(i).totorch() for i in range(SERVE_BASES)]

    def saturated(sv):
        """Three drains of a queue filled behind a parked worker; the best
        drain's wall (gate open to the last future's finish), and every
        drain's futures."""
        best, allf, outs = float("inf"), [], None
        for _ in range(3):
            gate = threading.Event()
            blocker = sv.submit(gate.wait)
            futs = [sv.submit(make14(i), tenant="t%d" % (i % 4))
                    for i in range(SERVE_REQUESTS)]
            t0 = time.perf_counter()
            gate.set()
            outs = [f.result(timeout=600).totorch() for f in futs]
            best = min(best, max(f.finished_s for f in futs) - t0)
            blocker.result(timeout=30)
            allf += futs
            for i, o in enumerate(outs):
                check(torch.equal(o, refs[i % SERVE_BASES]), "config 14 "
                      "request %d differs from its standalone run" % i)
        return best, allf

    def sparse(sv, n=30):
        """Min of two medians of ``n`` lone requests' latencies, and the
        medians of their queue waits and runs (start to finish: the host
        dispatch, the launch returning before the device ends)."""
        meds, waits, runs = [], [], []
        [sv.submit(make14()).result(timeout=60) for _ in range(5)]
        for _ in range(2):
            lats = []
            for _ in range(n):
                f = sv.submit(make14())
                f.result(timeout=60)
                lats.append(f.finished_s - f.submitted_s)
                waits.append(f.wait_seconds)
                runs.append(f.run_seconds)
                time.sleep(0.005)
            lats.sort()
            meds.append(lats[len(lats) // 2])
        return min(meds), sorted(waits)[len(waits) // 2], \
            sorted(runs)[len(runs) // 2]

    with serve.serving(workers=1, queue_limit=2 * SERVE_REQUESTS) as sv:
        [f.result(timeout=60) for f in
         [sv.submit(make14(i)) for i in range(16)]]
        wall_u, _ = saturated(sv)
        p50_off, wait_off, run_off = sparse(sv)
    with serve.serving(workers=1, queue_limit=2 * SERVE_REQUESTS,
                       batching={"max_batch": 16, "linger": 0.002}) as sv:
        batched.warm(make14, buckets=sv.batching.buckets)
        [f.result(timeout=60) for f in
         [sv.submit(make14(i)) for i in range(16)]]
        torch.cuda.synchronize()
        c0 = engine.counters()
        K.reset_launches()
        wall_b, futs = saturated(sv)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        c1 = engine.counters()
        p50_on, wait_on, run_on = sparse(sv)
    # a batched drain's run seconds: one dispatch's, shared by its lanes
    runs_b = sorted(f.run_seconds for f in futs if f.batch_width)
    asm_b = sorted(f.assembly_seconds for f in futs if f.batch_width)
    d = {k: c1[k] - c0[k] for k in ("misses", "aot_compiles",
                                     "batched_dispatches",
                                     "batched_requests", "dispatches")}
    alone = sum(1 for f in futs if f.batch_width is None)
    check(d["misses"] == 0 and d["aot_compiles"] == 0, "config 14's "
          "steady state built %s" % d)
    check(d["batched_dispatches"] >= 1, "config 14 never coalesced")
    check(launches["fused_map_reduce_lanes"] == d["batched_dispatches"],
          "config 14 launched fused_map_reduce_lanes %d times for %d "
          "batched dispatches" % (launches["fused_map_reduce_lanes"],
                                  d["batched_dispatches"]))
    check(launches["fused_map_reduce"] == alone, "config 14 launched the "
          "standalone fused_map_reduce %d times for %d standalone requests"
          % (launches["fused_map_reduce"], alone))
    check(d["batched_requests"] + alone == 3 * SERVE_REQUESTS,
          "config 14's batched and standalone requests do not add up")
    out.update(reqs_per_s_batched=SERVE_REQUESTS / wall_b,
               reqs_per_s_unbatched=SERVE_REQUESTS / wall_u,
               ratio=wall_u / wall_b, p50_on_s=p50_on, p50_off_s=p50_off,
               p50_ratio=p50_on / p50_off, wait_p50_off_s=wait_off,
               run_p50_off_s=run_off, wait_p50_on_s=wait_on,
               run_p50_on_s=run_on,
               batched_run_p50_s=runs_b[len(runs_b) // 2] if runs_b
               else None,
               batched_assembly_p50_s=asm_b[len(asm_b) // 2] if asm_b
               else None,
               occupancy=d["batched_requests"] / d["batched_dispatches"],
               dispatches_per_request=d["dispatches"] / (3.0
                                                         * SERVE_REQUESTS),
               standalone_requests=alone, counters=d)
    log("phase 13 config14: %d x %s requests, 1 worker: %.0f req/s "
        "batched vs %.0f unbatched (%.2fx; the reference's bench gate >= "
        "3x), occupancy %.2f, sparse p50 %.1f us on / %.1f us off (%.3fx; "
        "its gate < 1.2x), %d standalone requests, steady-state builds 0; "
        "a lone request's queue wait %.1f us and run %.1f us (unbatched "
        "server), a batched dispatch's run %s us (1772.5 us before the lanes "
        "form's redesign, NVIDIA H100 80GB HBM3, 700 W) and assembly %s us"
        % (SERVE_REQUESTS, CONFIG14, out["reqs_per_s_batched"],
           out["reqs_per_s_unbatched"], out["ratio"], out["occupancy"],
           1e6 * p50_on, 1e6 * p50_off, out["p50_ratio"], alone,
           1e6 * wait_off, 1e6 * run_off,
           None if not runs_b else "%.1f" % (1e6 * out["batched_run_p50_s"]),
           None if not asm_b else "%.1f" % (
               1e6 * out["batched_assembly_p50_s"])))
    return launches, [b._data for b in b14]


def lanes_timings(K, torch, dev, bases, add1):
    """``fused_map_reduce_lanes`` at config 14 (16 lanes of ``(128, 32)``
    f32): bit for bit against 16 standalone launches in both forms, and at
    1, 2, 5 and 16 lanes and more lanes than a launch's table holds;
    against its plain version; the kernels a call runs (1) and the scratch
    it allocates (none); timed beside the standalone launches, the library
    call on a stacked copy and its bound, host-paced and on the device
    alone."""
    from bolt_tpu_torch.ops import mapexpr
    gen = torch.Generator(device=dev).manual_seed(141)
    wide = K._MAX_LANES + 16
    xs = [b for b in bases] + [torch.randn(CONFIG14, generator=gen,
                                           device=dev)
                               for _ in range(wide - len(bases))]
    prog = mapexpr.compile((add1,), CONFIG14[1:], torch.float32)
    full = mapexpr.compile((add1,), CONFIG14, torch.float32)
    ones = [K.fused_map_reduce_cols(x, prog) for x in xs]
    onesf = [K.fused_map_reduce_program(x, full) for x in xs]
    for w in (1, 2, 5, 16, wide):
        before = K.LAUNCHES["fused_map_reduce_lanes"]
        got = K.fused_map_reduce_lanes(xs[:w], prog, cols=True)
        gotf = K.fused_map_reduce_lanes(xs[:w], full)
        check(K.LAUNCHES["fused_map_reduce_lanes"] - before
              == 2 * -(-w // K._MAX_LANES), "fused_map_reduce_lanes at %d "
              "lanes launched %d times" % (
                  w, K.LAUNCHES["fused_map_reduce_lanes"] - before))
        for i in range(w):
            check(torch.equal(got[i], ones[i])
                  and torch.equal(gotf[i], onesf[i]),
                  "lane %d of %d of fused_map_reduce_lanes differs from "
                  "its standalone launch" % (i, w))
    xs = xs[:16]
    got = K.fused_map_reduce_lanes(xs, prog, cols=True)
    plain = K._fused_map_reduce_lanes_plain(xs, prog, True)
    err = float((got.double() - plain.double()).abs().max())
    mag = float(plain.double().abs().max())
    check(err <= 1e-4 * (1 + mag), "fused_map_reduce_lanes: max abs err "
          "%.3g against its plain version" % err)
    # the kernels a call runs (the plan's: 2 where a combine or fold
    # kernel adds partials) and the bytes it allocates beyond its output
    # (the caching allocator's counts around one call)
    kernels, scratch = {}, {}
    for form, p, cols, out_bytes in (("cols", prog, True, 16 * 32 * 4),
                                     ("full", full, False, 16 * 4)):
        rec = K._record(K._encoded(p), cols, CONFIG14 if cols else
                        CONFIG14[0] * CONFIG14[1], torch.float32,
                        xs[0].device, 4)
        kernels[form] = rec.kernels
        torch.cuda.synchronize()
        s0 = torch.cuda.memory_stats(dev)
        K.fused_map_reduce_lanes(xs, p, cols=cols)
        torch.cuda.synchronize()
        s1 = torch.cuda.memory_stats(dev)
        scratch[form] = (s1["allocated_bytes.all.allocated"]
                         - s0["allocated_bytes.all.allocated"]
                         - 512 * -(-out_bytes // 512))
    check(kernels == {"cols": 1, "full": 1}
          and scratch == {"cols": 0, "full": 0},
          "config 14's lanes call runs %s kernels and allocates %s scratch "
          "bytes (one kernel and none expected)" % (kernels, scratch))
    stacked = torch.stack(xs)
    n_el = stacked.numel()
    t_bytes = (n_el + 16 * CONFIG14[1]) * 4 / HBM_BYTES_PER_S
    t_ops = OPS_PER_ELEMENT["fused_map_reduce"] * n_el / PEAK_OPS["float32"]
    dev_us, paced = queued_device_us(lambda: K.fused_map_reduce_lanes(
        xs, prog, cols=True))
    full_us, full_paced = queued_device_us(
        lambda: K.fused_map_reduce_lanes(xs, full))
    row = {"ms": timed_ms(lambda: K.fused_map_reduce_lanes(
               xs, prog, cols=True), 200),
           "full_ms": timed_ms(lambda: K.fused_map_reduce_lanes(xs, full),
                               200),
           "standalone_16_ms": timed_ms(
               lambda: [K.fused_map_reduce_cols(x, prog) for x in xs], 50),
           "standalone_1_ms": timed_ms(
               lambda: K.fused_map_reduce_cols(xs[0], prog), 200),
           "plain_ms": timed_ms(lambda: K._fused_map_reduce_lanes_plain(
               xs, prog, True), 50),
           "library_ms": timed_ms(lambda: torch.sum(stacked, 1), 200),
           "library_full_ms": timed_ms(
               lambda: torch.sum(stacked.reshape(16, -1), 1), 200),
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": err,
           "kernels_a_call": kernels, "scratch_bytes": scratch,
           "bit_for_bit_lanes": [1, 2, 5, 16, wide],
           # the device's own time a call: calls queued behind a sleep
           "device_us": dev_us, "device_paced": paced,
           "full_device_us": full_us, "full_device_paced": full_paced,
           "standalone_1_device_us": queued_device_us(
               lambda: K.fused_map_reduce_cols(xs[0], prog))[0],
           "library_device_us": queued_device_us(
               lambda: torch.sum(stacked, 1))[0],
           # the profiler's kernel time a call, over 50 calls, and its
           # view of the library call (does it see any kernel here?)
           "profiler_device_us": (lambda k: None if k is None else k / 50)(
               device_us(lambda: [K.fused_map_reduce_lanes(
                   xs, prog, cols=True) for _ in range(50)])[1]),
           "profiler_library_us": (lambda k: None if k is None else k / 50)(
               device_us(lambda: [torch.sum(stacked, 1)
                                  for _ in range(50)])[1])}
    log("fused_map_reduce_lanes config14 x16: device %.2f us a call (full "
        "form %.2f us; one standalone launch %.2f us; torch.sum of the "
        "stacked copy %.2f us; %s), the profiler %s us (of torch.sum %s "
        "us); %s kernels a call, scratch bytes %s; every lane bit for bit "
        "at %s lanes"
        % (dev_us, full_us, row["standalone_1_device_us"],
           row["library_device_us"],
           "paced by the host" if paced or full_paced else "not paced",
           row["profiler_device_us"], row["profiler_library_us"], kernels,
           scratch,
           row["bit_for_bit_lanes"]))
    log("fused_map_reduce_lanes config14 x16 kernel_ms %.4f (full form "
        "%.4f) standalone_16_ms %.4f (one launch %.4f) plain_ms %.4f "
        "library_ms %.4f (torch.sum(x.reshape(16, -1), 1) %.4f) bound_ms "
        "%.6f (%s)"
        % (row["ms"], row["full_ms"], row["standalone_16_ms"],
           row["standalone_1_ms"],
           row["plain_ms"], row["library_ms"], row["library_full_ms"],
           row["bound_ms"], row["bound_by"]))
    return row


def serve_phase(bolt, K, torch, np, dev, report):
    """Phase 13: config 9's four streamed tenants, config 1 in memory
    under the arbiter and its armed int8 stream under a one-slab budget,
    and config 14's micro-batched requests; returns each path's launches
    and the lanes kernel's timings."""
    from bolt_tpu_torch import engine, serve, stream
    from bolt_tpu_torch.gpu import batched
    from bolt_tpu_torch.obs import metrics
    t0 = time.perf_counter()
    reg = metrics.registry()
    add1 = lambda v: v + 1           # noqa: E731 — shared by every tenant
    out = {}
    launches = {}

    def path(label, fn):
        """One path: its wall, peak device memory and launches (counted
        from 0), logged on one line."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        out[label] = {}
        t = time.perf_counter()
        got = fn(out[label])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[label] = dict(K.LAUNCHES) if got is None else got
        peak = torch.cuda.max_memory_allocated()
        out[label].update(wall_s=wall, peak_gb=peak / 1e9, launches={
            k: v for k, v in launches[label].items() if v})
        log("phase 13 %-9s wall %.3f s, peak %.3f GB, launches %s"
            % (label, wall, peak / 1e9, json.dumps(out[label]["launches"])))

    path("config9", lambda o: serve_config9(bolt, torch, np, dev, engine,
                                            serve, reg, add1, o))
    path("config1", lambda o: serve_config1(bolt, K, torch, np, dev, serve,
                                            add1, o))
    path("int8_c1", lambda o: serve_int8(bolt, K, torch, np, stream, serve,
                                         reg, o))
    bases = []

    def c14(o):
        got, b = serve_config14(bolt, K, torch, np, dev, engine, serve,
                                batched, add1, o)
        bases.extend(b)
        return got

    path("config14", c14)
    lanes = lanes_timings(K, torch, dev, bases, add1)
    check(not serve.active() and not batched.armed(), "phase 13 left a "
          "server or the batching door behind")
    report["serve_phase"] = dict(out, lanes_kernel=lanes)
    report["phases"]["serve_s"] = time.perf_counter() - t0
    log("serve phase ok in %.1f s" % report["phases"]["serve_s"])
    return launches, lanes


def analysis_phase(bolt, K, torch, np, dev, report):
    """Phase 14: ``analysis.check`` of the main path's pipelines at full
    width (nothing built, launched or allocated on the card by a check),
    then each pipeline under ``analysis.strict()``: its prediction equal
    to its result, its result bit for bit the unguarded run's, BLT017's
    forecast equal to the spill decision, BLT010 refused at ``submit``, a
    broken chain refused before any build.  Returns each path's launches,
    counted from 0."""
    import shutil
    from bolt_tpu_torch import (analysis, checkpoint, engine, ops, serve,
                                stream)
    from bolt_tpu_torch.gpu import batched
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    from bolt_tpu_torch.ops import _build
    t0 = time.perf_counter()
    add1 = lambda v: v + 1           # noqa: E731
    pred = lambda v: v.mean() > 1    # noqa: E731  (config 4's)
    checks, launches, results = {}, {}, {}
    out = {"checks": checks, "results": results}
    c_start = engine.counters()

    def checked(label, obj):
        """``analysis.check(obj)`` twice (first and cached host walls),
        holding the engine's builds, every launch counter, the kernel
        libraries and the card's allocated bytes and peak flat."""
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        c0, l0, b0 = engine.counters(), dict(K.LAUNCHES), len(_build._LOADED)
        t = time.perf_counter()
        rep = analysis.check(obj)
        first = time.perf_counter() - t
        t = time.perf_counter()
        analysis.check(obj)
        cached = time.perf_counter() - t
        torch.cuda.synchronize()
        c1 = engine.counters()
        moved = {k: c1[k] - c0[k] for k in ("misses", "aot_compiles",
                                             "dispatches")}
        moved.update({k: v - l0.get(k, 0) for k, v in K.LAUNCHES.items()})
        moved["libraries"] = len(_build._LOADED) - b0
        moved["allocated"] = torch.cuda.memory_allocated() - a0
        moved["peak"] = torch.cuda.max_memory_allocated() - a0
        moved = {k: v for k, v in moved.items() if v}
        check(not moved, "phase 14 check of %s moved %s" % (label, moved))
        codes = sorted({d.code for d in rep.diagnostics})
        checks[label] = {"first_ms": 1e3 * first, "cached_ms": 1e3 * cached,
                         "codes": codes, "ok": rep.ok,
                         "shape": rep.shape, "dtype": str(rep.dtype),
                         "dynamic": rep.dynamic}
        log("phase 14 check %-16s first %.3f ms, cached %.3f ms, codes %s, "
            "shape %s %s" % (label, 1e3 * first, 1e3 * cached, codes,
                             rep.shape, rep.dtype))
        return rep

    def predicted(label, rep, got):
        """The report's shape and dtype equal the result tensor's (a
        dynamic report: the value axes)."""
        shape, dtype = tuple(got.shape), got.dtype
        if rep.dynamic:
            check(rep.shape[0] is None and rep.shape[1:] == shape[1:],
                  "phase 14 %s: predicted %s, got %s" % (label, rep.shape,
                                                         shape))
        else:
            check(rep.shape == shape, "phase 14 %s: predicted %s, got %s"
                  % (label, rep.shape, shape))
        check(np.dtype(rep.dtype) == np.dtype(str(dtype).split(".")[1]),
              "phase 14 %s: predicted dtype %s, got %s" % (label, rep.dtype,
                                                           dtype))

    def same(label, got, want):
        check(got.dtype == want.dtype and got.shape == want.shape
              and torch.equal(got.reshape(-1).view(torch.int32)
                              if got.dtype == torch.float32
                              else got.reshape(-1), want.reshape(-1).view(
                                  torch.int32) if want.dtype == torch.float32
                              else want.reshape(-1)),
              "phase 14 %s under strict() differs from its unguarded run"
              % label)
        results[label] = "bit for bit"

    def path(label, fn):
        """One path's launches counted from 0 (its unguarded and strict
        runs), its wall logged."""
        torch.cuda.synchronize()
        K.reset_launches()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        launches[label] = dict(K.LAUNCHES)
        log("phase 14 %-10s wall %.3f s, launches %s" % (
            label, time.perf_counter() - t,
            json.dumps({k: v for k, v in launches[label].items() if v})))

    # ---- the north-star (10.49 GB on the card) ------------------------
    b = bolt.randn(NORTH_STAR, mode="gpu", dtype=np.float32, seed=0)

    def north_star():
        rep = checked("ns_map_sum", b.map(add1).sum())
        want = b.map(add1).sum().totorch()
        with analysis.strict():
            got = b.map(add1).sum().totorch()
        predicted("ns_map_sum", rep, got)
        same("ns_map_sum", got, want)
        rep = checked("ns_stats", b)
        want = b.stats()
        with analysis.strict():
            st = b.stats()
        check(tuple(st.mean().shape) == rep.shape[rep.split:],
              "phase 14 stats(): predicted value shape %s, got %s"
              % (rep.shape[rep.split:], st.mean().shape))
        for m in ("mean", "variance", "min", "max"):
            check(np.array_equal(getattr(st, m)(), getattr(want, m)()),
                  "phase 14 stats() %s under strict() differs" % m)
        results["ns_stats"] = "bit for bit"
        names = ("sum", "mean", "var", "std", "min", "max", "ptp")
        m = b.map(add1)
        plain = [getattr(m, n)() for n in names]
        bolt.compute(*plain)
        m = b.map(add1)
        handles = [getattr(m, n)() for n in names]
        rep = checked("ns_group", handles[0])
        check(rep.has("BLT009"), "phase 14: the group forecast no BLT009")
        with analysis.strict():
            bolt.compute(*handles)
        for n, h, p in zip(names, handles, plain):
            predicted("ns_group_%s" % n, rep if n == "sum"
                      else analysis.check(h), h.totorch())
            same("ns_group_%s" % n, h.totorch(), p.totorch())
        f = b.map(add1).filter(pred)
        rep = checked("ns_filter", f)
        check(rep.dynamic and rep.has("BLT008"), "phase 14: config 4's "
              "filter is not dynamic")
        rep_s = checked("ns_filter_sum", f.sum())
        want = b.map(add1).filter(pred).sum().totorch()
        with analysis.strict():
            got = b.map(add1).filter(pred).sum().totorch()
        predicted("ns_filter_sum", rep_s, got)
        same("ns_filter_sum", got, want)
        # a broken hand-built chain: refused before any build or launch
        bad = BoltArrayGPU._deferred(
            b.totorch(), (lambda v: v @ torch.ones((99, 2), device=v.device),
                          ), 1, dev, (NORTH_STAR[0], 2), np.float32)
        c0, l0 = engine.counters(), dict(K.LAUNCHES)
        a0 = torch.cuda.memory_allocated()
        with analysis.strict():
            try:
                bad.sum()
            except analysis.PipelineError as exc:
                check("BLT001" in str(exc), "phase 14: the broken chain "
                      "was refused without BLT001: %s" % exc)
            else:
                check(False, "phase 14: strict() dispatched a broken chain")
        c1 = engine.counters()
        check(c1["misses"] == c0["misses"] and c1["aot_compiles"]
              == c0["aot_compiles"] and dict(K.LAUNCHES) == l0
              and torch.cuda.memory_allocated() == a0, "phase 14: the "
              "refused chain built, launched or allocated")
        results["ns_broken_chain"] = "refused (BLT001)"
        # strict's extra host time on the cached map(v + 1).sum()
        reps = 20
        walls = {}
        for mode in ("plain", "strict", "plain2", "strict2"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                if mode.startswith("strict"):
                    with analysis.strict():
                        b.map(add1).sum().totorch()
                else:
                    b.map(add1).sum().totorch()
            torch.cuda.synchronize()
            walls[mode] = (time.perf_counter() - t) / reps
        plain = min(walls["plain"], walls["plain2"])
        guarded = min(walls["strict"], walls["strict2"])
        out["strict_overhead_ms"] = 1e3 * (guarded - plain)
        out["ns_map_sum_plain_ms"] = 1e3 * plain
        out["ns_map_sum_strict_ms"] = 1e3 * guarded
        log("phase 14 strict() on the cached north-star map(v+1).sum(): "
            "%.4f ms a call against %.4f ms unguarded (%.4f ms extra host "
            "time; B1 itself about 3.48 ms)"
            % (1e3 * guarded, 1e3 * plain, out["strict_overhead_ms"]))

    path("north_star", north_star)

    # ---- config 1: swap and the per-chunk SVD (no kernel) ---------------
    b1 = bolt.randn(CONFIG1, mode="gpu", dtype=np.float32, seed=1)
    b5 = bolt.randn((64, 4096, 32), mode="gpu", dtype=np.float32, seed=5)

    def config1():
        rep = checked("c1_swap", b1.map(add1))
        want = b1.map(add1).swap((0,), (0,)).totorch()
        with analysis.strict():
            got = b1.map(add1).swap((0,), (0,)).totorch()
        check(rep.shape == CONFIG1, "phase 14 swap's input shape")
        same("c1_swap", got, want)
        view = b5.chunk(size=(512,), axis=(0,))
        rep = checked("c5_chunk_svd", view)
        svd = lambda blk: ops.svdvals(blk)[None, :]      # noqa: E731
        want = view.map(svd).unchunk().totorch()
        with analysis.strict():
            got = b5.chunk(size=(512,), axis=(0,)).map(svd).unchunk()
        check(rep.shape == (64, 4096, 32) and tuple(got.shape) == (64, 8, 32),
              "phase 14 chunk().map() shapes")
        same("c5_chunk_svd", got.totorch(), want)

    path("config1", config1)
    del b1, b5

    # ---- the streamed north-star (40 slabs) ------------------------------
    cb = seeded_records(np, STREAM_NS[1:])

    def stream_ns():
        src = bolt.fromcallback(cb, STREAM_NS, mode="gpu", dtype=np.float32)
        rep = checked("stream_map", src.map(add1))
        check(len(rep.stages) == 2 and "%d slabs" % -(
            -STREAM_NS[0] // SLAB_RECORDS) in rep.stages[0].note,
            "phase 14: the streamed plan's stages")
        rep_s = checked("stream_map_sum", src.map(add1).sum())
        with stream.uploaders(4), analysis.strict():
            got = src.map(add1).sum().totorch().reshape(-1)
        predicted("stream_map_sum", rep_s, got.view(STREAM_NS[1:]))
        same("stream_map_sum", got, KEEP["ns_map_sum"])

    path("stream_ns", stream_ns)

    # ---- config 1's armed int8 stream (BLT016) --------------------------
    cb1 = seeded_records(np, CONFIG1[1:], integers=True)

    def source1(codec=None, chunks=SLAB_RECORDS):
        return bolt.fromcallback(cb1, CONFIG1, mode="gpu", dtype=np.float32,
                                 chunks=chunks, codec=codec)

    def int8_c1():
        os.environ["BOLT_CODEC_KERNEL"] = "1"
        try:
            rep = checked("int8_c1", source1("int8").sum())
            check(rep.has("BLT016") and rep.has("BLT009"),
                  "phase 14: the armed int8 stream forecast no BLT016")
            with analysis.strict():
                got = source1("int8").sum().totorch()
        finally:
            os.environ.pop("BOLT_CODEC_KERNEL", None)
        predicted("int8_c1", rep, got)
        check(torch.equal(got.view(torch.int32),
                          KEEP["c1_int8"].view(torch.int32)),
              "phase 14 int8_c1 under strict() differs from phase 11's")
        results["int8_c1"] = "bit for bit"

    path("int8_c1", int8_c1)

    # ---- a resumable one-shot iterator (BLT011) --------------------------
    def resumable():
        shape = (SLAB_RECORDS * 4,) + CONFIG1[1:]

        def gen():
            for lo in range(0, shape[0], SLAB_RECORDS):
                yield cb1((slice(lo, lo + SLAB_RECORDS),))

        def run(guard):
            ck_dir = os.path.join(ROOT, "build", "phase14_ckpt_" + guard)
            shutil.rmtree(ck_dir, ignore_errors=True)
            with stream.resumable(ck_dir):
                src = bolt.fromiter(gen(), shape, mode="gpu",
                                    dtype=np.float32)
                rep = checked("resumable_%s" % guard, src)
                check(rep.has("BLT011") and rep.ok, "phase 14: no BLT011 "
                      "warning on a one-shot iterator under resumable()")
                if guard == "strict":
                    with analysis.strict():
                        return rep, src.sum().totorch()
                return rep, src.sum().totorch()

        _, want = run("plain")
        rep, got = run("strict")
        check(rep.shape == shape, "phase 14 resumable source shape")
        same("resumable_sum", got, want)

    path("resumable", resumable)

    # ---- config 1's swap under a 256 MiB budget (BLT017) ----------------
    spill_dir = os.path.join(ROOT, "build", "phase14_spill")
    os.makedirs(spill_dir, exist_ok=True)

    def blt017(rep):
        ds = [d for d in rep.diagnostics if d.code == "BLT017"]
        check(len(ds) == 1, "phase 14: %d BLT017 findings" % len(ds))
        return ds[0]

    def swap_c1():
        checkpoint.spill_clear(spill_dir)
        rep = checked("swap_c1_resident", source1().swap((0,), (0,)))
        d = blt017(rep)
        check(d.severity == "info" and "resident" in d.message, "phase 14 "
              "resident forecast: %s" % d.message)
        s0 = engine.counters()["spill_bytes"]
        want = source1().swap((0,), (0,)).sum().totorch()
        check(engine.counters()["spill_bytes"] == s0, "phase 14: the "
              "resident forecast spilled")
        with stream.spill(spill_dir, budget=SPILL_BUDGET):
            sw = source1().swap((0,), (0,))
            d = blt017(checked("swap_c1_spill", sw))
            check(d.severity == "info" and "spill" in d.message, "phase 14 "
                  "spill forecast: %s" % d.message)
            with analysis.strict():
                got = sw.sum().totorch()
        check(engine.counters()["spill_bytes"] > s0, "phase 14: the spill "
              "forecast spilled nothing")
        same("swap_c1_spill", got, want)
        checkpoint.spill_clear(spill_dir)
        with stream.spill(None, budget=SPILL_BUDGET):
            sw = source1().swap((0,), (0,))
            d = blt017(checked("swap_c1_nodir", sw))
            check(d.severity == "warning" and "NO spill directory"
                  in d.message, "phase 14 no-dir forecast: %s" % d.message)
            s1 = engine.counters()["spill_bytes"]
            try:
                with analysis.strict():
                    sw.sum().totorch()
            except RuntimeError as exc:
                check("spill" in str(exc), "phase 14: the no-dir swap "
                      "raised %s" % exc)
            else:
                check(False, "phase 14: the no-dir swap was not refused")
            check(engine.counters()["spill_bytes"] == s1, "phase 14: the "
                  "refused swap spilled")
        results["swap_c1_nodir"] = "refused at dispatch, as forecast"

    path("swap_c1", swap_c1)

    # ---- BLT010: a server whose budget is below the floor ----------------
    def blt010():
        # half of one slab: the stream can never degrade into it
        budget = analysis.admission_floor_bytes(source1()) // 2
        with serve.serving(workers=1, budget_bytes=budget) as sv:
            arr = source1().map(add1).sum()
            rep = checked("blt010", arr)
            check(rep.has("BLT010") and not rep.ok, "phase 14: no BLT010 "
                  "under a budget of %d bytes" % budget)
            try:
                sv.submit(arr)
            except serve.AdmissionError as exc:
                check("BLT010" in str(exc), "phase 14 admission: %s" % exc)
            else:
                check(False, "phase 14: submit admitted the BLT010 pipeline")
            try:
                with analysis.strict():
                    source1().map(add1).sum().totorch()
            except analysis.PipelineError as exc:
                check("BLT010" in str(exc), "phase 14 strict: %s" % exc)
            else:
                check(False, "phase 14: strict() ran the BLT010 pipeline")
        results["blt010"] = "refused at submit and by strict()"

    path("blt010", blt010)

    # ---- config 14 on a batching server (BLT015) --------------------------
    def config14():
        gen = torch.Generator(device=dev).manual_seed(141)
        bases = [bolt.array(torch.randn(CONFIG14, generator=gen, device=dev),
                            dev) for _ in range(16)]
        want = [b_.map(add1).sum().totorch() for b_ in bases]
        with serve.serving(workers=1, batching={"max_batch": 16,
                                                "linger": 0.002}):
            arrs = [b_.map(add1).sum() for b_ in bases]
            rep = checked("config14", arrs[0])
            check(rep.has("BLT015"), "phase 14: no BLT015 on a batching "
                  "server")
            with analysis.strict():
                batch = batched.claim(arrs, batched.batch_key(arrs[0]))
                check(batch is not None, "phase 14: could not claim the "
                      "16 requests")
                batched.dispatch(batch, (16,))
            for i, a in enumerate(arrs):
                predicted("config14", rep, a.totorch())
                same("config14_%d" % i, a.totorch(), want[i])

    path("config14", config14)
    checkpoint.spill_clear(spill_dir)
    del b

    c_end = engine.counters()
    out["strict_checks"] = c_end["strict_checks"] - c_start["strict_checks"]
    out["strict_rejections"] = (c_end["strict_rejections"]
                                - c_start["strict_rejections"])
    out["launches"] = {p: {k: v for k, v in c.items() if v}
                       for p, c in launches.items()}
    for name, where in (("fused_map_reduce", "north_star"),
                        ("fused_welford", "north_star"),
                        ("fused_decode_sum", "int8_c1"),
                        ("fused_map_reduce_lanes", "config14")):
        check(launches[where][name] > 0, "phase 14 %s never launched %s "
              "under strict()" % (where, name))
    report["analysis_phase"] = out
    report["phases"]["analysis_s"] = time.perf_counter() - t0
    log("phase 14 strict_checks %d, strict_rejections %d"
        % (out["strict_checks"], out["strict_rejections"]))
    log("analysis phase ok in %.1f s" % report["phases"]["analysis_s"])
    return launches


# phase 15's pods: every rank on the one card ("cuda"); the one-rank pod
# on NCCL, the others on gloo (two ranks cannot share a card under NCCL)
MESH_POD_DEVICE = "cuda"
MESH_ONE_BACKEND = "nccl"
MESH_CHUNK = 50
MESH_POD_WALL = 300


def mesh_pod(harness, out, name, payload, nproc, backend, args):
    """Run ``payload`` on a pod of ``nproc`` ranks on the card; log each
    path's wall, peak growth and launches per rank and its collective
    bytes (host-staged among them) beside the card's name and power
    limit.  Returns the per-rank results."""
    t = time.perf_counter()
    res = harness.run_cluster(payload, nproc=nproc, timeout=MESH_POD_WALL,
                              args=args, device=MESH_POD_DEVICE,
                              backend=backend)
    wall = time.perf_counter() - t
    pod = out["pods"][name] = {"ranks": nproc, "backend": backend,
                               "wall_s": wall, "paths": {}}
    KEEP.setdefault("pods", {})[name] = res
    for path in res[0]["paths"]:
        per = [r["paths"][path] for r in res]
        pod["paths"][path] = per
        # phase 16's, 18's and 19's paths ride the same pods ("s16_...",
        # "s18_...", "s19_...")
        label = path[1:3] if path.startswith(("s16_", "s18_", "s19_")) \
            else "15"
        log("phase %s %s %s: wall %s s, peak growth %s GB per rank, "
            "launches per rank %s, collective bytes %s, host-staged %s%s "
            "(%s)" % (label, name, path,
                      [round(p["wall_s"], 3) for p in per],
                      [round(p.get("peak_growth_bytes", 0) / 1e9, 3)
                       for p in per], [p["launches"] for p in per],
                      [p["collectives"]["collective_bytes"] for p in per],
                      [p["collectives"]["collective_host_bytes"]
                       for p in per],
                      "" if not path.startswith("s16_") else
                      ", rows %s, transfer bytes %s, engine misses %s"
                      % ([p.get("rows") for p in per],
                         [p["engine"]["transfer_bytes"] for p in per],
                         [p["engine"]["misses"] for p in per]),
                      out["card"]))
    log("phase %s pod %s: %d ranks (%s) in %.1f s"
        % ("16" if all(p.startswith("s16_") for p in res[0]["paths"])
           else "15, 16, 18 and 19", name, nproc, backend, wall))
    return res


def mesh_phase(bolt, K, torch, np, dev, report):
    """Phase 15: device meshes.  Child pods of ranks on this one card
    (``bolt_tpu_torch/parallel/harness.py``), each held against the
    single-device result this process computes first: a one-rank NCCL
    pod at the north-star (``map(v + 1).sum()``, ``stats()`` and
    ``swap`` bit for bit), a two-rank gloo pod with the north-star split
    1600 records a rank (crafted exact data bit for bit: ``map(v +
    1).sum()``, ``reduce(add)``, config 4's filter ``sum()``/``mean()``,
    ``stats()`` and the fluent group of constant columns; ``randn``
    against f64 references; config 1's crafted ``swap`` box by box and
    ``toarray()``, each by fingerprint), a
    four-rank ``(2, 2)`` gloo pod at config 1 (the keys on ``"k"``,
    replicated on ``"v"``: the sum with no double count; the halo-padded
    chunk map and ``ops.gaussian(..., shard="v")`` each rank's box bit
    for bit), and two NCCL ranks on one card refused.  Returns each
    path's launches per rank."""
    from operator import add
    from bolt_tpu_torch import ops
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    from bolt_tpu_torch.parallel import harness, payloads, sharding
    from bolt_tpu_torch.parallel.mesh import layout
    t_phase = time.perf_counter()
    out = {"pods": {}, "card": report["card"]}
    report["mesh"] = out
    add1 = lambda v: v + 1           # noqa: E731
    pred = lambda v: v.mean() > 1    # noqa: E731  (config 4's)
    whole = lambda shape: tuple((0, n) for n in shape)  # noqa: E731

    # ---- the single-device results ----------------------------------------
    t = time.perf_counter()
    torch.cuda.empty_cache()
    b = bolt.randn(NORTH_STAR, mode="gpu", dtype=np.float32, seed=0)
    st = b.stats()
    one = {"map_sum": b.map(add1).sum().toarray(), "mean": st.mean(),
           "var": st.variance()}
    s = b.swap((0,), (0,))
    one["swap"] = payloads.fingerprint(s.totorch())
    del b, s
    x = BoltArrayGPU(payloads.crafted_box(NORTH_STAR, whole(NORTH_STAR),
                                          dev), 1, dev)
    two = {"map_sum": x.map(add1).sum().toarray(),
           "reduce": x.reduce(add).toarray(),
           "filter_sum": x.map(add1).filter(pred).sum().toarray(),
           "filter_mean": x.map(add1).filter(pred).mean().toarray()}
    del x
    z = BoltArrayGPU(payloads.constant_box(NORTH_STAR, whole(NORTH_STAR),
                                           dev), 1, dev)
    st = z.stats()
    two["const"] = {k: np.asarray(getattr(st, k)()) for k in
                    ("mean", "variance", "min", "max")}
    g = z.map(add1).stats(*payloads.GROUP_NAMES)
    two["const_group"] = {k: g[k].toarray() for k in payloads.GROUP_NAMES}
    del z, g
    c1 = BoltArrayGPU(payloads.crafted_box(CONFIG1, whole(CONFIG1), dev), 1,
                      dev)
    four = {"map_sum": c1.map(add1).sum().toarray()}
    # config 1's crafted swap on two ranks: each rank's box of the single
    # device's swap, and the whole array a gather gives every rank
    sw = c1.swap((0,), (0,)).totorch()
    lay2 = layout((2,), ("k",))
    sw_shape = tuple(sw.shape)
    sw_spec = sharding.key_spec(lay2, sw_shape, 1)
    two["swap_fp"] = {}
    for r in range(lay2.size):
        bx = sharding.box(lay2, sw_spec, sw_shape, r)
        two["swap_fp"][bx] = payloads.fingerprint(
            sw[sharding.box_slices(bx)])
    two["toarray_fp"] = payloads.fingerprint(c1.totorch())
    two["swapped_fp"] = payloads.fingerprint(sw)
    del sw
    KEEP["mesh_two"] = two
    halo = c1.chunk(size=(MESH_CHUNK,), axis=(0,), padding=2).map(
        lambda blk: blk * 2 + 1).unchunk().totorch()
    gauss = ops.gaussian(c1, 2.0, axis=(0, 2)).totorch()
    lay = layout((2, 2), ("k", "v"))
    spec = sharding.combined_spec(lay, CONFIG1, 1, {0: "v"})
    four["halo"], four["gaussian"] = {}, {}
    for r in range(lay.size):
        bx = sharding.box(lay, spec, CONFIG1, r)
        sl = sharding.box_slices(bx)
        four["halo"][bx] = payloads.fingerprint(halo[sl])
        four["gaussian"][bx] = payloads.fingerprint(gauss[sl])
    del c1, halo, gauss
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["refs_s"] = time.perf_counter() - t
    log("phase 15 single-device results in %.1f s" % out["refs_s"])

    def same(got, want, what):
        check(got.dtype == np.asarray(want).dtype
              and np.array_equal(got, want), "phase 15 %s" % what)

    # ---- the one-rank NCCL pod: the single-device path's bits --------------
    res = mesh_pod(harness, out, "one", "card_one", 1, MESH_ONE_BACKEND,
                   {"north_star": list(NORTH_STAR),
                    "stream": pod_stream_args()})
    r = res[0]
    check(r["backend"] == MESH_ONE_BACKEND, "phase 15 one-rank backend")
    same(r["map_sum"], one["map_sum"], "one-rank map(v+1).sum()")
    same(r["mean"], one["mean"], "one-rank stats() mean")
    same(r["var"], one["var"], "one-rank stats() variance")
    check(r["swap"] == one["swap"], "phase 15 one-rank swap fingerprint")
    check(all(p["collectives"]["collective_host_bytes"] == 0
              for p in r["paths"].values()),
          "phase 15 one-rank pod staged bytes through the host")

    # ---- two gloo ranks on the card: the north-star split ------------------
    res = mesh_pod(harness, out, "pod2", "card_pod2", 2, "gloo",
                   {"north_star": list(NORTH_STAR),
                    "config1": list(CONFIG1),
                    "stream": pod_stream_args(),
                    "surface": surface_args(), "numpy": numpy_args()})
    for r in res:
        for k in ("map_sum", "reduce", "filter_sum", "filter_mean"):
            same(r[k], two[k], "two-rank crafted %s (rank %d)"
                 % (k, r["rank"]))
        for k, v in two["const"].items():
            same(r["const_stats"][k], v, "two-rank constant-column stats "
                 "%s (rank %d)" % (k, r["rank"]))
        for k, v in two["const_group"].items():
            same(r["const_group"][k], v, "two-rank fluent stat group %s "
                 "(rank %d)" % (k, r["rank"]))
        check(r["const_count"] == NORTH_STAR[0], "phase 15 stats count")
        e = r["randn_err"]
        check(e["sum"] <= 2e-2 and e["mean"] <= 2e-5
              and e["var_rel"] <= 1e-4, "phase 15 two-rank randn against "
              "f64 references: %s" % e)
        check(r["swap_equal"], "phase 15 config 1 swap through the "
              "all_to_all vs np.transpose (rank %d)" % r["rank"])
        bx = tuple(tuple(b) for b in r["swap_box"])
        check(r["swap_fp"] == two["swap_fp"].get(bx), "phase 15 two-rank "
              "crafted config 1 swap box %s bit for bit (rank %d)"
              % (bx, r["rank"]))
        check(r["toarray_fp"] == two["toarray_fp"]
              and r["swapped_fp"] == two["swapped_fp"], "phase 15 two-rank "
              "crafted config 1 toarray() bit for bit (rank %d)" % r["rank"])
        p = r["paths"]
        check(p["ns_map_sum"]["launches"].get("fused_map_reduce", 0) >= 1
              and p["ns_filter"]["launches"].get("fused_map_reduce", 0) >= 2
              and p["ns_stats"]["launches"].get("fused_welford", 0) >= 1
              and p["ns_group"]["launches"].get("fused_map_reduce", 0) >= 1
              and p["ns_group"]["launches"].get("fused_welford", 0) >= 1
              and p["ns_randn"]["launches"].get("fused_welford", 0) >= 1,
              "phase 15 two-rank kernel launches: %s" % {
                  k: v["launches"] for k, v in p.items()})
        check(p["c1_swap"]["collectives"]["collective_host_bytes"] > 0,
              "phase 15 the gloo swap staged nothing through the host")
    check(all(np.array_equal(res[0][k], res[1][k]) for k in
              ("map_sum", "reduce", "filter_sum", "filter_mean")),
          "phase 15 two ranks returned different bits")
    log("phase 15 two-rank randn errors against f64: %s; gather %s"
        % ([r["randn_err"] for r in res], res[0]["gather_stats"]))

    # ---- four gloo ranks, (2, 2) ("k", "v"), config 1 ----------------------
    res = mesh_pod(harness, out, "pod4", "card_pod4", 4, "gloo",
                   {"config1": list(CONFIG1), "chunk": MESH_CHUNK,
                    "stream": pod_stream_args(),
                    "surface": surface_args(), "numpy": numpy_args()})
    for r in res:
        check(r["spec"] == ["k", None, None, None], "phase 15 pod4 layout")
        same(r["map_sum"], four["map_sum"], "four-rank map(v+1).sum() with "
             "the keys replicated on 'v' (rank %d)" % r["rank"])
        for k in ("halo", "gaussian"):
            bx = tuple(tuple(b) for b in r[k]["box"])
            check(r[k]["fp"] == four[k][bx], "phase 15 four-rank %s box %s "
                  "bit for bit (rank %d)" % (k, bx, r["rank"]))
        p = r["paths"]
        check(p["c1_sum"]["launches"].get("fused_map_reduce", 0) >= 1
              and p["c1_gaussian"]["launches"].get("sepfilter1d", 0) >= 1
              and p["c1_gaussian"]["launches"].get("lane_band", 0) >= 1,
              "phase 15 four-rank kernel launches: %s" % {
                  k: v["launches"] for k, v in p.items()})

    # ---- two NCCL ranks on one card: refused, pointedly --------------------
    if MESH_POD_DEVICE == "cuda":
        t = time.perf_counter()
        try:
            harness.run_cluster("sleep", nproc=2, timeout=MESH_POD_WALL,
                                args={"seconds": 0}, device="cuda",
                                backend="nccl")
            check(False, "phase 15: two NCCL ranks on one card ran")
        except RuntimeError as exc:
            check("distinct GPU per rank" in str(exc),
                  "phase 15 nccl refusal: %s" % str(exc)[-400:])
        log("phase 15 two NCCL ranks on one card refused in %.1f s"
            % (time.perf_counter() - t))

    launches = {}
    for name, pod in out["pods"].items():
        for path, per in pod["paths"].items():
            if not path.startswith(("s16_", "s18_", "s19_")):
                launches["%s/%s" % (name, path)] = [p["launches"]
                                                    for p in per]
    out["wall_s"] = time.perf_counter() - t_phase
    report["phases"]["mesh_s"] = out["wall_s"]
    log("phase 15 ok in %.1f s" % out["wall_s"])
    return launches


# phase 16's streamed pods: the phase 15 pods run its paths too (the
# "stream" args), and two more two-rank pods kill and resume path c
POD_STREAM_UPLOADERS = 4
POD_STREAM_REPLICATED = (198, 200, 64, 64)
POD_STREAM_REPLICATED_CHUNKS = 22
POD_STREAM_KILL = "stream.upload:7:kill"
POD_STREAM_DIR = os.path.join(ROOT, "build", "phase16")


def pod_stream_args():
    """The ``stream`` args of phase 16's paths in the phase 15 pods."""
    os.makedirs(POD_STREAM_DIR, exist_ok=True)
    return {"north_star": list(NORTH_STAR), "config1": list(CONFIG1),
            "chunks": SLAB_RECORDS, "seed": STREAM_SEED,
            "uploaders": POD_STREAM_UPLOADERS,
            "replicated": list(POD_STREAM_REPLICATED),
            "replicated_chunks": POD_STREAM_REPLICATED_CHUNKS,
            "spill": os.path.join(POD_STREAM_DIR, "spill"),
            "ckpt_clean": os.path.join(POD_STREAM_DIR, "clean"),
            "ckpt_sub": os.path.join(POD_STREAM_DIR, "sub")}


def full_depth_refs(bolt, torch, np, shape):
    """The f64 references of phase 6's seeded records at ``shape`` (the
    full depth phase 16 streams; phase 6 streams ``STREAM_NS``): the
    source materialised on the card once, its column sums taken and the
    records freed."""
    from bolt_tpu_torch import stream
    t = time.perf_counter()
    with stream.uploaders(4):
        x = bolt.fromcallback(seeded_records(np, shape[1:]), shape,
                              mode="gpu", dtype=np.float32).totorch()
    ref = f64_column_refs(x.view(shape[0], -1))
    del x
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log("phase 16 f64 references of the seeded north-star (%d records) in "
        "%.1f s" % (shape[0], time.perf_counter() - t))
    return ref


def pod_stream_phase(bolt, K, torch, np, dev, report):
    """Phase 16: streamed pods on the one card.  Path a, b (two ranks),
    b (four ranks) and d ran inside phase 15's pods; this phase takes the
    single-device references, runs path c (a two-rank checkpointed pod
    killed -9 on every rank mid-run, then restarted), and holds every
    rank's results: path a's seeded ``randn`` within phase 6's
    tolerances of its f64 references and its crafted data bit for bit
    against the single device's streamed runs, the same bits on both
    ranks, 1600 records (5.24 GB) a pass a rank, no build in a second
    pass, under 2 GB of peak growth a rank; path b's swap box by box, the
    codecs, the refusals; path c's resumed sum; path d's armed int8 sum
    (one ``fused_decode_sum`` a slab) bit for bit against phase 11's.
    The two-rank pods launch no kernel.  Returns each path's launches, a
    count a rank."""
    import shutil
    from bolt_tpu_torch import engine, stream
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    from bolt_tpu_torch.parallel import harness, payloads
    t_phase = time.perf_counter()
    out = {"card": report["card"], "paths": {}, "pods": {}}
    report["pod_stream"] = out
    pods = KEEP["pods"]
    ns, c1 = NORTH_STAR, CONFIG1
    n = ns[0]
    nslabs = -(-n // SLAB_RECORDS)
    whole = lambda shape: tuple((0, k) for k in shape)  # noqa: E731
    add1 = lambda v: v + 1                               # noqa: E731

    def same(got, want, what):
        want = want.cpu().numpy() if hasattr(want, "cpu") else want
        check(np.asarray(got).dtype == np.asarray(want).dtype
              and np.array_equal(got, want), "phase 16 %s" % what)

    # ---- the single device's streamed runs of the crafted sources ----------
    t = time.perf_counter()
    c0 = engine.counters()
    with stream.uploaders(POD_STREAM_UPLOADERS):
        def src(cb, shape=ns):
            return bolt.fromcallback(cb, shape, mode="gpu", dtype=np.float32,
                                     chunks=SLAB_RECORDS)
        one = {"crafted_sum": src(payloads.crafted_records(ns[1:])).map(
            add1).sum().toarray()}
        g = src(payloads.crafted_records(ns[1:], constant=True)).map(
            add1).stats(*payloads.GROUP_NAMES)
        one["const_group"] = {k: v.toarray() for k, v in g.items()}
        one["c1_sum"] = src(payloads.crafted_records(c1[1:]), c1).map(
            add1).sum().toarray()
    del g
    # phase 17 holds its resumed runs against these
    KEEP["ns_crafted_sum"] = one["crafted_sum"]
    KEEP["c1_crafted_sum"] = one["c1_sum"]
    check(engine.counters()["stream_chunks"] - c0["stream_chunks"]
          == 2 * nslabs + -(-c1[0] // SLAB_RECORDS),
          "phase 16 single-device crafted streams")
    rep_box = payloads.crafted_box(POD_STREAM_REPLICATED,
                                   whole(POD_STREAM_REPLICATED), dev)
    rep_sum = BoltArrayGPU(rep_box, 1, dev).map(add1).sum().toarray()
    del rep_box
    torch.cuda.empty_cache()
    out["refs_s"] = time.perf_counter() - t
    log("phase 16 single-device streamed references in %.1f s"
        % out["refs_s"])

    # ---- path a: the streamed north-star on two gloo ranks -----------------
    ref = full_depth_refs(bolt, torch, np, ns)
    res = pods["pod2"]
    recs_rank = n // 2
    rank_bytes = recs_rank * 4 * math.prod(ns[1:])
    for r in res:
        s = r["s16"]
        p = r["paths"]
        k = r["rank"]
        got = torch.from_numpy(s["randn_sum"]).to(dev).reshape(-1)
        sum_close(got, ref, n, "phase 16 pod randn map(v+1).sum() (rank %d)"
                  % k)
        gr = {m: torch.from_numpy(v).to(dev).reshape(-1)
              for m, v in s["randn_group"].items()}
        sum_close(gr["sum"], ref, n, "phase 16 pod randn group sum (rank %d)"
                  % k)
        close(gr["mean"], ref["mean"] + 1, 1e-5, 1e-6,
              "phase 16 pod randn group mean (rank %d)" % k)
        close(gr["var"], ref["var"], 1e-4, 1e-5,
              "phase 16 pod randn group var (rank %d)" % k)
        for m in ("min", "max"):
            check(torch.equal(gr[m], ref[m].float() + 1), "phase 16 pod "
                  "randn group %s not exact (rank %d)" % (m, k))
        same(s["crafted_sum"], one["crafted_sum"], "pod crafted "
             "map(v+1).sum() against the single device's stream (rank %d)"
             % k)
        same(s["crafted_again"], one["crafted_sum"], "pod crafted second "
             "pass (rank %d)" % k)
        for m, v in one["const_group"].items():
            same(s["const_group"][m], v, "pod constant-column group %s "
                 "(rank %d)" % (m, k))
        for path in ("s16_ns_randn_sum", "s16_ns_randn_group",
                     "s16_ns_crafted_sum", "s16_ns_crafted_again",
                     "s16_ns_const_group"):
            q = p[path]
            check(q["rows"] == recs_rank and q["engine"]["transfer_bytes"]
                  == rank_bytes and q["engine"]["stream_chunks"] == nslabs,
                  "phase 16 %s rank %d produced %s records, uploaded %s "
                  "bytes in %s slabs" % (path, k, q["rows"],
                                         q["engine"]["transfer_bytes"],
                                         q["engine"]["stream_chunks"]))
            check(q.get("peak_growth_bytes", 0) < STREAM_PEAK_BYTES,
                  "phase 16 %s peak growth %.3f GB (rank %d)"
                  % (path, q.get("peak_growth_bytes", 0) / 1e9, k))
            check(q["collectives"]["collective_host_bytes"] > 0,
                  "phase 16 %s staged nothing through the host" % path)
        check(p["s16_ns_crafted_again"]["engine"]["misses"] == 0,
              "phase 16 the second pass built a program (rank %d)" % k)
    for key in ("randn_sum", "crafted_sum"):
        check(np.array_equal(res[0]["s16"][key], res[1]["s16"][key]),
              "phase 16 two ranks returned different bits: %s" % key)
    for m in payloads.GROUP_NAMES:
        check(np.array_equal(res[0]["s16"]["randn_group"][m],
                             res[1]["s16"]["randn_group"][m]),
              "phase 16 two ranks' randn group %s differ" % m)

    # ---- path b: config 1 on two ranks --------------------------------------
    two = KEEP["mesh_two"]
    for r in res:
        s = r["s16"]
        k = r["rank"]
        bx = tuple(tuple(b) for b in s["swap"]["box"])
        check(s["swap"]["fp"] == two["swap_fp"].get(bx), "phase 16 streamed "
              "pod swap box %s bit for bit (rank %d)" % (bx, k))
        check("single-process only" in (s["pod_spill_refused"] or ""),
              "phase 16 pod spill refusal: %s" % s["pod_spill_refused"])
        raw = s["codec"]["raw"]
        same(raw, one["c1_sum"], "pod crafted config 1 sum (rank %d)" % k)
        same(s["codec"]["delta-f32"], raw, "delta-f32 pod sum (rank %d)" % k)
        check(np.allclose(s["codec"]["bf16"], raw, rtol=1e-2),
              "phase 16 bf16 pod sum (rank %d)" % k)
        p = r["paths"]
        rb = p["s16_c1_raw"]["engine"]["transfer_bytes"]
        check(rb == c1[0] // 2 * 4 * math.prod(c1[1:])
              and p["s16_c1_delta-f32"]["engine"]["transfer_bytes"] == rb
              and 2 * p["s16_c1_bf16"]["engine"]["transfer_bytes"] == rb,
              "phase 16 codec bytes a rank: raw %s, delta %s, bf16 %s" % (
                  rb, p["s16_c1_delta-f32"]["engine"]["transfer_bytes"],
                  p["s16_c1_bf16"]["engine"]["transfer_bytes"]))
        check("sidecar" in (s["int8_refused"] or ""), "phase 16 int8 pod "
              "refusal: %s" % s["int8_refused"])
        check((s["blt012_refused"] or "").startswith("BLT012: slab")
              and s["blt012_forecast"], "phase 16 BLT012: %s"
              % s["blt012_refused"])
        check("RE-ITERABLE" in (s["oneshot_refused"] or ""),
              "phase 16 one-shot fromiter refusal")
        same(s["clean_sum"], one["c1_sum"], "pod checkpointed clean sum "
             "(rank %d)" % k)
    clean = os.path.join(POD_STREAM_DIR, "clean")
    check(not (os.path.isdir(clean) and os.listdir(clean)),
          "phase 16 the clean checkpointed pod run left files")

    # ---- path b: four ranks, (2, 2), the keys replicated on "v" ------------
    for r in pods["pod4"]:
        s = r["s16"]
        check(s["spec"] == ["k", None, None, None], "phase 16 replicated "
              "layout %s" % s["spec"])
        same(s["rep_sum"], rep_sum, "four-rank streamed sum with the keys "
             "replicated on 'v' (rank %d)" % r["rank"])
        if r["rank"] < 2:
            check((s["sub_pod_refused"] or "").startswith(
                "resumable checkpointing on a SUB-POD mesh"),
                "phase 16 sub-pod refusal: %s" % s["sub_pod_refused"])

    # ---- path d: one NCCL rank, config 1's armed int8 sum -------------------
    r = pods["one"][0]
    same(r["s16"]["int8_sum"], KEEP["c1_int8"], "one-rank armed int8 sum "
         "against the single device's")
    check(r["paths"]["s16_c1_int8"]["launches"].get("fused_decode_sum", 0)
          == -(-c1[0] // SLAB_RECORDS), "phase 16 one-rank armed int8 "
          "launches: %s" % r["paths"]["s16_c1_int8"]["launches"])

    # ---- path c: kill -9 on every rank, then resume ------------------------
    ck = os.path.join(POD_STREAM_DIR, "resume")
    shutil.rmtree(ck, ignore_errors=True)
    args = dict(pod_stream_args(), ckpt=ck)
    t = time.perf_counter()
    rcs = harness.run_cluster("card_resume", nproc=2, timeout=MESH_POD_WALL,
                              args=args, device=MESH_POD_DEVICE,
                              backend="gloo", expect_dead=True,
                              env={"BOLT_CHAOS": POD_STREAM_KILL,
                                   "BOLT_CHECKPOINT_EVERY": "1"})
    out["kill_s"] = time.perf_counter() - t
    left = sorted(os.listdir(ck))
    shards = {p.split(".")[1] for p in left if p.startswith("stream_state.p")
              and p.endswith(".npz")}
    log("phase 16 path c: the pod killed by %s in %.1f s, exit codes %s, "
        "left %s" % (POD_STREAM_KILL, out["kill_s"], rcs, left))
    check(rcs == [-9, -9] and "stream_meta.json" in left
          and shards == {"p0", "p1"}, "phase 16 kill -9: %s %s" % (rcs, left))
    res = mesh_pod(harness, out, "resume", "card_resume", 2, "gloo", args)
    out["resume_s"] = out["pods"]["resume"]["wall_s"]
    for r in res:
        e = r["paths"]["s16_c1_resumed"]["engine"]
        same(r["s16"]["sum"], one["c1_sum"], "resumed pod sum (rank %d)"
             % r["rank"])
        check(e["stream_resumes"] == 1 and 0 < e["stream_chunks"]
              < -(-c1[0] // SLAB_RECORDS), "phase 16 resumed run: %s" % e)
    check(not os.listdir(ck), "phase 16 the resumed run left %s"
          % os.listdir(ck))

    launches = {}
    for name in ("one", "pod2", "pod4"):
        for path, per in report["mesh"]["pods"][name]["paths"].items():
            if path.startswith("s16_"):
                launches["%s/%s" % (name, path)] = [p["launches"]
                                                    for p in per]
    launches["resume/s16_c1_resumed"] = [
        p["launches"] for p in out["pods"]["resume"]["paths"][
            "s16_c1_resumed"]]
    for path, per in launches.items():
        if not path.startswith("one/"):
            check(not any(per), "phase 16 %s launched kernels on a pod: %s"
                  % (path, per))
    for name in ("pod2", "pod4", "one"):
        for path, per in report["mesh"]["pods"][name]["paths"].items():
            if path.startswith("s16_"):
                out["paths"]["%s/%s" % (name, path)] = per
    out["wall_s"] = time.perf_counter() - t_phase
    out["stream_paths_s"] = sum(
        max(p["wall_s"] for p in per) for per in out["paths"].values())
    report["phases"]["pod_stream_s"] = out["wall_s"]
    log("phase 16 ok: %.1f s here (references, path c) and %.1f s of "
        "streamed paths inside phase 15's pods (%s)"
        % (out["wall_s"], out["stream_paths_s"], out["card"]))
    return launches


RECOVERY_DIR = os.path.join(ROOT, "build", "phase17")
RECOVERY_TIMEOUT = 4.0          # BOLT_POD_TIMEOUT of phase 17's pods
RECOVERY_EVERY = 4              # BOLT_CHECKPOINT_EVERY of phase 17's runs
RECOVERY_WALL = 420
RECOVERY_PACE = 0.0             # seconds a load sleeps (a CPU rehearsal's
#                                 small slabs need some, so the rejoin
#                                 lands while job B still streams)


def recovery_phase(bolt, K, torch, np, dev, report):
    """Phase 17: pod liveness and recovery on the one card (gloo ranks
    sharing ``cuda:0``, the shared-directory transport).  Path e, a
    manual shrink: a two-rank pod streams the crafted north-star
    ``map(v + 1).sum()`` (``per_process=True``, checkpointed), rank 1 is
    killed -9 at its 7th upload, rank 0 catches ``PeerLostError`` naming
    it within 2x ``BOLT_POD_TIMEOUT`` and a barrier converts too, then
    ``multihost.reform`` onto one rank (the same device, no library
    built) resumes through the topology remap to phase 16's
    single-device bits, and on the reformed pod config 1's armed int8 sum
    (one ``fused_decode_sum`` a slab) and a resident ``map(v + 1).sum()``
    (one ``fused_map_reduce``) each equal their earlier phase's bits.
    Path f, supervised shrink and growth: a two-rank ``Server(supervise=
    True)`` pod runs job A (the crafted north-star sum, ``retries=``),
    rank 1 is killed -9, the survivor reforms to one rank by itself (its
    budget share 1/2); a replacement process attaches during job B, the
    pod quiesces at a checkpoint, reforms up to two ranks and resumes;
    both jobs equal the single device's bits, the share ends at 1.0, no
    arbiter byte, span, checkpoint or marker is left.  Each path logs
    its detection, reform and resume seconds and its recovery wall
    against the clean two-rank stream of phase 16.  Returns each path's
    launches, a count a rank."""
    import shutil
    from bolt_tpu_torch.parallel import harness
    t_phase = time.perf_counter()
    out = {"card": report["card"], "paths": {}}
    report["recovery"] = out
    shutil.rmtree(RECOVERY_DIR, ignore_errors=True)
    os.makedirs(RECOVERY_DIR)
    ns, c1 = NORTH_STAR, CONFIG1
    c1_slabs = -(-c1[0] // SLAB_RECORDS)
    env = {"BOLT_POD_TIMEOUT": RECOVERY_TIMEOUT,
           "BOLT_CHECKPOINT_EVERY": RECOVERY_EVERY}
    clean = report["pod_stream"]["paths"].get(
        "pod2/s16_ns_crafted_sum") or []
    clean_s = max((p["wall_s"] for p in clean), default=None)
    out["clean_two_rank_s"] = clean_s

    def same(got, want, what):
        want = want.cpu().numpy() if hasattr(want, "cpu") else want
        check(np.asarray(got).dtype == np.asarray(want).dtype
              and np.array_equal(got, want), "phase 17 %s" % what)

    def leftovers(d):
        return [p for p in os.listdir(d) if p.startswith("stream_")] \
            if os.path.isdir(d) else []

    # ---- path e: kill -9, manual reform onto one rank, resume ---------------
    ck = os.path.join(RECOVERY_DIR, "e-ckpt")
    args = {"shape": list(ns), "chunks": SLAB_RECORDS,
            "uploaders": POD_STREAM_UPLOADERS, "stats": False,
            "card": True, "config1": list(c1), "c1_chunks": SLAB_RECORDS,
            "seed": STREAM_SEED, "ckpt": ck,
            "reform_store": os.path.join(RECOVERY_DIR, "e-store")}
    t = time.perf_counter()
    res, rcs = harness.run_cluster(
        "reform", 2, timeout=RECOVERY_WALL, args=args,
        device=MESH_POD_DEVICE, backend="gloo", tolerate={1},
        env=dict(env, BOLT_POD_HB_DIR=os.path.join(RECOVERY_DIR, "e-hb")),
        worker_env={1: {"BOLT_CHAOS": POD_STREAM_KILL}})
    out["e_wall_s"] = time.perf_counter() - t
    check(rcs[1] == -9 and res[1] is None and res[0] is not None,
          "phase 17 path e exit codes %s" % rcs)
    r = res[0]
    e = {k: r.get(k) for k in (
        "caught_s", "caught_peer", "caught_slab", "caught_phase",
        "detection_s", "barrier_s", "reform_s", "resume_s", "recovery_s",
        "new_nproc", "new_device", "new_backend", "reform_builds",
        "sum_resumes")}
    out["e"] = e
    log("phase 17 path e: %s" % json.dumps(e))
    check(r["peer_lost"] and r["caught_peer"] == 1 and r["dead_peers"] == [1],
          "phase 17 path e: PeerLostError naming rank 1: %s" % e)
    check(r["detection_s"] <= 2 * RECOVERY_TIMEOUT, "phase 17 path e "
          "detection %.2f s past 2x the deadline" % r["detection_s"])
    check(r["barrier_peerlost"], "phase 17 path e: the barrier next to the "
          "dead rank did not convert")
    check(r["new_nproc"] == 1 and r["new_device"] == "cuda:0"
          and r["new_backend"] == "gloo" and r["reform_builds"] == 0,
          "phase 17 path e reform: %s" % e)
    same(r["sum"], KEEP["ns_crafted_sum"], "path e resumed sum against the "
         "single device's crafted stream")
    check(r["sum_resumes"] == 1 and not r["sum_stale_ckpt"]
          and not leftovers(ck), "phase 17 path e resume: %d resumes, "
          "left %s" % (r["sum_resumes"], leftovers(ck)))
    same(r["int8_sum"], KEEP["c1_int8"], "path e reformed pod's armed int8 "
         "sum against phase 11's")
    same(r["resident_sum"], KEEP["c1_crafted_sum"], "path e reformed pod's "
         "resident map(v+1).sum() against the single device's")
    p = r["paths"]
    check(p["s17_c1_int8"]["launches"].get("fused_decode_sum", 0)
          == c1_slabs, "phase 17 path e int8 launches: %s"
          % p["s17_c1_int8"]["launches"])
    check(p["s17_c1_resident"]["launches"].get("fused_map_reduce", 0) == 1,
          "phase 17 path e resident launches: %s"
          % p["s17_c1_resident"]["launches"])
    if clean_s:
        log("phase 17 path e recovery %.1f s (learn -> barrier -> reform -> "
            "resume) against the clean two-rank stream's %.1f s"
            % (r["recovery_s"], clean_s))
    log("phase 17 path e rank 0 over the killed stream and its resume: "
        "collectives %s, launches %s"
        % (json.dumps(r["collectives"]), json.dumps(r["launches_total"])))
    out["paths"]["e/s17_c1_int8"] = [p["s17_c1_int8"]]
    out["paths"]["e/s17_c1_resident"] = [p["s17_c1_resident"]]

    # ---- path f: supervised shrink to one rank and growth back to two -----
    ck = os.path.join(RECOVERY_DIR, "f-ckpt")
    out_f = os.path.join(RECOVERY_DIR, "f-out")
    os.makedirs(out_f)
    args = {"shape": list(ns), "chunks": SLAB_RECORDS, "pace": RECOVERY_PACE,
            "out": out_f, "ckpt": ck, "expect_bstart": 1,
            "rejoin_id": "card-w1b"}
    t = time.perf_counter()
    res, rcs = harness.run_cluster(
        "supervise", 2, timeout=RECOVERY_WALL, args=args,
        device=MESH_POD_DEVICE, backend="gloo", tolerate={1},
        env=dict(env, BOLT_POD_HB_DIR=os.path.join(RECOVERY_DIR, "f-hb"),
                 BOLT_SUPERVISE_BACKOFF="0.25"),
        worker_env={1: {"BOLT_CHAOS": POD_STREAM_KILL}}, extra=[{}])
    out["f_wall_s"] = time.perf_counter() - t
    check(rcs[1] == -9 and res[0] is not None and res[2] is not None,
          "phase 17 path f exit codes %s" % rcs)
    inc, rj = res[0], res[2]
    f = {k: inc.get(k) for k in (
        "wall_a", "wall_b", "detection_age", "reform_s", "recovery_s",
        "rejoin_recovery_s", "a_resumes", "b_resumes", "reforms", "rejoins",
        "nproc_after_a", "nproc_after_b", "budget_share_after_a",
        "budget_share_after_b", "supervise_seconds")}
    f["attach_s"] = rj.get("attach_s")
    out["f"] = f
    log("phase 17 path f: %s" % json.dumps(f))
    check(inc["detection_age"] is not None
          and inc["detection_age"] <= 2 * RECOVERY_TIMEOUT,
          "phase 17 path f detection: %s" % inc["detection_age"])
    check(inc["nproc_after_a"] == 1 and inc["budget_share_after_a"] == 0.5,
          "phase 17 path f shrink: %s" % f)
    check(rj["new_nproc"] == 2 and inc["nproc_after_b"] == 2
          and inc["rejoins"] == 1 and inc["budget_share_after_b"] == 1.0,
          "phase 17 path f growth: %s" % f)
    check(inc["a_resumes"] + inc["b_resumes"] >= 1 and rj["b_resumes"] == 1,
          "phase 17 path f resumes: %s" % f)
    same(inc["sumA"], KEEP["ns_crafted_sum"], "path f job A")
    for who, x in (("incumbent", inc), ("rejoiner", rj)):
        same(x["sumB"], KEEP["ns_crafted_sum"], "path f job B (%s)" % who)
        check(x["arbiter_bytes_after"] == 0 and x["leaked_spans"] == 0
              and x["stale_ckpt"] == [] and x["stale_markers"] == 0,
              "phase 17 path f hygiene (%s): arbiter %s, spans %s, "
              "checkpoints %s, markers %s" % (
                  who, x["arbiter_bytes_after"], x["leaked_spans"],
                  x["stale_ckpt"], x["stale_markers"]))
    for who, x in (("incumbent", inc), ("rejoiner", rj)):
        log("phase 17 path f %s over its run: collectives %s, launches %s"
            % (who, json.dumps(x["collectives"]),
               json.dumps(x["launches_total"])))
    if clean_s:
        log("phase 17 path f walls: A %.1f s, B %.1f s against the clean "
            "two-rank stream's %.1f s a job" % (inc["wall_a"], inc["wall_b"],
                                                clean_s))
    launches = {path: [q["launches"] for q in per]
                for path, per in out["paths"].items()}
    out["wall_s"] = time.perf_counter() - t_phase
    report["phases"]["recovery_s"] = out["wall_s"]
    log("phase 17 ok in %.1f s: path e %.1f s, path f %.1f s (%s)"
        % (out["wall_s"], out["e_wall_s"], out["f_wall_s"], out["card"]))
    return launches


# phase 18 (the surface on a mesh): the seeds of phase 9's pca and
# segment_reduce data, which the pods rebuild
PCA_SEED = 9
SEGMENT_SEED = 12
SEGMENT_LABEL_SEED = 13
SEGMENT_NSEG = 256


def surface_args():
    """The ``surface`` args of phase 18's paths in the phase 15 pods."""
    return {"north_star": list(NORTH_STAR), "config1": list(CONFIG1),
            "pca": list(PCA_SHAPE), "pca_seed": PCA_SEED,
            "segment": list(SEGMENT_SHAPE), "segment_seed": SEGMENT_SEED,
            "segment_label_seed": SEGMENT_LABEL_SEED,
            "nseg": SEGMENT_NSEG}


def surface_mesh_phase(bolt, K, torch, np, dev, report):
    """Phase 18: the array surface and the ops library on a mesh, whose
    paths ran inside phase 15's two- and four-rank gloo pods on this card
    (``payloads._surface_ns``/``_surface_ops``/``_surface_c1``), each
    held here against the single device on the same data: at the
    north-star split 1600 records a rank, three operator chains of the
    crafted data ending in ``sum``/``mean`` and a chain's ``stats()`` of
    the constant columns bit for bit, one ``fused_map_reduce`` (or
    ``fused_welford``) a rank; at config 1 on
    the ``(2, 2)`` pod with both key axes split, quantiles, a sort, an
    argmax, a scan, a key-merging reshape, indexing, ``set``,
    ``concatenate`` and ``transpose``, every rank's box bit for bit; on
    two ranks phase 9's ``pca``/``cov``/``corrcoef`` within phase 9's
    tolerances, its ``segment_reduce`` within the same bound of its f64
    references, and ``unique`` with counts exactly.  Returns each path's
    launches per rank."""
    from bolt_tpu_torch import ops
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    from bolt_tpu_torch.parallel import payloads, sharding
    t_phase = time.perf_counter()
    out = {"card": report["card"], "paths": {}}
    report["surface_mesh"] = out
    pods = KEEP["pods"]
    whole = lambda shape: tuple((0, k) for k in shape)  # noqa: E731

    def same(got, want, what):
        want = want.cpu().numpy() if hasattr(want, "cpu") else want
        check(np.asarray(got).dtype == np.asarray(want).dtype
              and np.array_equal(got, want), "phase 18 %s" % what)

    for name in ("pod2", "pod4"):
        for path, per in report["mesh"]["pods"][name]["paths"].items():
            if path.startswith("s18_"):
                out["paths"]["%s/%s" % (name, path)] = per

    # ---- two ranks: the north-star's operator chains -----------------------
    x = BoltArrayGPU(payloads.crafted_box(NORTH_STAR, whole(NORTH_STAR),
                                          dev), 1, dev)
    one = {"ops_sum": (x * 2.0 + 1.0).sum().toarray(),
           "ufunc_mean": np.add(x, 1.0).mean().toarray(),
           "clip_sum": x.clip(-2.0, 2.0).sum().toarray()}
    del x
    # the chain's stats() on the constant columns, as the pods take it
    z = BoltArrayGPU(payloads.constant_box(NORTH_STAR, whole(NORTH_STAR),
                                           dev), 1, dev)
    one["ops_stats"] = payloads._counter((z * 2.0 + 1.0).stats())
    del z
    torch.cuda.empty_cache()
    res2 = pods["pod2"]
    want_kernel = {"ops_sum": "fused_map_reduce",
                   "ufunc_mean": "fused_map_reduce",
                   "clip_sum": "fused_map_reduce",
                   "ops_stats": "fused_welford"}
    for r in res2:
        k = r["rank"]
        for name, kern in want_kernel.items():
            got, want = r["s18"][name], one[name]
            if isinstance(want, dict):
                for m in want:
                    same(got[m], want[m], "two-rank %s %s (rank %d)"
                         % (name, m, k))
            else:
                same(got, want, "two-rank %s (rank %d)" % (name, k))
            la = r["paths"]["s18_ns_" + name]["launches"]
            check(la == {kern: 1}, "phase 18 %s launched %s on rank %d, "
                  "not one %s" % (name, la, k, kern))

    # ---- two ranks: the ops library at phase 9's shapes ---------------------
    b = bolt.randn(PCA_SHAPE, mode="gpu", dtype=np.float32, seed=PCA_SEED)
    b.totorch().mul_(torch.linspace(1.0, 4.0, PCA_SHAPE[1], device=dev))
    _, comps, sv = ops.pca(b, k=4, center=True)
    cov = ops.cov(b)
    corr = ops.corrcoef(b)
    del b
    torch.cuda.empty_cache()
    errs = {}
    for r in res2:
        p = r["s18"]
        rel = float(np.max(np.abs(p["pca"]["sv"] - sv) / sv))
        check(rel <= 1e-4, "phase 18 pca singular values (rank %d): %.3g"
              % (r["rank"], rel))
        cerr = 0.0
        for i in range(4):
            sgn = np.sign(np.dot(p["pca"]["comps"][:, i], comps[:, i])) or 1.0
            cerr = max(cerr, float(np.abs(sgn * p["pca"]["comps"][:, i]
                                          - comps[:, i]).max()))
        check(cerr <= 1e-3, "phase 18 pca components (rank %d): %.3g"
              % (r["rank"], cerr))
        verr = float(np.max(np.abs(p["cov"] - cov)) / np.abs(cov).max())
        check(verr <= 1e-4, "phase 18 cov (rank %d): %.3g" % (r["rank"], verr))
        rerr = float(np.max(np.abs(p["corrcoef"] - corr)))
        check(rerr <= 1e-4, "phase 18 corrcoef (rank %d): %.3g"
              % (r["rank"], rerr))
        errs["pca_rank%d" % r["rank"]] = {"sv_rel": rel, "comps": cerr,
                                          "cov_rel": verr, "corr": rerr}
    for r in res2[1:]:
        for k in ("cov", "corrcoef"):
            same(r["s18"][k], res2[0]["s18"][k], "%s on every rank" % k)
    b = bolt.randn(SEGMENT_SHAPE, mode="gpu", dtype=np.float32,
                   seed=SEGMENT_SEED)
    xs = b.totorch()
    n = SEGMENT_SHAPE[0]
    gen = torch.Generator(device=dev).manual_seed(SEGMENT_LABEL_SEED)
    lab = torch.randint(0, SEGMENT_NSEG, (n,), generator=gen, device=dev)
    flat = xs.view(n, -1)
    ref = torch.zeros((SEGMENT_NSEG, flat.shape[1]), dtype=torch.float64,
                      device=dev)
    mag = torch.zeros_like(ref)
    for s0 in range(0, n, 512):
        blk = flat[s0:s0 + 512].double()
        ref.index_add_(0, lab[s0:s0 + 512], blk)
        mag.index_add_(0, lab[s0:s0 + 512], blk.abs())
        del blk
    del b, xs, flat
    for r in res2:
        got = torch.from_numpy(r["s18"]["segment"]).to(dev).view(
            SEGMENT_NSEG, -1)
        err = float(((got.double() - ref).abs() / (mag + 1e-30)).max())
        check(err <= 64 * 2.0 ** -24, "phase 18 segment_reduce (rank %d): "
              "%.3g of sum|x|" % (r["rank"], err))
        errs["segment_rank%d" % r["rank"]] = err
        del got
    del ref, mag, lab
    torch.cuda.empty_cache()
    c = BoltArrayGPU(payloads.crafted_box(CONFIG1, whole(CONFIG1), dev), 1,
                     dev) * 2.0
    u, cnt = ops.unique(c, return_counts=True)
    del c
    for r in res2:
        same(r["s18"]["unique"]["values"], u, "unique values (rank %d)"
             % r["rank"])
        same(r["s18"]["unique"]["counts"], cnt, "unique counts (rank %d)"
             % r["rank"])

    # ---- four ranks, (2, 2) ("k", "v"): config 1 with both keys split -------
    c1 = BoltArrayGPU(payloads.crafted_box(CONFIG1, whole(CONFIG1), dev), 2,
                      dev)
    s = c1.astype(np.float32)
    s.sort(axis=1)
    singles = {
        "median": lambda: c1.median(),
        "quantile": lambda: c1.quantile([0.25, 0.75]),
        "sort": lambda: s,
        "cumsum": lambda: c1.cumsum(axis=0),
        "reshape": lambda: c1.reshape((CONFIG1[0] * CONFIG1[1],)
                                      + CONFIG1[2:]),
        "getitem": lambda: c1[3:197, [0, 5, 9]],
        "set": lambda: c1.set(np.s_[90:110, 95:105, 10:20], -1.0),
        "concatenate": lambda: c1.concatenate(c1, axis=0),
        "transpose": lambda: c1.transpose(1, 0, 3, 2)}
    res4 = pods["pod4"]
    for name, fn in singles.items():
        t = fn().totorch()
        for r in res4:
            bx = tuple(tuple(v) for v in r["s18"][name]["box"])
            check(r["s18"][name]["fp"] == payloads.fingerprint(
                t[sharding.box_slices(bx)]), "phase 18 four-rank %s: rank "
                "%d's box %s is not the single device's" % (name, r["rank"],
                                                             bx))
        del t
    am = int(c1.argmax().toarray())
    for r in res4:
        check(r["s18"]["argmax"] == am, "phase 18 four-rank argmax (rank %d)"
              % r["rank"])
        check(r["s18"]["spec"] == ["k", "v", None, None],
              "phase 18 four-rank layout %s" % r["s18"]["spec"])
    del c1, s
    torch.cuda.empty_cache()

    launches = {path: [p["launches"] for p in per]
                for path, per in out["paths"].items()}
    out["errors"] = errs
    out["wall_s"] = time.perf_counter() - t_phase
    out["paths_s"] = sum(max(p["wall_s"] for p in per)
                         for per in out["paths"].values())
    report["phases"]["surface_mesh_s"] = out["wall_s"]
    log("phase 18 ok: %.1f s here (single-device references) and %.1f s of "
        "paths inside phase 15's pods; errors %s (%s)"
        % (out["wall_s"], out["paths_s"], json.dumps(errs), out["card"]))
    return launches


# phase 19 (numpy's function table on a mesh): its paths ride phase 15's
# pods ("numpy" args)
def numpy_args():
    """The ``numpy`` args of phase 19's paths in the phase 15 pods."""
    return {"north_star": list(NORTH_STAR), "config1": list(CONFIG1)}


def crafted_total(np, shape):
    """The exact sum of ``crafted_box`` data of ``shape`` mapped by ``(v +
    1) * 2 + 1`` (record ``r``, slot ``j``: ``2 (r % 8) - 5 + j % 16``),
    in Python integers."""
    n, nv = shape[0], int(np.prod(shape[1:]))
    rec = sum(2 * (r % 8) - 5 for r in range(n))
    return rec * nv + n * sum(j % 16 for j in range(nv))


def numpy_mesh_phase(bolt, K, torch, np, dev, report):
    """Phase 19: numpy's function table on a mesh, whose paths ran inside
    phase 15's two- and four-rank gloo pods on this card
    (``payloads._numpy_two``/``_numpy_four``), each held here against the
    single device on the same data: on two ranks at the north-star, with
    ``b`` the crafted data plus one (a deferred chain), ``np.sum(b * 2 +
    1)`` within ``1e-5`` of its exact total (f32 accumulation) and
    ``np.mean(b, axis=0)`` bit for bit, one ``fused_map_reduce`` a rank
    each, ``np.var(t + 1, axis=0)`` of the trend data (whose ranks' boxes
    differ in mean and variance) within ``1e-5`` of its exact f64 value on
    every column (one ``fused_welford`` a rank), and at config 1 ``map(with_keys=True)
    .sum()``, a host-predicate ``filter(...).sum()`` and ``stats("sum",
    "max", accumulate="bf16")`` bit for bit; on the ``(2, 2)`` pod at
    config 1 with both keys split, every rank's box of ``einsum`` (a
    fold over a sharded axis), ``tensordot``, ``stack``,
    ``concatenate``, ``roll``, ``pad(mode="reflect")``,
    ``broadcast_to``, ``where``, ``nanmean``, ``sort(axis=None)`` and
    ``split`` bit for bit, ``rfft`` along a sharded axis and
    ``linalg.inv`` over the sharded batch, every element of every box
    within phase 10's ``1e-5`` of the box's largest magnitude (each rank
    holds its box against the single device's result it builds), ``cov`` within phase 9's ``1e-4``, and
    ``histogram``/``unique`` exactly.  Returns each path's launches per
    rank."""
    from bolt_tpu_torch.gpu.array import BoltArrayGPU
    from bolt_tpu_torch.parallel import payloads, sharding
    t_phase = time.perf_counter()
    out = {"card": report["card"], "paths": {}, "errors": {}}
    report["numpy_mesh"] = out
    pods = KEEP["pods"]
    whole = lambda shape: tuple((0, k) for k in shape)  # noqa: E731
    errs = out["errors"]

    def same(got, want, what):
        want = want.cpu().numpy() if hasattr(want, "cpu") else want
        check(np.asarray(got).dtype == np.asarray(want).dtype
              and np.array_equal(got, want), "phase 19 %s" % what)

    for name in ("pod2", "pod4"):
        for path, per in report["mesh"]["pods"][name]["paths"].items():
            if path.startswith("s19_"):
                out["paths"]["%s/%s" % (name, path)] = per

    # ---- two ranks: the north-star and config 1 -----------------------------
    x = BoltArrayGPU(payloads.crafted_box(NORTH_STAR, whole(NORTH_STAR),
                                          dev), 1, dev) + 1.0
    one = {"mean": np.mean(x, axis=0).toarray(),
           "sum_one": np.sum(x * 2.0 + 1.0).toarray()}
    del x
    c = BoltArrayGPU(payloads.crafted_box(CONFIG1, whole(CONFIG1), dev), 1,
                     dev)
    one["with_keys"] = c.map(lambda kv: kv[1] + kv[0][0],
                             with_keys=True).sum().toarray()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f = c.filter(payloads.numpy_host_pred)
    one["host_filter"] = {"count": int(f.shape[0]), "sum": f.sum().toarray()}
    g = c.stats("sum", "max", accumulate="bf16")
    one["accumulate"] = {k: v.toarray() for k, v in g.items()}
    del c, f, g
    torch.cuda.empty_cache()
    total = crafted_total(np, NORTH_STAR)
    var = payloads.trend_variance(NORTH_STAR[0])
    res2 = pods["pod2"]
    for r in res2:
        k, got = r["rank"], r["s19"]
        err = abs(float(got["sum"]) - total) / abs(total)
        check(err <= 1e-5, "phase 19 two-rank np.sum(b * 2 + 1) (rank %d): "
              "%.3g of the exact total" % (k, err))
        errs["ns_sum_rank%d" % k] = err
        for name in ("mean", "with_keys"):
            same(got[name], one[name], "two-rank %s (rank %d)" % (name, k))
        # every column's variance is the trend's over all the records
        verr = float(np.max(np.abs(got["var"] - var)) / var)
        check(got["var"].shape == NORTH_STAR[1:] and verr <= 1e-5,
              "phase 19 two-rank np.var(t + 1, axis=0) (rank %d): shape %s, "
              "%.3g of the exact variance" % (k, got["var"].shape, verr))
        errs["ns_var_rank%d" % k] = verr
        check(got["host_filter"]["count"] == one["host_filter"]["count"],
              "phase 19 host-predicate filter count (rank %d)" % k)
        same(got["host_filter"]["sum"], one["host_filter"]["sum"],
             "host-predicate filter sum (rank %d)" % k)
        for name in ("sum", "max"):
            same(got["accumulate"][name], one["accumulate"][name],
                 "stats(accumulate='bf16') %s (rank %d)" % (name, k))
        p = r["paths"]
        for path, kern in (("s19_ns_sum", "fused_map_reduce"),
                           ("s19_ns_mean", "fused_map_reduce"),
                           ("s19_ns_var", "fused_welford")):
            la = p[path]["launches"]
            check(la.get(kern, 0) == 1, "phase 19 %s launched %s on rank %d, "
                  "not one %s" % (path, la, k, kern))
    same(res2[1]["s19"]["sum"], res2[0]["s19"]["sum"],
         "np.sum on every rank")
    errs["ns_sum_single"] = abs(float(one["sum_one"]) - total) / abs(total)

    # ---- four ranks, (2, 2) ("k", "v"): config 1 with both keys split -------
    c1 = BoltArrayGPU(payloads.crafted_box(CONFIG1, whole(CONFIG1), dev), 2,
                      dev)
    w = (np.arange(CONFIG1[3] * 8) % 5).astype(np.float32).reshape(
        CONFIG1[3], 8)
    eye = np.float32(1000.0) * np.eye(CONFIG1[3], dtype=np.float32)
    exact = {
        "einsum": lambda: np.einsum("ijkl->jkl", c1),
        "tensordot": lambda: np.tensordot(c1, w, axes=([3], [0])),
        "stack": lambda: np.stack([c1, c1]),
        "concatenate": lambda: np.concatenate([c1, c1], axis=1),
        "roll": lambda: np.roll(c1, 3, axis=0),
        "pad": lambda: np.pad(c1, ((0, 0), (2, 1), (0, 0), (0, 0)),
                              mode="reflect"),
        "broadcast_to": lambda: np.broadcast_to(c1, (2,) + CONFIG1),
        "where": lambda: np.where(c1 > 0, c1, 0.0),
        "nanmean": lambda: np.nanmean(c1),
        "sort": lambda: np.sort(c1, axis=None),
        "split": lambda: np.split(c1, 4, axis=0)}
    close_ = {"rfft": lambda: np.fft.rfft(c1, axis=1),
              "inv": lambda: np.linalg.inv(c1 + eye)}
    res4 = pods["pod4"]
    for name, fn in list(exact.items()) + list(close_.items()):
        outs = fn()
        outs = outs if isinstance(outs, list) else [outs]
        for i, o in enumerate(outs):
            t = o.totorch()
            for r in res4:
                got = r["s19"][name][i]
                check(got["shape"] == list(o.shape)
                      and got["split"] == o.split, "phase 19 four-rank %s "
                      "shape/split %s/%s, single device %s/%s"
                      % (name, got["shape"], got["split"], list(o.shape),
                         o.split))
                bx = tuple(tuple(v) for v in got["box"])
                part = t[sharding.box_slices(bx)]
                bits = got["fp"] == payloads.fingerprint(part)
                if name in exact:
                    check(bits, "phase 19 four-rank %s: rank %d's box %s is "
                          "not the single device's" % (name, r["rank"], bx))
                    continue
                # the whole box within phase 10's bound of its largest
                # magnitude, held in the pod against the single device's
                # result there; its bits as the single device's here
                err = got["err"]
                check(err <= 1e-5 and got["bits"] == bits,
                      "phase 19 four-rank %s (rank %d): %.3g of max|x| "
                      "against the single device" % (name, r["rank"], err))
                errs["%s_rank%d" % (name, r["rank"])] = {"err": err,
                                                         "bits": bits}
            del t
        del outs
    torch.cuda.empty_cache()
    cov = np.cov(c1[:, 0, :, 0], rowvar=False)
    hist = np.histogram(c1, bins=64)
    uniq = np.unique(c1, return_counts=True)
    for r in res4:
        got = r["s19"]
        verr = float(np.max(np.abs(got["cov"] - cov)) / np.abs(cov).max())
        check(verr <= 1e-4, "phase 19 four-rank cov (rank %d): %.3g"
              % (r["rank"], verr))
        errs["cov_rank%d" % r["rank"]] = verr
        same(got["histogram"][0], hist[0], "histogram counts (rank %d)"
             % r["rank"])
        same(got["histogram"][1], hist[1], "histogram edges (rank %d)"
             % r["rank"])
        same(got["unique"][0], uniq[0], "unique values (rank %d)" % r["rank"])
        same(got["unique"][1], uniq[1], "unique counts (rank %d)" % r["rank"])
    del c1
    torch.cuda.empty_cache()

    launches = {path: [p["launches"] for p in per]
                for path, per in out["paths"].items()}
    out["wall_s"] = time.perf_counter() - t_phase
    out["paths_s"] = sum(max(p["wall_s"] for p in per)
                         for per in out["paths"].values())
    report["phases"]["numpy_mesh_s"] = out["wall_s"]
    log("phase 19 ok: %.1f s here (single-device references) and %.1f s of "
        "paths inside phase 15's pods; errors %s (%s)"
        % (out["wall_s"], out["paths_s"], json.dumps(errs), out["card"]))
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
    from bolt_tpu_torch import _lockdep, ops
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
    # under the armed lock witness: phase 8 reads what it recorded
    _lockdep.reset()
    _lockdep.enable()
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
    _lockdep.disable()

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
    _lockdep.enable()
    stream_launches = stream_phase(bolt, K, torch, np, dev, report)
    _lockdep.disable()
    report["lockdep"] = {"violations": _lockdep.violations(),
                         "acquires": _lockdep.stats()["acquires"]}

    # ---- phase 7: the array surface and the stat groups -------------------
    surface_phase(bolt, K, torch, np, report)

    # ---- phase 8: the engine, donation, stacked, profile -------------------
    check(not report["lockdep"]["violations"], "the lock witness, armed "
          "over phases 3 and 6, recorded: %s" % report["lockdep"])
    log("lock witness over phases 3 and 6: %d acquires, no violation"
        % report["lockdep"]["acquires"])
    engine_phase(bolt, K, torch, np, dev, report)

    # ---- phase 9: the ops library and the numpy surface -------------------
    ops_phase(bolt, torch, np, report)

    # ---- phase 10: the rest of the numpy surface ----------------------------
    numpy_tail_phase(bolt, torch, np, report)

    # ---- phase 11: the streamed stages, groups, shuffle and retries --------
    stages_phase(bolt, K, torch, np, dev, report)

    # ---- phase 12: resume, checkpoints and unsigned records ----------------
    resume_launches = resume_phase(bolt, K, torch, np, dev, report)

    # ---- phase 13: serving -------------------------------------------------
    serve_launches, lanes = serve_phase(bolt, K, torch, np, dev, report)
    timings[("fused_map_reduce_lanes", "config14_x16")] = lanes
    max_err["fused_map_reduce_lanes"] = lanes["max_abs_err"]

    # ---- phase 14: the analysis layer --------------------------------------
    analysis_launches = analysis_phase(bolt, K, torch, np, dev, report)

    # ---- phase 15: device meshes -------------------------------------------
    mesh_launches = mesh_phase(bolt, K, torch, np, dev, report)

    # ---- phase 16: streamed pods --------------------------------------------
    pod_stream_launches = pod_stream_phase(bolt, K, torch, np, dev, report)

    # ---- phase 17: pod liveness and recovery -------------------------------
    recovery_launches = recovery_phase(bolt, K, torch, np, dev, report)

    # ---- phase 18: the surface on a mesh (paths ran in phase 15's pods) -----
    surface_mesh_launches = surface_mesh_phase(bolt, K, torch, np, dev,
                                               report)

    # ---- phase 19: numpy's table on a mesh (paths ran in phase 15's pods) ---
    numpy_mesh_launches = numpy_mesh_phase(bolt, K, torch, np, dev, report)
    report["total_s"] = time.perf_counter() - t_start

    # each kernel's launches are those of the path that runs it: the moment
    # kernels' and fused_map_reduce's from phases 2-3, the window kernels'
    # from phase 4, fused_decode_sum's from phase 6 (timed at the slab it is
    # given there), fused_map_reduce_lanes' from phase 13's config 14 (timed
    # at 16 lanes of it)
    kernels = []
    for name, path_launches, label in (
            ("fused_welford", launches, "north_star"),
            ("fused_stats", launches, "north_star"),
            ("sepfilter1d", img_launches, "imaging"),
            ("lane_band", img_launches, "imaging"),
            ("fused_decode_sum", stream_launches, "slab"),
            ("fused_map_reduce", launches, "north_star_cols"),
            ("fused_map_reduce_lanes", serve_launches["config14"],
             "config14_x16")):
        row = timings[(name, label)]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCE[name], "replaces": REPLACES[name],
                        "launches": path_launches[name],
                        "max_abs_err": max_err[name], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        "phase12_launches": {
                            path: c[name] for path, c in
                            resume_launches.items() if c[name]},
                        "phase13_launches": {
                            path: c[name] for path, c in
                            serve_launches.items() if c[name]},
                        "phase14_launches": {
                            path: c[name] for path, c in
                            analysis_launches.items() if c[name]},
                        "phase15_launches": {
                            path: [c.get(name, 0) for c in per]
                            for path, per in mesh_launches.items()
                            if any(c.get(name, 0) for c in per)},
                        "phase16_launches": {
                            path: [c.get(name, 0) for c in per]
                            for path, per in pod_stream_launches.items()
                            if any(c.get(name, 0) for c in per)},
                        "phase17_launches": {
                            path: [c.get(name, 0) for c in per]
                            for path, per in recovery_launches.items()
                            if any(c.get(name, 0) for c in per)},
                        "phase18_launches": {
                            path: [c.get(name, 0) for c in per]
                            for path, per in surface_mesh_launches.items()
                            if any(c.get(name, 0) for c in per)},
                        "phase19_launches": {
                            path: [c.get(name, 0) for c in per]
                            for path, per in numpy_mesh_launches.items()
                            if any(c.get(name, 0) for c in per)}})
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
