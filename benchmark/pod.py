"""A cell of several cards, run as a pod: one process a card, each
brought into the pod by the port's own entry
(``multihost.initialize``, as a user's ``torchrun`` script calls it),
each holding only its box of a dataset drawn in blocks from the seed
(``blocks.py``).

:func:`launch` is the launcher ``run.py`` calls for a cell of more than
one chip: it starts one worker a rank (this file, run as a script) and
watches them.  A rank that exits with an error, or a pod still running
past the wall limit, ends the run at once: every worker is killed, the
run exits non-zero with no result line, and the dead or stuck ranks are
named with the end of each worker's standard error.

Each worker (:func:`worker`) builds nothing before rank 0 has built the
port's kernels, brings the pod up, draws its box and makes it a mesh
array (``sharding.assemble_from_parts``), and runs the cell's passes in
lockstep with the others: the same two warm passes, then a number of
timed passes that rank 0 fixes from its second warm pass and hands the
others through the harness's own store (never the program's
collectives).  Rank 0's clock times the window.  After it every rank
compares its kept outputs with rank 0's, bit for bit (``ranks.agree``),
the other ranks leave, and rank 0 alone holds what it kept against the
reference, drawn again block by block on its card."""

import datetime
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import blocks, common, harness, tracing  # noqa: E402
from benchmark.pipeline import Pass  # noqa: E402
from benchmark.reference import plain  # noqa: E402

# seconds a pod may run once rank 0 has built the kernels, and seconds the
# build may take (a checkout's first run compiles)
WALL_S = 320
BUILD_S = 1100
# seconds a worker waits on the harness's store for the other ranks
WAIT_S = 600
# the end of each worker's standard error quoted when the pod fails
QUOTE = 4000


def _store(run_dir, world):
    from torch.distributed import FileStore
    store = FileStore(os.path.join(run_dir, "harness.store"), world)
    store.set_timeout(datetime.timedelta(seconds=WAIT_S))
    return store


def _all(store, key, world):
    """Wait until every rank has reached ``key`` (a barrier on the
    harness's store)."""
    if store.add(key, 1) == world:
        store.set(key + "/all", "1")
    store.wait([key + "/all"])


def _gather(store, key, rank, world, value):
    """Every rank's ``value`` under ``key``, in rank order."""
    store.set("%s/%d" % (key, rank), value)
    keys = ["%s/%d" % (key, r) for r in range(world)]
    store.wait(keys)
    return [store.get(k) for k in keys]


def _flat(kept):
    """Every tensor a pass kept, ``{"range.step.output": tensor}``."""
    return {"%s.%s.%s" % (label, step, q): t
            for keep in kept for (label, step), outs in keep.items()
            for q, t in outs.items()}


def disagreement(mine, theirs):
    """The largest difference between two ranks' kept outputs, 0 where
    every one has the same bits (a NaN against a NaN agrees), infinite
    where one lacks an output the other has or a NaN stands alone."""
    import torch
    if set(mine) != set(theirs):
        return float("inf")
    worst = 0.0
    for k, a in mine.items():
        b = theirs[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        if torch.equal(a, b):
            continue
        a, b = a.double(), b.double()
        nan = a.isnan() | b.isnan()
        if bool((a.isnan() != b.isnan()).any()):
            return float("inf")
        d = (a - b).abs().masked_fill(nan, 0.0)
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def pod_config(name, overrides=None):
    """The configuration of the pod cell ``name`` as it is run."""
    config = harness.load_cell(name)[1]
    return dict(config, **(overrides or {}).get("config", {}))


def per_layer(spec, name):
    """The per-layer metrics a pod cell reports: those that list it, and
    those that list no cell and move an end-to-end metric it reports."""
    reported = {m["name"] for m in harness.for_cell(spec["end_to_end"], name)}
    return [m for m in spec["per_layer"] if name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)]


class Rank:
    """One rank of the pod: its device, the pod, and the mesh the
    configuration states (``mesh``, ``mesh_axes``) over its ranks."""

    def __init__(self, rank, world, run_dir, backend, device, config):
        import torch
        if math.prod(config["mesh"]) != world:
            raise ValueError("the mesh %s does not hold %d ranks"
                             % (config["mesh"], world))
        self.torch = torch
        self.rank, self.world, self.run_dir = rank, world, run_dir
        self.device = torch.device(device, rank) if device == "cuda" \
            else torch.device(device)
        self.on_card = self.device.type == "cuda"
        if self.on_card:
            torch.cuda.set_device(self.device)
        self.store = _store(run_dir, world)
        from bolt_tpu_torch.parallel import mesh, multihost
        self.multihost = multihost
        if rank == 0:
            if self.on_card:
                # every kernel built once, before any rank waits on another
                from bolt_tpu_torch.ops import _build
                _build.build()
            open(os.path.join(run_dir, "built"), "w").close()
            self.store.set("built", "1")
        else:
            self.store.wait(["built"], datetime.timedelta(seconds=BUILD_S))
        multihost.initialize(num_processes=world, process_id=rank,
                             backend=backend, device=self.device,
                             store_path=os.path.join(run_dir, "pod.store"))
        self.mesh = mesh.make_mesh(tuple(config["mesh"]),
                                   tuple(config["mesh_axes"]))

    def sync(self):
        if self.on_card:
            self.torch.cuda.synchronize()

    def shutdown(self):
        self.multihost.shutdown()

    def run(self, name, seed, seconds, trace, t_start, overrides=None):
        """One run of the cell on this rank; on rank 0 ``(result, stderr
        lines)``, on the others None."""
        import torch
        from bolt_tpu_torch import engine
        from bolt_tpu_torch.ops import kernels
        from bolt_tpu_torch.parallel import sharding
        _, _, traffic, limits, spec = harness.load_cell(name)
        overrides = overrides or {}
        config = pod_config(name, overrides)
        traffic = overrides.get("traffic", traffic)
        limits = overrides.get("limits", limits)
        store, world, rank, sync = self.store, self.world, self.rank, self.sync
        tag = "run/%d" % seed
        marks = {"start": time.time() - t_start}

        shape = tuple(config["shape"])
        sh = sharding.key_sharding(self.mesh, shape, len(config["key_axes"]))
        (lo, hi) = sh.box()[0]
        part, prints = blocks.draw_box(torch, config, seed, lo, hi,
                                       self.device)
        data = sharding.assemble_from_parts(shape, sh, [part],
                                            split=len(config["key_axes"]))
        del part
        declared = common.branch_specs(traffic, config)
        pass_bytes = sum(v[2] for v in declared.values())
        run = Pass(traffic, data, seed)
        sync()
        marks["data"] = time.time() - t_start
        warm = []
        for i in range(harness.WARMUP):
            ts = time.perf_counter()
            outs = run(ranges=bool(trace))
            sync()
            warm.append(time.perf_counter() - ts)
            del outs
            marks["warm%d" % (i + 1)] = time.time() - t_start
        compile_s = engine.counters().get("compile_seconds", 0.0)
        if rank == 0:
            store.set(tag + "/passes",
                      str(max(1, math.ceil(seconds / warm[-1]))))
        store.wait([tag + "/passes"])
        passes = int(store.get(tag + "/passes"))
        keep_at = min(passes - 1, int(np.random.default_rng(
            int(seed) & (2 ** 63 - 1)).integers(0, harness.KEEP_WITHIN)))
        _all(store, tag + "/window", world)

        engine0 = dict(engine.counters())
        pod0 = self.multihost.counters()
        launches0 = dict(kernels.LAUNCHES)
        prof = window_range = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.on_card else []))
            prof.start()
            window_range = record_function(tracing.WINDOW)
            window_range.__enter__()
        if self.on_card:
            torch.cuda.reset_peak_memory_stats()
        times, kept = [], []
        t0 = time.perf_counter()
        setup_s = time.time() - t_start
        for i in range(passes):
            ts = time.perf_counter()
            outs = run(ranges=bool(trace))
            sync()
            times.append(time.perf_counter() - ts)
            if i in (keep_at, passes - 1):
                kept.append(run.keep(outs))
                sync()
            del outs
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if self.on_card else 0
        if trace:
            window_range.__exit__(None, None, None)
            prof.stop()
        engine1 = dict(engine.counters())
        pod1 = self.multihost.counters()
        launches = {k: n - launches0.get(k, 0)
                    for k, n in kernels.LAUNCHES.items()}
        found = harness.forbidden_modules()
        if found:
            raise SystemExit("the run loaded %s" % ", ".join(found))

        summary = None
        if trace and self.on_card:
            groups = tracing.kernel_groups()
            summary = tracing.summarize(prof, groups)
            faults = tracing.cross_check(groups, summary.launches, launches)
            if faults:
                raise SystemExit(
                    "rank %d: the trace does not stand against "
                    "ops.kernels.LAUNCHES, so no per-layer metric is read "
                    "from it: %s" % (rank, "; ".join(faults)))
        metrics, lines = {}, []
        if rank == 0 and trace:
            # each rank's share of the declared work (the key axis divides
            # evenly over the ranks), so a roofline reads one card
            share = {k: (a, b, nbytes / world, ops / world)
                     for k, (a, b, nbytes, ops) in declared.items()}
            ctx = harness.MetricContext(summary, share, engine0, engine1,
                                        passes)
            ctx.collective = lambda key: pod1.get(key, 0) - pod0.get(key, 0)
            ctx.events = prof.profiler.kineto_results.events() \
                if summary is not None else None
            for m in per_layer(spec, name):
                v = common.piece("metrics", m["name"]).read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if summary is not None:
                lines.append("trace (rank 0): busy %.6f s of %.6f s; "
                             "launches %s; unattributed %.6f s; by range %s"
                             % (summary.busy_s, summary.window_s,
                                {k: n for k, n in launches.items() if n},
                                summary.unattributed_s, summary.by_range))
        busy = [summary.busy_s, summary.window_s] if summary else None
        breakdown = None
        if rank == 0 and summary is not None:
            breakdown = {"device_ops": [[n, s] for n, s in summary.device_ops],
                         "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
        del prof, summary, run, data
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

        # every rank's kept outputs against rank 0's, bit for bit
        mine = {k: t.cpu() for k, t in _flat(kept).items()}
        kept0 = os.path.join(self.run_dir, "kept0.pt")
        if rank == 0:
            torch.save(mine, kept0)
            store.set(tag + "/kept0", "1")
            agree = 0.0
        else:
            store.wait([tag + "/kept0"])
            agree = disagreement(mine, torch.load(kept0, map_location="cpu",
                                                  weights_only=True))
        del mine
        reports = [json.loads(b) for b in _gather(
            store, tag + "/report", rank, world, json.dumps(
                {"agree": agree, "passes": len(times), "peak": int(peak),
                 "busy": busy, "prints": {str(b): v.tolist()
                                          for b, v in prints.items()}}))]
        if rank != 0:
            return None
        os.remove(kept0)

        # the reference, from the seed again, block by block on this card
        base = blocks.Blocks(torch, config, seed, self.device)
        ref = plain.evaluate(traffic, config, base, seed)
        drawn = {b: v.tolist() for b, v in base.prints.items()}
        timed = {int(b): v for r in reports for b, v in r["prints"].items()}
        same_input = timed == drawn
        numbers = harness.judge_passes(traffic, kept, ref)
        numbers["ranks.agree"] = max(r["agree"] for r in reports)
        del ref, base
        counts = [r["passes"] for r in reports]
        lockstep = len(set(counts)) == 1
        correct, checks = harness.held(numbers, limits)
        correct = correct and same_input and lockstep and bool(kept)
        peak_all = max(r["peak"] for r in reports)

        dev = {"platform": "gpu" if self.on_card else "cpu", "count": world,
               "memory_peak_bytes": peak_all}
        if self.on_card:
            dev["kind"], dev["power_limit_w"] = harness.card(torch)
        else:
            dev["kind"] = "cpu"
        if not trace:
            values = {"scan_gbps": pass_bytes * passes / window_s / 1e9,
                      "pass_ms_p95": harness.p95(times) * 1e3,
                      "peak_mem_gb": peak_all / 1e9, "setup_s": setup_s}
            units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
            for m in harness.for_cell(spec["end_to_end"], name):
                # a metric split by kind of cell (scan_gbps.pod) is the
                # quantity named before its dot
                metrics[m["name"]] = {"value": values[m["name"].split(".")[0]],
                                      "unit": units[m["name"]]}
        elif all(r["busy"] for r in reports):
            # rank 0's, as every per-layer metric; each rank's on stderr
            dev["busy_s"], dev["window_s"] = reports[0]["busy"]
            lines.append("busy s of window s per rank: %s"
                         % [r["busy"] for r in reports])
        lines.append("passes %d in %.6f s on rank 0, %d kept, nvcc %.3f s, "
                     "setup %.3f s; per rank passes %s, peak bytes %s"
                     % (passes, window_s, len(kept), compile_s, setup_s,
                        counts, [r["peak"] for r in reports]))
        if not same_input:
            lines.append("the regenerated dataset differs from the timed "
                         "ranks' boxes")
        if not lockstep:
            lines.append("the ranks ran different numbers of passes: %s"
                         % counts)
        for n, c in checks.items():
            lines.append("check %s %.6g limit %s %s"
                         % (n, c["value"], c["limit"],
                            "ok" if c["limit"] is not None
                            and c["value"] <= c["limit"] else "FAIL"))
        result = {"correct": correct, "attempted": passes, "failed": 0,
                  "metrics": metrics, "device": dev}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["setup"] = {"nvcc_s": compile_s, "marks_s": marks,
                           "passes": passes, "window_s": window_s,
                           "pass_bytes": pass_bytes, "warm_s": warm}
        result["pod"] = {"ranks": world, "passes": counts,
                         "peak_bytes": [r["peak"] for r in reports],
                         "collective_bytes": pod1.get("collective_bytes", 0)
                         - pod0.get("collective_bytes", 0)}
        result["checks"] = checks
        return result, lines


def _control(torch, name, seed, mode, device, overrides=None):
    """The control's numbers on one seed: the reference and the
    reference in ``mode`` over the blocks, on this card."""
    _, config, traffic, _, _ = harness.load_cell(name)
    config = dict(config, **(overrides or {}).get("config", {}))
    ref = plain.evaluate(traffic, config,
                         blocks.Blocks(torch, config, seed, device), seed)
    ctl = plain.evaluate(traffic, config,
                         blocks.Blocks(torch, config, seed, device), seed,
                         mode=mode)
    return harness.judge_passes(traffic, [ctl], ref)


def worker(rank, run_dir):
    """One rank's whole run, from ``args.json`` in ``run_dir``; rank 0
    prints the result line (``run``) or a line a seed
    (``calibrate``)."""
    args = common.load_json(os.path.join(run_dir, "args.json"))
    config = pod_config(args["workload"], args.get("overrides"))
    me = Rank(rank, args["world"], run_dir,
              args.get("backend") or config["backend"], args["device"],
              config)
    if args["mode"] == "run":
        out = me.run(args["workload"], args["seed"], args["seconds"],
                     args["trace"], args["t_start"], args.get("overrides"))
        me.shutdown()
        if out is not None:
            result, lines = out
            print(json.dumps(result), flush=True)
            for line in lines:
                print(line, file=sys.stderr)
        return 0
    overrides = dict(args.get("overrides") or {}, limits={})
    for s in args["seeds"]:
        t = time.time()
        out = me.run(args["workload"], s, args["seconds"], 0, t,
                     overrides)
        if out is not None:
            res = out[0]
            print(json.dumps({
                "kind": "program", "seed": s,
                "passes": res["setup"]["passes"], "failed": res["failed"],
                "seconds": time.time() - t,
                "numbers": {k: c["value"]
                            for k, c in res["checks"].items()}}), flush=True)
        _all(me.store, "calibrate/%d" % s, me.world)
    me.shutdown()
    if rank == 0:
        import torch
        for s in args["control_seeds"]:
            t = time.time()
            nums = _control(torch, args["workload"], s, args["control"],
                            me.device, args.get("overrides"))
            print(json.dumps({"kind": "control", "seed": s,
                              "seconds": time.time() - t, "numbers": nums}),
                  flush=True)
    return 0


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def _tail(path):
    try:
        with open(path, errors="replace") as f:
            return f.read()[-QUOTE:]
    except OSError:
        return ""


def launch(args, world, wall_s=WALL_S, command=None):
    """Start ``world`` workers on ``args`` (what ``args.json`` holds:
    ``mode``, ``workload``, ``device``, the mode's own keys, and
    ``backend`` where it is not the configuration's) and watch them;
    returns ``(rc, rank 0's standard output, rank 0's standard error,
    what went wrong or None)``.  ``command`` is the
    worker's command before its rank and run directory (default: this
    file under the running Python)."""
    command = command or [sys.executable, os.path.abspath(__file__)]
    run_dir = tempfile.mkdtemp(prefix="bench-pod-")
    with open(os.path.join(run_dir, "args.json"), "w") as f:
        json.dump(dict(args, world=world), f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = []

    def stop(signum, frame):
        _kill(procs)
        sys.exit(128 + signum)
    previous = signal.signal(signal.SIGTERM, stop)
    t0 = time.time()
    try:
        for r in range(world):
            with open(os.path.join(run_dir, "rank%d.out" % r), "w") as out, \
                    open(os.path.join(run_dir, "rank%d.err" % r), "w") as err:
                procs.append(subprocess.Popen(
                    command + [str(r), run_dir], stdout=out, stderr=err,
                    env=env, cwd=ROOT, start_new_session=True))
        built = None
        wrong = None
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            dead = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            now = time.time()
            if built is None and os.path.exists(os.path.join(run_dir,
                                                             "built")):
                built = now
            limit = (built + wall_s) if built is not None else t0 + BUILD_S
            if dead:
                wrong = "; ".join("rank %d exited with %d" % rc
                                  for rc in dead)
            elif now > limit:
                stuck = [r for r, c in enumerate(codes) if c is None]
                wrong = ("ranks %s still running %.0f s after %s: stuck"
                         % (stuck, now - (built or t0),
                            "the build" if built else "the start"))
            if wrong:
                _kill(procs)
                break
            time.sleep(0.1)
        out = ""
        if not wrong:
            with open(os.path.join(run_dir, "rank0.out"),
                      errors="replace") as f:
                out = f.read()
        with open(os.path.join(run_dir, "rank0.err"), errors="replace") as f:
            err = f.read()
        if wrong:
            err = "\n".join("--- rank %d, end of standard error:\n%s"
                            % (r, _tail(os.path.join(run_dir,
                                                     "rank%d.err" % r)))
                            for r in range(world))
        return (1 if wrong else 0), out, err, wrong
    finally:
        _kill(procs)
        signal.signal(signal.SIGTERM, previous)
        shutil.rmtree(run_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), sys.argv[2]))
