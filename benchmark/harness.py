"""One run of one cell: make the dataset from the seed, warm the cell's
own pass, run it again and again for the window, then hold what the
timed passes produced against the plain reference.

:func:`run_cell` is the whole run on any torch device (the tests drive
it on the CPU at a small size); ``run.py`` is the command, which first
demands the CUDA cards the cell asks for."""

import gc
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np

from benchmark import common, peaks, tracing
from benchmark.pipeline import Pass
from benchmark.reference import plain

# top-level module names that may not be loaded: JAX, and the JAX package
# with its compatibility shim (``bolt_tpu_torch`` is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "bolt_tpu", "bolt")
# passes run before the window: the first builds every program and
# kernel, the second must find them all
WARMUP = 2
# the window's pass whose outputs are judged besides the last is drawn
# from the seed among its first KEEP_WITHIN passes
KEEP_WITHIN = 8


def forbidden_modules(names=None):
    """Top-level names among ``names`` (default: ``sys.modules``) that
    the benchmark may not load, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def benchmark_spec():
    return common.load_json(os.path.join(common.ROOT, "BENCHMARK.json"))


def for_cell(entries, name):
    """The metric entries that a cell reports."""
    return [m for m in entries if "workloads" not in m
            or name in m["workloads"]]


def load_cell(name, spec=None):
    """``(cell, config, traffic, limits, spec)`` of the workload ``name``,
    each found by its name."""
    spec = spec or benchmark_spec()
    cells = [w for w in spec["workloads"] if w["name"] == name]
    if not cells:
        raise KeyError("no workload %r in BENCHMARK.json" % name)
    cell = cells[0]
    conf = [c for c in spec["configs"] if c["name"] == cell["config"]][0]
    config = common.load_json(os.path.join(common.ROOT, conf["file"]))
    traffic = common.load_json(os.path.join(common.HERE, "traffic",
                                            cell["traffic"] + ".json"))
    path = os.path.join(common.HERE, "limits", name + ".json")
    limits = common.load_json(path) if os.path.exists(path) else {}
    return cell, config, traffic, limits, spec


def make_data(torch, config, seed, device):
    """The dataset, drawn on ``device`` from the seed in a few large calls
    (the same seed gives the same bits), and its key-first view.

    ``config["planted"]`` (optional) adds low-rank structure along one
    axis to the standard normals: ``{"axis": a, "variances": [...]}``
    adds, for each variance ``v``, ``sqrt(v) * u[t] * s[...]``, with the
    ``u`` orthonormal along axis ``a`` (drawn on the host, a few hundred
    numbers) and each loading ``s`` a field of standard normals over the
    other axes (drawn on ``device``)."""
    if config["data"] != "randn":
        raise ValueError("no maker for data %r" % config["data"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    dtype = getattr(torch, config["dtype"])
    x = torch.randn(config["shape"], generator=g, dtype=dtype, device=device)
    planted = config.get("planted")
    if planted:
        ax, var = planted["axis"], planted["variances"]
        t = x.shape[ax]
        if len(var) > t:
            raise ValueError("%d planted components along an axis of %d"
                             % (len(var), t))
        h = torch.Generator()
        h.manual_seed(int(seed))
        u = torch.linalg.qr(torch.randn((t, len(var)), generator=h,
                                        dtype=torch.float64))[0]
        u = (u * torch.tensor(var, dtype=torch.float64).sqrt()).to(
            dtype=dtype, device=device)
        along = [1] * x.ndim
        along[ax] = t
        across = list(x.shape)
        across[ax] = 1
        for c in range(len(var)):
            s = torch.randn(across, generator=g, dtype=dtype, device=device)
            x.addcmul_(u[:, c].reshape(along), s)
            del s
    keys = sorted(config["key_axes"])
    rest = [i for i in range(x.ndim) if i not in keys]
    return x, x.permute(keys + rest)


def fingerprint(torch, x, count=4096):
    flat = x.reshape(-1)
    step = max(1, flat.numel() // count)
    return flat[::step][:count].clone()


def p95(values):
    """The 95th percentile, nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def card(torch):
    """``(name, power limit in W or None)`` of card 0."""
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        limit = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        limit = None
    return name, limit


class MetricContext:
    """What a per-layer reader (``metrics/<name>.py``) reads: the trace's
    summary, each branch's declared work, the engine's counters before
    and after the window."""

    def __init__(self, trace, declared, engine0, engine1, passes):
        self.trace, self.declared = trace, declared
        self.engine0, self.engine1, self.passes = engine0, engine1, passes

    def engine(self, key):
        return self.engine1.get(key, 0) - self.engine0.get(key, 0)

    def roofline(self, label):
        """Percent of the least time for the range ``label``'s calls in
        the device time of the operations launched inside them, or None
        where the window has no such call."""
        if self.trace is None or label not in self.trace.by_range \
                or label not in self.declared:
            return None
        calls, device_s = self.trace.by_range[label]
        if calls == 0 or device_s <= 0:
            return None
        _, _, nbytes, ops = self.declared[label]
        return 100.0 * peaks.least_seconds(nbytes, ops) * calls / device_s


def judge_passes(traffic, kept, ref):
    """The largest reading of each number over the kept passes."""
    numbers = {}
    for k in kept:
        for name, v in plain.judge(traffic, k, ref).items():
            numbers[name] = max(numbers.get(name, v), v)
    return numbers


def held(numbers, limits):
    """``(correct, {name: {"value", "limit"}})``: every number of the
    limits present and within its limit, no number without a limit."""
    limits = limits.get("limits", {})
    checks = {}
    ok = bool(limits)
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name, float("inf"))
        limit = limits.get(name, {}).get("limit")
        good = limit is not None and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def run_cell(name, seed, seconds, trace, device="cuda", spec=None,
             t_start=None, overrides=None):
    """Run the cell once; returns ``(result, stderr lines)``.
    ``overrides`` replaces entries of the cell's config, traffic or
    limits (the tests' small shapes and broken paths)."""
    import torch
    t_start = time.time() if t_start is None else t_start
    cell, config, traffic, limits, spec = load_cell(name, spec)
    overrides = overrides or {}
    config = dict(config, **overrides.get("config", {}))
    traffic = overrides.get("traffic", traffic)
    limits = overrides.get("limits", limits)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    marks = {"start": time.time() - t_start}
    import bolt_tpu_torch as bolt
    from bolt_tpu_torch import engine
    from bolt_tpu_torch.ops import kernels
    marks["imported"] = time.time() - t_start

    lines = []
    x, xk = make_data(torch, config, seed, device)
    stamp = fingerprint(torch, xk)
    data = bolt.array(x, context=torch.device(device),
                      axis=tuple(sorted(config["key_axes"])))
    del x, xk
    declared = common.branch_specs(traffic, config)
    pass_bytes = sum(v[2] for v in declared.values())
    run = Pass(traffic, data, seed)
    sync()
    marks["data"] = time.time() - t_start
    for i in range(WARMUP):
        outs = run(ranges=bool(trace))
        sync()
        del outs
        marks["warm%d" % (i + 1)] = time.time() - t_start
    compile_s = engine.counters().get("compile_seconds", 0.0)

    engine0 = dict(engine.counters())
    launches0 = dict(kernels.LAUNCHES)
    prof = window_range = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.start()
        window_range = record_function(tracing.WINDOW)
        window_range.__enter__()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    keep_at = int(np.random.default_rng(int(seed) & (2 ** 63 - 1)).integers(
        0, KEEP_WITHIN))
    times, kept = [], []
    attempted = failed = 0
    error = None
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    stop_at = t0 + seconds
    i = 0
    while True:
        ts = time.perf_counter()
        attempted += 1
        try:
            outs = run(ranges=bool(trace))
            sync()
        except Exception:          # the run reports it: correct is false
            failed += 1
            error = traceback.format_exc()
            te = time.perf_counter()
            break
        te = time.perf_counter()
        times.append(te - ts)
        last = te >= stop_at
        if i == keep_at or last:
            kept.append(run.keep(outs))
            sync()
        del outs
        i += 1
        if last:
            break
    window_s = te - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    summary = None
    if trace:
        window_range.__exit__(None, None, None)
        prof.stop()
    engine1 = dict(engine.counters())
    launches = {k: n - launches0.get(k, 0)
                for k, n in kernels.LAUNCHES.items()}
    found = forbidden_modules()
    if found:
        raise SystemExit("the run loaded %s" % ", ".join(found))

    metrics = {}
    breakdown = None
    dev = {"platform": "gpu" if on_card else "cpu", "count": 1,
           "memory_peak_bytes": int(peak)}
    if on_card:
        dev["kind"], dev["power_limit_w"] = card(torch)
    else:
        dev["kind"] = "cpu"
    if not trace:
        values = {"scan_gbps": pass_bytes * len(times) / window_s / 1e9,
                  "pass_ms_p95": p95(times) * 1e3 if times else float("nan"),
                  "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        for m in for_cell(spec["end_to_end"], name):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": units[m["name"]]}
    else:
        if on_card:
            groups = tracing.kernel_groups()
            summary = tracing.summarize(prof, groups)
            faults = tracing.cross_check(groups, summary.launches, launches)
            if faults:
                raise SystemExit(
                    "the trace does not stand against ops.kernels.LAUNCHES, "
                    "so no per-layer metric is read from it: "
                    + "; ".join(faults))
            dev["busy_s"] = summary.busy_s
            dev["window_s"] = summary.window_s
            breakdown = {"device_ops": [[n, s] for n, s in summary.device_ops],
                         "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
            lines.append("trace: busy %.6f s of %.6f s; launches %s; "
                         "unattributed %.6f s; by range %s"
                         % (summary.busy_s, summary.window_s,
                            {k: n for k, n in launches.items() if n},
                            summary.unattributed_s, summary.by_range))
        ctx = MetricContext(summary, declared, engine0, engine1, len(times))
        for m in for_cell(spec["per_layer"], name):
            v = common.piece("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    del prof, run, data
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the reference, from the seed again, once the program's state is gone
    x, xk = make_data(torch, config, seed, device)
    same_input = bool(torch.equal(fingerprint(torch, xk), stamp))
    ref = plain.evaluate(traffic, config, xk, seed)
    numbers = judge_passes(traffic, kept, ref)
    del x, xk, ref
    correct, checks = held(numbers, limits)
    correct = correct and failed == 0 and same_input and bool(kept)
    lines.append("passes %d in %.6f s, %d kept, nvcc %.3f s, setup %.3f s"
                 % (len(times), window_s, len(kept), compile_s, setup_s))
    if error:
        lines.append("a pass failed:\n" + error)
    if not same_input:
        lines.append("the regenerated dataset differs from the timed one")
    for n, c in checks.items():
        lines.append("check %s %.6g limit %s %s"
                     % (n, c["value"], c["limit"],
                        "ok" if c["limit"] is not None
                        and c["value"] <= c["limit"] else "FAIL"))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup"] = {"nvcc_s": compile_s, "marks_s": marks,
                       "passes": len(times), "window_s": window_s,
                       "pass_bytes": pass_bytes}
    result["checks"] = checks
    return result, lines
