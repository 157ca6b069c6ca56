"""The readings a cell's limits are set from: the program's numbers over
many seeds (the lower readings) and the control's (the upper readings),
in one process, on the card:

    python3 benchmark/calibrate.py --workload ns.fused --seeds 11,12,13 \
        --control-seeds 21,22,23 [--seconds 2] [--out FILE] [--write]

Each program seed is a run of the cell (``harness.run_cell``: the data,
the warm-up, a window of ``--seconds``, the comparison), and its numbers
are the ones that run compares; a cell of more than one chip runs its
seeds one after another in one pod (``pod.py``).  Each control seed puts the reference,
computed in the precision below the configuration's (``control`` in
``limits/<cell>.json``), in the program's place.  Prints one JSON line a
seed and, last, each number's largest program reading, smallest control
reading and the limit that :func:`limit_of` sets between them;
``--write`` writes those into ``limits/<cell>.json``."""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

RULE = ("lower: the largest of the program's readings (runs of the cell); "
        "upper: the smallest of the control's; limit = lower^(1/3) * "
        "upper^(2/3) (more room above the lower), two digits, where the "
        "upper is three times the lower or more; 0 where the lower reading "
        "is 0")


def control_readings(torch, name, seed, mode, device="cuda", overrides=None):
    from benchmark import harness
    from benchmark.reference import plain
    cell, config, traffic, limits, spec = harness.load_cell(name)
    overrides = overrides or {}
    config = dict(config, **overrides.get("config", {}))
    x, xk = harness.make_data(torch, config, seed, device)
    ref = plain.evaluate(traffic, config, xk, seed)
    ctl = plain.evaluate(traffic, config, xk, seed, mode=mode)
    return harness.judge_passes(traffic, [ctl], ref)


def program_run(name, seed, seconds, device="cuda", overrides=None):
    """``(numbers, result)`` of one run of the cell, judged with no
    limits (every number it compares, each as read)."""
    from benchmark import harness
    res, _ = harness.run_cell(name, seed, seconds, 0, device=device,
                              overrides=dict(overrides or {}, limits={}))
    return {k: c["value"] for k, c in res["checks"].items()}, res


def pod_lines(name, chips, seeds, control_seeds, seconds, mode,
              backend=None, device="cuda", overrides=None, wall_s=3000):
    """The readings of a pod cell (``pod.py``): the program's seeds run
    one after another in one pod, then the control's on rank 0's card;
    one dict a seed, or None where the pod failed (said on standard
    error)."""
    from benchmark import pod
    rc, out, err, wrong = pod.launch(
        {"mode": "calibrate", "workload": name, "seeds": seeds,
         "control_seeds": control_seeds, "control": mode,
         "seconds": seconds, "backend": backend, "device": device,
         "overrides": overrides}, chips, wall_s=wall_s)
    if wrong:
        print("the pod failed: %s\n%s" % (wrong, err), file=sys.stderr)
        return None
    lines = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


def limit_of(lower, upper):
    """The limit between a number's two readings by :data:`RULE`, or None
    where they do not separate."""
    if lower == 0:
        return 0.0
    if upper is None or not math.isfinite(upper) or upper < 3 * lower:
        return None
    return float("%.2g" % (lower ** (1 / 3) * upper ** (2 / 3)))


def limits_file(old, mode, card, seeds, control_seeds, lower, upper):
    """The new ``limits/<cell>.json``.  An entry of ``old`` that names
    ``same_as`` takes that number's limit (its note kept)."""
    entries = {}
    for k in sorted(lower):
        up = upper.get(k, float("inf"))
        e = {"limit": limit_of(lower[k], up), "lower": lower[k],
             "upper": up if math.isfinite(up) else "inf"}
        prev = old.get("limits", {}).get(k, {})
        for key in ("same_as", "note"):
            if key in prev:
                e[key] = prev[key]
        entries[k] = e
    for e in entries.values():
        if "same_as" in e:
            e["limit"] = entries[e["same_as"]]["limit"]
    return {"control": {"mode": mode, "card": card, "program_seeds": seeds,
                        "control_seeds": control_seeds, "rule": RULE},
            "limits": entries}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    old = harness.load_cell(args.workload)[3]
    mode = old.get("control", {}).get("mode", "bfloat16")
    seeds = [int(v) for v in args.seeds.split(",") if v]
    control_seeds = [int(v) for v in args.control_seeds.split(",") if v]
    chips = harness.load_cell(args.workload)[0]["chips"]
    if chips > 1:
        lines = pod_lines(args.workload, chips, seeds, control_seeds,
                          args.seconds, mode)
        if lines is None:
            return 3
    else:
        lines = []
        for kind, group in (("program", seeds), ("control", control_seeds)):
            for s in group:
                t = time.time()
                line = {"kind": kind, "seed": s}
                if kind == "program":
                    nums, res = program_run(args.workload, s, args.seconds)
                    line["passes"] = res["setup"]["passes"]
                    line["failed"] = res["failed"]
                else:
                    nums = control_readings(torch, args.workload, s, mode)
                line.update(seconds=time.time() - t, numbers=nums)
                lines.append(line)
                print(json.dumps(line), flush=True)
    lower, upper = {}, {}
    for line in lines:
        for k, v in line["numbers"].items():
            if line["kind"] == "program":
                lower[k] = max(lower.get(k, v), v)
            else:
                upper[k] = min(upper.get(k, v), v)
    if lower:
        # the control is judged on what the program's own runs compare
        upper = {k: v for k, v in upper.items() if k in lower}
    card = torch.cuda.get_device_name(0)
    summary = {"workload": args.workload, "control": mode, "card": card,
               "lower": lower, "upper": upper,
               "limit": {k: limit_of(v, upper.get(k, float("inf")))
                         for k, v in lower.items()}}
    if args.out:
        with open(args.out, "w") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    if args.write:
        name, limit = harness.card(torch)
        new = limits_file(old, mode, "%s, %s W" % (name, limit), seeds,
                          control_seeds, lower, upper)
        path = os.path.join(ROOT, "benchmark", "limits",
                            args.workload + ".json")
        with open(path, "w") as f:
            json.dump(new, f, indent=1)
            f.write("\n")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
