"""Run one cell of BENCHMARK.json once and print its result line:

    python3 benchmark/run.py --workload ns.fused --seed 7 --seconds 10 --trace 0

It needs the CUDA cards the cell asks for and the ``bolt_tpu_torch``
package of the checkout; without either it exits with 2 and prints no
result.  A cell of more than one chip runs as a pod, one process a card
(``pod.py``).  The last line of standard output is one JSON object; the
numbers compared with the reference close standard error."""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness
    cell = harness.load_cell(args.workload)[0]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print("the cell needs %d cards, %d found"
              % (cell["chips"], torch.cuda.device_count()), file=sys.stderr)
        return 2
    if cell["chips"] > 1:
        return run_pod(args, cell["chips"])
    try:
        import bolt_tpu_torch  # noqa: F401
    except ImportError as e:
        print("the program under test is missing: %s" % e, file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     args.trace, t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print("the run loaded %s" % ", ".join(found), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


def run_pod(args, chips):
    """The cell as a pod of ``chips`` NCCL ranks, one a card
    (``pod.py``): rank 0's result line, or a non-zero exit and none."""
    from importlib.util import find_spec
    from benchmark import harness, pod
    if find_spec("bolt_tpu_torch") is None:
        print("the program under test is missing", file=sys.stderr)
        return 2
    rc, out, err, wrong = pod.launch(
        {"mode": "run", "workload": args.workload, "seed": args.seed,
         "seconds": args.seconds, "trace": args.trace, "t_start": T_START,
         "device": "cuda"}, chips)
    last = out.strip().splitlines()[-1] if out.strip() else ""
    if not wrong and not last.startswith("{"):
        wrong = "rank 0 printed no result"
    found = harness.forbidden_modules()
    if found:
        wrong = "the launcher loaded %s" % ", ".join(found)
    if wrong:
        print("the pod failed: %s\n%s" % (wrong, err), file=sys.stderr)
        return rc or 3
    print(last, flush=True)
    sys.stderr.write(err)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
