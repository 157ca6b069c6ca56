"""Local pods: N worker processes, one rank each, running a named payload.

Port of ``scripts/multihost_harness.py`` (``run_cluster``,
``worker_main`` and its fault reporter).  :func:`run_cluster` spawns
``nproc`` workers (``python -m bolt_tpu_torch.parallel.harness --worker
RANK``) that import only ``bolt_tpu_torch``, joins them into one pod
through ``multihost.initialize`` on a ``FileStore`` in the run's
directory (no port to race for), runs the payload named in
:data:`PAYLOADS` on every rank, and returns each rank's result: a JSON
dict whose numpy arrays travel as ``.npy`` files.

* Every run has a wall limit; past it every worker is killed and the
  run raises.
* When a rank dies, the others (which would wait in the next collective)
  are killed after a short grace, and the run raises a ``RuntimeError``
  naming the dead rank and its exit code (``expect_dead=True``, for a
  run killed on purpose, returns every rank's exit code instead).
* Workers set ``torch.set_num_threads(1)`` and run at a lower CPU
  priority (``nice`` 10) than their caller: a pod of 8 shares the host's
  cores.

The payloads live here, not in the test files: a worker must never
import a test module (those import jax).  Run one from the shell::

    python -m bolt_tpu_torch.parallel.harness --payload dryrun --nproc 2 \\
        --device cuda --backend gloo
    python -m bolt_tpu_torch.parallel.harness --payload dryrun --nproc 3 \\
        --device cpu

The ranks' device is always the caller's choice: nothing here picks the
CPU for a caller that named no device.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# the payloads a worker runs, fn(rank, args, inputs) -> dict
from bolt_tpu_torch.parallel.payloads import PAYLOADS

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------
# the parent side
# ---------------------------------------------------------------------

def _encode(value, out_dir, rank, path):
    """``value`` as JSON, numpy arrays (and tensors) saved beside it."""
    if isinstance(value, dict):
        return {str(k): _encode(v, out_dir, rank, path + (str(k),))
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode(v, out_dir, rank, path + (str(i),))
                for i, v in enumerate(value)]
    if hasattr(value, "detach") and hasattr(value, "cpu"):
        value = value.detach().cpu().numpy()
    if isinstance(value, np.ndarray):
        name = "r%d.%s.npy" % (rank, ".".join(path) or "value")
        np.save(os.path.join(out_dir, name), value)
        return {"__npy__": name}
    if isinstance(value, np.generic):
        return value.item()
    return value


def _decode(value, out_dir):
    if isinstance(value, dict):
        if set(value) == {"__npy__"}:
            return np.load(os.path.join(out_dir, value["__npy__"]))
        return {k: _decode(v, out_dir) for k, v in value.items()}
    if isinstance(value, list):
        return [_decode(v, out_dir) for v in value]
    return value


def _tail(path, n=3000):
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def run_cluster(payload, nproc=2, timeout=120, args=None, inputs=None, *,
                device, backend=None, env=None, worker_env=None,
                keep=False, expect_dead=False):
    """Stand up an ``nproc``-rank pod and run ``PAYLOADS[payload]`` on
    every rank; returns the list of per-rank result dicts (numpy arrays
    loaded back).

    ``args`` (JSON) and ``inputs`` (``{name: ndarray}``) reach every
    rank's payload.  ``device`` (required) is each rank's device:
    ``"cuda"`` (every rank on ``cuda:0``), ``"cuda:rank"`` (rank ``r`` on
    ``cuda:r``) or ``"cpu"``; a CUDA spec raises here when CUDA is
    missing.  ``backend`` as ``multihost.initialize``
    takes it.  ``env`` adds to every worker's environment, ``worker_env``
    (``{rank: {...}}``) to one's — how a test arms ``BOLT_CHAOS`` on one
    rank.  A rank that dies raises a ``RuntimeError`` naming it; so does
    the wall limit ``timeout``.  ``expect_dead=True`` (a run a test kills
    on purpose) returns the list of every rank's exit code instead of
    results: once one rank died, the others get the same short grace and
    are then killed.  ``keep=True`` leaves the run's directory (its
    logs) in place."""
    _check_device(device)
    out_dir = tempfile.mkdtemp(prefix="bolt-pod-")
    try:
        return _run(payload, nproc, timeout, args, inputs, device, backend,
                    env, worker_env, out_dir, expect_dead)
    finally:
        if not keep:
            shutil.rmtree(out_dir, ignore_errors=True)


def _check_device(spec):
    """Refuse a device spec the ranks could not take, before any spawn."""
    import torch
    if not str(spec).startswith(("cpu", "cuda")):
        raise ValueError("run_cluster: device must be 'cuda', 'cuda:rank' "
                         "or a torch device string, not %r" % (spec,))
    if str(spec).startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("run_cluster: device %r asked for CUDA, which "
                           "this process does not have" % (spec,))


def _run(payload, nproc, timeout, args, inputs, device, backend, env,
         worker_env, out_dir, expect_dead=False):
    os.makedirs(os.path.join(out_dir, "inputs"))
    for name, arr in (inputs or {}).items():
        np.save(os.path.join(out_dir, "inputs", name + ".npy"),
                np.asarray(arr))
    with open(os.path.join(out_dir, "args.json"), "w") as f:
        json.dump(args or {}, f)
    base = dict(os.environ)
    base.pop("BOLT_CHAOS", None)          # never inherit a stale arming
    base["PYTHONPATH"] = _ROOT + (os.pathsep + base["PYTHONPATH"]
                                  if base.get("PYTHONPATH") else "")
    base.update({"BOLT_POD_PAYLOAD": str(payload),
                 "BOLT_POD_NPROC": str(nproc),
                 "BOLT_POD_OUT": out_dir,
                 "BOLT_POD_DEVICE": str(device),
                 "BOLT_POD_WALL": str(float(timeout)),
                 "BOLT_POD_BACKEND": backend or ""})
    if env:
        base.update({k: str(v) for k, v in env.items()})
    procs = []
    try:
        for rank in range(nproc):
            e = dict(base)
            if worker_env and rank in worker_env:
                e.update({k: str(v) for k, v in worker_env[rank].items()})
            log = open(os.path.join(out_dir, "worker.%d.log" % rank), "wb")
            try:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "bolt_tpu_torch.parallel.harness",
                     "--worker", str(rank)],
                    cwd=_ROOT, env=e, stdout=log, stderr=subprocess.STDOUT))
            finally:
                log.close()
        rcs = _watch(procs, timeout, out_dir, expect_dead)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if expect_dead:
        return rcs
    results = []
    for rank in range(nproc):
        with open(os.path.join(out_dir, "result.%d.json" % rank)) as f:
            results.append(_decode(json.load(f), out_dir))
    return results


def _watch(procs, timeout, out_dir, expect_dead=False):
    """Wait for every worker; on a death kill the rest (after a short
    grace) and raise naming the dead rank (``expect_dead``: return every
    exit code); past ``timeout`` kill all."""
    deadline = time.monotonic() + timeout
    while True:
        rcs = [p.poll() for p in procs]
        if all(rc == 0 for rc in rcs):
            return rcs
        bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
        if bad:
            grace = time.monotonic() + 3.0
            while time.monotonic() < grace and any(
                    p.poll() is None for p in procs):
                time.sleep(0.05)
            for p in procs:
                if p.poll() is None:
                    p.kill()
            if expect_dead:
                return [p.wait() for p in procs]
            dead = bad[0]
            log = os.path.join(out_dir, "worker.%d.log" % dead)
            raise RuntimeError(
                "pod: rank %d died (exit code %s) before the run finished; "
                "its peers were killed; log tail:\n%s"
                % (dead, rcs[dead], _tail(log)))
        if time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            late = [r for r, rc in enumerate(rcs) if rc is None]
            log = os.path.join(out_dir, "worker.%d.log" % late[0])
            raise RuntimeError(
                "pod: wall limit of %.0fs passed with ranks %s still "
                "running; all were killed; rank %d's stacks:\n%s"
                % (timeout, late, late[0], _tail(log, 6000)))
        time.sleep(0.02)


# ---------------------------------------------------------------------
# the worker side
# ---------------------------------------------------------------------

def _device(spec, rank):
    import torch
    if spec == "cuda:rank":
        return torch.device("cuda", rank)
    if spec == "cuda":
        return torch.device("cuda", 0)
    return torch.device(spec)


def worker_main(rank):
    import faulthandler
    # a pod of 8 shares the host's cores with whatever started it: its
    # ranks yield them (the torch import below is most of a rank's CPU)
    os.nice(10)
    import torch
    torch.set_num_threads(1)
    # a rank still running near the wall limit writes its stacks to its
    # log, which the parent's wall-limit error quotes
    wall = float(os.environ.get("BOLT_POD_WALL", "0"))
    if wall > 0:
        faulthandler.dump_traceback_later(wall * 0.85)
    from bolt_tpu_torch.parallel import multihost
    out = os.environ["BOLT_POD_OUT"]
    nproc = int(os.environ["BOLT_POD_NPROC"])
    multihost.initialize(num_processes=nproc, process_id=rank,
                         backend=os.environ.get("BOLT_POD_BACKEND") or None,
                         device=_device(os.environ["BOLT_POD_DEVICE"], rank),
                         store_path=os.path.join(out, "store"))
    with open(os.path.join(out, "args.json")) as f:
        args = json.load(f)
    inputs = {}
    for name in sorted(os.listdir(os.path.join(out, "inputs"))):
        inputs[name[:-4]] = np.load(os.path.join(out, "inputs", name))
    res = PAYLOADS[os.environ["BOLT_POD_PAYLOAD"]](rank, args, inputs)
    # no rank tears the group down under a peer still mid-payload
    multihost.barrier("harness.exit")
    tmp = os.path.join(out, "result.%d.json.tmp" % rank)
    with open(tmp, "w") as f:
        json.dump(_encode(res, out, rank, ()), f)
    os.replace(tmp, os.path.join(out, "result.%d.json" % rank))
    multihost.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Run a named payload on a local pod of ranks.")
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--payload", default="dryrun",
                    choices=sorted(PAYLOADS))
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (every rank on cuda:0), cuda:rank or cpu; "
                         "required to start a pod")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--args", default="{}", help="payload args (JSON)")
    ap.add_argument("--timeout", type=float, default=300)
    a = ap.parse_args(argv)
    if a.worker is not None:
        worker_main(a.worker)
        return 0
    if a.device is None:
        ap.error("--device is required (cuda, cuda:rank or cpu)")
    res = run_cluster(a.payload, nproc=a.nproc, timeout=a.timeout,
                      args=json.loads(a.args), device=a.device,
                      backend=a.backend)

    def show(v):
        if isinstance(v, np.ndarray):
            return "<array %s %s>" % (v.dtype, v.shape)
        if isinstance(v, dict):
            return {k: show(x) for k, x in v.items()}
        if isinstance(v, list):
            return [show(x) for x in v]
        return v

    for rank, r in enumerate(res):
        print(json.dumps({"rank": rank, "result": show(r)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
