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
  ``tolerate={rank}`` names a VICTIM expected to die while its peers
  recover, and ``extra=[env]`` starts replacement processes beside the
  pod (``BOLT_POD_REJOINER=1``: they bring up no pod and join it through
  ``parallel.supervisor.attach``); both return ``(results, rcs)``, a
  rank that left no result reading ``None``.  The recovery scenarios
  are packaged as :func:`run_reform_bench`, :func:`run_supervise_bench`
  and :func:`run_precollective_probe`.
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
                keep=False, expect_dead=False, tolerate=None, extra=None):
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
    are then killed.  ``tolerate`` (a set of ranks that may die while the
    rest finish) and ``extra`` (a list of environments, one replacement
    process each, numbered from ``nproc``) return ``(results, rcs)``.
    ``keep=True`` leaves the run's directory (its logs) in place."""
    _check_device(device)
    out_dir = tempfile.mkdtemp(prefix="bolt-pod-")
    try:
        return _run(payload, nproc, timeout, args, inputs, device, backend,
                    env, worker_env, out_dir, expect_dead,
                    set(tolerate or ()), list(extra or ()))
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
         worker_env, out_dir, expect_dead=False, tolerate=(), extra=()):
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
        for rank in range(nproc + len(extra)):
            e = dict(base)
            if worker_env and rank in worker_env:
                e.update({k: str(v) for k, v in worker_env[rank].items()})
            if rank >= nproc:
                e.update({k: str(v) for k, v in extra[rank - nproc].items()})
                e["BOLT_POD_REJOINER"] = "1"
            log = open(os.path.join(out_dir, "worker.%d.log" % rank), "wb")
            try:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "bolt_tpu_torch.parallel.harness",
                     "--worker", str(rank)],
                    cwd=_ROOT, env=e, stdout=log, stderr=subprocess.STDOUT))
            finally:
                log.close()
        rcs = _watch(procs, timeout, out_dir, expect_dead, tolerate)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if expect_dead:
        return rcs
    results = []
    for rank in range(len(procs)):
        path = os.path.join(out_dir, "result.%d.json" % rank)
        if (tolerate or extra) and not os.path.exists(path):
            results.append(None)
            continue
        with open(path) as f:
            results.append(_decode(json.load(f), out_dir))
    if tolerate or extra:
        return results, rcs
    return results


def _watch(procs, timeout, out_dir, expect_dead=False, tolerate=()):
    """Wait for every worker; on a death kill the rest (after a short
    grace) and raise naming the dead rank (``expect_dead``: return every
    exit code; a ``tolerate``d rank may die while the rest finish); past
    ``timeout`` kill all."""
    deadline = time.monotonic() + timeout
    while True:
        rcs = [p.poll() for p in procs]
        if all(rc == 0 or (r in tolerate and rc is not None)
               for r, rc in enumerate(rcs)):
            return rcs
        bad = [r for r, rc in enumerate(rcs)
               if rc not in (None, 0) and r not in tolerate]
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
    from bolt_tpu_torch.parallel import multihost, podwatch
    out = os.environ["BOLT_POD_OUT"]
    nproc = int(os.environ["BOLT_POD_NPROC"])
    if os.environ.get("BOLT_POD_REJOINER") != "1":
        # a replacement process brings up no pod: its payload joins the
        # running one (parallel.supervisor.attach)
        multihost.initialize(
            num_processes=nproc, process_id=rank,
            backend=os.environ.get("BOLT_POD_BACKEND") or None,
            device=_device(os.environ["BOLT_POD_DEVICE"], rank),
            store_path=os.path.join(out, "store"))
    with open(os.path.join(out, "args.json")) as f:
        args = json.load(f)
    inputs = {}
    for name in sorted(os.listdir(os.path.join(out, "inputs"))):
        inputs[name[:-4]] = np.load(os.path.join(out, "inputs", name))
    res = PAYLOADS[os.environ["BOLT_POD_PAYLOAD"]](rank, args, inputs)
    # no rank tears the group down under a peer still mid-payload (next
    # to a dead victim no barrier can complete: its survivors just go;
    # BOLT_POD_EXIT_BARRIER=0 says so where no watch could tell)
    if not podwatch.dead_peers() and \
            os.environ.get("BOLT_POD_EXIT_BARRIER") != "0":
        multihost.barrier("harness.exit")
    tmp = os.path.join(out, "result.%d.json.tmp" % rank)
    with open(tmp, "w") as f:
        json.dump(_encode(res, out, rank, ()), f)
    os.replace(tmp, os.path.join(out, "result.%d.json" % rank))
    multihost.shutdown()


# ---------------------------------------------------------------------
# the recovery scenarios: a victim killed -9, a replacement rejoining
# ---------------------------------------------------------------------

def _stale(root, subs):
    """Stream-checkpoint files still under ``root/<sub>``."""
    out = []
    for sub in subs:
        d = os.path.join(root, sub)
        if os.path.isdir(d):
            out += [p for p in os.listdir(d) if p.startswith("stream_")]
    return out


def run_reform_bench(nproc=3, shape=(96, 8), chunks=12, pace=0.25,
                     kill_at=7, pod_timeout=2.0, timeout=300, *, device,
                     backend=None, args=None, workdir=None):
    """The reference harness's ``run_reform_bench``: a CLEAN
    ``nproc - 1``-rank run of ``payloads.payload_reform`` (the unkilled
    baseline at the smaller width), then an ``nproc``-rank run with rank
    1 killed -9 at its ``kill_at``-th upload (``pace`` seconds a load put
    the death mid-stream): every survivor must catch ``PeerLostError``
    within 2x ``pod_timeout``, reform and resume bit for bit.  Returns
    both legs' results, the exit codes and the reference's summary
    figures (``recovery_over_clean``, ``detection_s``,
    ``bit_identical``...); ``args`` adds to the payload's."""
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="bolt-pod-reform-")
    base = dict(args or {}, shape=list(shape), chunks=chunks, pace=pace)
    env = {"BOLT_POD_TIMEOUT": pod_timeout, "BOLT_CHECKPOINT_EVERY": "1"}
    try:
        clean = run_cluster(
            "reform", nproc - 1, timeout=timeout, device=device,
            backend=backend,
            args=dict(base, ckpt=os.path.join(workdir, "ck-clean"),
                      reform_store=os.path.join(workdir, "rs-clean")),
            env=dict(env, BOLT_POD_HB_DIR=os.path.join(workdir, "hb-c")))
        killed, rcs = run_cluster(
            "reform", nproc, timeout=timeout, device=device,
            backend=backend, tolerate={1},
            args=dict(base, ckpt=os.path.join(workdir, "ck-kill"),
                      reform_store=os.path.join(workdir, "rs-kill")),
            env=dict(env, BOLT_POD_HB_DIR=os.path.join(workdir, "hb-k")),
            worker_env={1: {"BOLT_CHAOS":
                            "stream.upload:%d:kill" % kill_at}})
        survivors = [r for r in killed if r is not None]
        ref = clean[0]
        keys = [k for k in ("sum", "stats_sum", "stats_var") if k in ref]
        bit = bool(survivors) and all(
            np.array_equal(r[k], ref[k]) for r in survivors for k in keys)
        clean_s = max(r["wall_s"] for r in clean)
        recovery_s = max(r.get("recovery_s") or 0.0 for r in survivors)
        return {
            "clean": clean, "killed": killed, "rcs": rcs,
            "clean_s": clean_s, "recovery_s": recovery_s,
            "recovery_over_clean": recovery_s / clean_s,
            "detection_s": max(r.get("detection_s") or 0.0
                               for r in survivors),
            "reform_s": max(r.get("reform_s") or 0.0 for r in survivors),
            "resume_s": max(r.get("resume_s") or 0.0 for r in survivors),
            "barrier_s": max(r.get("barrier_s") or 0.0
                             for r in survivors),
            "pod_timeout": float(pod_timeout),
            "survivors": len(survivors), "victim_rc": rcs[1],
            "peer_lost_everywhere": all(r.get("peer_lost")
                                        for r in survivors),
            "barrier_peerlost": all(r.get("barrier_peerlost")
                                    for r in survivors),
            "sum_resumes": sum(r.get("sum_resumes", 0) for r in survivors),
            "stats_resumes": sum(r.get("stats_resumes", 0)
                                 for r in survivors),
            "bit_identical": bit,
            "stale_checkpoint_files": _stale(
                os.path.join(workdir, "ck-kill"), ("sum", "stats")),
            "leaked_spans": sum(r.get("leaked_spans", 0)
                                for r in survivors)}
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def run_supervise_bench(nproc=3, shape=(96, 8), chunks=12, pace=0.2,
                        kill_at=4, pod_timeout=2.0, timeout=420, *, device,
                        backend=None, args=None, workdir=None):
    """The reference harness's ``run_supervise_bench``: a CLEAN
    ``nproc``-rank run of ``payloads.payload_supervise``, then the
    ELASTIC leg: rank 1 killed -9 at its ``kill_at``-th upload during A
    (an automatic shrink), a replacement process rejoining during B (a
    quiesce and a reform up), C clean on the re-expanded pod.  Every
    artifact must equal the clean run's bits.  Returns both legs'
    results, the exit codes and the reference's summary figures."""
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="bolt-pod-elastic-")
    env = {"BOLT_POD_TIMEOUT": pod_timeout, "BOLT_CHECKPOINT_EVERY": "1",
           "BOLT_SUPERVISE_BACKOFF": "0.25"}
    base = dict(args or {}, shape=list(shape), chunks=chunks, pace=pace)
    try:
        out_c = os.path.join(workdir, "out-clean")
        out_e = os.path.join(workdir, "out-elastic")
        os.makedirs(out_c)
        os.makedirs(out_e)
        clean = run_cluster(
            "supervise", nproc, timeout=timeout, device=device,
            backend=backend,
            args=dict(base, out=out_c,
                      ckpt=os.path.join(workdir, "ck-clean")),
            env=dict(env, BOLT_POD_HB_DIR=os.path.join(workdir, "hb-c")))
        res, rcs = run_cluster(
            "supervise", nproc, timeout=timeout, device=device,
            backend=backend, tolerate={1},
            args=dict(base, out=out_e, ckpt=os.path.join(workdir, "ck-el"),
                      expect_bstart=nproc - 1, rejoin_id="w1b"),
            env=dict(env, BOLT_POD_HB_DIR=os.path.join(workdir, "hb-e")),
            worker_env={1: {"BOLT_CHAOS":
                            "stream.upload:%d:kill" % kill_at}},
            extra=[{}])
        done = [r for r in res if r is not None]
        survivors = [r for r in done if not r["rejoiner"]]
        rejoiner = [r for r in done if r["rejoiner"]]
        ref = clean[0]
        names = [k for k in ("sumA", "sumB", "statsC_sum", "statsC_var")
                 if k in ref]
        bit = bool(survivors) and all(
            np.array_equal(r[k], ref[k]) for r in done for k in names
            if k in r)
        walls = ("wall_a", "wall_b", "wall_c")
        clean_s = max(sum(r.get(w, 0.0) for w in walls) for r in clean)
        scenario_s = max(sum(r.get(w, 0.0) for w in walls)
                         for r in survivors)
        return {
            "clean": clean, "elastic": res, "rcs": rcs,
            "clean_s": clean_s, "scenario_s": scenario_s,
            "scenario_over_clean": scenario_s / clean_s,
            "detection_s": max(r.get("detection_age") or 0.0
                               for r in survivors),
            "reform_s": max(r.get("reform_s") or 0.0 for r in survivors),
            "recovery_s": max(r.get("recovery_s") or 0.0
                              for r in survivors),
            "rejoin_s": max(r.get("rejoin_recovery_s") or 0.0
                            for r in survivors),
            "attach_s": rejoiner[0].get("attach_s") if rejoiner else None,
            "pod_timeout": float(pod_timeout), "victim_rc": rcs[1],
            "survivors": len(survivors), "rejoined": len(rejoiner),
            "a_resumes": sum(r.get("a_resumes", 0) for r in survivors),
            "b_resumes": sum(r.get("b_resumes", 0) for r in survivors),
            "reforms": max(r.get("reforms", 0) for r in done),
            "rejoins": max(r.get("rejoins", 0) for r in done),
            "nproc_after_a": min(r.get("nproc_after_a", nproc)
                                 for r in survivors),
            "nproc_final": max(r.get("nproc_after_b", 0) for r in done),
            "budget_share_after_a": min(
                r.get("budget_share_after_a", 1.0) for r in survivors),
            "budget_share_after_b": max(
                r.get("budget_share_after_b", 0.0) for r in done),
            "bit_identical": bit,
            "arbiter_bytes": max(r.get("arbiter_bytes_after", 0)
                                 for r in done),
            "stale_ckpt": sorted({c for r in done
                                  for c in r.get("stale_ckpt", [])}),
            "stale_markers": max(r.get("stale_markers", 0) for r in done),
            "leaked_spans": sum(r.get("leaked_spans", 0) for r in done),
            "blt014": all(r.get("blt014", True) for r in done),
            "explain_supervised": all(r.get("explain_supervised", True)
                                      for r in done)}
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def run_precollective_probe(pod_timeout=2.0, timeout=180, *, device,
                            backend=None):
    """The reference harness's ``run_precollective_probe``: rank 1 dies
    at its FIRST upload (no exchange ever issued); the survivor must
    catch ``PeerLostError`` within 2x ``pod_timeout`` of the death
    (``pre_after_death``: from the victim's last heartbeat; ``pre_elapsed``
    counts from the survivor's start, the victim's own start-up
    included)."""
    workdir = tempfile.mkdtemp(prefix="bolt-pod-precoll-")
    try:
        res, rcs = run_cluster(
            "precollective", 2, timeout=timeout, device=device,
            backend=backend, tolerate={1},
            env={"BOLT_POD_TIMEOUT": pod_timeout,
                 "BOLT_POD_HB_DIR": os.path.join(workdir, "hb")},
            worker_env={1: {"BOLT_CHAOS": "stream.upload:1:kill"}})
        r = res[0]
        after = None
        if r.get("pre_elapsed") is not None \
                and r.get("victim_last_beat_s") is not None:
            after = r["pre_elapsed"] - r["victim_last_beat_s"]
        return {"victim_rc": rcs[1], "pre_peerlost": r.get("pre_peerlost"),
                "pre_elapsed": r.get("pre_elapsed"),
                "pre_after_death": after,
                "pre_phase": r.get("pre_phase"),
                "pre_peer": r.get("pre_peer"),
                "pod_timeout": float(pod_timeout)}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


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
