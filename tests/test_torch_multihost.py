"""The port's pod layer (``bolt_tpu_torch/parallel/multihost.py`` and the
harness), against the reference's ``tests/test_multihost.py`` helpers.

In process (a single process, no pod): the topology queries, the barrier,
``local_value``, the idempotent ``initialize``, the single-process
schedule digest (``test_concurrency.py::
test_verify_schedule_single_process_returns_digest``), the pointed
refusal of ``nccl`` with two ranks on one device, the later slices'
``NotImplementedError``\\ s, and BLT004 against the reference's emitter.

On pods of CPU ranks (``bolt_tpu_torch/parallel/harness.py``, gloo): the
schedule digests agreeing across two ranks and a skewed rank raising a
pointed divergence on both (the reference's ``sched_pod`` pair), BLT004
and ``explain`` on a live mesh, ``kill -9`` of one rank giving a pointed
error naming it, and the wall limit ending a pod that overstays.  Every
comparison is exact (codes, messages, digests, integers).
"""

import importlib
import threading

import numpy as np
import pytest
import torch

import jax
import bolt_tpu as bolt
from bolt_tpu.analysis.diagnostics import Diagnostic as RefDiagnostic

import bolt_tpu_torch as tbolt
from bolt_tpu_torch import convert, engine
from bolt_tpu_torch.parallel import default_mesh, harness, multihost
from bolt_tpu_torch.parallel.mesh import make_mesh

# the checker modules (each package's ``analysis.check`` is a function)
ref_check = importlib.import_module("bolt_tpu.analysis.check")
port_check = importlib.import_module("bolt_tpu_torch.analysis.check")

CPU = torch.device("cpu")
POD_WALL = 120


# ---------------------------------------------------------------------
# in-process helpers (a single process)
# ---------------------------------------------------------------------

def test_topology_single_process():
    assert multihost.process_count() == 1
    assert multihost.process_index() == 0
    assert not multihost.is_multiprocess()
    assert multihost.topology_token() is None
    mesh = default_mesh(devices=[CPU])
    assert multihost.mesh_process_count(mesh) == 1
    assert not multihost.is_multiprocess(mesh)
    assert mesh.size == 1 and mesh.device == CPU and mesh.rank == 0


def test_barrier_noop_single_process():
    before = engine.schedule_digest()
    multihost.barrier("test")          # must not dispatch anything
    assert engine.schedule_digest() == before


def test_local_value_roundtrip():
    mesh = default_mesh(devices=[CPU])
    b = tbolt.array(np.arange(6.0).reshape(2, 3), mesh)
    assert np.array_equal(multihost.local_value(b),
                          np.arange(6.0).reshape(2, 3))
    assert np.array_equal(multihost.local_value(b._data),
                          np.arange(6.0).reshape(2, 3))
    assert np.array_equal(multihost.local_value(np.ones(3)), np.ones(3))


def test_initialize_idempotent_single_process(monkeypatch):
    # no process count from the call or the environment: a plain single
    # process, the helper declines and stays down
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert not multihost.is_initialized()
    assert multihost.shutdown() is False
    assert multihost.backend() is None and multihost.local_device() is None


def test_verify_schedule_single_process_returns_digest():
    got = multihost.verify_schedule("t17")
    assert got == engine.schedule_digest()[1]


def test_one_rank_pod_brings_up_and_down():
    # a one-process pod through the store: a bound mesh, the barrier and
    # the collectives' one-rank forms, then a clean shutdown
    assert multihost.initialize(num_processes=1, process_id=0,
                                device=CPU) is True
    try:
        assert multihost.initialize(num_processes=1, process_id=0,
                                    device=CPU) is False
        assert multihost.is_initialized() and multihost.backend() == "gloo"
        mesh = make_mesh((1,), ("k",))
        assert mesh.device == CPU and multihost.pod_devices() == [CPU]
        multihost.barrier("one")
        b = tbolt.array(np.arange(12.0).reshape(4, 3), mesh)
        assert np.array_equal(b.map(lambda v: v * 2).sum().toarray(),
                              np.arange(12.0).reshape(4, 3).sum(0) * 2)
    finally:
        assert multihost.shutdown() is True
    assert not multihost.is_initialized()


def test_bound_mesh_spans_the_pod():
    with pytest.raises(ValueError, match="spans the whole pod"):
        make_mesh((2,), ("k",), devices=[CPU, CPU])
    lay = convert.mesh_from_reference((4, 2), ("a", "b"))
    assert not lay.bound and lay.size == 8
    assert lay.group_ranks(("b",), rank=5) == [4, 5]
    assert lay.group_ranks(("a",), rank=5) == [1, 3, 5, 7]
    with pytest.raises(ValueError, match="unbound"):
        lay.group(("a",))


@pytest.mark.parametrize("name,item", [
    ("reform", "A12c"), ("heal_backend_init", "A12c"),
    ("local_slab_spec", "A12b"), ("slab_divisibility_error", "A12b"),
    ("sidecar_codec_error", "A12b"), ("key_collective_axes", "A12b")])
def test_later_slices_raise_naming_their_item(name, item):
    with pytest.raises(NotImplementedError, match="ROADMAP %s" % item):
        getattr(multihost, name)()


def test_nccl_needs_a_cuda_device():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        multihost.initialize(num_processes=1, process_id=0,
                             backend="nccl", device=CPU)
    assert not multihost.is_initialized()


def test_nccl_two_ranks_on_one_device_refused(tmp_path):
    # both ranks publish their device through the store and both refuse,
    # pointedly, before NCCL is touched
    assert multihost.shared_devices(["h/cuda/A", "h/cuda/B"]) is None
    assert multihost.shared_devices(["h/cuda/A", "h/cuda/B", "h/cuda/A"]) \
        == (0, 2, "h/cuda/A")
    store = torch.distributed.FileStore(str(tmp_path / "store"), 2)
    errors = {}

    def rank(r):
        try:
            multihost._refuse_shared_nccl(store, r, 2, CPU, 30.0)
            errors[r] = None
        except ValueError as exc:
            errors[r] = str(exc)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for r in (0, 1):
        assert errors[r] is not None
        assert "ranks 0 and 1 both run on" in errors[r]
        assert "backend='gloo'" in errors[r]


# ---------------------------------------------------------------------
# BLT004 against the reference's emitter
# ---------------------------------------------------------------------

def _fields(d):
    return (d.code, d.severity, d.message, d.stage)


@pytest.mark.parametrize("shape,split", [((3, 4), 1), ((8, 4), 1),
                                         ((4, 3, 5), 2), ((6, 2), 2)])
def test_blt004_matches_reference(mesh, mesh2d, shape, split):
    for ref_mesh in (mesh, mesh2d):
        lay = convert.mesh_from_reference(ref_mesh.devices.shape,
                                          ref_mesh.axis_names)
        want, got = [], []
        ref_check._idle_device_check(ref_mesh, shape, split, 0, want, False)
        port_check._idle_device_check(lay, shape, split, 0, got, False)
        assert [_fields(d) for d in got] == [_fields(d) for d in want]
        assert all(isinstance(d, RefDiagnostic) for d in want)


# ---------------------------------------------------------------------
# pods of CPU ranks
# ---------------------------------------------------------------------

SCHED_INPUTS = {"x": np.arange(64.0).reshape(8, 8),
                "idle_x": np.random.RandomState(4).randn(3, 4),
                "main_x": np.random.RandomState(5).randn(8, 4)}


@pytest.fixture(scope="module")
def sched_pod():
    return harness.run_cluster(
        "sched", nproc=2, timeout=POD_WALL, inputs=SCHED_INPUTS,
        args={"mesh": [2], "names": ["k"], "skew_rank": 1}, device="cpu")


def test_schedule_digests_match_across_pod(sched_pod):
    """Matched schedules verify bit-identically: every rank folded the
    same program keys in the same order into the same digest."""
    r0, r1 = sched_pod
    assert r0["count_matched"] > 0
    assert r0["count_matched"] == r1["count_matched"]
    assert r0["digest_matched"] == r1["digest_matched"]
    assert np.array_equal(r0["sum"], r1["sum"])
    assert np.array_equal(r0["sum"], SCHED_INPUTS["x"].sum(0) + 8)


def test_schedule_skew_raises_pointed_divergence(sched_pod):
    """One extra program on ONE rank turns the next verify into a
    pointed ScheduleDivergenceError on EVERY rank, naming the diverging
    peer and the first divergent slot."""
    r0, r1 = sched_pod
    assert r1["skewed"] is True and r0["skewed"] is False
    assert r0["divergence"]["peer"] == 1
    assert r1["divergence"]["peer"] == 0
    for r in (r0, r1):
        d = r["divergence"]
        assert d is not None, r
        assert "diverged" in d["message"]
        # the skew was ONE extra program appended after the matched
        # prefix: the first divergent slot is exactly the shared count
        assert d["index"] == r["count_matched"]
    # the skewed rank's key log names the extra program it enqueued
    assert r1["divergence"]["local_key"], r1["divergence"]


def test_blt004_and_explain_on_a_live_mesh(sched_pod):
    m2 = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("k",))
    ref = ref_check.check(bolt.array(SCHED_INPUTS["idle_x"], m2)
                          .map(lambda v: v + 1))
    want = [_fields(d) for d in ref.diagnostics if d.code == "BLT004"]
    assert len(want) == 1
    for r in sched_pod:
        a = r["analysis"]
        got = [(d["code"], d["severity"], d["message"], d["stage"])
               for d in a["idle"] if d["code"] == "BLT004"]
        assert got == want
        assert "BLT004" not in a["busy"]
        # each stage's spec is the rank's box
        assert "mesh {'k': 2} rank %d" % r["rank"] in a["explain"]
        assert "box ((0, 3), (0, 4))" in a["explain"]


def test_kill_one_rank_raises_pointed_error():
    """kill -9 of ONE rank at its first barrier: its peer would wait
    there, so the harness ends it and names the dead rank."""
    with pytest.raises(RuntimeError,
                       match=r"rank 1 died \(exit code -9\)"):
        harness.run_cluster(
            "sleep", nproc=2, timeout=POD_WALL, args={"seconds": 0},
            device="cpu",
            worker_env={1: {"BOLT_CHAOS": "multihost.barrier:1:kill"}})


def test_pod_wall_limit_is_bounded():
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="wall limit of 5s"):
        harness.run_cluster("sleep", nproc=2, timeout=5,
                            args={"seconds": 120}, device="cpu")
    assert time.monotonic() - t0 < 30


def test_pod_device_is_the_callers_choice(capsys):
    """No pod starts on the CPU unless the caller names it: ``device`` is
    required by ``run_cluster`` and the CLI, and a CUDA spec raises where
    CUDA is missing, before any worker is spawned."""
    with pytest.raises(TypeError, match="device"):
        harness.run_cluster("sleep", nproc=2, args={"seconds": 0})
    with pytest.raises(SystemExit):
        harness.main(["--payload", "sleep", "--nproc", "2"])
    assert "--device is required" in capsys.readouterr().err
    with pytest.raises(ValueError, match="device must be"):
        harness.run_cluster("sleep", nproc=2, device="tpu")
    if not torch.cuda.is_available():
        for spec in ("cuda", "cuda:rank"):
            with pytest.raises(RuntimeError, match="asked for CUDA"):
                harness.run_cluster("sleep", nproc=2, device=spec)


def test_one_rank_pod_from_torchrun_environment(monkeypatch):
    """``initialize()`` with no arguments reads torchrun's variables
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and
    serves the pod's store over TCP on localhost."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    assert multihost.initialize(device=CPU, timeout=30) is True
    try:
        assert multihost.process_count() == 1
        assert multihost.backend() == "gloo"
        multihost.barrier("tcp")
        assert multihost.verify_schedule("tcp") == \
            engine.schedule_digest()[1]
    finally:
        assert multihost.shutdown() is True
