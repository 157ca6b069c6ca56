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
    ("reform", "A12c"), ("heal_backend_init", "A12c")])
def test_later_slices_raise_naming_their_item(name, item):
    # A12c (pod recovery) is ported: neither door names a later slice.
    # reform with no width refuses pointedly; heal_backend_init with no
    # failed bring-up to clean up returns False
    if name == "reform":
        with pytest.raises(ValueError, match="num_processes"):
            multihost.reform()
    else:
        assert multihost.heal_backend_init() is False


# ---------------------------------------------------------------------
# the streamed pod's helpers in one process (``test_multihost.py``'s
# in-process half and ``test_codec.py``'s sidecar rule)
# ---------------------------------------------------------------------

def test_local_slab_spec_identity_single_process():
    mesh = default_mesh(devices=[CPU])
    spec = multihost.local_slab_spec(mesh, (64, 8), 1)
    assert spec.nproc == 1
    assert spec.local_range(0, 16) == (0, 16)
    assert spec.local_range(48, 64) == (48, 64)
    # source-like duck typing (a StreamSource)
    src = tbolt.fromcallback(lambda idx: np.zeros((8, 4), np.float32)[idx],
                             (8, 4), mesh, dtype=np.float32)._stream
    spec2 = multihost.local_slab_spec(src)
    assert spec2.shape == (8, 4) and spec2.split == 1


def test_slab_divisibility_single_process_is_quiet():
    mesh = default_mesh(devices=[CPU])
    assert multihost.slab_divisibility_error(
        mesh, (7, 3), 1, [(0, 7)]) is None


def test_per_process_flag_single_process_parity(mesh):
    """per_process=True on one rank is the plain streaming path: one
    loader runs unchanged from one card to a pod (and both equal the
    reference's run)."""
    one = default_mesh(devices=[CPU])
    x = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)

    def make(per_process):
        return tbolt.fromcallback(lambda idx: x[idx], (64, 4), one,
                                  dtype=np.float32, chunks=16,
                                  per_process=per_process)

    a = make(True).map(lambda v: v + 1).sum().toarray()
    b = make(False).map(lambda v: v + 1).sum().toarray()
    want = np.asarray(bolt.fromcallback(
        lambda idx: x[idx], (64, 4), mesh, dtype=np.float32, chunks=16,
        per_process=True).map(lambda v: v + 1).sum().toarray())
    assert np.array_equal(a, b) and np.array_equal(a, want)


def test_per_process_requires_dtype():
    one = default_mesh(devices=[CPU])
    with pytest.raises(ValueError, match="explicit dtype") as mine:
        tbolt.fromcallback(lambda idx: np.zeros((4, 2))[idx], (4, 2), one,
                           per_process=True)
    with pytest.raises(ValueError) as theirs:
        bolt.fromcallback(lambda idx: np.zeros((4, 2))[idx], (4, 2),
                          jax.make_mesh((8,), ("k",)), per_process=True)
    assert str(mine.value) == str(theirs.value)


def test_sidecar_codec_error_names_the_pod_rule(monkeypatch):
    from bolt_tpu_torch.gpu import codec as codeclib
    monkeypatch.setattr(multihost, "mesh_process_count", lambda m: 3)
    msg = multihost.sidecar_codec_error(codeclib.get("int8"), None)
    assert "int8" in msg and "sidecar" in msg and "bf16" in msg
    assert "spanning 3 processes" in msg
    assert multihost.sidecar_codec_error(codeclib.get("bf16"),
                                         None) is None
    assert multihost.sidecar_codec_error(codeclib.get("delta-f32"),
                                         None) is None
    assert multihost.sidecar_codec_error(None, None) is None


_DIVIDE_CASES = [
    ((64, 8), 1, [(0, 16), (16, 32)]),
    ((64, 8), 1, [(0, 3)]),
    ((64, 8), 1, [(0, 16), (16, 20)]),
    ((7, 3), 1, [(0, 7)]),
    ((24, 6, 4), 2, [(0, 8), (8, 16)]),
    ((16, 2, 5), 2, [(0, 4)]),
]


@pytest.mark.parametrize("shape,split,ranges", _DIVIDE_CASES)
def test_slab_divisibility_error_is_the_references(
        monkeypatch, mesh2d, shape, split, ranges):
    """BLT012's verdict and message, on a pod of the reference's (4, 2)
    mesh shape, equal the reference's word for word."""
    from bolt_tpu.parallel import multihost as ref_mh
    lay = convert.mesh_from_reference((4, 2), ("a", "b"))
    monkeypatch.setattr(multihost, "mesh_process_count", lambda m: 8)
    monkeypatch.setattr(ref_mh, "mesh_process_count", lambda m: 8)
    got = multihost.slab_divisibility_error(lay, shape, split, ranges)
    want = ref_mh.slab_divisibility_error(mesh2d, shape, split, ranges)
    assert got == want
    assert multihost.key_collective_axes(lay, shape, split) == \
        ref_mh.key_collective_axes(mesh2d, shape, split)


@pytest.mark.parametrize("rank,want", [(0, (0, 4)), (1, (4, 8)),
                                       (3, (12, 16))])
def test_local_slab_spec_ranges_of_a_pod(monkeypatch, rank, want):
    """Each rank's rows of a 16-record slab on a 4-rank pod, in global
    record coordinates; an uneven slab is BLT012."""
    lay = convert.mesh_from_reference((4,), ("k",))
    monkeypatch.setattr(multihost, "mesh_process_count", lambda m: 4)
    monkeypatch.setattr(type(lay), "rank", property(lambda self: rank))
    spec = multihost.local_slab_spec(lay, (64, 8), 1)
    assert spec.local_range(0, 16) == want
    assert spec.local_range(32, 48) == (32 + want[0], 32 + want[1])
    with pytest.raises(ValueError, match="BLT012: slab"):
        spec.local_range(0, 6)


def test_local_slab_spec_refuses_a_box_that_is_not_whole_records(
        monkeypatch):
    """Two key axes split over a (2, 2) mesh: a rank's box of a slab is
    not whole records, so no per-rank ingest range exists."""
    lay = convert.mesh_from_reference((2, 2), ("a", "b"))
    monkeypatch.setattr(multihost, "mesh_process_count", lambda m: 4)
    spec = multihost.local_slab_spec(lay, (8, 4, 3), 2)
    with pytest.raises(ValueError, match="process boundary on the "
                                         "leading key axis"):
        spec.local_range(0, 4)


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
