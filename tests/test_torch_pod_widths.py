"""Pod recovery of the port at the card's widths, and the checkpoint
topology remap: a manual reform of two CPU gloo ranks down to one and a
supervised pod shrinking to ONE rank and growing back through its
rejoin door (``chip_smoke.py`` phase 17's paths e and f, rehearsed at
the reference harness's size), the remap at 1 -> 2 on real pods and at
2 -> 1, 1 -> 2 and 4 -> 2 in one process, and ``heal_backend_init``
after a failed bring-up.  Split from ``tests/test_torch_pod_recovery.py``
so the two files' pods run on two test workers.

The bits are held against ``bolt_tpu``'s single-process streamed run of
the same crafted data on the tests' 8-device CPU mesh (exact in f32)
and against the unkilled pod; tolerances: bit for bit, the reference's
timing bounds.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest

import bolt_tpu as ref

from bolt_tpu_torch.parallel import harness
from bolt_tpu_torch.parallel.payloads import crafted

POD_WALL = 240


def ADD1(v):
    return v + 1


def _ref_sum(mesh, x, chunks):
    return np.asarray(ref.fromcallback(
        lambda idx: x[idx], x.shape, mesh, dtype=np.float32,
        chunks=chunks).map(ADD1).sum().toarray())


# ---------------------------------------------------------------------
# the card's widths (chip_smoke.py phase 17 rehearsed): a manual reform
# of two ranks down to one, and a supervised pod shrinking to ONE rank
# and growing back through the one-rank pod's rejoin door
# ---------------------------------------------------------------------

def test_manual_reform_to_one_rank(mesh):
    r = harness.run_reform_bench(nproc=2, device="cpu", timeout=POD_WALL,
                                 args={"stats": False})
    assert r["victim_rc"] == -9 and r["survivors"] == 1
    assert r["peer_lost_everywhere"] and r["barrier_peerlost"]
    assert r["bit_identical"] and r["sum_resumes"] == 1
    assert r["stale_checkpoint_files"] == [] and r["leaked_spans"] == 0
    s = r["killed"][0]
    assert s["new_nproc"] == 1 and s["new_pid"] == 0
    assert np.array_equal(s["sum"], _ref_sum(mesh, crafted(96, 8), 12))


def test_supervised_pod_shrinks_to_one_rank_and_grows_back(mesh):
    r = harness.run_supervise_bench(nproc=2, device="cpu",
                                    timeout=POD_WALL)
    assert r["victim_rc"] == -9 and r["survivors"] == 1
    assert r["nproc_after_a"] == 1 and r["budget_share_after_a"] == 0.5
    assert r["rejoined"] == 1 and r["nproc_final"] == 2
    assert r["budget_share_after_b"] == 1.0 and r["b_resumes"] >= 1
    assert r["bit_identical"]
    want = _ref_sum(mesh, crafted(96, 8), 12)
    for e in r["elastic"]:
        if e is not None:
            assert np.array_equal(e["sumB"], want), e["rank"]
    assert r["arbiter_bytes"] == 0 and r["leaked_spans"] == 0
    assert r["stale_ckpt"] == [] and r["stale_markers"] == 0


# ---------------------------------------------------------------------
# the topology remap on real pods: 1 -> 2, and in one process with
# faked widths: 2 -> 1, 4 -> 2
# ---------------------------------------------------------------------

def test_remap_one_process_checkpoint_resumes_on_a_pod(mesh):
    """A one-rank run killed -9 mid-stream leaves a single-process
    checkpoint; a two-rank pod resumes it (a growth) with each rank's
    own rows, and ends with the clean sum's bits."""
    ck = tempfile.mkdtemp(prefix="bolt-pod-remap12-")
    try:
        rcs = harness.run_cluster(
            "resume", 1, timeout=POD_WALL, device="cpu",
            args={"ckpt": ck}, expect_dead=True,
            env={"BOLT_CHAOS": "stream.dispatch:5:kill",
                 "BOLT_CHECKPOINT_EVERY": "1"})
        assert rcs == [-9]
        assert "stream_state.npz" in os.listdir(ck)
        res = harness.run_cluster("resume", 2, timeout=POD_WALL,
                                  device="cpu", args={"ckpt": ck},
                                  env={"BOLT_CHECKPOINT_EVERY": "1"})
        want = _ref_sum(mesh, crafted(64, 8), 8)
        for r in res:
            assert r["resumes"] == 1 and 0 < r["slabs"] < 8, r
            assert np.array_equal(r["sum"], want)
        assert os.listdir(ck) == []
    finally:
        shutil.rmtree(ck, ignore_errors=True)


@pytest.fixture
def fake_pod(monkeypatch):
    """A faked pod of a settable width and rank for the checkpoint layer
    (no-op barriers)."""
    from bolt_tpu_torch.parallel import multihost
    cell = {"pid": 0, "nproc": 1}
    monkeypatch.setattr(multihost, "process_count", lambda: cell["nproc"])
    monkeypatch.setattr(multihost, "process_index", lambda: cell["pid"])
    monkeypatch.setattr(multihost, "barrier", lambda name: None)
    return cell


@pytest.mark.parametrize("old,new", [(2, 1), (1, 2), (4, 2)])
def test_remap_widths(tmp_path, fake_pod, old, new):
    """A checkpoint cut at width ``old`` resumes at width ``new`` on
    every new rank, reporting the remap, and the resumed run's clear
    leaves nothing behind."""
    from bolt_tpu_torch import checkpoint
    fp = ("fp-remap", "topology-%d" % old)
    val = np.arange(6, dtype=np.float32) * 0.5
    fake_pod["nproc"] = old
    for pid in range(old):
        fake_pod["pid"] = pid
        checkpoint.stream_save(str(tmp_path), fp, 3, 36,
                               ([val], None), multiprocess=old > 1)
    fp2 = ("fp-remap", "topology-%d" % new)
    fake_pod["nproc"] = new
    for pid in range(new):
        fake_pod["pid"] = pid
        info = {}
        got = checkpoint.stream_load(str(tmp_path), fp2,
                                     multiprocess=new > 1, info=info)
        assert got[:2] == (3, 36), (old, new, pid)
        assert np.array_equal(got[2][0][0].numpy(), val)
        assert info == {"remapped_from": old}
    fake_pod["pid"] = 0
    checkpoint.stream_clear(str(tmp_path), multiprocess=new > 1)
    assert [p for p in os.listdir(str(tmp_path))
            if p.startswith("stream_")] == []


def test_heal_backend_init_after_a_failed_bring_up(tmp_path):
    """A reform whose peer never arrives fails its bring-up within its
    ``init_timeout``; ``heal_backend_init`` then finds the live store,
    drops the half state and reports it (the reference's contract: True
    only against a live store), and no pod is left up."""
    import torch
    import torch.distributed as dist
    from bolt_tpu_torch import obs
    from bolt_tpu_torch.parallel import multihost
    assert multihost.heal_backend_init() is False       # nothing failed
    obs.clear()
    obs.enable()
    try:
        with pytest.raises(Exception):
            multihost.reform(store_path=str(tmp_path / "store"),
                             num_processes=2, process_id=0,
                             device=torch.device("cpu"), backend="gloo",
                             init_timeout=2)
        assert not multihost.is_initialized()
        assert multihost.heal_backend_init() is True
        assert not dist.is_initialized()
        assert [e for e in obs.spans()
                if e.name == "multihost.backend_heal"]
    finally:
        obs.disable()
