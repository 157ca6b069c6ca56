"""Streamed pods of the port (``bolt_tpu_torch/stream.py`` on a mesh of
several ranks, ``parallel/multihost.py :: local_slab_spec``, the pod
shuffle, per-rank checkpoint shards, BLT012) against the reference's
``tests/test_multihost.py`` clusters, on CPU gloo pods.

Pods come from ``bolt_tpu_torch/parallel/harness.py`` (``device="cpu"``),
one module-scoped pod serving many asserts: two ranks for the parity,
codec and swap payloads (``parallel/payloads.py :: payload_stream_suite``),
four ranks for a ``(2, 2)`` mesh whose second axis replicates the keys
and for the sub-pod checkpoint refusal, and the resume trio (a clean
run, a run killed -9 on every rank, a restarted run).  The inputs are
the reference harness's crafted data (``payloads.crafted``, made with
numpy), on which every fold is exact.  The reference's side is its own
single-process streamed run on the tests' 8-device CPU mesh with x64
on; its ``test_multihost.py`` proves that run equals its pod run.

Tolerances: bit for bit everywhere (sums, ``stats("sum", "var")``, the
swap's boxes, the resumed sum, byte counts, messages), except the
``bf16`` codec, held at ``rtol=1e-2`` as the reference holds it.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest

import bolt_tpu as ref

from bolt_tpu_torch.parallel import harness
from bolt_tpu_torch.parallel.payloads import crafted

N, VDIM, CHUNKS = 64, 8, 16
POD_WALL = 120


def ADD1(v):
    return v + 1


def _ref_stream(mesh, x, chunks=CHUNKS):
    return ref.fromcallback(lambda idx: x[idx], x.shape, mesh,
                            dtype=np.float32, chunks=chunks)


@pytest.fixture(scope="module")
def reference(mesh):
    """The reference's single-process streamed runs of the crafted
    source (the 8-device CPU mesh)."""
    x = crafted(N, VDIM)
    st = _ref_stream(mesh, x).map(ADD1).stats("sum", "var")
    blocks = [x[i:i + CHUNKS] for i in range(0, N, CHUNKS)]
    fi = ref.fromiter(blocks, x.shape, mesh, dtype=np.float32)
    return {"sum": np.asarray(_ref_stream(mesh, x).map(ADD1).sum()
                              .toarray()),
            "stats_sum": np.asarray(st["sum"].toarray()),
            "stats_var": np.asarray(st["var"].toarray()),
            "fromiter_sum": np.asarray(fi.map(ADD1).sum().toarray())}


@pytest.fixture(scope="module")
def pod2():
    spill = tempfile.mkdtemp(prefix="bolt-pod-spill-")
    try:
        yield harness.run_cluster("stream_suite", 2, timeout=POD_WALL,
                                  device="cpu", args={"spill": spill})
    finally:
        shutil.rmtree(spill, ignore_errors=True)


@pytest.fixture(scope="module")
def pod4():
    ck = tempfile.mkdtemp(prefix="bolt-pod-ck4-")
    arr = tempfile.mkdtemp(prefix="bolt-pod-arr-")
    try:
        yield harness.run_cluster("pod_extras", 4, timeout=POD_WALL,
                                  device="cpu",
                                  args={"ckpt": ck, "array_dir": arr}), \
            ck, arr
    finally:
        shutil.rmtree(ck, ignore_errors=True)
        shutil.rmtree(arr, ignore_errors=True)


@pytest.fixture(scope="module")
def resumed():
    """A clean checkpointed pod run, the same run killed -9 on every rank
    at its 7th slab dispatch (checkpoints every slab, so the ranks write
    in lockstep), the restarted pod resuming from the shards, and a
    one-rank run over the killed run's checkpoint (another width: the
    topology remap).  The
    kill is at the consumer's seam, before the slab's exchange, so no
    rank can be left in an exchange its peer never joins: each dies by
    its own fault, whatever the host's load."""
    ck_clean = tempfile.mkdtemp(prefix="bolt-pod-ckA-")
    ck = tempfile.mkdtemp(prefix="bolt-pod-ckB-")
    ck_width = tempfile.mkdtemp(prefix="bolt-pod-ckC-")
    try:
        out = {"clean": harness.run_cluster(
            "resume", 2, timeout=POD_WALL, device="cpu",
            args={"ckpt": ck_clean})}
        out["clean_left"] = sorted(os.listdir(ck_clean))
        out["rcs"] = harness.run_cluster(
            "resume", 2, timeout=POD_WALL, device="cpu", args={"ckpt": ck},
            expect_dead=True, env={"BOLT_CHAOS": "stream.dispatch:7:kill",
                                   "BOLT_CHECKPOINT_EVERY": "1"})
        out["killed_left"] = sorted(os.listdir(ck))
        shutil.copytree(ck, ck_width, dirs_exist_ok=True)
        out["resumed"] = harness.run_cluster(
            "resume", 2, timeout=POD_WALL, device="cpu", args={"ckpt": ck},
            env={"BOLT_CHECKPOINT_EVERY": "1"})
        out["resumed_left"] = sorted(os.listdir(ck))
        out["other_width"] = harness.run_cluster(
            "resume", 1, timeout=POD_WALL, device="cpu",
            args={"ckpt": ck_width}, env={"BOLT_CHECKPOINT_EVERY": "1"})
        out["width_left"] = sorted(os.listdir(ck_width))
        yield out
    finally:
        for d in (ck_clean, ck, ck_width):
            shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------
# parity: the pod's streamed results against the reference's run
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sum", "stats_sum", "stats_var",
                                  "fromiter_sum"])
def test_pod_stream_bit_identical_to_reference(pod2, reference, name):
    want = reference[name]
    for r in pod2:
        got = r["parity"][name]
        assert got.dtype == want.dtype and np.array_equal(got, want), \
            (r["rank"], name)


def test_each_rank_produced_only_its_rows(pod2):
    for r in pod2:
        p = r["parity"]
        assert p["rows_produced"] == p["rows_expected"] == 3 * (N // 2), p
        # two streamed sum passes of 32 local records x 8 f32 values
        assert p["transfer_bytes"] == 2 * 32 * VDIM * 4, p


def test_second_pass_builds_nothing(pod2):
    for r in pod2:
        assert r["parity"]["recompiles_second_pass"] == 0, r["parity"]


def test_blt012_uneven_slab_refused_and_forecast(pod2):
    for r in pod2:
        p = r["parity"]
        assert p["blt012_refused"].startswith("BLT012: slab [0, 3) holds 3 "
                                              "records, not divisible by "
                                              "the 2-way"), p
        assert p["blt012_forecast"] is True


def test_oneshot_iterator_refused_and_no_span_leaks(pod2):
    for r in pod2:
        p = r["parity"]
        assert "RE-ITERABLE" in p["oneshot_refused"]
        assert "one-shot" in p["oneshot_refused"]
        assert p["leaked_spans"] == 0


def test_explain_names_every_ranks_rows(pod2):
    text = pod2[0]["parity"]["explain"]
    assert "MULTI-PROCESS: 2 ranks x ~8 records/slab" in text, text
    assert "rank 0 rows [0, 8), rank 1 rows [8, 16)" in text, text


def test_codec_pod_local_shards_encode_and_fold(pod2):
    raw0 = pod2[0]["codec"]["raw"]
    for r in pod2:
        c = r["codec"]
        assert np.array_equal(c["raw"], raw0)
        assert np.array_equal(c["delta"], raw0), r["rank"]
        assert np.allclose(c["bf16"], raw0, rtol=1e-2), r["rank"]
        assert c["bf16_bytes"] * 2 == c["raw_bytes"], c
        assert c["delta_bytes"] == c["raw_bytes"], c
        assert "sidecar" in c["sidecar_refused"] \
            and "'int8'" in c["sidecar_refused"], c
        assert c["leaked_spans"] == 0


def test_pod_streamed_swap_bit_identical(pod2):
    oracle = np.transpose(crafted(N, VDIM), (1, 0))
    rows = oracle.shape[0] // 2
    for r in pod2:
        s = r["swap"]
        k = r["rank"]
        assert s["box"] == [[k * rows, (k + 1) * rows], [0, N]]
        assert np.array_equal(s["streamed"], s["materialised"]), k
        assert np.array_equal(s["streamed"],
                              oracle[k * rows:(k + 1) * rows]), k
        assert s["lazy_after_swap"] is True
        assert s["shuffle_bytes"] > 0 and s["spill_bytes"] == 0, s
        assert "single-process only" in s["pod_spill_refused"], s
        assert s["leaked_spans"] == 0


def test_retried_dispatch_on_one_rank_keeps_bits_and_schedule(pod2):
    r0, r1 = (r["retried"] for r in pod2)
    assert (r0["retries"], r1["retries"]) == (0, 1)
    for r in (r0, r1):
        assert np.array_equal(r["retried"], r["clean"])
    assert np.array_equal(r0["retried"], r1["retried"])
    assert r0["digest"] == r1["digest"]


def test_pod_stream_equals_the_one_rank_run(pod2):
    """The reference harness's ``single_ref`` on a one-rank pod: the same
    loader and pipelines as one device."""
    one = harness.run_cluster("single_ref", 1, timeout=POD_WALL,
                              device="cpu")[0]
    for key in ("sum", "stats_sum", "stats_var", "fromiter_sum"):
        for r in pod2:
            assert np.array_equal(r["parity"][key], one[key]), key


def test_a_fault_on_one_rank_ends_the_pod_naming_it(tmp_path):
    """An error raised on one rank only (its 3rd upload) fails that rank;
    the harness ends its peer, left in the slab's exchange, and names
    the rank that failed."""
    with pytest.raises(RuntimeError, match="rank 1 died"):
        harness.run_cluster("resume", 2, timeout=POD_WALL, device="cpu",
                            args={"ckpt": str(tmp_path)},
                            worker_env={1: {"BOLT_CHAOS":
                                            "stream.upload:3:raise"}})


# ---------------------------------------------------------------------
# four ranks: a replicating mesh axis and the sub-pod refusal
# ---------------------------------------------------------------------

def test_replicating_mesh_axis_folds_exactly(pod4, mesh):
    res = pod4[0]
    xq = crafted(6, 4, 4)
    want = np.asarray(_ref_stream(mesh, xq, chunks=2).map(ADD1).sum()
                      .toarray())
    for r in res:
        assert r["replicated_spec"] == ["a", None], r
        assert np.array_equal(r["replicated_sum"], want), r["rank"]
        assert np.array_equal(r["replicated_sum"], (xq + 1).sum(axis=0))


def test_sub_pod_checkpoint_refused(pod4):
    res, ck = pod4[:2]
    for r in res[:2]:
        assert r["sub_pod_refused"].startswith(
            "resumable checkpointing on a SUB-POD mesh is not supported: "
            "this mesh spans 2 of the runtime's 4 processes"), r
    assert os.listdir(ck) == []


def test_mesh_array_checkpoint_is_a_shard_a_rank(pod4):
    """``checkpoint.save``/``load`` of a mesh array: each rank writes and
    reads back its own box, bit for bit; rank 0 writes the meta; a single
    process cannot load the shards onto a device."""
    import json
    import torch
    import bolt_tpu_torch.checkpoint as tckpt
    res, _, arr = pod4
    xq = crafted(6, 4, 4)
    for r in res:
        a = r["array"]
        assert np.array_equal(a["loaded_box"], a["saved_box"]), r["rank"]
        assert np.array_equal(a["value"], xq + 1)
        assert a["spec"] == ["a", None] and a["shape"] == [6, 4]
        lo, hi = a["box"][0]
        assert np.array_equal(a["loaded_box"], (xq + 1)[lo:hi])
    assert sorted(os.listdir(arr)) == ["array.p%d.npy" % r for r in
                                       range(4)] + ["bolt_meta.json"]
    with open(os.path.join(arr, "bolt_meta.json")) as f:
        meta = json.load(f)
    assert meta["format"] == "npy-shards"
    assert meta["mesh"] == [["a", "b"], [2, 2]]
    assert meta["boxes"] == [[[0, 3], [0, 4]], [[0, 3], [0, 4]],
                             [[3, 6], [0, 4]], [[3, 6], [0, 4]]]
    with pytest.raises(ValueError, match="load it onto a mesh of that "
                                         "layout"):
        tckpt.load(arr, context=torch.device("cpu"))


# ---------------------------------------------------------------------
# kill -9 on every rank, then resume from the per-rank shards
# ---------------------------------------------------------------------

def test_clean_pod_run_leaves_no_checkpoint(resumed, mesh):
    want = np.asarray(_ref_stream(mesh, crafted(N, VDIM), chunks=8)
                      .map(ADD1).sum().toarray())
    for r in resumed["clean"]:
        assert r["resumes"] == 0 and r["slabs"] == 8, r
        assert np.array_equal(r["sum"], want)
    assert resumed["clean_left"] == []


def test_kill_on_every_rank_leaves_a_shard_per_rank(resumed):
    assert resumed["rcs"] == [-9, -9]
    left = resumed["killed_left"]
    assert "stream_meta.json" in left
    shards = [p for p in left if p.startswith("stream_state.p")
              and p.endswith(".npz")]
    assert {p.split(".")[1] for p in shards} == {"p0", "p1"}, left


def test_restarted_pod_resumes_bit_for_bit(resumed):
    ref_sum = resumed["clean"][0]["sum"]
    for r in resumed["resumed"]:
        assert r["resumes"] == 1, r
        assert 0 < r["slabs"] < 8, r      # only the tail streamed again
        assert np.array_equal(r["sum"], ref_sum)
    assert resumed["resumed_left"] == []


def test_checkpoint_of_another_width_refused(resumed):
    # no longer refused: the one-rank run adopts the two-rank pod's
    # shards through the topology remap and ends with the clean sum
    r = resumed["other_width"][0]
    assert r["resumes"] == 1 and 0 < r["slabs"] < 8, r
    assert np.array_equal(r["sum"], resumed["clean"][0]["sum"])
    assert resumed["width_left"] == []
