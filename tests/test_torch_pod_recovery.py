"""Pod recovery of the port on real CPU gloo pods: counterparts of the
reference's cluster tests in ``tests/test_multihost.py`` (the 3 -> 2
reform, the supervised 3 -> 2 -> 3 scenario, the pre-collective death
bound, the serving layer's degradation) and the raw gloo error a dead
peer leaves; ``tests/test_torch_pod_widths.py`` holds the card's widths
and the topology remap.

Pods come from ``bolt_tpu_torch/parallel/harness.py`` (``device="cpu"``);
the victim dies by ``BOLT_CHAOS=stream.upload:N:kill``, a replacement
process joins through ``parallel.supervisor.attach``.  The reference's
own cluster runs of these scenarios cannot run here (its
``multihost.reform`` re-initialises ``jax.distributed`` in one process,
which this jax refuses), so the contract is its tests' assertions, and
the bits are held against two oracles: the unkilled pod at the smaller
width (the same payload with no victim) and ``bolt_tpu``'s
single-process streamed run of the same crafted data on the tests'
8-device CPU mesh (exact in f32: integer-valued sums, period-aligned
moments).  Tolerances: bit for bit; the timing bounds are the
reference's (detection within 2x ``BOLT_POD_TIMEOUT``, recovery under
2x the clean wall, the elastic scenario under 2.5x).
"""

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


def _ref_stats(mesh, x, chunks):
    st = ref.fromcallback(lambda idx: x[idx], x.shape, mesh,
                          dtype=np.float32, chunks=chunks).map(ADD1) \
        .stats("sum", "var")
    return np.asarray(st["sum"].toarray()), np.asarray(st["var"].toarray())


@pytest.fixture(scope="module")
def reform():
    """ONE 3-rank kill -9 scenario and its clean 2-rank baseline
    (``harness.run_reform_bench``: 96 keys, ``chunks=12``, ``vdim=8``)."""
    return harness.run_reform_bench(device="cpu", timeout=POD_WALL)


@pytest.fixture(scope="module")
def elastic():
    """ONE supervised 3 -> 2 -> 3 scenario and its clean 3-rank run
    (``harness.run_supervise_bench``)."""
    return harness.run_supervise_bench(device="cpu", timeout=POD_WALL)


# ---------------------------------------------------------------------
# the manual reform (the reference's reform tests)
# ---------------------------------------------------------------------

def test_kill_raises_peerlost_on_every_survivor(reform):
    """kill -9 of ONE rank: every survivor raises PeerLostError naming
    it (no hang), within 2x the watchdog deadline of the death."""
    assert reform["victim_rc"] == -9
    assert reform["survivors"] == 2
    assert reform["peer_lost_everywhere"]
    assert reform["detection_s"] <= 2 * reform["pod_timeout"], reform
    for r in reform["killed"]:
        if r is not None:
            assert r["caught_peer"] == 1 and r["dead_peers"] == [1], r
            # an exchange names its slab; a checkpoint's barrier (the
            # reference's observed case) names the barrier
            assert r["caught_slab"] is not None \
                or "barrier" in r["caught_phase"], r


def test_watchdog_barrier_converts_on_survivors(reform):
    assert reform["barrier_peerlost"]
    assert reform["barrier_s"] <= 2 * reform["pod_timeout"], reform


def test_reform_and_resume_bit_identical(reform, mesh):
    """reform onto the 2 survivors and resume from the 3-rank checkpoint
    (the topology remap): the unkilled 2-rank run's bits, and
    ``bolt_tpu``'s single-process run's, for the streamed sum and for
    the ``stats("sum", "var")`` whose resume rides the abort-path
    checkpoint."""
    assert reform["bit_identical"]
    assert reform["sum_resumes"] >= 2        # one a survivor
    assert reform["stats_resumes"] >= 2
    want = _ref_sum(mesh, crafted(96, 8), 12)
    ssum, svar = _ref_stats(mesh, crafted(128, 8), 16)
    for r in reform["killed"]:
        if r is None:
            continue
        assert np.array_equal(r["sum"], want), r["rank"]
        assert np.array_equal(r["stats_sum"], ssum), r["rank"]
        assert np.array_equal(r["stats_var"], svar), r["rank"]
        # the same device and backend, no kernel library rebuilt
        assert r["new_device"] == "cpu" and r["new_backend"] == "gloo"
        assert r["reform_builds"] == 0
        assert r["new_nproc"] == 2 and r["new_pid"] in (0, 1)


def test_reform_recovery_bounded_and_clean(reform):
    assert reform["recovery_over_clean"] < 2.0, reform
    assert reform["stale_checkpoint_files"] == []
    assert reform["leaked_spans"] == 0


# ---------------------------------------------------------------------
# the supervised scenario (the reference's elastic tests)
# ---------------------------------------------------------------------

def test_supervised_shrink_is_automatic(elastic):
    """kill -9 under Server(supervise=True): the survivors' futures
    succeed with no caller intervention, detection within 2x the
    deadline, and the arbiter budget follows the surviving share."""
    assert elastic["victim_rc"] == -9
    assert elastic["survivors"] == 2
    assert elastic["detection_s"] <= 2 * elastic["pod_timeout"], elastic
    assert elastic["a_resumes"] >= 1 or elastic["b_resumes"] >= 1
    assert elastic["reforms"] >= 1
    assert elastic["nproc_after_a"] == 2
    assert abs(elastic["budget_share_after_a"] - 2 / 3) < 1e-6


def test_rejoin_re_expands_the_pod(elastic):
    assert elastic["rejoined"] == 1
    assert elastic["rejoins"] >= 1
    assert elastic["nproc_final"] == 3
    assert elastic["b_resumes"] >= 1
    assert elastic["budget_share_after_b"] == 1.0
    (rj,) = [r for r in elastic["elastic"] if r and r["rejoiner"]]
    assert rj["new_nproc"] == 3 and rj["new_pid"] == 2


def test_elastic_bit_identical_and_bounded(elastic, mesh):
    """Every artifact of the 3 -> 2 -> 3 scenario equals the unkilled
    3-rank run's bits and ``bolt_tpu``'s single-process run's; the
    scenario stays under 2.5x the clean wall and nothing leaks."""
    assert elastic["bit_identical"]
    want = _ref_sum(mesh, crafted(96, 8), 12)
    ssum, svar = _ref_stats(mesh, crafted(96, 8, period=4), 24)
    for r in elastic["elastic"]:
        if r is None:
            continue
        if not r["rejoiner"]:
            assert np.array_equal(r["sumA"], want), r["rank"]
        assert np.array_equal(r["sumB"], want), r["rank"]
        assert np.array_equal(r["statsC_sum"], ssum), r["rank"]
        assert np.array_equal(r["statsC_var"], svar), r["rank"]
    assert elastic["scenario_over_clean"] < 2.5, elastic
    assert elastic["arbiter_bytes"] == 0
    assert elastic["leaked_spans"] == 0
    assert elastic["stale_ckpt"] == []
    assert elastic["stale_markers"] == 0


def test_blt014_and_explain_on_the_live_pod(elastic):
    assert elastic["blt014"]
    assert elastic["explain_supervised"]


# ---------------------------------------------------------------------
# the pre-collective bound, serving, the raw gloo error
# ---------------------------------------------------------------------

def test_pre_collective_death_bounded():
    """A peer killed BEFORE the first exchange: the survivor's readiness
    rendezvous raises PeerLostError within 2x BOLT_POD_TIMEOUT of the
    death (dated by the victim's last heartbeat: the victim dies only
    once its own first run reached an upload)."""
    r = harness.run_precollective_probe(device="cpu", timeout=POD_WALL)
    assert r["victim_rc"] == -9
    assert r["pre_peerlost"] is True, r
    assert r["pre_after_death"] <= 2 * r["pod_timeout"], r
    assert "ready" in (r["pre_phase"] or "")
    assert r["pre_peer"] == 1


def test_serve_pod_degrades_instead_of_deadlocking(tmp_path):
    """A serving tenant's in-flight future FAILS with PeerLostError when
    a pod peer dies mid-stream, the arbiter reads zero bytes after the
    abort, and admission drains until the reform notification."""
    res, rcs = harness.run_cluster(
        "serve_pod", 2, timeout=POD_WALL, device="cpu", tolerate={1},
        env={"BOLT_POD_TIMEOUT": 2,
             "BOLT_POD_HB_DIR": str(tmp_path / "hb")},
        worker_env={1: {"BOLT_CHAOS": "stream.upload:5:kill"}})
    assert rcs[1] == -9
    r = res[0]
    assert r["future_error"] == "PeerLostError", r
    assert r["future_peer"] == 1
    assert r["arbiter_bytes_after_abort"] == 0
    assert r["pod_paused"] and r["pod_resumed"]
    assert r["leaked_spans"] == 0


def test_gloo_error_of_a_dead_peer_is_classified():
    """With the watch off, what the installed torch's gloo raises at a
    survivor's next collective once its peer died, and that
    ``podwatch.is_transport_error`` classifies it."""
    res, rcs = harness.run_cluster(
        "raw_error", 2, timeout=POD_WALL, device="cpu", tolerate={1},
        env={"BOLT_POD_TIMEOUT": 0, "BOLT_POD_EXIT_BARRIER": 0},
        worker_env={1: {"BOLT_CHAOS": "multihost.collective:2:kill"}})
    assert rcs[1] == -9
    r = res[0]
    assert r["watch"] is False
    assert r["error"] is not None, r
    assert "Connection closed by peer" in r["error"] \
        or "Connection reset" in r["error"], r["error"]
    assert r["classified"] is True
