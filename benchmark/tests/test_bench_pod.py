"""A cell of several cards runs as a pod (``pod.py``), rehearsed here on
the CPU under gloo at a small size: a sound run is correct on 2 and 4
ranks, every rank runs the same passes to the same bits, the blocked
dataset does not depend on the rank count, a broken fold and a dead or
stuck rank are caught, and a one-chip cell's data is what it was."""

import hashlib
import json
import os
import subprocess
import sys
import time

import pytest

from conftest import ROOT, small

FAULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "pod_faults.py")


def _launch(world, seed=2 ** 31 + 4321, seconds=0.3, trace=0, fault=None,
            wall_s=120, mesh=None, axes=None, backend="gloo"):
    from benchmark import pod
    overrides = small("ns.mesh4")
    config = dict(overrides["config"], mesh=mesh or [world],
                  mesh_axes=axes or ["k"])
    if backend is None:
        config["backend"] = "gloo"
    args = {"mode": "run", "workload": "ns.mesh4", "seed": seed,
            "seconds": seconds, "trace": trace, "t_start": time.time(),
            "backend": backend, "device": "cpu",
            "overrides": dict(overrides, config=config)}
    command = [sys.executable, FAULTS, fault] if fault else None
    t = time.time()
    rc, out, err, wrong = pod.launch(args, world, wall_s=wall_s,
                                     command=command)
    res = None
    if out.strip():
        res = json.loads(out.strip().splitlines()[-1])
    return {"rc": rc, "result": res, "err": err, "wrong": wrong,
            "seconds": time.time() - t}


@pytest.fixture(scope="module")
def pods():
    return {w: _launch(w) for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_a_pod_run_is_correct(pods, world):
    from benchmark import harness
    run = pods[world]
    assert run["rc"] == 0 and run["wrong"] is None, run["err"][-3000:]
    res = run["result"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["device"]["count"] == world
    assert set(res["metrics"]) == {m["name"] for m in harness.for_cell(
        harness.benchmark_spec()["end_to_end"], "ns.mesh4")}
    assert {"scan_gbps.pod", "pass_ms_p95.pod"} <= set(res["metrics"])
    limits = harness.load_cell("ns.mesh4")[3]["limits"]
    assert set(res["checks"]) == set(limits)
    assert res["checks"]["ranks.agree"] == {"value": 0.0, "limit": 0.0}


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_runs_the_same_passes_to_the_same_bits(pods, world):
    res = pods[world]["result"]
    assert res["pod"]["passes"] == [res["attempted"]] * world
    assert res["checks"]["ranks.agree"]["value"] == 0.0
    assert res["pod"]["collective_bytes"] > 0


def test_the_mesh_and_backend_are_the_configurations():
    """The pod runs the mesh its configuration states, over the backend
    it states, and refuses a mesh that does not hold its ranks."""
    run = _launch(2, mesh=[2, 1], axes=["k", "v"], backend=None)
    assert run["rc"] == 0, run["err"][-3000:]
    assert run["result"]["correct"] is True, run["result"]["checks"]
    wrong = _launch(2, mesh=[4])
    assert wrong["rc"] != 0 and wrong["result"] is None
    assert "does not hold 2 ranks" in wrong["err"]


def test_a_pod_reports_the_metrics_of_its_own_cell():
    """A pod cell reports the per-layer metrics that list it and those
    that list no cell and move an end-to-end metric it reports; every
    one moves a metric of the cell."""
    from benchmark import harness, pod
    spec = harness.benchmark_spec()
    e2e = {m["name"] for m in harness.for_cell(spec["end_to_end"],
                                               "ns.mesh4")}
    names = {m["name"] for m in pod.per_layer(spec, "ns.mesh4")}
    assert {"collective_ms", "collective_mb", "map_sum_roofline.pod",
            "filter_sum_roofline.pod", "group_roofline.pod",
            "device_idle_pct.pod"} <= names
    assert all(m["moves"] in e2e for m in pod.per_layer(spec, "ns.mesh4"))


def test_disagreement_reads_bits():
    import torch
    from benchmark.pod import disagreement
    a = {"s": torch.tensor([1.0, float("nan"), 3.0])}
    assert disagreement(a, {"s": a["s"].clone()}) == 0.0
    assert disagreement(a, {"s": torch.tensor([1.0, float("nan"), 3.5])}) \
        == 0.5
    assert disagreement(a, {"s": torch.tensor([1.0, 2.0, 3.0])}) \
        == float("inf")
    assert disagreement(a, {}) == float("inf")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_the_blocks_do_not_depend_on_the_rank_count(world):
    import torch
    from benchmark import blocks, harness
    from bolt_tpu_torch.parallel import mesh, sharding
    config = dict(harness.load_cell("ns.mesh4")[1],
                  **small("ns.mesh4")["config"])
    seed = 2 ** 31 + 99
    whole, _ = blocks.draw_box(torch, config, seed, 0, config["shape"][0],
                               "cpu")
    m = mesh.layout((world,), ("k",))
    spec = sharding.key_spec(m, config["shape"], 1)
    parts = []
    for r in range(world):
        (lo, hi) = sharding.box(m, spec, config["shape"], r)[0]
        parts.append(blocks.draw_box(torch, config, seed, lo, hi, "cpu")[0])
    assert torch.equal(torch.cat(parts), whole)
    base = blocks.Blocks(torch, config, seed, "cpu")
    assert torch.equal(base[3:29], whole[3:29])
    assert torch.equal(base[44:48], whole[44:48])
    other, _ = blocks.draw_box(torch, config, seed + 1, 0, 4, "cpu")
    assert not torch.equal(other, whole[:4])


@pytest.mark.parametrize("fault", ["drop_last", "no_exchange", "half",
                                   "altered"])
def test_a_broken_fold_is_not_correct(fault):
    run = _launch(4, fault=fault)
    assert run["rc"] == 0, run["err"][-3000:]
    checks = run["result"]["checks"]
    assert run["result"]["correct"] is False
    assert any(c["value"] > c["limit"] for c in checks.values())
    if fault == "drop_last":
        # a rank's partial left out reads far past the limit
        for name in ("map_sum.sum", "group.sum", "filter_sum.sum"):
            assert checks[name]["value"] > 10 * checks[name]["limit"], name
    if fault == "no_exchange":
        assert checks["ranks.agree"]["value"] > 0


def test_the_bfloat16_control_is_not_correct():
    import torch
    from benchmark import harness, pod
    limits = harness.load_cell("ns.mesh4")[3]
    got = pod._control(torch, "ns.mesh4", 2 ** 31 + 7,
                       limits["control"]["mode"], "cpu", small("ns.mesh4"))
    assert any(v > limits["limits"][k]["limit"] for k, v in got.items())


@pytest.mark.parametrize("fault", ["kill", "stuck"])
def test_a_dead_or_stuck_rank_ends_the_run(fault):
    run = _launch(4, seconds=30.0, fault=fault, wall_s=20)
    assert run["rc"] != 0 and run["result"] is None
    if fault == "kill":
        assert "rank 1 exited" in run["wrong"]
    else:
        assert "stuck" in run["wrong"] and "1" in run["wrong"]
    assert run["seconds"] < 60


def test_a_pod_cell_without_cards_prints_nothing():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark",
                                                       "run.py"),
                          "--workload", "ns.mesh4", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


# sha-256 of make_data's bits for a one-chip cell at the tests' small
# shapes, seed 2**31 + 4321 (the parent's harness gives the same)
ONE_CHIP = {
    "ns.fused": "140642c0e1a775e401585802b0a9bdcad172544f97b96e0690929e32aace0a6f",
    "img.path": "2b9438feaf4dbc51d5033fb1efe7ceb1e95062ca7602df8c3abe235be0e1e65d",
}


@pytest.mark.parametrize("cell", sorted(ONE_CHIP))
def test_a_one_chip_cell_draws_the_same_bits(cell):
    import torch
    from benchmark import harness
    config = dict(harness.load_cell(cell)[1], **small(cell)["config"])
    x, _ = harness.make_data(torch, config, 2 ** 31 + 4321, "cpu")
    digest = hashlib.sha256(x.contiguous().numpy().tobytes()).hexdigest()
    assert digest == ONE_CHIP[cell]


def test_a_library_range_on_the_card_is_no_operation():
    """torch's NCCL group opens ``nccl:all_gather`` on the card around
    each exchange: the trace counts the kernel inside it, once, and
    ``collective_ms`` reads the NCCL kernels alone."""
    from benchmark import common, tracing
    from test_bench_tracing import Ev
    ms = 1_000_000
    events = [
        Ev("bench.window", 0, 100 * ms, corr=1),
        Ev("bench.map_sum", 0, 100 * ms, corr=2),
        Ev("void mr_cols_kernel<float, 4, 4, false>(...)", 10 * ms, 40 * ms,
           device=True, link=2),
        Ev("nccl:all_gather", 40 * ms, 60 * ms, device=True),
        Ev("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
           45 * ms, 55 * ms, device=True),
    ]
    assert not tracing.is_operation("nccl:all_gather")
    assert tracing.is_operation(events[-1].name())
    s = tracing.Summary(events, groups={})
    assert s.busy_s == pytest.approx(0.040)
    assert [n for n, _ in s.device_ops] == [events[2].name(),
                                            events[-1].name()]

    class Ctx:
        passes = 2
    ctx = Ctx()
    ctx.events = events
    assert common.piece("metrics", "collective_ms").read(ctx) == \
        pytest.approx(5.0)
    ctx.events = events[:-1]
    assert common.piece("metrics", "collective_ms").read(ctx) is None
    ctx.collective = lambda key: {"collective_bytes": 6e6}[key]
    assert common.piece("metrics", "collective_mb").read(ctx) == 3.0
