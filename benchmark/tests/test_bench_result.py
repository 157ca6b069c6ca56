"""The result line: the contract's keys, the cell's own metrics, the
numbers compared last; a run with no CUDA card prints nothing and fails."""

import json
import os
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT, small


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_at_a_small_size(cell):
    from benchmark import harness
    res, lines = harness.run_cell(cell, 2 ** 31 + 12345, 0.2, 0,
                                  device="cpu", overrides=small(cell))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {m["name"] for m in harness.for_cell(
        harness.benchmark_spec()["end_to_end"], cell)}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    limits = harness.load_cell(cell)[3]["limits"]
    assert set(res["checks"]) == set(limits)
    assert lines[-len(limits):] == [
        l for l in lines if l.startswith("check ")]
    json.dumps(res)


def test_the_traced_run_reports_per_layer_metrics_only():
    from benchmark import harness
    res, _ = harness.run_cell("ns.fused", 77, 0.2, 1, device="cpu",
                              overrides=small("ns.fused"))
    names = {m["name"] for m in harness.benchmark_spec()["per_layer"]}
    assert set(res["metrics"]) <= names
    # on the CPU the profiler sees no card: only the engine's counters
    assert set(res["metrics"]) == {"engine_dispatch_us", "engine_builds"}
    assert res["metrics"]["engine_builds"]["value"] == 0


def test_same_seed_same_data():
    import torch
    from benchmark import harness
    config = {"shape": [6, 5, 4], "dtype": "float32", "key_axes": [1],
              "data": "randn"}
    a, ak = harness.make_data(torch, config, 2 ** 33 + 1, "cpu")
    b, bk = harness.make_data(torch, config, 2 ** 33 + 1, "cpu")
    c, _ = harness.make_data(torch, config, 2 ** 33 + 2, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert tuple(ak.shape) == (5, 6, 4) and torch.equal(ak, bk)


def test_no_card_no_result():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark",
                                                       "run.py"),
                          "--workload", "ns.fused", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_p95_is_the_nearest_rank():
    from benchmark import harness
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95([3.0]) == 3.0
    assert harness.p95(list(range(1, 21))) == 19
