"""The harness finds every piece by its name: a configuration, a traffic
mix and a per-layer metric added as new files, with new entries in
BENCHMARK.json, run without an edit to any file that was there."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import CELLS, POD_CELLS, ROOT


def test_every_cell_finds_its_pieces():
    from benchmark import common, harness
    spec = harness.benchmark_spec()
    assert [w["name"] for w in spec["workloads"]] == list(CELLS + POD_CELLS)
    for name in CELLS + POD_CELLS:
        cell, config, traffic, limits, _ = harness.load_cell(name)
        assert config["name"] == cell["config"]
        assert limits["limits"], name
        for br in traffic["branches"]:
            for step, _ in br["steps"]:
                common.piece("ops", step)
                common.piece("reference", step)
    for m in spec["per_layer"]:
        assert callable(common.piece("metrics", m["name"]).read)


def test_a_missing_piece_names_itself():
    from benchmark import common
    with pytest.raises(FileNotFoundError, match="no_such_step"):
        common.piece("ops", "no_such_step")


ADDED = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import harness
res, lines = harness.run_cell("tiny.sum", 5, 0.2, int(sys.argv[2]),
                              device="cpu")
print(json.dumps(res))
'''


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_added_by_new_files_only(tmp_path, trace):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric and their cell as new files and new entries; the
    copy's harness runs the new cell and reads the new metric."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(tmp_path / "benchmark") for p in fs}
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b = tmp_path / "benchmark"
    (b / "configs" / "tiny.json").write_text(json.dumps({
        "name": "tiny", "shape": [12, 5, 4], "dtype": "float32",
        "key_axes": [0], "data": "randn"}))
    (b / "traffic" / "plain_sum.json").write_text(json.dumps({
        "why": "a sum", "branches": [
            {"range": "only_sum", "from": "data", "as": "s",
             "steps": [["map", {"fn": "add", "value": 2.0}],
                       ["sum", {}]]}]}))
    (b / "metrics" / "passes_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.passes)\n")
    (b / "limits" / "tiny.sum.json").write_text(json.dumps({
        "control": {"mode": "bfloat16"},
        "limits": {"only_sum.sum": {"limit": 1e-5}}}))
    spec["configs"].append({"name": "tiny", "source": "a test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny.sum", "config": "tiny",
                              "traffic": "plain_sum", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("scan_gbps", "pass_ms_p95"):
            m["workloads"].append("tiny.sum")
    spec["per_layer"].append({"name": "passes_seen", "unit": "passes",
                              "better": "higher", "source": "host_clock",
                              "layer": "harness", "moves": "scan_gbps",
                              "workloads": ["tiny.sum"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", ADDED, str(tmp_path),
                          str(trace)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert list(res["checks"]) == ["only_sum.sum"]
    if trace:
        assert res["metrics"]["passes_seen"]["value"] >= 1
    else:
        assert set(res["metrics"]) == {"scan_gbps", "pass_ms_p95",
                                       "peak_mem_gb", "setup_s"}
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _, fs in os.walk(tmp_path / "benchmark") for p in fs
             if p in before}
    assert all(after[p] == before[p] for p in after)
