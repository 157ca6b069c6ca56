"""The control: the reference put in the program's place and computed
in the precision below the configuration's must come out not correct
under each cell's limits (the chip's readings at full size are in
PERF.md; this holds the same at a size a test run holds)."""

import pytest

from conftest import small


def _control_fails(cell, device):
    import torch
    from benchmark import calibrate, harness
    limits = harness.load_cell(cell)[3]
    mode = limits["control"]["mode"]
    got = calibrate.control_readings(torch, cell, 2 ** 31 + 7, mode,
                                     device=device, overrides=small(cell))
    over = {k: v for k, v in got.items()
            if k in limits["limits"] and v > limits["limits"][k]["limit"]}
    return over


@pytest.mark.parametrize("cell", ["ns.fused", "img.path", "ns.series"])
def test_the_bfloat16_control_is_not_correct(cell):
    assert _control_fails(cell, "cpu")


@pytest.mark.gpu
def test_the_tf32_control_is_not_correct(cuda):
    # TF32 exists on the card only
    assert _control_fails("img.pca", "cuda")


def test_lower_readings_are_runs_of_the_cell():
    """The program's readings that set a limit come from the run itself:
    the same numbers that ``run_cell`` compares, and all of them."""
    from benchmark import calibrate, harness
    nums, res = calibrate.program_run("ns.series", 2 ** 31 + 9, 0.2,
                                      device="cpu",
                                      overrides=small("ns.series"))
    assert res["setup"]["passes"] >= 1 and res["failed"] == 0
    assert nums == {k: c["value"] for k, c in res["checks"].items()}
    assert set(nums) == set(harness.load_cell("ns.series")[3]["limits"])


def test_the_limit_rule():
    from benchmark import calibrate
    assert calibrate.limit_of(0.0, 1e-3) == 0.0
    assert calibrate.limit_of(1e-6, 2e-6) is None        # no separation
    assert calibrate.limit_of(1e-6, float("inf")) is None
    assert calibrate.limit_of(1e-6, 1e-3) == 1e-4
    old = {"limits": {"b": {"same_as": "a", "note": "why"}}}
    new = calibrate.limits_file(old, "bfloat16", "card", [1], [2],
                                {"a": 1e-6, "b": 2e-6},
                                {"a": 1e-3, "b": float("inf")})
    assert new["limits"]["b"]["limit"] == 1e-4
    assert new["limits"]["b"]["upper"] == "inf"
    assert new["limits"]["b"]["note"] == "why"
