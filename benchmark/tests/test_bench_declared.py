"""The declared bytes and operations of each cell's pass, from its
shapes: each branch's input read once and its result written once."""

import pytest

from conftest import CELLS

NS = 3200 * 200 * 64 * 64 * 4           # 10.49 GB
NS_REC = 200 * 64 * 64 * 4              # one output of a key reduction
IMG = 64 * 2048 * 4096 * 4              # 2.15 GB
PIX = 2048 * 4096

EXPECTED = {
    "ns.fused": {"map_sum": NS + NS_REC, "group": NS + 6 * NS_REC,
                 "filter_sum": NS + NS_REC},
    "img.path": {"gaussian": 2 * IMG, "swap": 2 * IMG,
                 "series": IMG + 4 * 64 * 4},
    "ns.series": {"swap": 2 * NS, "center_sum": NS + 3200 * 64 * 64 * 4},
    "img.pca": {"swap": 2 * IMG,
                "pca": IMG + 4 * (PIX * 16 + 64 * 16 + 16)},
}


@pytest.mark.parametrize("cell", CELLS)
def test_declared_bytes(cell):
    from benchmark import common, harness
    _, config, traffic, _, _ = harness.load_cell(cell)
    got = {k: v[2] for k, v in common.branch_specs(traffic, config).items()}
    assert got == EXPECTED[cell]


def test_operations_that_can_bind():
    """The gaussian's taps and the PCA's Gram and projection are the
    operations a roofline may be bound by; the rest are a few a byte."""
    from benchmark import common, harness, peaks
    _, config, traffic, _, _ = harness.load_cell("img.pca")
    _, _, nbytes, ops = common.branch_specs(traffic, config)["pca"]
    gram = 2 * PIX * 64 * 64
    proj = 2 * PIX * 64 * 16
    assert ops == gram + proj + 6 * PIX * 64
    assert peaks.least_seconds(nbytes, ops) == ops / peaks.PEAK_OPS[
        "float32"]
    _, config, traffic, _, _ = harness.load_cell("img.path")
    _, _, nbytes, ops = common.branch_specs(traffic, config)["gaussian"]
    assert ops == 2 * 17 * 2 * IMG // 4
    assert peaks.least_seconds(nbytes, ops) == nbytes / peaks.HBM_BYTES_PER_S


def test_swap_spec_follows_bolts_algebra():
    from benchmark import common
    assert common.swap_perm(1, 4, [0], [0]) == ([1, 0, 2, 3], 1)
    assert common.swap_perm(1, 3, [0], [0, 1]) == ([1, 2, 0], 2)
    assert common.swap_perm(2, 4, [1], [1]) == ([0, 3, 1, 2], 2)
