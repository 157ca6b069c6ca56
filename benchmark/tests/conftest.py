"""Shared settings of the benchmark's own tests: the repo root on the
path, and the small shapes every cell is rehearsed at on the CPU."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the configurations' shapes, cut so a test run holds them
SMALL = {"northstar": {"shape": [96, 20, 8, 8]},
         "imaging": {"shape": [64, 32, 24]},
         "northstar.pod4": {"shape": [48, 20, 8, 8], "block_records": 4}}
CELLS = ("ns.fused", "img.path", "ns.series", "img.pca")
# the cells run as a pod of several cards (pod.py)
POD_CELLS = ("ns.mesh4",)


def small(cell):
    from benchmark import harness
    return {"config": SMALL[harness.load_cell(cell)[0]["config"]]}


@pytest.fixture
def cuda():
    """Skips, with the reason, where the process has no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
