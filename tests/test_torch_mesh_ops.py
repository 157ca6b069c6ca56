"""The ops library on a mesh of several ranks against the reference's
(``tests/test_ops_pca.py``, ``test_ops_group.py``, ``test_ops_series.py``,
``test_stats_extras.py``'s cov/histogram cases and ``test_hbm_guards.py``'s
``_unique_sharded`` cases).

Each case of ``bolt_tpu_torch/parallel/surface.py`` (``OPS_CASES``) is
one function of the ops library the two packages share, named after the
reference test it mirrors, its data made from a seed.  The port runs it
on pods of CPU ranks (``parallel/harness.py``, gloo): one module-scoped
pod of 8 ranks building the ``(8,)``, ``(4, 2)`` and ``(2, 4)`` meshes in
turn, and one of 3 ranks (replicated layouts: ``unique`` there must
count each element once, not once a replica).  The reference runs the
same function in this process on meshes of the same shapes.  Every rank
returns the same bits.

Tolerances: f64 data folded in another order than XLA's reduction:
``rtol=1e-12, atol=1e-12``; integer results (``bincount``, ``unique``
counts, ``topk`` indices, histogram counts) are exact.  Principal
components are compared in absolute value (their signs are arbitrary).
The f32 large-offset cases take their reference test's own tolerance
(``TOLS``: the centring fold cancels to about 1e-2 there).
"""

import numpy as np
import pytest

import jax
import bolt_tpu as bolt

from bolt_tpu_torch.parallel import harness, surface

POD_WALL = 300
CASES = list(surface.OPS_CASES)
LAYOUT = [c for c in surface.LAYOUT_CASES if c in CASES]
TOLS = {"pca_centering_fold_large_offset": dict(rtol=0, atol=0.2),
        "cov_centering_fold_large_offset": dict(rtol=0, atol=3e-2)}


@pytest.fixture(scope="module")
def pod8():
    """ONE pod of 8 CPU ranks for the module: the ``(8,)``, ``(4, 2)``
    and ``(2, 4)`` meshes span it in turn."""
    meshes = [{"label": "k8", "mesh": [8], "names": ["k"], "cases": CASES},
              {"label": "ab42", "mesh": [4, 2], "names": ["a", "b"],
               "cases": CASES},
              {"label": "ab24", "mesh": [2, 4], "names": ["a", "b"],
               "cases": LAYOUT}]
    return harness.run_cluster("surface", nproc=8, timeout=POD_WALL,
                               args={"meshes": meshes}, device="cpu")


@pytest.fixture(scope="module")
def pod3():
    """A pod of 3 CPU ranks: keys of 8, 12, 16 and 32 replicate on it."""
    return harness.run_cluster(
        "surface", nproc=3, timeout=POD_WALL, device="cpu",
        args={"meshes": [{"label": "k3", "mesh": [3], "names": ["k"],
                          "cases": CASES}]})


def _ref_mesh(label, mesh, mesh2d):
    if label == "k8":
        return mesh
    if label == "ab42":
        return mesh2d
    if label == "ab24":
        return jax.make_mesh((2, 4), ("a", "b"))
    return jax.sharding.Mesh(np.array(jax.devices()[:3]), ("k",))


def _check(pod, label, case, ref_mesh):
    results = [r[label][case] for r in pod]
    for r, got in zip(pod[1:], results[1:]):
        surface.same(got, results[0], "rank %d %s" % (r["rank"], case),
                     rtol=0, atol=0)
    want = surface.CASES[case](bolt, ref_mesh)
    surface.same(results[0], want, case, **TOLS.get(case, {}))


@pytest.mark.parametrize("case", CASES)
def test_on_a_1d_mesh(case, pod8, mesh, mesh2d):
    _check(pod8, "k8", case, _ref_mesh("k8", mesh, mesh2d))


@pytest.mark.parametrize("case", CASES)
def test_on_a_4x2_mesh(case, pod8, mesh, mesh2d):
    _check(pod8, "ab42", case, _ref_mesh("ab42", mesh, mesh2d))


@pytest.mark.parametrize("case", LAYOUT)
def test_on_a_2x4_mesh(case, pod8, mesh, mesh2d):
    _check(pod8, "ab24", case, _ref_mesh("ab24", mesh, mesh2d))


@pytest.mark.parametrize("case", CASES)
def test_on_three_ranks(case, pod3, mesh, mesh2d):
    _check(pod3, "k3", case, _ref_mesh("k3", mesh, mesh2d))


def test_unique_on_a_replicated_layout_counts_each_element_once(pod3):
    """6 keys on 3 ranks: the keys split 3 ways, and on 8 ranks 6 keys
    replicate; either way each element is counted once
    (``test_unique_sharded_declines_ineligible_layouts``)."""
    x = np.random.RandomState(46).randint(0, 5, size=(6, 4)).astype(float)
    un, cn = np.unique(x, return_counts=True)
    for r in pod3:
        got = r["k3"]["unique_sharded_declines_ineligible_layouts"]
        np.testing.assert_array_equal(got["u"], un)
        np.testing.assert_array_equal(got["c"], cn)
