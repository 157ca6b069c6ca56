"""The array surface on a mesh of several ranks against the reference's
(``tests/test_tpu_operators.py``, ``test_tpu_getting.py``,
``test_tpu_shaping.py``, ``test_tpu_edges.py``, ``test_tpu_stacking.py``,
``test_ndarray_methods.py``, ``test_stats_extras.py``,
``test_toarray_out.py`` and ``test_tpu_construct.py``'s concatenate).

Each case of ``bolt_tpu_torch/parallel/surface.py`` is one function of
the surface the two packages share, named after the reference test it
mirrors; it makes its data from a seed.  The port runs it on pods of CPU
ranks (``parallel/harness.py``, gloo): one module-scoped pod of 8 ranks
that builds the ``(8,)``, ``(4, 2)`` and ``(2, 4)`` meshes in turn, and
one of 3 ranks, whose keys mostly do not divide the mesh (the replicated
layouts).  The reference runs the same function in this process on
``conftest.py``'s ``mesh``/``mesh2d`` and on meshes of the same shapes.
Every rank returns the same bits.

Tolerances: f64 data, and the port folds its ranks' partials in another
order than XLA's reduction: ``rtol=1e-12, atol=1e-12``.  Layouts,
indexing, sorts, scans, integer results and error classes are exact.
The f32 ``dot_precision_option`` takes its reference test's own
tolerance (``TOLS``).
"""

import numpy as np
import pytest

import jax
import bolt_tpu as bolt

from bolt_tpu_torch.parallel import harness, surface

POD_WALL = 300
CASES = list(surface.SURFACE_CASES)
LAYOUT = [c for c in surface.LAYOUT_CASES if c in CASES]
SPECIAL = ("iter_shards",)
# the reference test's own tolerance where the data is f32
TOLS = {"dot_precision_option": dict(rtol=1e-6, atol=1e-6)}


def _meshes(cases, layout):
    return [{"label": "k8", "mesh": [8], "names": ["k"], "cases": cases,
             "mismatch": {"mesh": [4, 2], "names": ["a", "b"]}},
            {"label": "ab42", "mesh": [4, 2], "names": ["a", "b"],
             "cases": cases},
            {"label": "ab24", "mesh": [2, 4], "names": ["a", "b"],
             "cases": layout}]


@pytest.fixture(scope="module")
def pod8():
    """ONE pod of 8 CPU ranks for the module: the ``(8,)``, ``(4, 2)``
    and ``(2, 4)`` meshes span it in turn."""
    return harness.run_cluster("surface", nproc=8, timeout=POD_WALL,
                               args={"meshes": _meshes(CASES, LAYOUT)},
                               device="cpu")


@pytest.fixture(scope="module")
def pod3():
    """A pod of 3 CPU ranks: keys of 8, 12 and 16 replicate on it."""
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
        # every rank returns the same bits
        surface.same(got, results[0], "rank %d %s" % (r["rank"], case),
                     rtol=0, atol=0)
    want = surface.CASES[case](bolt, ref_mesh)
    surface.same(results[0], want, case, **TOLS.get(case, {}))


@pytest.mark.parametrize("case", [c for c in CASES if c not in SPECIAL])
def test_on_a_1d_mesh(case, pod8, mesh, mesh2d):
    _check(pod8, "k8", case, _ref_mesh("k8", mesh, mesh2d))


@pytest.mark.parametrize("case", [c for c in CASES if c not in SPECIAL])
def test_on_a_4x2_mesh(case, pod8, mesh, mesh2d):
    _check(pod8, "ab42", case, _ref_mesh("ab42", mesh, mesh2d))


@pytest.mark.parametrize("case", [c for c in LAYOUT if c not in SPECIAL])
def test_on_a_2x4_mesh(case, pod8, mesh, mesh2d):
    _check(pod8, "ab24", case, _ref_mesh("ab24", mesh, mesh2d))


@pytest.mark.parametrize("case", [c for c in CASES if c not in SPECIAL])
def test_on_three_ranks(case, pod3, mesh, mesh2d):
    _check(pod3, "k3", case, _ref_mesh("k3", mesh, mesh2d))


@pytest.mark.parametrize("label", ["k8", "ab42", "k3"])
def test_iter_shards_yields_this_ranks_box(label, pod8, pod3, mesh,
                                           mesh2d):
    """``iter_shards`` yields the shards this process holds (the
    reference's contract): a rank its box, copies that never alias; the
    ranks' shards together cover the array, as the reference's one
    process's do."""
    pod = pod3 if label == "k3" else pod8
    want = surface.c_iter_shards(bolt, _ref_mesh(label, mesh, mesh2d))
    assert want["seen"].all()
    seen = np.zeros_like(want["seen"])
    for r in pod:
        got = r[label]["iter_shards"]
        surface.same(got["intact"], want["intact"], "intact")
        m = got["seen"]
        assert m.any() and not m.all() or label == "k3"
        np.testing.assert_array_equal(got["walked"][m], want["walked"][m])
        seen |= m
    assert seen.all()


def test_mesh_mismatch_raises(pod8):
    """Operands on another mesh of the pod are refused with the
    reference's ``different meshes`` error; an explicit move works
    (``test_tpu_operators.py::test_mesh_mismatch_raises``)."""
    x = np.random.RandomState(12).randn(8, 4, 5)
    for r in pod8:
        got = r["k8"]["mismatch"]
        for op in ("add", "cat", "mm"):
            assert got[op][0] == "ValueError", (op, got[op])
            assert "different meshes" in got[op][1], got[op]
        surface.same(got["moved"], x * 2, "moved")


def test_cross_mesh_operands_rejected(pod8):
    """``set`` and ``searchsorted`` refuse a foreign mesh's operand
    (``test_ndarray_methods.py::test_cross_mesh_operands_rejected``)."""
    for r in pod8:
        got = r["k8"]["mismatch"]
        for op in ("set", "search"):
            assert got[op][0] == "ValueError", (op, got[op])
            assert "different meshes" in got[op][1], got[op]


def test_toarray_out_8_way_layout(pod8, mesh):
    """``toarray(out=)`` of an array split 8 ways (the 8-way layout of
    ``test_toarray_out.py``): every rank fills the caller's buffer with
    the whole array."""
    want = surface.c_toarray_out_both_backends(bolt, mesh)
    for r in pod8:
        got = r["k8"]["toarray_out_both_backends"]
        assert got["same"] is True
        surface.same(got["v"], want["v"], "out")


def test_gather_of_a_strided_one_element_box():
    """A box that is a one-element view of a strided tensor (a map that
    picks one slot of each record, on a mesh with one record a rank) is
    sent as its own bytes: it counts as contiguous but keeps its stride,
    which a dtype view refuses, and the holder's error left its peers in
    the gather."""
    import torch
    from bolt_tpu_torch.parallel import multihost
    t = torch.arange(6.0, dtype=torch.float64).reshape(3, 2)[:1, 1]
    assert t.is_contiguous() and t.stride() == (2,)
    b = multihost._as_bytes(t)
    assert b.numel() == 8
    np.testing.assert_array_equal(
        multihost._from_bytes(b, torch.float64, (1,)).numpy(), [1.0])
