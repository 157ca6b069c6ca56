"""numpy's function table on a mesh of several ranks against the
reference's detail tests (``tests/test_array_function.py``), and the
mesh halves of ``map(with_keys=True)``, a host-predicate ``filter`` and
``stats(accumulate=)``.

Each case of ``bolt_tpu_torch/parallel/npsurface.py`` (``CASES``) is one
reference test's calls, ``fn(bolt, mesh) -> dict``, named after it.  The
port runs it on pods of CPU ranks (``parallel/harness.py``, gloo): one
module-scoped pod of 8 ranks that builds the ``(8,)``, ``(4, 2)`` and
``(2, 4)`` meshes in turn, and one of 3 ranks, whose keys mostly do not
divide the mesh.  The reference runs the same function in this process
on ``conftest.py``'s ``mesh``/``mesh2d`` and on meshes of the same
shapes.  Every rank returns the same bits, and every bolt result is laid
out by ``key_spec`` of its shape and split.

Tolerances: f64 at ``rtol=atol=1e-12``; the linalg details at their
reference tests' bound (``rtol=1e-6, atol=1e-8``, ``LINALG_CASES``'
own); ``stats(accumulate=)`` at ``rtol=atol=1e-6`` (its results are
f32, and the fold of the ranks' moments rounds in another order; its
sums and maxima of integer-valued data are exact).  Shapes, splits, dtypes, integer results, error
classes and whether a message matches the reference test's pattern are
exact.
"""

import numpy as np
import pytest

import jax
import bolt_tpu as bolt

from bolt_tpu_torch.parallel import harness, npsurface, surface

POD_WALL = 300
ALL = sorted(npsurface.CASES) + ["cov_corrcoef_parity_keys1d"]
# the reference tests that also take ``mesh2d``, and the cases of this
# slice's own mesh halves, at two key axes
MESH2D = ["cov_corrcoef_parity_keys2d", "einsum_key_survival_and_mxu_policy",
          "stack_family_split_bookkeeping",
          "dispatch_tail2_split_matches_method_convention",
          "linalg_multi_output_and_batch_split",
          "complex_and_cleanup_parity", "map_with_keys",
          "host_predicate_filter", "stats_accumulate"]
LAYOUT = ["einsum_key_survival_and_mxu_policy",
          "stack_family_split_bookkeeping",
          "dispatch_tail2_split_matches_method_convention",
          "complex_and_cleanup_parity"]
# the reference test's own tolerance
LINALG = dict(rtol=1e-6, atol=1e-8)
TOLS = {"linalg_multi_output_and_batch_split": LINALG,
        "linalg_rejections_and_uplo": LINALG,
        "batch23_review_edges": LINALG, "batch4_review_edges": LINALG,
        "tail9_linalg_details": LINALG, "tail9_split_bookkeeping": LINALG,
        "stats_accumulate": dict(rtol=1e-6, atol=1e-6)}


@pytest.fixture(scope="module")
def pod8():
    """ONE pod of 8 CPU ranks for the module: the ``(8,)``, ``(4, 2)``
    and ``(2, 4)`` meshes span it in turn."""
    return harness.run_cluster("npsurface", nproc=8, timeout=POD_WALL,
                               device="cpu", args={"meshes": [
                                   {"label": "k8", "mesh": [8],
                                    "names": ["k"], "cases": ALL,
                                    "other": {"mesh": [4, 2],
                                              "names": ["a", "b"]}},
                                   {"label": "ab42", "mesh": [4, 2],
                                    "names": ["a", "b"], "cases": MESH2D},
                                   {"label": "ab24", "mesh": [2, 4],
                                    "names": ["a", "b"],
                                    "cases": LAYOUT}]})


@pytest.fixture(scope="module")
def pod3():
    """A pod of 3 CPU ranks."""
    return harness.run_cluster("npsurface", nproc=3, timeout=POD_WALL,
                               device="cpu", args={"meshes": [
                                   {"label": "k3", "mesh": [3],
                                    "names": ["k"], "cases": ALL}]})


def _ref_mesh(label, mesh, mesh2d):
    if label == "k8":
        return mesh
    if label == "ab42":
        return mesh2d
    if label == "ab24":
        return jax.make_mesh((2, 4), ("a", "b"))
    return jax.sharding.Mesh(np.array(jax.devices()[:3]), ("k",))


# the programs a case builds anew, as the reference test asserts them
# (``== n_before + 1``): the reference's own count in this process
# depends on which tests this worker ran before (its jit cache), while
# each pod starts with an empty cache
NEW_PROGRAMS = {"concatenate_axis_none_and_one_program": {"programs": 1},
                "batch23_review_edges": {"sweep_programs": 1}}


def _check(pod, label, case, ref_mesh, other=None):
    results = [r[label][case] for r in pod]
    for r, got in zip(pod[1:], results[1:]):
        surface.same(got, results[0], "rank %d %s" % (r["rank"], case),
                     rtol=0, atol=0)
    faults = [f for f in pod[0][label]["layout_faults"] if f[0] == case]
    assert not faults, faults
    want = dict(npsurface.run_case(bolt, ref_mesh, case, other),
                **NEW_PROGRAMS.get(case, {}))
    surface.same(results[0], want, case, **TOLS.get(case, {}))
    return results[0]


@pytest.mark.parametrize("case", ALL)
def test_on_a_1d_mesh(case, pod8, mesh, mesh2d):
    _check(pod8, "k8", case, _ref_mesh("k8", mesh, mesh2d), mesh2d)


@pytest.mark.parametrize("case", MESH2D)
def test_on_a_4x2_mesh(case, pod8, mesh, mesh2d):
    _check(pod8, "ab42", case, _ref_mesh("ab42", mesh, mesh2d))


@pytest.mark.parametrize("case", LAYOUT)
def test_on_a_2x4_mesh(case, pod8, mesh, mesh2d):
    _check(pod8, "ab24", case, _ref_mesh("ab24", mesh, mesh2d))


@pytest.mark.parametrize("case", ALL)
def test_on_three_ranks(case, pod3, mesh, mesh2d):
    _check(pod3, "k3", case, _ref_mesh("k3", mesh, mesh2d))


def test_device_served_no_gather(pod8, pod3):
    """``np.sum``/``np.mean``/``np.sort``/``np.concatenate`` and the round-4
    tail on a mesh never call ``toarray`` or ``__array__``
    (``test_device_served_no_gather``,
    ``test_dispatch_tail_stays_on_device``), on every rank; the
    ``np.concatenate`` of four operands is one program a rank."""
    for pod, label in ((pod8, "k8"), (pod3, "k3")):
        for r in pod:
            assert r[label]["device_served_no_gather"]["raised"] is None
            assert r[label]["dispatch_tail_stays_on_device"]["raised"] \
                is None
            assert r[label]["concatenate_axis_none_and_one_program"][
                "programs"] == 1


def test_mesh_halves_of_with_keys_filter_and_accumulate(pod8):
    """``map(with_keys=True)`` sees global key tuples, the host
    predicate's survivors are keyed in order, and ``stats(accumulate=)``
    folds each rank's group: all equal to numpy on the host array."""
    x = npsurface._x2()
    for label in ("k8", "ab42"):
        got = pod8[0][label]
        k = got["map_with_keys"]["keys1d"]["keys"]["v"]
        want = np.broadcast_to((np.arange(8) + 1.0)[:, None, None], x.shape)
        np.testing.assert_array_equal(k, want)
        k2 = got["map_with_keys"]["keys2d"]["keys"]["v"]
        want2 = (np.arange(8)[:, None] + 1.0) + 10 * (np.arange(6) + 1.0)
        np.testing.assert_array_equal(k2, np.broadcast_to(
            want2[:, :, None], x.shape))
        f = got["host_predicate_filter"]["keys1d"]["filtered"]
        np.testing.assert_array_equal(f["v"], x[x.mean(axis=(1, 2)) > 0])
        assert f["split"] == 1
        f2 = got["host_predicate_filter"]["keys2d"]["filtered"]
        flat = x.reshape(48, 4)
        np.testing.assert_array_equal(f2["v"], flat[flat.mean(axis=1) > 0])
        xf = np.floor(x * 4).astype(np.float32)
        for tag, axis in (("keys1d", (0,)), ("keys2d", (0, 1))):
            for mode in ("bf16", "f32"):
                g = got["stats_accumulate"]["%s_%s" % (tag, mode)]
                np.testing.assert_array_equal(g["sum"]["v"],
                                              xf.sum(axis=axis))
                np.testing.assert_array_equal(g["max"]["v"],
                                              xf.max(axis=axis))
                np.testing.assert_allclose(g["mean"]["v"],
                                           xf.mean(axis=axis), rtol=1e-6)
                np.testing.assert_allclose(g["var"]["v"],
                                           xf.var(axis=axis), rtol=1e-5)


def test_every_reference_mesh_test_has_a_counterpart():
    """Each test of ``tests/test_array_function.py`` that takes a mesh
    (``mesh``, ``mesh2d`` or a layout fixture by ``request``) has a case
    here or a table of ``test_torch_mesh_numpy.py``."""
    import ast
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_array_function.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    mesh_tests = [n.name for n in tree.body
                  if isinstance(n, ast.FunctionDef)
                  and n.name.startswith("test_")
                  and {a.arg for a in n.args.args} & {"mesh", "mesh2d",
                                                      "request"}]
    tables = {t[2] for t in npsurface.TABLES.values()}
    cov = {"test_cov_corrcoef_parity"}
    missing = [t for t in mesh_tests if t[5:] not in npsurface.CASES
               and t not in tables | cov]
    assert not missing, missing
    assert len(mesh_tests) == 55
