"""numpy's function table on a mesh of several ranks against the
reference's (``tests/test_array_function.py``): its case tables.

Each entry of the reference's tables (``DEVICE_CASES``, ``TAIL_CASES``,
``TAIL2_CASES`` with ``TAIL2_CLEAN``, ``LINALG_CASES``, ``TAIL4_CASES``,
``FFT_CASES``, ``TAIL8_CASES``, ``TAIL9_CASES``) runs at the reference's
key layouts through ``bolt_tpu_torch/parallel/npsurface.py ::
table_case`` on pods of CPU ranks (``parallel/harness.py``, gloo): one
module-scoped pod of 8 ranks, one key axis on the ``(8,)`` mesh and two
on the ``(4, 2)`` mesh (as the reference's ``mesh`` and ``mesh2d``), and
one of 3 ranks, whose keys do not divide the mesh (the replicated
layouts).  The reference runs the same entry in this process on its mesh
of the same shape.  Every rank returns the same bits, and every bolt
result is laid out by ``key_spec`` of its shape and split.

Tolerances: f64 data at ``rtol=atol=1e-12`` (the port folds its ranks'
partials in rank order, XLA in its own); ``LINALG_CASES`` at its
reference test's ``rtol=1e-6, atol=1e-8``.  Shapes, splits, dtypes,
integer results and error classes are exact.
"""

import warnings

import numpy as np
import pytest

import jax
import bolt_tpu as bolt

from bolt_tpu_torch.parallel import harness, npsurface, surface
from tests import test_array_function as ref_cases

POD_WALL = 300
TOLS = {"linalg": dict(rtol=1e-6, atol=1e-8)}
KEYS1D = [i for t in npsurface.TABLES for i in npsurface.table_ids(
    t, ("keys1d",))]
KEYS2D = [i for t in npsurface.TABLES for i in npsurface.table_ids(
    t, ("keys2d",))]


@pytest.fixture(scope="module")
def pod8():
    """ONE pod of 8 CPU ranks: one key axis on the ``(8,)`` mesh, two on
    the ``(4, 2)`` mesh."""
    return harness.run_cluster("npsurface", nproc=8, timeout=POD_WALL,
                               device="cpu", args={"meshes": [
                                   {"label": "k8", "mesh": [8],
                                    "names": ["k"], "tables": KEYS1D},
                                   {"label": "ab42", "mesh": [4, 2],
                                    "names": ["a", "b"],
                                    "tables": KEYS2D}]})


@pytest.fixture(scope="module")
def pod3():
    """A pod of 3 CPU ranks: keys of 8 and 16 replicate on it."""
    return harness.run_cluster("npsurface", nproc=3, timeout=POD_WALL,
                               device="cpu", args={"meshes": [
                                   {"label": "k3", "mesh": [3],
                                    "names": ["k"], "tables": KEYS1D}]})


def _ref_mesh(label, mesh, mesh2d):
    if label == "k8":
        return mesh
    if label == "ab42":
        return mesh2d
    return jax.sharding.Mesh(np.array(jax.devices()[:3]), ("k",))


def _check(pod, label, cid, ref_mesh):
    results = [r[label][cid] for r in pod]
    for r, got in zip(pod[1:], results[1:]):
        surface.same(got, results[0], "rank %d %s" % (r["rank"], cid),
                     rtol=0, atol=0)
    assert not pod[0][label]["layout_faults"], \
        pod[0][label]["layout_faults"]
    want = npsurface.table_case(bolt, ref_mesh, cid)
    surface.same(results[0], want, cid,
                 **TOLS.get(cid.split(":")[0], {}))


def _host(fn, x):
    """``fn(x)`` on the host array ``x``: its values (each member of a
    tuple or list) with their dtypes, or the class of what it raised."""
    def val(v):
        if isinstance(v, (tuple, list)):
            return [val(i) for i in v]
        v = np.asarray(v)
        return (str(v.dtype), v)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return val(fn(x.copy()))
    except Exception as exc:  # noqa: BLE001 — the error is the answer
        return type(exc).__name__


def _equal(got, want, path):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, "%s/%d" % (path, i))
    elif isinstance(want, str):
        assert got == want, (path, got, want)
    else:
        assert got[0] == want[0], (path, got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1], err_msg=path)


def test_tables_are_the_references():
    """The payload's tables are the reference test file's, entry by
    entry: the names, the data helpers' values, and each call's result
    on the host array its test gives it (values, dtypes and error
    classes equal)."""
    for name, table in (("DEVICE_CASES", "device"), ("TAIL_CASES", "tail"),
                        ("TAIL2_CASES", "tail2"), ("TAIL2_CLEAN", "tail2"),
                        ("LINALG_CASES", "linalg"),
                        ("TAIL4_CASES", "tail4"), ("FFT_CASES", "fft"),
                        ("TAIL8_CASES", "tail8"), ("TAIL9_CASES", "tail9")):
        mine, theirs = getattr(npsurface, name), getattr(ref_cases, name)
        assert [c[0] for c in mine] == [c[0] for c in theirs], name
        for m, t in zip(mine, theirs):
            x = npsurface._data(table, m[0])
            _equal(_host(m[1], x), _host(t[1], x), "%s:%s" % (name, m[0]))
            if table == "linalg":
                np.testing.assert_array_equal(m[2](), t[2]())
    for name in ("_x", "_x2", "_xnan", "_spd", "_tall"):
        np.testing.assert_array_equal(getattr(npsurface, name)(),
                                      getattr(ref_cases, name)())
    assert len(KEYS1D) == 52 + 42 + 26 + 12 + 13 + 26 + 14 + 25
    assert len(KEYS2D) == 42 + 26 + 9 + 26 + 25


@pytest.mark.parametrize("cid", KEYS1D)
def test_one_key_axis_on_8_ranks(cid, pod8, mesh, mesh2d):
    _check(pod8, "k8", cid, _ref_mesh("k8", mesh, mesh2d))


@pytest.mark.parametrize("cid", KEYS2D)
def test_two_key_axes_on_a_4x2_mesh(cid, pod8, mesh, mesh2d):
    _check(pod8, "ab42", cid, _ref_mesh("ab42", mesh, mesh2d))


@pytest.mark.parametrize("cid", KEYS1D)
def test_one_key_axis_on_3_ranks(cid, pod3, mesh, mesh2d):
    _check(pod3, "k3", cid, _ref_mesh("k3", mesh, mesh2d))
