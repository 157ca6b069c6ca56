"""The port's device meshes against the reference's (``tests/test_multichip.py``).

The reference runs in this process on ``conftest.py``'s 8-device CPU
mesh (x64 on); the port runs in pods of CPU ranks
(``bolt_tpu_torch/parallel/harness.py``, gloo): one module-scoped pod of
8 ranks on which each mesh shape is built in turn, and the dry run's
pods of 2, 3 and 5 ranks, each bounded by its wall limit.  Both get the same numpy
inputs, made from a seed.  Each rank's box equals the reference's shard
of the device at the same mesh coordinate; specs equal the reference's
tuples on unbound layouts; every rank returns the same bits.

Tolerances: f64 data, and the port folds its ranks' partials in another
order than XLA's reduction: ``rtol=1e-12, atol=1e-12``.  Layouts, swaps,
gathers and filtered records are exact.
"""

import operator

import numpy as np
import pytest
import torch

import jax
import bolt_tpu as bolt
from bolt_tpu.parallel.sharding import key_spec as ref_key_spec

import bolt_tpu_torch as tbolt
from bolt_tpu_torch import convert
from bolt_tpu_torch.parallel import default_mesh, harness
from bolt_tpu_torch.parallel.sharding import key_spec

CPU = torch.device("cpu")
TOL = dict(rtol=1e-12, atol=1e-12)
POD_WALL = 180


def _x(shape, seed=8):
    return np.random.RandomState(seed).randn(*shape)


INPUTS = {
    "swap_x": _x((8, 4, 16)),
    "welford_x": _x((16, 4)),
    "reduce_x": _x((32, 5)),
    "gather_x": np.arange(40 * 6, dtype=np.float64).reshape(40, 6),
    "main_x": _x((16, 8, 4, 4), seed=3),
    "two_keys_x": _x((4, 2, 6)),
    "whole_x": _x((16, 4, 6)),
    "matching_x": _x((4, 2, 6)),
}


MESHES = [
    {"label": "k8", "mesh": [8], "names": ["k"],
     "checks": ["ones", "swap", "welford", "reduce", "gather", "main_path",
                "not_ported"]},
    {"label": "ab42", "mesh": [4, 2], "names": ["a", "b"],
     "checks": ["two_keys", "whole_mesh"]},
    {"label": "ab24", "mesh": [2, 4], "names": ["a", "b"],
     "checks": ["matching"]},
]


@pytest.fixture(scope="module")
def pod():
    """ONE pod of 8 CPU ranks for the module: each mesh of ``MESHES``
    spans it in turn."""
    return harness.run_cluster("checks", nproc=8, timeout=POD_WALL,
                               inputs=INPUTS, args={"meshes": MESHES},
                               device="cpu")


def _on(pod, label):
    """The pod's per-rank results on the mesh ``label``."""
    return [dict(r[label], rank=r["rank"]) for r in pod]


@pytest.fixture(scope="module")
def pod_k8(pod):
    return _on(pod, "k8")


@pytest.fixture(scope="module")
def pod_42(pod):
    return _on(pod, "ab42")


@pytest.fixture(scope="module")
def pod_24(pod):
    return _on(pod, "ab24")


def _ok(results, check):
    for r in results:
        assert check in r, sorted(r)
    return results


def _same_on_every_rank(results, *path):
    def get(r):
        for p in path:
            r = r[p]
        return r
    first = get(results[0])
    for r in results[1:]:
        assert np.array_equal(get(r), first), (path, r["rank"])
    return first


def _ref_boxes(ref_arr, mesh):
    """``{coords: box}`` of a reference array's shards on ``mesh``."""
    shape = tuple(ref_arr.shape)
    idx = ref_arr._data.sharding.devices_indices_map(shape)
    return convert.boxes_from_reference(
        {c: idx[d] for c, d in np.ndenumerate(mesh.devices)}, shape)


def _boxes_match(results, check, ref_boxes, key=None):
    for r in results:
        lay = r[check] if key is None else r[check][key]
        got = tuple(tuple(b) for b in lay["box"])
        assert got == ref_boxes[tuple(r["coords"])], (r["rank"], got)


def _layout(mesh):
    return convert.mesh_from_reference(mesh.devices.shape, mesh.axis_names)


def test_key_spec_assignment(mesh, mesh2d):
    lay, lay2 = _layout(mesh), _layout(mesh2d)
    cases = [(mesh, lay, (8, 4, 6), 1), (mesh, lay, (7, 4), 1),
             (mesh2d, lay2, (8, 4, 6), 2), (mesh2d, lay2, (8, 4, 6), 1),
             (mesh2d, lay2, (4, 4, 6), 1), (mesh2d, lay2, (4, 4, 6), 2)]
    for ref_mesh, port_mesh, shape, split in cases:
        assert key_spec(port_mesh, shape, split) == tuple(
            ref_key_spec(ref_mesh, shape, split))
    assert key_spec(lay2, (8, 4, 6), 1) == (("a", "b"), None, None)


def test_key_spec_matching_beats_greedy_order():
    m = jax.make_mesh((2, 4), ("a", "b"))
    lay = _layout(m)
    for shape, split in (((4, 2, 6), 2), ((4, 6), 1), ((2, 4, 6), 2),
                         ((7, 5), 2)):
        assert key_spec(lay, shape, split) == tuple(
            ref_key_spec(m, shape, split))
    assert key_spec(lay, (4, 2, 6), 2) == ("b", "a", None)


def test_matching_assignment_end_to_end(pod_24):
    m = jax.make_mesh((2, 4), ("a", "b"))
    x = INPUTS["matching_x"]
    ref = bolt.array(x, m, axis=(0, 1))
    _ok(pod_24, "matching")
    _boxes_match(pod_24, "matching", _ref_boxes(ref, m), "layout")
    for r in pod_24:
        assert r["matching"]["layout"]["local_shape"] == [1, 1, 6]
    got = _same_on_every_rank(pod_24, "matching", "sum")
    np.testing.assert_allclose(
        got, np.asarray(ref.map(lambda v: v + 1).sum(axis=(0, 1))
                        .toarray()), **TOL)


def test_single_key_axis_uses_whole_2d_mesh(mesh2d, pod_42):
    x = INPUTS["whole_x"]
    ref = bolt.array(x, mesh2d, axis=(0,))
    _ok(pod_42, "whole_mesh")
    _boxes_match(pod_42, "whole_mesh", _ref_boxes(ref, mesh2d), "layout")
    assert {tuple(r["whole_mesh"]["layout"]["local_shape"])
            for r in pod_42} == {(2, 4, 6)}
    np.testing.assert_allclose(
        _same_on_every_rank(pod_42, "whole_mesh", "sum"),
        np.asarray(ref.map(lambda v: v + 1).sum(axis=(0,)).toarray()),
        **TOL)
    st = ref.stats()
    np.testing.assert_allclose(
        _same_on_every_rank(pod_42, "whole_mesh", "mean"),
        np.asarray(st.mean()), **TOL)
    np.testing.assert_allclose(
        _same_on_every_rank(pod_42, "whole_mesh", "stdev"),
        np.asarray(st.stdev()), **TOL)


def test_data_actually_distributed(mesh, pod_k8):
    ref = bolt.ones((8, 64), mesh)
    _ok(pod_k8, "ones")
    _boxes_match(pod_k8, "ones", _ref_boxes(ref, mesh), "ones")
    assert all(r["ones"]["ones"]["local_shape"] == [1, 64] for r in pod_k8)


def test_map_preserves_sharding(mesh, pod_k8):
    ref = bolt.ones((8, 64), mesh).map(lambda v: v * 2)
    _boxes_match(pod_k8, "ones", _ref_boxes(ref, mesh), "map")
    for r in pod_k8:
        assert r["ones"]["map"]["spec"] == r["ones"]["ones"]["spec"] == \
            ["k", None]
    assert np.array_equal(_same_on_every_rank(pod_k8, "ones", "value"),
                          np.asarray(ref.toarray()))


def test_swap_resharding(mesh, pod_k8):
    x = INPUTS["swap_x"]
    ref = bolt.array(x, mesh).swap((0,), (1,))
    _ok(pod_k8, "swap")
    assert np.array_equal(_same_on_every_rank(pod_k8, "swap", "value"),
                          np.transpose(x, (2, 0, 1)))
    assert np.array_equal(pod_k8[0]["swap"]["value"],
                          np.asarray(ref.toarray()))
    _boxes_match(pod_k8, "swap", _ref_boxes(ref, mesh))
    assert all(r["swap"]["local_shape"] == [2, 8, 4] for r in pod_k8)


def test_mesh2d_two_key_axes(mesh2d, pod_42):
    x = INPUTS["two_keys_x"]
    ref = bolt.array(x, mesh2d, axis=(0, 1))
    _ok(pod_42, "two_keys")
    _boxes_match(pod_42, "two_keys", _ref_boxes(ref, mesh2d), "layout")
    assert all(r["two_keys"]["layout"]["local_shape"] == [1, 1, 6]
               for r in pod_42)
    np.testing.assert_array_equal(
        _same_on_every_rank(pod_42, "two_keys", "map"),
        np.asarray(ref.map(lambda v: v + 1, axis=(0, 1)).toarray()))
    np.testing.assert_allclose(_same_on_every_rank(pod_42, "two_keys", "sum"),
                               np.asarray(ref.sum().toarray()), **TOL)
    c = ref.stats()
    np.testing.assert_allclose(
        _same_on_every_rank(pod_42, "two_keys", "mean"),
        np.asarray(c.mean()), **TOL)
    np.testing.assert_allclose(
        _same_on_every_rank(pod_42, "two_keys", "var"),
        np.asarray(c.variance()), **TOL)


def test_welford_sharded_collectives(mesh, pod_k8):
    x = INPUTS["welford_x"]
    c = bolt.array(x, mesh).stats()
    _ok(pod_k8, "welford")
    assert {r["welford"]["count"] for r in pod_k8} == {c.count()} == {16}
    for name, ref in (("mean", c.mean()), ("var", c.variance()),
                      ("max", c.max())):
        np.testing.assert_allclose(
            _same_on_every_rank(pod_k8, "welford", name), np.asarray(ref),
            **TOL)


def test_default_mesh_single_device():
    # a single process: default_mesh is a one-rank mesh over its device
    m = default_mesh(devices=[CPU])
    b = tbolt.array(np.ones((8, 3)), m)
    assert b.mesh is not None and b.mesh.size == 1
    assert b.mesh.axis_names == ("k",)
    assert np.array_equal(b.toarray(), np.ones((8, 3)))


def test_reduce_over_sharded_axis(mesh, pod_k8):
    x = INPUTS["reduce_x"]
    ref = bolt.array(x, mesh).reduce(operator.add).toarray()
    _ok(pod_k8, "reduce")
    np.testing.assert_allclose(
        _same_on_every_rank(pod_k8, "reduce", "value"), np.asarray(ref),
        **TOL)


def test_shard_gather_assembly(mesh, pod_k8):
    # each rank's box reaches every rank in broadcasts of bounded pieces:
    # 8 boxes of 5 records x 6 f64 (240 bytes), in one piece each, then
    # in 64-byte pieces (4 each)
    x = INPUTS["gather_x"]
    ref = bolt.array(x, mesh)
    assert np.array_equal(np.asarray(ref.toarray()), x)
    _ok(pod_k8, "gather")
    for r in pod_k8:
        g = r["gather"]
        assert g["value"].dtype == x.dtype
        assert np.array_equal(g["value"], x)
        assert np.array_equal(g["small_value"], x)
        assert g["stats"] == {"regions": 8, "broadcasts": 8,
                              "max_piece_bytes": 240}
        assert g["small_stats"] == {"regions": 8, "broadcasts": 32,
                                    "max_piece_bytes": 64}


@pytest.mark.parametrize("n", [2, 3, 5])
def test_dryrun_multichip_device_counts(n):
    """The multichip dry run on a pod of n ranks: the 2-d mesh at even n,
    the 1-d mesh and the replication branches at odd n."""
    res = harness.run_cluster("dryrun", nproc=n, timeout=POD_WALL,
                              device="cpu")
    assert [r["rank"] for r in res] == list(range(n))
    shape = tuple(res[0]["result"]["shape"])
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    pdata = np.random.RandomState(7).randn(n * 6, 5)
    sv = np.linalg.svd(pdata - pdata.mean(axis=0), compute_uv=False)[:3]
    for r in res:
        np.testing.assert_array_equal(r["result"]["sum"],
                                      (x * 2.0 + 1.0).sum(axis=(0, 1)))
        # the surface steps (pca, median, cov, the per-chunk SVD, set,
        # sort, quantile, segment_reduce, topk, toarray(out=),
        # iter_shards) and the numpy tail (np.sum, np.concatenate, the
        # stack family, np.roll, np.pad, np.einsum, np.tensordot,
        # np.broadcast_to, np.cov) ran and checked themselves on every
        # rank
        np.testing.assert_allclose(r["result"]["pca_svals"], sv, rtol=1e-6)
        sdata = np.random.RandomState(11).randn(shape[0], 12, 3)
        tail = r["result"]["numpy"]
        np.testing.assert_allclose(tail["sum"], sdata.sum(), rtol=1e-12)
        # np.stack's new leading key axis, einsum's surviving keys,
        # broadcast_to's prepended key axis
        assert tail["splits"] == [2, 1, 2]
        assert r["result"]["median_shape"] == [4, 6]
        assert 0 < r["result"]["shard_elements"] <= res[0]["result"][
            "shape"][0] * 12 * 3
    np.testing.assert_array_equal(res[0]["result"]["pca_svals"],
                                  res[-1]["result"]["pca_svals"])


# ---------------------------------------------------------------------
# the main path on a mesh, against the reference
# ---------------------------------------------------------------------

def _mean_pos(v):
    return v.mean() > 1


def test_main_path_on_a_mesh(mesh, pod_k8):
    x = INPUTS["main_x"]
    ref = bolt.array(x, mesh)
    _ok(pod_k8, "main_path")
    m = lambda: ref.map(lambda v: v + 1)  # noqa: E731
    np.testing.assert_allclose(
        _same_on_every_rank(pod_k8, "main_path", "map_sum"),
        np.asarray(m().sum().toarray()), **TOL)
    st = ref.stats()
    for name, want in (("mean", st.mean()), ("var", st.variance()),
                       ("min", st.min()), ("max", st.max())):
        np.testing.assert_allclose(
            _same_on_every_rank(pod_k8, "main_path", name),
            np.asarray(want), **TOL)
    np.testing.assert_allclose(
        _same_on_every_rank(pod_k8, "main_path", "filter_sum"),
        np.asarray(m().filter(_mean_pos).sum().toarray()), **TOL)
    np.testing.assert_allclose(
        _same_on_every_rank(pod_k8, "main_path", "filter_mean"),
        np.asarray(m().filter(_mean_pos).mean().toarray()), **TOL)
    assert np.array_equal(_same_on_every_rank(pod_k8, "main_path", "toarray"),
                          x)
    assert np.array_equal(_same_on_every_rank(pod_k8, "main_path", "swap"),
                          np.asarray(ref.swap((0,), (0,)).toarray()))


def test_filter_on_a_mesh_laid_out_by_key_spec(mesh, pod_k8):
    # survivors re-keyed flat in key order; a count the 8 ranks do not
    # divide is replicated, as the reference lays it out
    x = INPUTS["main_x"]
    ref = bolt.array(x, mesh).map(lambda v: v + 1).filter(_mean_pos)
    want = np.asarray(ref.toarray())
    got = _same_on_every_rank(pod_k8, "main_path", "filter")
    assert np.array_equal(got, want)
    spec = [None] * want.ndim
    if want.shape[0] % 8 == 0:
        spec[0] = "k"
    for r in pod_k8:
        lay = r["main_path"]["filter_layout"]
        assert lay["shape"] == list(want.shape) and lay["split"] == 1
        assert lay["spec"] == spec


def test_stat_group_on_a_mesh_equals_standalone(pod_k8):
    """Each member of a fluent group on a mesh is its standalone terminal
    bit for bit; each rank resolves the partials it folds as ONE stat
    group over its box (sum, max, min, which ptp shares; the moment
    members share one fused_welford call) and exchanges each distinct
    partial once: five value-shaped (8, 4, 4) f64 partials (sum, mean,
    M2, max, min) and a count, gathered from 8 ranks."""
    partial = 8 * 4 * 4 * 8
    for r in pod_k8:
        g, alone = r["main_path"]["group"], r["main_path"]["alone"]
        for name in ("sum", "mean", "var", "min", "max", "ptp"):
            assert np.array_equal(g[name], alone[name]), name
        counts = dict(r["main_path"]["group_counts"])
        moved = counts.pop("collective_bytes")
        assert counts == {"fused_stat_groups": 1, "fused_stat_terminals": 3}
        assert 8 * 5 * partial < moved < 8 * 6 * partial, moved


def test_one_rank_mesh_is_the_single_device_path():
    x = _x((16, 8, 4, 4), seed=3).astype(np.float32)
    one = tbolt.array(x, default_mesh(devices=[CPU]))
    dev = tbolt.array(x, CPU)
    runs = [lambda b: b.map(lambda v: v + 1).sum(),
            lambda b: b.map(lambda v: v + 1).mean(),
            lambda b: b.var(), lambda b: b.max(),
            lambda b: b.map(lambda v: v + 1).filter(_mean_pos).sum(),
            lambda b: b.map(lambda v: v + 1).filter(_mean_pos).mean(),
            lambda b: b.map(lambda v: v + 1).filter(_mean_pos),
            lambda b: b.reduce(operator.add),
            lambda b: b.swap((0,), (1,))]
    for run in runs:
        a, b = run(one).toarray(), run(dev).toarray()
        assert a.dtype == b.dtype and np.array_equal(a, b)
    s1, s2 = one.stats(), dev.stats()
    for name in ("mean", "variance", "min", "max"):
        assert np.array_equal(getattr(s1, name)(), getattr(s2, name)())
    # outside the slice a one-rank mesh runs the single-device method
    assert np.array_equal(one[2:5].toarray(), dev[2:5].toarray())
    assert np.array_equal(np.quantile(one, 0.5, axis=0),
                          np.quantile(dev, 0.5, axis=0))


def test_multi_rank_mesh_refuses_what_this_slice_does_not_port(pod_k8):
    _ok(pod_k8, "not_ported")
    x = INPUTS["main_x"]
    for r in pod_k8:
        got = r["not_ported"]
        # the array's own surface and numpy's function table with the
        # internals only it reaches run on the mesh: nothing is left
        # guarded
        calls = {"quantile", "getitem", "add", "asarray", "with_keys",
                 "host_filter", "accumulate", "wrap"}
        assert set(got) == calls | {"no_form", "quantile_value",
                                    "wrap_value"}
        for name in calls:
            assert got[name] is None, (name, got[name])
        # the single-device internals that name no mesh form refuse
        # rather than gather the whole array unseen
        assert set(got["no_form"]) == {"_mapped", "_chain_parts"}
        for name, msg in got["no_form"].items():
            assert msg is not None and "names no form" in msg, (name, msg)
        np.testing.assert_allclose(got["quantile_value"],
                                   np.quantile(x, 0.5), rtol=1e-12)
        np.testing.assert_array_equal(got["wrap_value"], x)


def test_device_placements_and_reshard(mesh2d):
    """The per-rank placements of a host array equal the reference's
    per-device indices, by mesh coordinate; ``reshard`` of a host array
    and ``assemble_from_parts`` on a one-rank mesh give back the array."""
    from bolt_tpu.parallel.sharding import device_placements as ref_dp
    from bolt_tpu_torch.parallel import reshard, sharding
    lay = convert.mesh_from_reference(mesh2d.devices.shape,
                                      mesh2d.axis_names)
    for shape, split in (((16, 4, 6), 1), ((4, 2, 6), 2), ((6, 4), 1)):
        _, ref = ref_dp(mesh2d, shape, split)
        by_dev = dict(ref)
        want = convert.boxes_from_reference(
            {c: by_dev[d] for c, d in np.ndenumerate(mesh2d.devices)},
            shape)
        sh, got = sharding.device_placements(lay, shape, split)
        assert sh.split == split and sh.spec == key_spec(lay, shape, split)
        for r, (dev, index) in enumerate(got):
            assert dev is None
            box = tuple(ix.indices(n)[:2] for ix, n in zip(index, shape))
            assert box == want[tuple(lay.coords(r).values())]
    one = default_mesh(devices=[CPU])
    x = _x((8, 3, 2))
    b = reshard(x, one, 1)
    assert b.mesh is one and np.array_equal(b.toarray(), x)
    assert np.array_equal(reshard(b, one, 2).toarray(), x)
    part = torch.from_numpy(x)
    a = sharding.assemble_from_parts(x.shape, sharding.key_sharding(
        one, x.shape, 1), [part])
    assert a.split == 1 and np.array_equal(a.toarray(), x)


def test_engine_keys_carry_the_mesh():
    """Work on a mesh builds its programs under keys that carry the pod's
    topology token and the mesh's geometry: a one-rank mesh's program
    never serves a single device's call of the same shape (or another
    mesh's), and single-device keys are unchanged."""
    from bolt_tpu_torch import engine
    x = _x((12, 5, 3))
    one = tbolt.array(x, default_mesh(devices=[CPU]))
    dev = tbolt.array(x, CPU)
    before = set(engine._CACHE)
    one.map(lambda v: v * 3).sum().toarray()
    mesh_keys = set(engine._CACHE) - before
    assert mesh_keys
    assert all(k[-1] == ("mesh", None, (("k",), (1,))) for k in mesh_keys)
    before = set(engine._CACHE)
    dev.map(lambda v: v * 3).sum().toarray()
    dev_keys = set(engine._CACHE) - before
    assert dev_keys and not dev_keys & mesh_keys
    assert all(not (isinstance(k[-1], tuple) and k[-1][:1] == ("mesh",))
               for k in dev_keys)


def test_one_rank_mesh_stat_groups_and_accumulate():
    """A one-rank mesh's fluent stat group equals the single device's bit
    for bit, and ``accumulate=`` takes the single device's reduced
    precision there."""
    x = _x((16, 4, 6), seed=5).astype(np.float32)
    one = tbolt.array(x, default_mesh(devices=[CPU]))
    dev = tbolt.array(x, CPU)
    names = ("sum", "mean", "var", "min", "max", "ptp")
    g1, g2 = one.stats(*names), dev.stats(*names)
    for n in names:
        a, b = g1[n].toarray(), g2[n].toarray()
        assert a.dtype == b.dtype and np.array_equal(a, b), n
    a1 = one.stats("sum", "mean", accumulate="bf16")
    a2 = dev.stats("sum", "mean", accumulate="bf16")
    for n in ("sum", "mean"):
        assert np.array_equal(a1[n].toarray(), a2[n].toarray()), n
