"""Value-axis sharding and the explicit halo exchange on the port's meshes,
against the reference (``tests/test_value_sharding.py``).

The reference runs in this process on ``conftest.py``'s CPU meshes (x64
on); the port in one module-scoped pod of 8 CPU ranks
(``bolt_tpu_torch/parallel/harness.py``) that builds two meshes in turn:
``("k",)`` for the halo exchange, ``("a", "b")`` of ``(4, 2)`` for the
chunk view's value shards and the sharded filters.  Both get the same
seeded numpy inputs.

Tolerances: the chunked maps and the halo sums move and add the same
f64 values in the same order as the reference: exact.  The Gaussian runs
the window kernel's plain version on each rank's halo-extended block
against XLA's convolution: ``rtol=1e-12, atol=1e-12``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import bolt_tpu as bolt
from bolt_tpu._compat import shard_map as _shard_map
from bolt_tpu.parallel import combined_spec as ref_combined_spec
from bolt_tpu.parallel import exchange_halo as ref_exchange_halo
from bolt_tpu.parallel.sharding import key_spec as ref_key_spec

from bolt_tpu_torch import convert
from bolt_tpu_torch.parallel import combined_spec, harness
from bolt_tpu_torch.parallel.sharding import key_spec

TOL = dict(rtol=1e-12, atol=1e-12)
POD_WALL = 180


def _x(shape=(4, 16, 6)):
    return np.random.RandomState(20).randn(*shape)


INPUTS = {
    "vs_x": _x(),
    "absorb_x": _x((8, 4, 6)),
    "overlap_x": np.random.RandomState(11).randn(4, 12, 3),
    "halo_zero_x": np.arange(8 * 4, dtype=np.float64),
    "halo_wrap_x": np.arange(16, dtype=np.float64),
}


@pytest.fixture(scope="module")
def pod():
    """ONE pod of 8 CPU ranks: the ``("k",)`` mesh, then the ``(4, 2)``
    ``("a", "b")`` mesh over the same ranks."""
    return harness.run_cluster(
        "checks", nproc=8, timeout=POD_WALL, inputs=INPUTS, device="cpu",
        args={"meshes": [
            {"label": "k8", "mesh": [8], "names": ["k"],
             "checks": ["halo"]},
            {"label": "ab", "mesh": [4, 2], "names": ["a", "b"],
             "checks": ["value_sharding", "overlap"]}]})


@pytest.fixture(scope="module")
def pod_k8(pod):
    return [dict(r["k8"], rank=r["rank"]) for r in pod]


@pytest.fixture(scope="module")
def pod_ab(pod):
    return [dict(r["ab"], rank=r["rank"]) for r in pod]


def _vs(pod, key):
    return [r["value_sharding"][key] for r in pod]


def _vshard(d):
    return {int(k): v for k, v in d.items()}


def _layout(mesh):
    return convert.mesh_from_reference(mesh.devices.shape, mesh.axis_names)


def _ref_halo(mesh, x, mode):
    xg = jax.device_put(jnp.asarray(x),
                        jax.sharding.NamedSharding(mesh, P("k")))

    def kernel(local):
        padded = ref_exchange_halo(local, 1, 0, "k", mode=mode)
        return padded[:-2] + padded[1:-1] + padded[2:]

    return np.asarray(jax.device_get(jax.jit(_shard_map(
        kernel, mesh=mesh, in_specs=P("k"), out_specs=P("k")))(xg)))


def test_combined_spec(mesh2d):
    lay = _layout(mesh2d)
    for shape, va in (((4, 16, 6), {0: "b"}), ((4, 16, 6), {0: "a"})):
        assert combined_spec(lay, shape, 1, va) == tuple(
            ref_combined_spec(mesh2d, shape, 1, va))
    assert combined_spec(lay, (4, 16, 6), 1, {0: "b"}) == ("a", "b", None)
    assert combined_spec(lay, (4, 16, 6), 1, {0: "a"}) == ("b", "a", None)
    for shape, va in (((4, 16, 6), {0: "b", 1: "b"}),
                      ((4, 15, 6), {0: "b"}), ((4, 16, 6), {0: "zz"})):
        with pytest.raises(ValueError):
            ref_combined_spec(mesh2d, shape, 1, va)
        with pytest.raises(ValueError):
            combined_spec(lay, shape, 1, va)


def test_chunk_shard_places_data(mesh2d, pod_ab):
    x = INPUTS["vs_x"]
    ref = bolt.array(x, mesh2d).chunk(size=(8,), axis=(0,)).shard("b")
    idx = ref._barray._data.sharding.devices_indices_map(x.shape)
    want = convert.boxes_from_reference(
        {c: idx[d] for c, d in np.ndenumerate(mesh2d.devices)}, x.shape)
    for r, got in zip(pod_ab, _vs(pod_ab, "shard")):
        assert _vshard(got["vshard"]) == ref.vshard == {0: "b"}
        assert got["local_shape"] == [1, 8, 6]
        assert tuple(tuple(b) for b in got["box"]) == \
            want[tuple(r["coords"])]
        assert np.array_equal(got["value"], x)


def test_sharded_chunk_map(mesh2d, pod_ab):
    x = INPUTS["vs_x"]
    ref = bolt.array(x, mesh2d).chunk(size=(8,), axis=(0,)).shard("b") \
        .map(lambda blk: blk * 2 + 1)
    for got in _vs(pod_ab, "map"):
        assert _vshard(got["vshard"]) == ref.vshard == {0: "b"}
        assert np.array_equal(got["value"],
                              np.asarray(ref.unchunk().toarray()))
        # the output keeps the value-axis shard
        assert tuple(got["spec"])[:2] == ("a", "b") == \
            tuple(ref._barray._data.sharding.spec)[:2]


def test_sharded_padded_map(mesh2d, pod_ab):
    x = INPUTS["vs_x"]
    ref = bolt.array(x, mesh2d).chunk(size=(4,), axis=(0,), padding=1) \
        .shard("b").map(lambda blk: blk * 3)
    for got in _vs(pod_ab, "padded"):
        assert np.array_equal(got["value"],
                              np.asarray(ref.unchunk().toarray()))
        assert tuple(got["spec"])[:2] == ("a", "b")


def test_shard_default_axis(mesh2d, pod_ab):
    x = INPUTS["vs_x"]
    ref = bolt.array(x, mesh2d).chunk(size=(8,), axis=(0,)).shard("b")
    for got in _vs(pod_ab, "default_axis"):
        assert _vshard(got) == ref.vshard == {0: "b"}


def test_exchange_halo(mesh, pod_k8):
    x = INPUTS["halo_zero_x"]
    got = np.concatenate([r["halo"]["zero"] for r in pod_k8])
    padded = np.concatenate([[0.0], x, [0.0]])
    expected = padded[:-2] + padded[1:-1] + padded[2:]
    assert np.array_equal(got, expected)
    assert np.array_equal(got, _ref_halo(mesh, x, "zero"))


def test_exchange_halo_wrap(mesh, pod_k8):
    x = INPUTS["halo_wrap_x"]
    got = np.concatenate([r["halo"]["wrap"] for r in pod_k8])
    padded = np.concatenate([[x[-1]], x, [x[0]]])
    expected = padded[:-2] + padded[1:-1] + padded[2:]
    assert np.array_equal(got, expected)
    assert np.array_equal(got, _ref_halo(mesh, x, "wrap"))


def test_vshard_survives_axis_exchange(mesh2d, pod_ab):
    x = INPUTS["vs_x"]
    c = bolt.array(x, mesh2d, axis=(0,)).chunk(size=(8,), axis=(0,)) \
        .shard("b")
    ref = c.keys_to_values((0,))
    for got in _vs(pod_ab, "k2v"):
        # old value axis 0 shifted right by the one moved-in key axis
        assert _vshard(got["vshard"]) == ref.vshard == {1: "b"}
        assert "b" in got["spec"]
        assert np.array_equal(got["value"], x)
    # moving the sharded axis itself into the keys drops its value shard
    assert c.values_to_keys((0,)).vshard == {}
    assert all(v == {} for v in _vs(pod_ab, "v2k_vshard"))


def test_vshard_dropped_with_warning_on_indivisible_map(mesh2d, pod_ab):
    import warnings
    x = INPUTS["vs_x"]
    c = bolt.array(x, mesh2d).chunk(size=(16,), axis=(0,)).shard("b")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ref = c.map(lambda blk: blk[:15])
    assert ref.vshard == {} and any("replicated" in str(i.message)
                                    for i in w)
    for got in _vs(pod_ab, "dropped"):
        assert got["vshard"] == {}
        assert any("replicated" in m for m in got["warnings"])
        assert np.array_equal(got["value"], x[:, :15, :])
        assert np.array_equal(got["value"],
                              np.asarray(ref.unchunk().toarray()))


def test_halo_pad_exceeds_shard(mesh, pod_k8):
    def kernel(local):
        return ref_exchange_halo(local, 5, 0, "k")  # shard extent is 2
    with pytest.raises(ValueError):
        jax.jit(_shard_map(kernel, mesh=mesh, in_specs=P("k"),
                           out_specs=P("k")))(jnp.ones(16))
    for r in pod_k8:
        assert "exceeds the per-shard extent 2" in r["halo"]["pad_exceeds"]


def test_exchange_halo_validation(mesh, pod_k8):
    def kernel(local):
        return ref_exchange_halo(local, 1, 0, "k", mode="bogus")
    with pytest.raises(ValueError):
        jax.jit(_shard_map(kernel, mesh=mesh, in_specs=P("k"),
                           out_specs=P("k")))(jnp.ones(16))
    for r in pod_k8:
        assert "mode must be 'zero' or 'wrap'" in r["halo"]["bogus_mode"]


def test_value_shard_survives_key_axis_absorption(mesh2d, pod_ab):
    lay = _layout(mesh2d)
    assert combined_spec(lay, (8, 4, 6), 1, {0: "b"}) == ("a", "b", None) \
        == tuple(ref_combined_spec(mesh2d, (8, 4, 6), 1, {0: "b"}))
    assert key_spec(lay, (8, 4, 6), 1) == (("a", "b"), None, None) == \
        tuple(ref_key_spec(mesh2d, (8, 4, 6), 1))
    x = INPUTS["absorb_x"]
    for got in _vs(pod_ab, "absorb"):
        assert _vshard(got["vshard"]) == {0: "b"}
        assert np.array_equal(got["value"], x * 2.0)


def test_sharded_filters_on_each_ranks_halo_block(mesh2d, pod_ab):
    """``shard=`` of the separable filters and the median: each rank
    filters its block of the split value axis, extended by its
    neighbours' halos, against the reference's sharded filters."""
    from bolt_tpu import ops as rops
    x = INPUTS["overlap_x"]
    rb = bolt.array(x, mesh2d, axis=(0,))
    want = {
        "gaussian": rops.gaussian(rb, 1.0, axis=(0,), shard="b"),
        "smooth": rops.smooth(rb, 3, axis=(0,), size=(6,), shard={0: "b"}),
        "median": rops.median_filter(rb, 3, axis=(0,), shard="b"),
    }
    for r in pod_ab:
        got = r["overlap"]
        for name, ref in want.items():
            np.testing.assert_allclose(got[name], np.asarray(ref.toarray()),
                                       **TOL)
        assert tuple(got["gaussian_layout"]["spec"])[:2] == ("a", "b")
