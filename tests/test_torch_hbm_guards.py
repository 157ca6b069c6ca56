"""The port's device-memory guards against the reference's
(``tests/test_hbm_guards.py``'s sixteen tests, on the CPU).

Ops with input-multiple transients switch to bounded slab or chunk paths
above ``ops/group.py :: _CHUNK_MAX_BYTES`` (forced small here: chunked
``unique``, slabbed ``topk``; one card sorts whole, so ``argsort`` has no
slab path and is held to numpy instead), and ops with inherently
input-sized outputs check their demand up front through
``gpu/array.py :: hbm_check``: a ``MemoryError`` above a KNOWN limit (the
override ``_HBM_LIMIT_OVERRIDE`` or ``BOLT_HBM_BYTES``; on the card
``torch.cuda.mem_get_info``), an ``HBMPressureWarning`` above an ASSUMED
one, silence below.  A CPU device has no limit.  Values are compared
exactly (``np.array_equal``) except ``topk`` values against the
reference's in f64 (``np.allclose`` defaults: the reference's
``lax.top_k`` values are the same elements, so they agree bit for bit
too in practice).
"""

import warnings

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch import engine
from bolt_tpu_torch.base import HBMPressureWarning
from bolt_tpu_torch.gpu import array as array_mod
from bolt_tpu_torch.ops import group

CPU = torch.device("cpu")


def _x(shape=(32, 8, 6), seed=40):
    return np.random.RandomState(seed).randn(*shape)


@pytest.fixture
def chunked(monkeypatch):
    """Record the chunked unique and slabbed topk paths' calls."""
    seen = []
    real_u, real_t = group._unique_chunked, group._topk_slabs

    def u(*a, **k):
        seen.append("unique-chunk")
        return real_u(*a, **k)

    def t(*a, **k):
        seen.append("topk-slab")
        return real_t(*a, **k)

    monkeypatch.setattr(group, "_unique_chunked", u)
    monkeypatch.setattr(group, "_topk_slabs", t)
    return seen


def test_unique_chunked_parity(monkeypatch, chunked):
    monkeypatch.setattr(group, "_CHUNK_MAX_BYTES", 256)
    x = np.random.RandomState(41).randint(0, 13, size=(16, 9)).astype(float)
    b = bolt.array(x, CPU)
    u, c = bolt.ops.unique(b, return_counts=True)
    un, cn = np.unique(x, return_counts=True)
    assert np.array_equal(u, un) and np.array_equal(c, cn)
    assert np.asarray(u).dtype == un.dtype and np.asarray(c).dtype == np.int64
    assert "unique-chunk" in chunked
    assert np.array_equal(bolt.ops.unique(b), un)


def test_unique_chunked_nan_merge(monkeypatch, chunked):
    monkeypatch.setattr(group, "_CHUNK_MAX_BYTES", 64)
    x = np.array([[1.0, np.nan, 2.0, np.nan]] * 8)
    u, c = bolt.ops.unique(bolt.array(x, CPU), return_counts=True)
    un, cn = np.unique(x, return_counts=True)
    u = np.asarray(u)
    assert u.shape == un.shape
    assert np.isnan(u[-1]) and np.array_equal(u[:-1], un[:-1])
    assert np.array_equal(c, cn) and "unique-chunk" in chunked


def test_unique_chunked_deferred_chain(monkeypatch, chunked):
    monkeypatch.setattr(group, "_CHUNK_MAX_BYTES", 128)
    x = np.random.RandomState(42).randint(0, 5, size=(12, 6)).astype(float)
    m = bolt.array(x, CPU).map(lambda v: v * 3)
    assert np.array_equal(bolt.ops.unique(m), np.unique(x * 3))
    assert "unique-chunk" in chunked


def test_argsort_parity_every_axis(mesh):
    """The reference's slabbed argsort is one whole sort here: every
    axis and the flattened form equal numpy's stable order and the
    reference's split."""
    x = _x()
    b = bolt.array(x, CPU)
    r = ref.array(x, mesh)
    for axis in (1, 0, -1, 2):
        got = b.argsort(axis=axis, kind="stable")
        assert got.split == r.argsort(axis=axis, kind="stable").split
        assert np.array_equal(got.toarray(),
                              x.argsort(axis=axis, kind="stable")), axis
    flat = bolt.array(x, CPU).argsort(axis=None, kind="stable")
    assert np.array_equal(flat.toarray(), x.argsort(axis=None,
                                                    kind="stable"))


def test_unique_single_card_path_parity(mesh):
    # the reference's shard-local unique: one card sorts once
    x = np.random.RandomState(45).randint(0, 9, size=(16, 6)).astype(float)
    x[3, 2] = np.nan
    x[9, 1] = np.nan
    u, c = bolt.ops.unique(bolt.array(x, CPU), return_counts=True)
    ru, rc = ref.ops.unique(ref.array(x, mesh), return_counts=True)
    u = np.asarray(u)
    assert u.shape == np.asarray(ru).shape
    assert np.array_equal(u[:-1], np.asarray(ru)[:-1]) and np.isnan(u[-1])
    assert np.array_equal(c, rc)
    mch = bolt.array(np.full((8, 4), 2.0), CPU).map(lambda v: v + 1)
    assert np.array_equal(bolt.ops.unique(mch), [3.0])


def test_unique_counts_exact_on_small_layouts(mesh):
    # the reference's declined layouts (6 keys on 8 devices) fall back
    # with exact counts; one card has no layout to decline
    x = np.random.RandomState(46).randint(0, 5, size=(6, 4)).astype(float)
    u, c = bolt.ops.unique(bolt.array(x, CPU), return_counts=True)
    ru, rc = ref.ops.unique(ref.array(x, mesh), return_counts=True)
    un, cn = np.unique(x, return_counts=True)
    assert np.array_equal(u, un) and np.array_equal(c, cn)
    assert np.array_equal(u, ru) and np.array_equal(c, rc)


def test_unique_whole_array_program_pinned():
    # below the chunk size one engine program sorts the whole array
    x = np.random.RandomState(48).randint(0, 7, size=(64, 4)).astype(float)
    assert np.array_equal(bolt.ops.unique(bolt.array(x, CPU)), np.unique(x))
    keys = [k for k in engine._CACHE if k[0] == "unique"
            and k[2] == (64, 4)]
    assert keys


def test_topk_chunked_parity(monkeypatch, chunked):
    monkeypatch.setattr(group, "_CHUNK_MAX_BYTES", 512)
    x = _x()
    b = bolt.array(x, CPU)
    for axis in (0, 1):
        v, i = bolt.ops.topk(b, 3, axis=axis)
        lv, li = ref.ops.topk(ref.array(x), 3, axis=axis)
        assert np.allclose(v.toarray(), np.asarray(lv.toarray())), axis
        assert np.array_equal(i.toarray(), np.asarray(li.toarray())), axis
    assert "topk-slab" in chunked


def test_topk_chunked_split_key(monkeypatch):
    monkeypatch.setattr(group, "_CHUNK_MAX_BYTES", 512)
    x = _x((8, 8, 6))
    v1, _ = bolt.ops.topk(bolt.array(x, CPU, axis=(0,)), 2, axis=1)
    v2, _ = bolt.ops.topk(bolt.array(x, CPU, axis=(0, 1)), 2, axis=2)
    assert v1.split == 1 and v2.split == 2
    lv1, _ = ref.ops.topk(ref.array(x), 2, axis=1)
    lv2, _ = ref.ops.topk(ref.array(x), 2, axis=2)
    assert np.allclose(v1.toarray(), np.asarray(lv1.toarray()))
    assert np.allclose(v2.toarray(), np.asarray(lv2.toarray()))


def test_np_quantile_numpy_only_method_falls_back():
    x = _x()
    got = np.quantile(bolt.array(x, CPU), 0.5, method="inverted_cdf")
    assert np.allclose(got, np.quantile(x, 0.5, method="inverted_cdf"))


def test_slab_plan_picks_largest_carry_axis(monkeypatch):
    monkeypatch.setattr(group, "_CHUNK_MAX_BYTES", 1 << 10)
    cax, pairs = group.slab_plan((2, 64, 8), axis=2, in_bytes=1 << 13)
    assert cax == 1
    assert len(pairs) == 8              # 8 KB / 1 KB target
    assert pairs[0][0] == 0 and pairs[-1][1] == 64
    assert group.slab_plan((1, 16), axis=1, in_bytes=1 << 20) is None


def test_topk_hbm_check_engages(monkeypatch):
    monkeypatch.setattr(array_mod, "_HBM_LIMIT_OVERRIDE", 1 << 10)
    b = bolt.array(_x(), CPU)
    with pytest.raises(MemoryError, match="topk"):
        bolt.ops.topk(b, 2, axis=-1)
    # the slabbed path checks its own (smaller) demand
    monkeypatch.setattr(group, "_CHUNK_MAX_BYTES", 512)
    with pytest.raises(MemoryError, match="per-slab"):
        bolt.ops.topk(b, 2, axis=0)


def test_small_inputs_skip_chunked_paths(chunked):
    x = _x((6, 4))
    bolt.ops.unique(bolt.array(x, CPU))
    bolt.array(x, CPU).argsort(axis=0)
    bolt.ops.topk(bolt.array(x, CPU), 2, axis=0)
    assert chunked == []


def test_hbm_check_known_limit_raises(monkeypatch):
    monkeypatch.setattr(array_mod, "_HBM_LIMIT_OVERRIDE", 1 << 10)
    b = bolt.array(_x(), CPU)
    with pytest.raises(MemoryError, match="cumsum"):
        b.cumsum()
    with pytest.raises(MemoryError, match="sort"):
        b.sort()
    with pytest.raises(MemoryError, match="argsort"):
        b.argsort(axis=None)
    # the env var is honoured the same way
    monkeypatch.setattr(array_mod, "_HBM_LIMIT_OVERRIDE", None)
    monkeypatch.setenv("BOLT_HBM_BYTES", str(1 << 10))
    with pytest.raises(MemoryError, match="cumprod"):
        b.cumprod()


def test_hbm_check_assumed_limit_warns(monkeypatch):
    monkeypatch.setattr(array_mod, "_hbm_limit",
                        lambda device=None: (1 << 10, False))
    b = bolt.array(_x(), CPU)
    with pytest.warns(HBMPressureWarning, match="ASSUMED"):
        out = b.cumsum(axis=0)
    # the op still runs
    assert np.array_equal(out.toarray(), _x().cumsum(axis=0))


def test_hbm_check_under_limit_is_silent(monkeypatch):
    monkeypatch.setattr(array_mod, "_HBM_LIMIT_OVERRIDE", 1 << 40)
    b = bolt.array(_x(), CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b.cumsum(axis=0)
        b.argsort(axis=0)
        bolt.ops.topk(b, 2)


def test_hbm_check_segment_reduce_and_meshgrid(monkeypatch):
    """The reference's other two sites: the forced one-hot
    ``segment_reduce`` and a dense ``np.meshgrid``."""
    b = bolt.array(_x(), CPU)
    labels = np.arange(32) % 4
    want = bolt.ops.segment_reduce(b, labels, 4, method="matmul").toarray()
    g = [bolt.array(np.arange(300.0), CPU), bolt.array(np.arange(200.0),
                                                       CPU)]
    monkeypatch.setattr(array_mod, "_HBM_LIMIT_OVERRIDE", 1 << 10)
    with pytest.raises(MemoryError, match="segment_reduce matmul"):
        bolt.ops.segment_reduce(b, labels, 4, method="matmul")
    with pytest.raises(MemoryError, match="meshgrid"):
        np.meshgrid(*g)
    # the auto gate and a sparse grid need no up-front check
    np.meshgrid(*g, sparse=True)
    monkeypatch.setattr(array_mod, "_HBM_LIMIT_OVERRIDE", 1 << 40)
    got = bolt.ops.segment_reduce(b, labels, 4, method="matmul").toarray()
    assert np.array_equal(got, want)


def test_hbm_limit_on_the_cpu_and_the_card(monkeypatch):
    """No limit on a CPU device; a CUDA device's is what
    ``torch.cuda.mem_get_info`` reports (a known limit), read once per
    card; a card that reports nothing gets the assumed 80 GB."""
    monkeypatch.delenv("BOLT_HBM_BYTES", raising=False)
    assert array_mod._hbm_limit(CPU) == (None, False)
    calls = []

    def info(idx):
        calls.append(idx)
        return (1 << 30, 80 << 30)

    monkeypatch.setattr(array_mod, "_HBM_DEVICE_REPORT", {})
    monkeypatch.setattr(torch.cuda, "mem_get_info", info)
    assert array_mod._hbm_limit(torch.device("cuda", 0)) == (80 << 30, True)
    assert array_mod._hbm_limit(torch.device("cuda", 0)) == (80 << 30, True)
    assert calls == [0]

    def broken(idx):
        raise RuntimeError("no report")

    monkeypatch.setattr(torch.cuda, "mem_get_info", broken)
    assert array_mod._hbm_limit(torch.device("cuda", 1)) == (
        array_mod._ASSUMED_HBM_BYTES, False)
