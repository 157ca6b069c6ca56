"""``bolt_tpu_torch.profile`` against ``bolt_tpu.profile``: the seven
tests of ``tests/test_profile.py`` on the port, on the CPU
(``context=torch.device("cpu")``).  ``trace`` is ``torch.profiler``
writing a Chrome trace, ``debug_nans`` arms the engine's NaN check of
every program's outputs (``jax_debug_nans``'s counterpart), and
``memory_stats`` is ``{}`` off the card; the card's keys are tested in
``tests/test_torch_card.py``.  Values equal ``bolt_tpu``'s (exact: sums
of ones)."""

import os

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch import engine, profile

CPU = torch.device("cpu")


def test_timeit_and_throughput(mesh):
    b = bolt.ones((8, 32), context=CPU)
    result, secs = profile.timeit(lambda: b.map(lambda v: v * 2).sum()._data,
                                  iters=2, warmup=1)
    assert secs > 0
    assert np.allclose(result.numpy(), np.full(32, 16.0))
    assert np.array_equal(result.numpy(), ref.ones((8, 32), mesh).map(
        lambda v: v * 2).sum().toarray())
    gbps = profile.throughput(profile.array_bytes(b), secs)
    assert gbps > 0
    with pytest.raises(ValueError, match="iters >= 1"):
        profile.timeit(lambda: 1, iters=0)


def test_array_bytes():
    b = bolt.ones((8, 4), context=CPU, dtype=np.float32)
    assert profile.array_bytes(b) == 8 * 4 * 4


def test_annotate_and_trace(tmp_path):
    with profile.annotate("bolt-test-region"):
        bolt.ones((8, 2), context=CPU).sum().toarray()
    logdir = str(tmp_path / "trace")
    with profile.trace(logdir):
        with profile.annotate("bolt-traced-region"):
            bolt.ones((8, 2), context=CPU).sum().toarray()
    assert os.path.isdir(logdir)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    text = open(os.path.join(logdir, files[0])).read()
    assert "bolt-traced-region" in text


def test_debug_nans_toggle():
    profile.debug_nans(True)
    assert engine.debug_nans_enabled()
    try:
        with pytest.raises(FloatingPointError):
            bolt.array(np.array([[-1.0], [1.0]]), context=CPU).map(
                lambda v: torch.log(v)).sum().toarray()
    finally:
        profile.debug_nans(False)
    assert not engine.debug_nans_enabled()


def test_memory_stats_dict():
    from bolt_tpu_torch.profile import memory_stats
    s = memory_stats()
    assert isinstance(s, dict)  # {} without a card
    for k, v in s.items():
        assert isinstance(k, str) and isinstance(v, int)
    assert memory_stats(CPU) == {}


def test_instrument_counts_ops_and_builds():
    x = np.random.RandomState(0).randn(8, 4, 5)
    b = bolt.array(x, context=CPU)
    f = lambda v: v * 2
    with profile.instrument() as stats:
        for _ in range(3):
            b.map(f).sum().toarray()
        b.stats()
    assert "stat" in stats and stats["stat"]["calls"] == 3
    # one built program serves all three identical pipelines
    assert stats["stat"]["builds"] == 1
    assert "welford" in stats
    assert stats["stat"]["dispatch_s"] >= 0.0
    txt = profile.report(stats)
    assert "stat" in txt and "builds" in txt
    # the patch is scoped: outside the context the plain cache is back
    import bolt_tpu_torch.gpu.array as arr
    import bolt_tpu_torch.gpu.stats as stats_mod
    assert arr._cached_jit is not stats_mod._cached_jit
    assert arr._cached_jit.__module__ == "bolt_tpu_torch.gpu.array"
    assert stats_mod._cached_jit.__module__ == "bolt_tpu_torch.gpu.stats"


def test_instrument_detects_recompiles():
    b = bolt.array(np.random.RandomState(1).randn(8, 4), context=CPU)
    with profile.instrument() as stats:
        for _ in range(3):
            b.map(lambda v: v + 1).sum().toarray()   # fresh lambda: rebuilds
    assert stats["stat"]["builds"] == 3              # the smoking gun
