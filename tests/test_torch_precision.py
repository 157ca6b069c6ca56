"""The port's scoped precision policy (``bolt_tpu_torch._precision``)
against the reference's (``bolt_tpu._precision``): the same calls give the
same resolutions and the same errors.  Follows ``test_precision.py``."""

import threading

import numpy as np
import pytest
import torch

import bolt_tpu._precision as refp
import bolt_tpu_torch as bolt
import bolt_tpu_torch._precision as P


@pytest.mark.parametrize("mod", [refp, P], ids=["reference", "port"])
def test_resolution_order(mod):
    assert mod.resolve() == "highest"
    assert mod.resolve(pinned="default") == "default"
    with mod.precision("default"):
        assert mod.resolve() == "default"
        with mod.precision("HIGH"):
            assert mod.resolve() == "high"
        assert mod.resolve() == "default"
        assert mod.resolve("highest") == "highest"     # explicit wins
    assert mod.resolve() == "highest"


def test_modes_match_reference():
    assert P.MODES == refp.MODES


@pytest.mark.parametrize("bad", ["bf16", "fast", 3, None])
def test_invalid_modes_rejected_like_reference(bad):
    for mod in (refp, P):
        with pytest.raises(ValueError, match="precision mode"):
            with mod.precision(bad):
                pass
    if bad is not None:             # resolve(None) means "no explicit"
        with pytest.raises(ValueError, match="precision mode"):
            P.resolve(bad)


def test_scope_is_exception_safe_and_thread_local():
    with pytest.raises(RuntimeError):
        with P.precision("default"):
            raise RuntimeError("boom")
    assert P.resolve() == "highest"
    seen = []
    with P.precision("default"):
        t = threading.Thread(target=lambda: seen.append(P.resolve()))
        t.start()
        t.join()
        assert P.resolve() == "default"
    assert seen == ["highest"]


def test_package_exports_the_scope():
    assert bolt.precision is P.precision
    with bolt.precision("high"):
        assert P.resolve() == "high"
    from bolt_tpu_torch.precision import MODES, resolve
    assert MODES == P.MODES and resolve is P.resolve
    import bolt_tpu_torch.precision as alias
    with alias("default"):                  # the module itself is callable
        assert P.resolve() == "default"


def test_float32_matmul_scope_restores_the_setting():
    # detrend's pin sets "highest" for its block and restores the
    # caller's setting after, also when the block raises
    from bolt_tpu_torch.ops.series import _highest_matmul
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        with _highest_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "medium"
        with pytest.raises(RuntimeError), _highest_matmul():
            raise RuntimeError
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_detrend_runs_highest_inside_any_scope():
    # detrend pins "highest" explicitly, as the reference does
    from bolt_tpu_torch import ops
    x = np.random.RandomState(4).randn(4, 12).astype(np.float32)
    cpu = torch.device("cpu")
    want = ops.detrend(bolt.array(x, cpu)).toarray()
    with bolt.precision("default"):
        np.testing.assert_array_equal(
            ops.detrend(bolt.array(x, cpu)).toarray(), want)
