"""User callables on the port against the reference: the exception a bug
raises (ROADMAP C7) and torch's rules inside a callable (C8).

C7: a bug in a callable that shape inference meets (a bad reshape,
mismatched shapes) raises the reference's ``TypeError``, chained to
torch's ``RuntimeError``, with a message naming the record's shape and
not vmap's batched one: ``map``, ``filter`` (whole and fused into a
reduction), ``reduce``, a stream's stage and ``np.apply_along_axis``;
the reference raises ``TypeError`` for the same callables
(``tests/test_tpu_functional.py:107-124``).  A trace error still takes
the host fallback, and an error that is not torch's ``RuntimeError``
(an ``AttributeError`` of a typo) passes through as it is.

C8 (pinned differences, ``gpu/dtypes.py``'s docstring): an ``int32``
record minus a Python float is float32 inside a callable (torch's rule)
where the reference's is float64, while the operator form follows jnp in
both; ``Tensor.mean()`` refuses an integer record, so
``filter(lambda v: v.mean() > 0)`` raises on an integer array where the
reference's filters.
"""

import warnings

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt

CPU = torch.device("cpu")


def _x():
    return np.random.RandomState(3).randn(8, 4, 5)


BUGS = {
    "map": lambda b: b.map(lambda v: v.reshape(3)),
    "filter": lambda b: b.filter(
        lambda v: (v + torch.ones(7, dtype=v.dtype)).sum() > 0),
    "reduce": lambda b: b.reduce(
        lambda a, c: a @ torch.ones((99, 2), dtype=a.dtype)),
    "filter_reduce": lambda b: b.filter(lambda v: v.sum() > 0).reduce(
        lambda a, c: a @ torch.ones((99, 2), dtype=a.dtype)),
}
REF_BUGS = {
    "map": lambda b: b.map(lambda v: v.reshape(3)),
    "filter": lambda b: b.filter(lambda v: (v + np.ones(7)).sum() > 0),
    "reduce": lambda b: b.reduce(lambda a, c: a @ np.ones((99, 2))),
    "filter_reduce": lambda b: b.filter(lambda v: v.sum() > 0).reduce(
        lambda a, c: a @ np.ones((99, 2))),
}


@pytest.mark.parametrize("name", sorted(BUGS))
def test_callable_bug_raises_the_references_type(mesh, name):
    with warnings.catch_warnings():
        warnings.simplefilter("error", bolt.HostFallbackWarning)
        warnings.simplefilter("error", ref.HostFallbackWarning)
        with pytest.raises((TypeError, ValueError)):
            np.asarray(REF_BUGS[name](ref.array(_x(), mesh)).toarray())
        with pytest.raises(TypeError) as info:
            np.asarray(BUGS[name](bolt.array(_x(), CPU)).toarray())
    exc = info.value
    assert isinstance(exc.__cause__, RuntimeError)
    # the record's shape, not vmap's batched one
    assert "(4, 5)" in str(exc) and "[1," not in str(exc)


def test_map_bug_message_names_the_record():
    with pytest.raises(TypeError, match=r"map: the callable .* record of "
                                        r"shape \(4, 5\)"):
        bolt.array(_x(), CPU).map(lambda v: v.reshape(3))


def test_stream_stage_bug_raises_type_error():
    x = _x()
    src = bolt.fromcallback(lambda i: x[i], x.shape, CPU, dtype=np.float64,
                            chunks=2)
    with pytest.raises(TypeError):
        src.map(lambda v: v.reshape(3))
    with pytest.raises(TypeError):
        src.chunk((2, 5)).map(lambda c: c.reshape(7))


def test_apply_along_axis_bug_raises_type_error():
    b = bolt.array(_x(), CPU)
    with pytest.raises(TypeError):
        np.apply_along_axis(lambda v: v.reshape(3), 1, b)


def test_typo_passes_through_and_trace_error_falls_back():
    b = bolt.array(_x(), CPU)
    with pytest.raises(AttributeError):
        b.map(lambda v: v.nonexistent_attr)
    with pytest.warns(bolt.HostFallbackWarning, match="map"):
        out = b.map(lambda v: np.asarray(v) * 2)
    np.testing.assert_allclose(np.asarray(out.toarray()), _x() * 2)


# ---------------------------------------------------------------------
# C8: torch's rules inside a callable (pinned)
# ---------------------------------------------------------------------

def test_int_record_minus_float_promotes_by_torchs_rule(mesh):
    x = np.arange(24, dtype=np.int32).reshape(6, 4)
    got = bolt.array(x, CPU).map(lambda v: v - 0.25).toarray()
    want = ref.array(x, mesh).map(lambda v: v - 0.25).toarray()
    assert got.dtype == np.float32 and want.dtype == np.float64
    np.testing.assert_array_equal(got, want.astype(np.float32))
    # the operator form follows jnp in both
    assert (bolt.array(x, CPU) - 0.25).toarray().dtype == np.float64
    assert (ref.array(x, mesh) - 0.25).toarray().dtype == np.float64
    # streamed alike
    s = bolt.fromcallback(lambda i: x[i], x.shape, CPU, dtype=np.int32,
                          chunks=2)
    assert s.map(lambda v: v - 0.25).sum().toarray().dtype == np.float32


def test_integer_record_mean_in_a_predicate_raises(mesh):
    x = np.arange(24, dtype=np.int32).reshape(6, 4) - 10
    want = ref.array(x, mesh).filter(lambda v: v.mean() > 0).toarray()
    assert len(want) == 3
    with pytest.raises(TypeError) as info:
        bolt.array(x, CPU).filter(lambda v: v.mean() > 0)
    assert "mean" in str(info.value.__cause__)
    # the float form filters as the reference does
    got = bolt.array(x, CPU).filter(lambda v: v.float().mean() > 0)
    assert np.array_equal(np.asarray(got.toarray()), want)
