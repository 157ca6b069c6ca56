"""The port's abstract pipeline checker (``bolt_tpu_torch.analysis``)
against the reference's, on the CPU.

The checker halves of ``tests/test_static_analysis.py`` (its lint tests
are in ``tests/test_torch_lint.py``): each test builds the same pipeline
from the same seeded numpy inputs in ``bolt_tpu`` (the 8-device CPU mesh,
x64 on, as ``tests/conftest.py`` sets it up) and in the port
(``context=torch.device("cpu")``), checks both, and holds the reports to
EXACT agreement (no tolerance: the reports hold shapes, dtypes, codes and
integers): the set of codes (BLT004, an idle-mesh warning the reference
may emit on its 8-device mesh, aside), each code's severity, the stage
count, each stage's shape, dtype and split, ``dynamic``, ``ok``,
``shape``, ``max_shape`` and ``dtype``.  Each check leaves the engine's
builds, dispatches and the kernel launch counters flat, and resolves
nothing.  ``strict()`` refuses an error finding before any build and
passes a clean pipeline bit for bit.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu import analysis as ref_analysis, engine as ref_engine
from bolt_tpu.tpu.array import BoltArrayTPU
from bolt_tpu_torch import _lockdep, analysis, engine, ops
from bolt_tpu_torch.analysis import PipelineError
from bolt_tpu_torch.gpu.array import BoltArrayGPU
from bolt_tpu_torch.ops import kernels

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _witness():
    """The port's lock witness, armed over every test: the checker runs
    under the terminals' guard, inside a group's resolution and a
    batched dispatch."""
    before = len(_lockdep.violations())
    was = _lockdep.enabled()
    _lockdep.enable()
    try:
        yield
    finally:
        if not was:
            _lockdep.disable()
    new = _lockdep.violations()[before:]
    assert not new, "lockdep violations during test:\n" + "\n".join(new)


def _x():
    return np.random.RandomState(0).randn(16, 6, 4)


def _flat(c0):
    """The engine's builds/dispatches and every kernel launch counter
    since ``c0`` (all must stay 0 across a check)."""
    c1 = engine.counters()
    out = {k: c1[k] - c0[0][k]
           for k in ("misses", "aot_compiles", "dispatches")}
    out.update({k: v - c0[1].get(k, 0) for k, v in kernels.LAUNCHES.items()})
    return {k: v for k, v in out.items() if v}


def _counters():
    return engine.counters(), dict(kernels.LAUNCHES)


def _codes(rep):
    return {d.code for d in rep.diagnostics} - {"BLT004"}


def agree(rr, pr):
    """The port's report ``pr`` equals the reference's ``rr`` exactly
    (BLT004 aside)."""
    assert _codes(rr) == _codes(pr), (rr.diagnostics, pr.diagnostics)
    for code in _codes(pr):
        assert {d.severity for d in rr.diagnostics if d.code == code} == \
            {d.severity for d in pr.diagnostics if d.code == code}, code
    assert len(rr.stages) == len(pr.stages), (str(rr), str(pr))
    for rs, ps in zip(rr.stages, pr.stages):
        assert tuple(rs.shape) == tuple(ps.shape), (rs.render(), ps.render())
        assert np.dtype(rs.dtype) == np.dtype(ps.dtype), (rs.render(),
                                                          ps.render())
        assert rs.split == ps.split and rs.dynamic == ps.dynamic
    assert rr.dynamic == pr.dynamic and rr.ok == pr.ok
    assert rr.shape == pr.shape and rr.max_shape == pr.max_shape
    assert (rr.dtype is None) == (pr.dtype is None)
    if pr.dtype is not None:
        assert np.dtype(rr.dtype) == np.dtype(pr.dtype)


def both(ref_obj, port_obj):
    """Check both; the port's check must leave every counter flat."""
    rr = ref_analysis.check(ref_obj)
    c0 = _counters()
    pr = analysis.check(port_obj)
    assert _flat(c0) == {}
    agree(rr, pr)
    return rr, pr


# ----------------------------------------------------------------------
# predictions
# ----------------------------------------------------------------------

def test_check_concrete_array(mesh):
    rr, pr = both(ref.array(_x(), mesh), bolt.array(_x(), CPU))
    assert pr.ok and pr.shape == (16, 6, 4)
    assert np.dtype(pr.dtype) == np.float64
    assert pr.stages[0].spec == CPU           # the stage's device


def test_check_predicts_chain_shape_and_dtype(mesh):
    r = ref.array(_x(), mesh).map(lambda v: v * 2).map(
        lambda v: v.sum(axis=0)).map(lambda v: v.astype(np.float32))
    p = bolt.array(_x(), CPU).map(lambda v: v * 2).map(
        lambda v: v.sum(axis=0)).map(lambda v: v.to(torch.float32))
    rr, pr = both(r, p)
    assert len(pr.stages) == 4 and pr.shape == (16, 4)
    got = p.toarray()
    assert got.shape == pr.shape and got.dtype == pr.dtype


def test_check_with_keys_stage(mesh):
    rr, pr = both(
        ref.array(_x(), mesh).map(lambda kv: kv[1] + kv[0][0],
                                  with_keys=True),
        bolt.array(_x(), CPU).map(lambda kv: kv[1] + kv[0][0],
                                  with_keys=True))
    assert pr.ok and "with_keys" in pr.stages[1].op


def test_check_deferred_filter_is_dynamic_and_does_not_resolve(mesh):
    r = ref.array(_x(), mesh).map(lambda v: v + 1).filter(
        lambda v: v.mean() > 0)
    p = bolt.array(_x(), CPU).map(lambda v: v + 1).filter(
        lambda v: v.mean() > 0)
    rr, pr = both(r, p)
    assert p.pending                        # the checker did not resolve it
    assert pr.dynamic and pr.shape == (None, 6, 4)
    assert pr.max_shape == (16, 6, 4) and pr.has("BLT008")
    got = p.toarray()
    assert got.shape[1:] == pr.shape[1:] and got.dtype == pr.dtype
    assert got.shape == np.asarray(r.toarray()).shape


def test_check_views_and_explain(mesh):
    r = ref.array(_x(), mesh).map(lambda v: v * 3)
    p = bolt.array(_x(), CPU).map(lambda v: v * 3)
    rr, pr = both(r.chunk(size=(3,), axis=(0,)),
                  p.chunk(size=(3,), axis=(0,)))
    assert pr.ok and "chunked view" in pr.target
    rr2, pr2 = both(r.stacked(size=4), p.stacked(size=4))
    assert pr2.ok and "stacked view" in pr2.target
    txt = analysis.explain(p)
    assert "stage 0" in txt and "map" in txt and "OK" in txt


def test_check_local_array_trivial():
    rr = ref_analysis.check(ref.array(_x()))
    pr = analysis.check(bolt.array(_x()))
    agree(rr, pr)
    assert pr.ok and pr.shape == (16, 6, 4) and pr.target == "local"


# ----------------------------------------------------------------------
# seeded diagnostics, one per code
# ----------------------------------------------------------------------

def _bad_pair(mesh, split=1, shape=(16, 6, 4), lie=None):
    """The reference's and the port's hand-built chain with a bad
    matmul (``v @ ones((99, 2))``)."""
    x = np.ones(shape) if shape != (16, 6, 4) else _x()
    rb = ref.array(x, mesh)._data
    rbad = BoltArrayTPU._deferred(
        rb, (lambda v: v @ jnp.ones((99, 2)),), split, mesh,
        jax.ShapeDtypeStruct(lie or (16, 2), np.float64))
    pb = bolt.array(x, CPU)._data
    pbad = BoltArrayGPU._deferred(
        pb, (lambda v: v @ torch.ones((99, 2), dtype=torch.float64),),
        split, CPU, lie or (16, 2), np.float64)
    return rbad, pbad


def test_blt001_stage_trace_failure(mesh):
    rr, pr = both(*_bad_pair(mesh))
    assert not pr.ok and pr.has("BLT001")
    d = [e for e in pr.errors if e.code == "BLT001"][0]
    assert d.stage == 1 and "abstract tracing" in d.message


def test_blt002_recorded_aval_lie(mesh):
    rb = ref.array(_x(), mesh)._data
    rliar = BoltArrayTPU._deferred(
        rb, (lambda v: v * 2,), 1, mesh,
        jax.ShapeDtypeStruct((16, 99), np.float32))
    pb = bolt.array(_x(), CPU)._data
    pliar = BoltArrayGPU._deferred(pb, (lambda v: v * 2,), 1, CPU,
                                   (16, 99), np.float32)
    rr, pr = both(rliar, pliar)
    assert not pr.ok and pr.has("BLT002") and "(16, 99)" in str(pr)


def test_blt003_dtype_widening(mesh):
    x = _x().astype(np.float32)
    r = ref.array(x, mesh).map(lambda v: v * np.float64(2))
    # torch promotes by a 0-d operand's category only: widen explicitly
    p = bolt.array(x, CPU).map(lambda v: v.double() * 2)
    rr, pr = both(r, p)
    assert pr.ok and pr.has("BLT003")
    assert np.dtype(pr.dtype) == np.float64
    assert p.toarray().dtype == np.float64      # it predicted reality


def test_blt004_registered_never_emitted_on_one_card(mesh):
    # the reference's 6 keys cannot divide its 8-device mesh (BLT004);
    # one card has no idle devices: the code is registered, never emitted
    y = np.random.RandomState(1).randn(6, 4)
    rr, pr = both(ref.array(y, mesh), bolt.array(y, CPU))
    assert rr.has("BLT004") and not pr.has("BLT004") and pr.ok
    assert analysis.CODES["BLT004"] == ref_analysis.CODES["BLT004"]


def test_blt005_use_after_donate_names_operation(mesh):
    x = _x()
    with ref_engine.donation(0), engine.donation(0):
        r = ref.array(x, mesh).map(lambda v: v + 1)
        r.sum().toarray()
        p = bolt.array(x, CPU).map(lambda v: v + 1)
        p.sum().toarray()
        rr, pr = both(r, p)
        assert not pr.ok and pr.has("BLT005")
        assert "sum()" in pr.errors[0].message
        with pytest.raises(RuntimeError, match=r"donated to sum\(\)"):
            p.toarray()


def test_blt006_donation_forecast_is_side_effect_free(mesh):
    x = _x()
    with ref_engine.donation(0), engine.donation(0):
        r = ref.array(x, mesh).map(lambda v: v + 1)
        p = bolt.array(x, CPU).map(lambda v: v + 1)
        rr, pr = both(r, p)
        assert pr.ok and pr.has("BLT006")
        # the forecast consumed nothing: the terminal still donates
        n0 = engine.counters()["donations"]
        p.sum().toarray()
        assert engine.counters()["donations"] == n0 + 1
    # outside the scope small chains do not donate, and the forecast
    # says so
    p2 = bolt.array(x, CPU).map(lambda v: v + 1)
    assert not analysis.check(p2).has("BLT006")
    n0 = engine.counters()["donations"]
    p2.sum().toarray()
    assert engine.counters()["donations"] == n0


@pytest.mark.parametrize("guarded", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("held", [False, True])
def test_blt006_forecast_equals_realised_donation(held, guarded):
    """Both directions: the forecast equals the realised ``donations``
    counter, with the chain sole-owned and with its parent held; under
    strict() the gate's own check leaves the terminal's decision as it
    was."""
    import contextlib
    x = _x()
    with engine.donation(0):
        parent = bolt.array(x, CPU)
        p = parent.map(lambda v: v * 2)
        if not held:
            del parent
        forecast = analysis.check(p).has("BLT006")
        n0 = engine.counters()["donations"]
        with analysis.strict() if guarded else contextlib.nullcontext():
            out = p.cache()
        assert (engine.counters()["donations"] - n0 == 1) == forecast
    assert forecast == (not held)
    assert np.array_equal(out.toarray(), x * 2)


def test_check_survives_malformed_split_state(mesh):
    # split beyond the base rank: BLT001 from the impossible vmap, and
    # strict refuses instead of crashing
    rr, pr = both(*_bad_pair(mesh, split=5, shape=(8, 4), lie=(8, 4)))
    assert not pr.ok and pr.has("BLT001")
    _, pbad = _bad_pair(mesh, split=5, shape=(8, 4), lie=(8, 4))
    with analysis.strict():
        with pytest.raises(PipelineError):
            pbad.sum()


def test_blt007_nonscalar_predicate_seeded(mesh):
    rb = ref.array(_x(), mesh)
    rbad = BoltArrayTPU(None, 1, mesh)
    rbad._fpending = (rb._data, (), lambda v: v > 0, 1, (6, 4), 16,
                      np.dtype(np.float64))
    pb = bolt.array(_x(), CPU)
    pbad = BoltArrayGPU(None, 1, CPU)
    pbad._fpending = (pb._data, (), lambda v: v > 0, 1, (6, 4), 16)
    pbad._dtype = np.dtype(np.float64)
    rr, pr = both(rbad, pbad)
    assert not pr.ok and pr.has("BLT007") and "scalar" in str(pr)


def test_donated_filter_metadata_raises_named_guard():
    with engine.donation(0):
        f = bolt.array(_x(), CPU).filter(lambda v: v.mean() > 0)
        f.sum().toarray()
        rep = analysis.check(f)
        assert not rep.ok and rep.has("BLT005")
        for read in (lambda: f.shape, lambda: f.toarray()):
            with pytest.raises(RuntimeError,
                               match=r"donated to filter\(\)\.sum\(\)"):
                read()


def test_donated_array_repr_never_raises():
    with engine.donation(0):
        f = bolt.array(_x(), CPU).filter(lambda v: v.mean() > 0)
        f.sum().toarray()
        assert "filter().sum()" in repr(f)
        d = bolt.array(_x(), CPU).map(lambda v: v + 1)
        d.sum().toarray()
        r = repr(d)
        assert "sum()" in r and "(16, 6, 4)" in r
        assert analysis.check(d).has("BLT005")


def test_donation_scope_is_thread_local():
    x = _x()
    seen = []
    inner = threading.Event()
    done = threading.Event()

    def other_thread():
        inner.wait(5)
        seen.append(engine.donation_min_bytes())
        d = bolt.array(x, CPU).map(lambda v: v + 1)
        seen.append(analysis.check(d).has("BLT006"))
        d.sum().toarray()
        seen.append(d.toarray().shape)
        done.set()

    t = threading.Thread(target=other_thread)
    t.start()
    with engine.donation(0):
        inner.set()
        assert done.wait(30)
    t.join()
    assert seen[0] == engine.donation_min_bytes() and seen[0] >= 1
    assert seen[1] is False and seen[2] == (16, 6, 4)


def test_precision_alias_import_keeps_package_scope_callable(monkeypatch):
    # importing the alias module rebinds the package attribute to it;
    # monkeypatch puts the package's function back for the other tests
    import bolt_tpu_torch
    monkeypatch.setattr(bolt_tpu_torch, "precision",
                        bolt_tpu_torch.precision)
    from bolt_tpu_torch.precision import resolve as r
    with bolt_tpu_torch.precision("default"):
        assert r() == "default"
    assert r() == "highest"


def test_diagnostics_counter_fed_by_checker():
    c0 = engine.counters()["diagnostics"]
    analysis.check(bolt.array(_x(), CPU).filter(lambda v: v.mean() > 0))
    assert engine.counters()["diagnostics"] > c0   # >= the BLT008 info


def test_blt012_registered_and_single_process_quiet(mesh):
    assert analysis.CODES["BLT012"][0] == "error"
    x = np.arange(14 * 3, dtype=np.float32).reshape(14, 3)
    r = ref.fromcallback(lambda idx: x[idx], (14, 3), mesh,
                         dtype=np.float32, chunks=3)
    p = bolt.fromcallback(lambda idx: x[idx], (14, 3), CPU,
                          dtype=np.float32, chunks=3)
    rr, pr = both(r.map(lambda v: v + 1), p.map(lambda v: v + 1))
    assert not pr.has("BLT012")


def test_code_table_is_the_references():
    assert analysis.CODES == ref_analysis.CODES
    assert set(analysis.__all__) == set(ref_analysis.__all__)


# ----------------------------------------------------------------------
# strict: the engine's pre-dispatch gate
# ----------------------------------------------------------------------

def test_strict_clean_pipeline_dispatches_bit_for_bit():
    x = _x()
    want = bolt.array(x, CPU).map(lambda v: v + 1).sum().toarray()
    with analysis.strict():
        c0 = engine.counters()["strict_checks"]
        out = bolt.array(x, CPU).map(lambda v: v + 1).sum()
        got = out.toarray()
        assert engine.counters()["strict_checks"] > c0
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_strict_refuses_error_findings_before_any_build(mesh):
    _, bad = _bad_pair(mesh)
    c0 = _counters()
    r0 = engine.counters()["strict_rejections"]
    with analysis.strict():
        with pytest.raises(PipelineError, match="BLT001"):
            bad.sum()
        with pytest.raises(PipelineError, match="refusing to dispatch"):
            bad.reduce(np.add)
    assert _flat(c0) == {}                 # refused BEFORE building
    assert engine.counters()["strict_rejections"] >= r0 + 2
    # outside the scope the gate is disarmed: the failure is torch's own,
    # at the lazy terminal's first read
    with pytest.raises(Exception):
        bad.sum().cache()


def test_strict_gates_views_and_filters(mesh):
    _, bad = _bad_pair(mesh)
    with analysis.strict():
        with pytest.raises(PipelineError):
            bad.chunk(size=(3,), axis=(0,)).map(lambda blk: blk * 2)
        with pytest.raises(PipelineError):
            bad.stacked(size=4).map(lambda blk: blk - 1)
        with pytest.raises(PipelineError):
            bad.toarray()                  # chain materialisation
    assert bolt.array(_x(), CPU).map(lambda v: v).sum() is not None


def test_strict_gates_a_stat_groups_resolution(mesh):
    """The group's resolve runs the gate too (through a pending
    member): a group formed outside the scope and read inside it is
    checked once more."""
    x = _x()
    m = bolt.array(x, CPU).map(lambda v: v + 1)
    s, v = m.sum(), m.var()
    with analysis.strict():
        c0 = engine.counters()["strict_checks"]
        got = s.toarray()
        assert engine.counters()["strict_checks"] == c0 + 1
    assert np.array_equal(got, bolt.array(x, CPU).map(
        lambda v: v + 1).sum().toarray())
    assert v._spending is None or v._spending.result is not None


def test_strict_is_thread_local_and_nests():
    errs = []

    def other_thread():
        try:
            assert not analysis.in_strict()
            bolt.array(np.ones((8, 3)), CPU).map(lambda v: v + 1).sum()
        except Exception as exc:           # pragma: no cover
            errs.append(exc)

    with analysis.strict():
        with analysis.strict():
            assert analysis.in_strict()
        assert analysis.in_strict()
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(30)
        assert not t.is_alive()
    assert not errs and not analysis.in_strict()
    assert engine._STRICT_GUARD is None


def test_strict_scopes_from_many_threads_leave_no_guard():
    """Eight threads enter and leave nested strict scopes at a short
    switch interval while checking and dispatching: the process-wide
    count returns to 0 and the engine's guard is uninstalled."""
    import sys
    from bolt_tpu_torch import analysis as pkg
    errs = []
    x = np.ones((8, 3))

    def worker(i):
        try:
            for _ in range(50):
                with analysis.strict():
                    with analysis.strict():
                        bolt.array(x, CPU).map(lambda v: v + i).sum()
                assert not analysis.in_strict()
        except Exception as exc:           # pragma: no cover
            errs.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert not errs, errs
    assert pkg._ACTIVE == 0 and engine._STRICT_GUARD is None


# ----------------------------------------------------------------------
# the view terminals: the guard names the donating operation and the
# check flags it before the next dispatch
# ----------------------------------------------------------------------

def test_chunk_map_donation_guard_names_operation(mesh):
    x = np.abs(_x())
    with ref_engine.donation(0), engine.donation(0):
        r = ref.array(x, mesh).map(lambda v: v * 3)
        r.chunk(size=(3,), axis=(0,)).map(lambda blk: blk * 2)
        p = bolt.array(x, CPU).map(lambda v: v * 3)
        got = p.chunk(size=(3,), axis=(0,)).map(lambda blk: blk * 2)
        assert np.allclose(got.unchunk().toarray(), x * 6)
        rr, pr = both(r, p)
        assert not pr.ok and "chunk().map()" in pr.errors[0].message
        with pytest.raises(RuntimeError,
                           match=r"donated to chunk\(\)\.map\(\)"):
            p.toarray()


def test_stack_map_donation_guard_names_operation(mesh):
    x = np.abs(_x())
    with ref_engine.donation(0), engine.donation(0):
        r = ref.array(x, mesh).map(lambda v: v - 1)
        r.stacked(size=4).map(lambda blk: blk * 2)
        p = bolt.array(x, CPU).map(lambda v: v - 1)
        got = p.stacked(size=4).map(lambda blk: blk * 2)
        assert np.allclose(got.unstack().toarray(), (x - 1) * 2)
        rr, pr = both(r, p)
        assert not pr.ok and "stacked().map()" in pr.errors[0].message
        with pytest.raises(RuntimeError,
                           match=r"donated to stacked\(\)\.map\(\)"):
            p.sum()


def test_swap_donation_guard_names_operation(mesh):
    with ref_engine.donation(0), engine.donation(0):
        r = ref.array(_x(), mesh)
        r.swap((0,), (0,), donate=True)
        p = bolt.array(_x(), CPU)
        p.swap((0,), (0,), donate=True)
        rr, pr = both(r, p)
        assert not pr.ok and pr.has("BLT005")
        with pytest.raises(RuntimeError, match=r"swap"):
            p.toarray()


def test_trace_error_stage_is_a_note_not_blt001():
    """A callable vmap cannot batch (the class map() and filter() reroute
    to the host fallback) reads as a stage with a note, not BLT001; a
    callable bug (the terminals' TypeError) is BLT001."""
    x = _x()
    base = bolt.array(x, CPU)._data
    host = BoltArrayGPU._deferred(
        base, (lambda v: v if bool(v.sum() > 0) else -v,), 1, CPU,
        (16, 6, 4), np.float64)
    rep = analysis.check(host)
    assert rep.ok and not rep.has("BLT001")
    assert "host fallback" in rep.stages[-1].note
    bug = BoltArrayGPU._deferred(base, (lambda v: v.reshape(7, -1),), 1,
                                 CPU, (16, 6, 4), np.float64)
    with pytest.raises(TypeError):
        bolt.array(x, CPU).map(lambda v: v.reshape(7, -1))
    assert analysis.check(bug).has("BLT001")


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
@pytest.mark.parametrize("name", ["wrap_floordiv", "wrap_gt"])
def test_unsigned_chain_checks_through_carrier_calls(mesh, dtype, name):
    """A callable torch has no unsigned kernel for runs on its carriers
    under ``CarrierMode`` at the terminal; the checker predicts its
    result through the same ``_user_call`` (on meta tensors, where the
    kernel exists), and the prediction is the executed dtype and
    shape."""
    from bolt_tpu_torch.gpu import array as garray
    f = {"wrap_floordiv": lambda v: (v - 5) // 2,
         "wrap_gt": lambda v: (v - 5) > 3}[name]
    x = (np.arange(16 * 6) % 11).astype(dtype).reshape(16, 6)
    r = ref.array(x, mesh).map(f)
    p = bolt.array(x, CPU).map(f)
    rr, pr = both(r, p)
    got = p.toarray()
    assert got.dtype == pr.dtype and got.shape == pr.shape
    assert np.array_equal(got, np.asarray(r.toarray()))
    plans = garray._CARRIED_CALLS[f]
    assert any(v is not None for (_, dev), v in plans.items()
               if dev == "cpu"), plans     # the terminal took the carriers


# ----------------------------------------------------------------------
# the BASELINE configs 1–5b: every pipeline checks clean, with the
# prediction the terminal realises
# ----------------------------------------------------------------------

ADD1 = lambda v: v + 1          # noqa: E731
MEANPOS = lambda v: v.mean() > 0    # noqa: E731


def _pipelines(pkg, ctx, k=16):
    rs = np.random.RandomState(7)
    x2 = (np.abs(rs.randn(k, 6, 4)) + 0.5).astype(np.float32)
    x4 = rs.randn(k, 6, 4).astype(np.float32)
    x3 = rs.randn(k, 4, 6).astype(np.float32)
    x5 = rs.randn(8, 32, 4).astype(np.float32)
    x5b = rs.randn(4, 64, 4).astype(np.float32)
    sqrt = np.sqrt if pkg is ref else torch.sqrt
    return [
        ("1 map->sum", pkg.array(np.ones((k, 8, 4), np.float32),
                                 ctx).map(ADD1)),
        ("2 ufunc+reductions", pkg.array(x2, ctx).map(sqrt)),
        ("3 swap", pkg.array(x3, ctx).map(ADD1)),
        ("4 filter mask", pkg.array(x4, ctx).filter(MEANPOS)),
        ("4b filter->sum fused", pkg.array(x4, ctx).filter(MEANPOS)),
        ("5 per-chunk SVD", pkg.array(x5, ctx).map(ADD1).chunk(
            size=(8,), axis=(0,))),
        ("5b per-chunk Jacobi", pkg.array(x5b, ctx).chunk(
            size=(16,), axis=(0,))),
    ]


def test_bench_all_configs_check_clean(mesh):
    for (name, r), (_, p) in zip(_pipelines(ref, mesh),
                                 _pipelines(bolt, CPU)):
        rr, pr = both(r, p)
        assert pr.ok, (name, pr.diagnostics)
        target = p.unchunk() if hasattr(p, "unchunk") else p
        got_shape = tuple(target.shape)
        if pr.dynamic:
            assert pr.shape[0] is None and pr.shape[1:] == got_shape[1:]
        else:
            assert pr.shape == got_shape, name
        assert np.dtype(pr.dtype) == np.dtype(target.dtype), name


def test_bench_configs_run_under_strict_bit_for_bit():
    """Each config's terminal under strict() equals its unguarded run."""
    def run(ps):
        out = {}
        for name, p in ps:
            if name.startswith("5"):
                out[name] = p.map(lambda blk: ops.svdvals(blk)[None, :]
                                  if name == "5b per-chunk Jacobi"
                                  else torch.linalg.svdvals(blk)[None, :]
                                  ).unchunk().toarray()
            elif name.startswith("4b"):
                out[name] = p.sum().toarray()
            elif name.startswith("3"):
                out[name] = p.swap((0,), (0,)).toarray()
            else:
                out[name] = p.toarray()
        return out

    plain = run(_pipelines(bolt, CPU))
    with analysis.strict():
        c0 = engine.counters()["strict_checks"]
        guarded = run(_pipelines(bolt, CPU))
        assert engine.counters()["strict_checks"] > c0
    for name in plain:
        a, b = plain[name], guarded[name]
        assert a.dtype == b.dtype and np.array_equal(a, b), name
