"""The port's lock inventory and runtime witness
(``bolt_tpu_torch/_lockdep.py``) and the engine's dispatch schedule:
the witness, factory, ``note_dispatch`` and schedule tests of
``tests/test_concurrency.py`` on the port, on the CPU, with the port's
lock names (``engine.cache`` 54 over ``stream.reseq`` 40 for the
inversion, ``gpu.lru`` for the leaf, ``stream.ring`` for a lock that
must not be held across a dispatch).  Then the port's own paths under
the armed witness: a map-sum, a group, a filter, a chunk and a stacked
map, and a streamed run record no violation.  The lint tests (BLT111 to
BLT114) are in ``tests/test_torch_lint.py``, the serving-layer races in
``tests/test_torch_serve.py``."""

import ast
import os

import numpy as np
import pytest
import torch

import bolt_tpu as ref
import bolt_tpu_torch as bolt
from bolt_tpu_torch import _lockdep, engine, obs

CPU = torch.device("cpu")
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bolt_tpu_torch")


@pytest.fixture
def witness():
    was = _lockdep.enabled()
    _lockdep.reset()
    _lockdep.enable()
    yield _lockdep
    _lockdep.disable()
    _lockdep.reset()
    if was:
        _lockdep.enable()


def test_factory_rejects_undeclared_names():
    with pytest.raises(ValueError, match="not in the declared"):
        _lockdep.lock("no.such.lock")
    with pytest.raises(ValueError, match="not in the declared"):
        _lockdep.condition("also.not.a.lock")


def test_reference_names_keep_their_ranks():
    from bolt_tpu import _lockdep as ref_lockdep
    for name in ("engine.cache", "engine.compile", "engine.order",
                 "multistat.group", "stream.reseq", "stream.uploader_hw",
                 "obs.trace", "obs.registry"):
        assert _lockdep.RANKS[name] == ref_lockdep.RANKS[name], name
    # the port's own caches nest as they are used: a chain program is
    # compiled under a build (engine.cache), a kernel library loaded
    # under a dispatch (engine.order)
    r = _lockdep.RANKS
    assert r["engine.cache"] < r["mapexpr.programs"] < r["obs.registry"]
    assert r["engine.order"] < r["ops.build"] < r["obs.registry"]


def test_every_port_lock_is_a_named_lock():
    # no raw threading lock is constructed in the port outside the
    # witness's own bookkeeping lock
    raw = ("Lock", "RLock", "Condition")
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            tree = ast.parse(open(path).read(), filename=path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute) and \
                        node.func.attr in raw and isinstance(
                            node.func.value, ast.Name) and \
                        node.func.value.id == "threading":
                    assert f == "_lockdep.py", (path, node.lineno)
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute) and node.func.attr in (
                        "lock", "rlock", "condition") and isinstance(
                        node.func.value, ast.Name) and \
                        node.func.value.id == "_lockdep":
                    name = node.args[0].value
                    assert name in _lockdep.RANKS, (path, name)


def test_witness_records_rank_inversion(witness):
    outer = witness.lock("engine.cache")       # rank 54
    inner = witness.lock("stream.reseq")       # rank 40
    with outer:
        with inner:
            pass
    v = witness.violations()
    assert len(v) == 1 and "inversion" in v[0]
    assert "'stream.reseq' (rank 40)" in v[0]
    assert "'engine.cache' (rank 54)" in v[0]
    witness.reset()
    with inner:
        with outer:
            pass
    assert witness.violations() == []
    assert ("stream.reseq", "engine.cache") in witness.edges()
    assert witness.check() == []


def test_witness_raise_mode_throws_at_the_acquisition(witness):
    witness.enable(raise_on_violation=True)
    outer = witness.lock("engine.cache")
    inner = witness.lock("stream.reseq")
    with outer:
        with pytest.raises(witness.LockOrderError, match="inversion"):
            inner.acquire()
    witness.reset()


def test_witness_rlock_reentry_is_exempt(witness):
    rl = witness.rlock("engine.order")
    with rl:
        with rl:
            assert witness.held_names() == ["engine.order"]
    assert witness.violations() == []
    assert witness.held_names() == []


def test_witness_flags_nonreentrant_self_deadlock(witness):
    lk = witness.lock("gpu.lru")
    lk.acquire()
    try:
        assert lk.acquire(blocking=False) is False
    finally:
        lk.release()
    assert any("self-deadlock" in x for x in witness.violations())


def test_witness_off_means_no_tracking(witness):
    witness.disable()
    outer = witness.lock("engine.cache")
    inner = witness.lock("stream.reseq")
    with outer:
        with inner:                       # inverted — but unobserved
            assert witness.held_names() == []
    assert witness.violations() == []


def test_witness_stats_count_acquires(witness):
    base = witness.stats()["acquires"]
    lk = witness.lock("gpu.lru")
    for _ in range(5):
        with lk:
            pass
    st = witness.stats()
    assert st["acquires"] >= base + 5
    assert st["violations"] == 0
    snap = obs.registry().snapshot()
    assert snap.get("lockdep.acquires", 0) >= 5


def test_note_dispatch_flags_held_locks_except_dispatch_safe(witness):
    lk = witness.lock("stream.ring")
    with lk:
        witness.note_dispatch("test.dispatch")
    v = witness.violations()
    assert len(v) == 1 and "dispatch-under-lock" in v[0]
    assert "'stream.ring'" in v[0]
    witness.reset()
    grp = witness.lock("multistat.group")
    with grp:
        witness.note_dispatch("test.dispatch")
    assert witness.violations() == []
    witness.note_dispatch("test.dispatch")
    assert witness.violations() == []


def test_port_paths_record_no_violation(witness, mesh):
    x = np.random.RandomState(3).randn(12, 5, 4)
    b = bolt.array(x, context=CPU)
    s = b.map(lambda v: v + 1).sum().toarray()
    m = b.map(lambda v: v * 2)
    bolt.compute(m.sum(), m.var(), m.max())
    b.filter(lambda v: v.sum() > 0).mean().toarray()
    b.filter(lambda v: v.sum() > 0).toarray()
    b.chunk(size=(2,), axis=(0,)).map(lambda c: c * 3).unchunk().toarray()
    b.stacked(5).map(lambda blk: blk - blk.mean(0)).unstack().toarray()
    b.stats()
    xs = np.random.RandomState(4).randn(16, 6)
    with bolt.stream.uploaders(2):
        bolt.fromcallback(lambda i: xs[i], xs.shape, CPU, dtype=np.float64,
                          chunks=4).map(lambda v: v + 1).sum().toarray()
    assert witness.violations() == []
    assert witness.stats()["acquires"] > 0
    np.testing.assert_allclose(s, ref.array(x, mesh).map(
        lambda v: v + 1).sum().toarray(), rtol=1e-10)


# ---------------------------------------------------------------------
# the dispatch schedule
# ---------------------------------------------------------------------

def test_schedule_digest_advances_per_enqueue():
    x = np.arange(48, dtype=np.float64).reshape(8, 6)
    c0, d0 = engine.schedule_digest()
    bolt.array(x, context=CPU).map(lambda v: v * 2).sum().toarray()
    c1, d1 = engine.schedule_digest()
    assert c1 > c0 and d1 != d0
    assert engine.schedule_recent()


def test_stable_key_strips_object_addresses():
    def f():
        pass
    a = engine._stable_key(("sig", f, (8, 6)))
    assert "0x" not in a
    assert "at 0x%x" % id(f) not in a
    assert f.__name__ in a


def test_schedule_log_arm_and_reset():
    assert engine.schedule_log() is None       # off by default
    engine.schedule_log_arm(True)
    try:
        x = np.arange(16, dtype=np.float64).reshape(8, 2)
        bolt.array(x, context=CPU).map(lambda v: v + 3).toarray()
        log = engine.schedule_log()
        assert log and all("0x" not in k for k in log)
        count, _ = engine.schedule_digest()
        assert len(log) <= count
    finally:
        engine.schedule_log_arm(False)
    assert engine.schedule_log() is None


def test_schedule_reset():
    bolt.ones((4, 2), context=CPU).sum().toarray()
    engine.schedule_reset()
    count, digest = engine.schedule_digest()
    assert count == 0 and engine.schedule_recent() == []
    import hashlib
    assert digest == hashlib.sha256(b"bolt-schedule").hexdigest()
